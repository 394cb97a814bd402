// paged_window_attention: attention of a W-token window read straight off
// the paged KV pool through the block table, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_window_attention (pallas_call, grid (b, nb) with the block axis
// sequential, the table as scalar prefetch, (m, l, acc) in VMEM scratch).
// Serving uses it for W = 1 decode (paged_decode_attention) and for the
// W-token chunked-prefill window.
//
// Semantics, as the reference's: q is scaled in its own dtype (q * scale
// rounded to q's dtype), logits and P@V accumulate in f32 with p rounded to
// the cache dtype for the product, query row r of the window attends to
// cache positions <= pos[t, r] (and > pos - window with a sliding window),
// masked probabilities are exactly 0, and the output is
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: the cache bytes, each needed K and V page
// read once for all W x g query rows of its kv head; a few operations per
// byte (33.5 MB per OPT-6.7B slot at 2048 tokens and 16.8 MB per
// Mixtral-8x22B slot over its 4096-token window: 0.010 and 0.005 ms at
// 3.35 TB/s).
//
// bf16 design (paged_attn_split, flash-decoding on tensor cores):
// 1. Split pages. Grid (row group, split s of S, slot x kv head). A block
//    finds its slot's needed pages from pos itself (none wholly past the
//    window's last position, none wholly before a sliding window), cuts them
//    into S runs of whole stages and walks run s: an online softmax over
//    the keys for all R = W * g query rows (a row group of up to 32 or 96
//    rows; more only for R > 96), so K and V are read once for the GQA
//    group and the window. S comes from shapes alone (the wrapper's
//    attention_splits: about two blocks an SM, scratch bounded), so a call
//    needs no host sync and is the same work whatever pos holds. With S = 1
//    the block writes the output; else it writes its partial (m, l, acc) in
//    f32 (a run with no page writes m = -1e30, l = 0, acc = 0), and
//    pa_merge folds the S partials in ascending order: m = max m_s, l and acc
//    each rescaled by exp(m_s - m) and summed, divided once.
// 2. Pages in flight. One producer warp fills a ring of stages of 64 keys
//    (64 / bs pages) of K and V, 3 stages for four consumer warps (two
//    blocks an SM), 6 for six (one block an SM), so an SM
//    keeps some 192 KB in flight either way: the TMA engine copies each page's bs x hd
//    slab as boxes of 64 columns with the 128-byte swizzle (hd 64, 128;
//    unswizzled rows otherwise) and completes them on the stage's mbarrier.
//    Its lanes read the table 32 pages ahead; pages of a stage past the
//    run are written as zeros. Barriers are paid once per 64 keys.
// 3. Tensor cores. Warp (m16 tile, key slice) multiplies q k^T with bf16
//    mma.sync.m16n8k16 (K read by ldmatrix, conflict-free in the swizzle),
//    keeps the running max and sum of its two rows in registers (the four
//    lanes of a row meet by shuffles), rounds p to bf16 straight from the
//    logits' accumulator into the A fragment of p @ v (FlashAttention-2), and
//    multiplies V read by ldmatrix.trans. At R <= 16 (decode) the four
//    consumer warps split the 64 keys of a stage (16 each) and merge their
//    states in order at the end; at R <= 32 two tiles take two warps each;
//    above, six warps own one m16 tile each (R = 96: Mixtral-8x22B's
//    16-token window).
//
// f32 (the engine's parity path; no time claimed): paged_window_attn, one
// block per (slot, kv head) on CUDA cores, the pages in sequence.
//
// Partial mode (paged_window_attention_partial; serving on a data axis,
// where each data row of the mesh holds its own range of the pool's
// blocks): the pool is the rank's local blocks, global ids blk0 ..
// blk0 + nloc - 1, the table holds global ids, and a page outside the
// range is skipped (the producer zero-fills its slot of the ring instead of
// loading it and the consumers mask its keys; a stage with no page of the
// rank costs its barrier and the zero fill). Instead of o the call writes
// each query row's partial softmax (acc, m, l) in f32 as one row of hd + 2
// floats, unnormalised (the S runs of a slot merged by pa_merge's rule
// first); a row with no key on the rank gives m = -1e30, l = 0, acc = 0.
// paged_attention_fold folds the D rows' partials of a query row, gathered
// over the data axis, in ascending data index by the same rule and divides
// once.
#include "tile_group.cuh"

#define ATT_THREADS 128

// grid (b, kvp); block ATT_THREADS. Dynamic shared memory (floats):
// q[R*hd] acc[R*hd] k[bs*hd] v[bs*hd] s[R*bs] m[R] l[R] corr[R], R = W*g.
// Partial mode: parts != nullptr (rows of hd + 2 floats: acc, m, l), pages
// of global blocks blk0 .. blk0 + nloc - 1 only.
__global__ void paged_window_attn(const float* __restrict__ q, const float* __restrict__ kp,
                                  const float* __restrict__ vp, const int* __restrict__ table,
                                  const int* __restrict__ pos, float* __restrict__ out, int W,
                                  int kvp, int g, int hd, int bs, int nb, int window,
                                  float scale, int blk0, int nloc, float* __restrict__ parts) {
  extern __shared__ float sm[];
  const int R = W * g;
  float* qs = sm;
  float* acc = qs + R * hd;
  float* ks = acc + R * hd;
  float* vs = ks + bs * hd;
  float* sc = vs + bs * hd;
  float* mr = sc + R * bs;
  float* lr = mr + R;
  float* cr = lr + R;
  const int t = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;

  // q rows r = w * g + gi of head h, scaled
  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, c = e % hd, w = r / g, gi = r % g;
    const long qi = ((((long)t * W + w) * kvp + h) * g + gi) * hd + c;
    qs[e] = q[qi] * scale;
    acc[e] = 0.f;
  }
  int pmax = -1, pmin = 0x7fffffff;
  for (int w = 0; w < W; ++w) {
    const int p = pos[(long)t * W + w];
    pmax = max(pmax, p);
    pmin = min(pmin, p);
  }
  for (int r = tid; r < R; r += blockDim.x) {
    mr[r] = -1e30f;
    lr[r] = 0.f;
  }
  __syncthreads();

  const long blk_elems = (long)kvp * bs * hd;
  for (int j = 0; j < nb; ++j) {
    const int k0 = j * bs;
    if (k0 > pmax) break;                               // wholly causal-masked
    if (window && k0 + bs - 1 <= pmin - window) continue;  // wholly before the window
    const int lb = table[(long)t * nb + j] - blk0;
    if (lb < 0 || lb >= nloc) continue;  // a page another rank holds
    const long base = (long)lb * blk_elems + (long)h * bs * hd;
    for (int e = tid; e < bs * hd; e += blockDim.x) {
      ks[e] = kp[base + e];
      vs[e] = vp[base + e];
    }
    __syncthreads();
    // logits: one warp per (row, key), lanes split hd
    for (int pr = warp; pr < R * bs; pr += nwarp) {
      const int r = pr / bs, s = pr % bs;
      float d = 0.f;
      for (int c = lane; c < hd; c += 32) d += qs[r * hd + c] * ks[s * hd + c];
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) sc[pr] = d;
    }
    __syncthreads();
    // online softmax update, one thread per row
    for (int r = tid; r < R; r += blockDim.x) {
      const int qp = pos[(long)t * W + r / g];
      float mx = mr[r];
      for (int s = 0; s < bs; ++s) {
        const int kpos = k0 + s;
        const bool valid = kpos <= qp && (!window || kpos > qp - window);
        mx = fmaxf(mx, valid ? sc[r * bs + s] : -1e30f);
      }
      float lsum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const int kpos = k0 + s;
        const bool valid = kpos <= qp && (!window || kpos > qp - window);
        const float p = valid ? expf(sc[r * bs + s] - mx) : 0.f;
        lsum += p;
        sc[r * bs + s] = p;
      }
      const float corr = expf(mr[r] - mx);
      lr[r] = lr[r] * corr + lsum;
      cr[r] = corr;
      mr[r] = mx;
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += blockDim.x) {
      const int r = e / hd, c = e % hd;
      float pv = 0.f;
      for (int s = 0; s < bs; ++s) pv += sc[r * bs + s] * vs[s * hd + c];
      acc[e] = acc[e] * cr[r] + pv;
    }
    __syncthreads();
  }
  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, c = e % hd, w = r / g, gi = r % g;
    const long row = (((long)t * W + w) * kvp + h) * g + gi;
    if (parts != nullptr) {
      parts[row * (hd + 2) + c] = acc[e];
      if (c == 0) parts[row * (hd + 2) + hd] = mr[r], parts[row * (hd + 2) + hd + 1] = lr[r];
    } else {
      out[row * hd + c] = acc[e] / fmaxf(lr[r], 1e-30f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: split pages, a TMA ring, tensor cores

#define PA_KS 64  // keys per ring stage

// NW consumer warps: 4 (two blocks an SM, a 3-stage ring each) or 6 (one
// block an SM, so a 6-stage ring keeps as many bytes in flight; seven warps
// leave every scheduler at most two, and each thread 255 registers)
template <int HD, int NW> struct PaShape {
  static constexpr bool SW = HD % 64 == 0;   // 64-column boxes, 128-byte swizzle
  static constexpr int BOXC = SW ? 64 : HD;  // columns per TMA box
  static constexpr int SLAB = PA_KS * HD;    // elements of one stage's K (or V)
  static constexpr int STAGES = NW == 4 ? 3 : 6;
  static constexpr size_t smem() { return 1024 + (size_t)STAGES * 2 * SLAB * 2; }
};

// element offset of (key k, column c) in a stage's slab, c a multiple of 8:
// [box][key][64] with 16-byte chunk j of row k at j ^ (k % 8), or [key][HD]
template <int HD> __device__ __forceinline__ int pa_off(int k, int c) {
  if constexpr (HD % 64 == 0)
    return (c >> 6) * PA_KS * 64 + k * 64 + ((((c >> 3) & 7) ^ (k & 7)) << 3);
  else
    return k * HD + c;
}

// c += a b on the tensor cores (bf16 m16n8k16, f32); not volatile, so the
// compiler may move it between the fragment loads it waits for
__device__ __forceinline__ void pa_mma(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of K rows key0 .. key0 + 8 * NTS - 1 for hd columns
// 16 kc .. 16 kc + 15: fragment np holds the n8 tiles 2 np and 2 np + 1
template <int HD, int NTS>
__device__ __forceinline__ void pa_load_k(const __nv_bfloat16* ks, int key0, int kc, int lane,
                                          unsigned (&b)[NTS / 2][4]) {
#pragma unroll
  for (int np = 0; np < NTS / 2; ++np) {
    const int key = key0 + np * 16 + ((lane >> 4) << 3) + (lane & 7);
    const int col = kc * 16 + ((lane >> 3) & 1) * 8;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[np][0]), "=r"(b[np][1]), "=r"(b[np][2]), "=r"(b[np][3])
                 : "r"(tg_saddr(ks + pa_off<HD>(key, col))));
  }
}

__device__ __forceinline__ void pa_consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

struct PaArgs {
  const __nv_bfloat16* q;  // (b, W, kvp, g, HD)
  const int* table;        // (b, nb)
  const int* pos;          // (b, W)
  __nv_bfloat16* out;      // (b, W, kvp, g, HD)
  float* po;               // partial acc (b * kvp, S, R, HD), S > 1
  float* pm;               // partial m (b * kvp, S, R)
  float* pl;               // partial l (b * kvp, S, R)
  int W, kvp, g, bs, nb, window;
  float scale;
  float* parts;  // partial mode: (b, W, kvp, g, HD + 2) acc, m, l; else nullptr
  int blk0, nloc;  // the pool's blocks: global ids blk0 .. blk0 + nloc - 1
};

// The consumer warp (m16 tile, key slice kw of KW): the online softmax of
// its two rows over its keys of every stage; returns m, the quad's l, and
// acc in the C fragments' layout.
// own[slot]: bit p set where page p of the stage is the rank's (its keys
// count; the producer zero-filled the others).
template <int HD, int STAGES, int KW>
__device__ __forceinline__ void pa_consume(const __nv_bfloat16* ring, unsigned long long* full,
                                           unsigned long long* empty, const unsigned* own,
                                           int nst, int kpos0, int kend, int bs,
                                           const unsigned (&qf)[HD / 16][4], int qp0,
                                           int qp1, int window, bool live, int kw, int lane,
                                           float (&m)[2], float (&l)[2],
                                           float (&o)[HD / 8][4]) {
  constexpr int KSW = PA_KS / KW, NTS = KSW / 8;
  const int q = lane & 3, lbs = __ffs(bs) - 1;  // page sizes are powers of two
  for (int st = 0; st < nst; ++st) {
    const int slot = st % STAGES;
    tg_bar_wait(&full[slot], (st / STAGES) & 1);
    const unsigned mine = own[slot];
    if (live && mine != 0u) {
      const __nv_bfloat16* ks = ring + slot * 2 * PA_KS * HD;
      const __nv_bfloat16* vs = ks + PA_KS * HD;
      float sc[NTS][4];
#pragma unroll
      for (int i = 0; i < NTS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      // logits: K rows are the col-major B operand as they stand; a k16
      // step's fragments are all loaded before its products
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        unsigned bk[NTS / 2][4];
        pa_load_k<HD, NTS>(ks, kw * KSW, kc, lane, bk);
#pragma unroll
        for (int np = 0; np < NTS / 2; ++np) {
          pa_mma(sc[2 * np], qf[kc], bk[np][0], bk[np][1]);
          pa_mma(sc[2 * np + 1], qf[kc], bk[np][2], bk[np][3]);
        }
      }
      // masks, the running max, p
      const int kb = kpos0 + st * PA_KS + kw * KSW;  // the slice's first key position
      unsigned valid = 0u;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kst = kw * KSW + nt * 8 + 2 * q + (j & 1);  // key of the stage
          const int key = kb + nt * 8 + 2 * q + (j & 1), qp = j < 2 ? qp0 : qp1;
          if (key < kend && key <= qp && (!window || key > qp - window) &&
              ((mine >> (kst >> lbs)) & 1u)) {
            valid |= 1u << (nt * 4 + j);
            mx[j >> 1] = fmaxf(mx[j >> 1], sc[nt][j]);
          }
        }
      float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = __expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = (valid >> (nt * 4 + j)) & 1u ? __expf(sc[nt][j] - mx[j >> 1]) : 0.f;
          sc[nt][j] = p;
          ls[j >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= corr[0], o[n][1] *= corr[0];
        o[n][2] *= corr[1], o[n][3] *= corr[1];
      }
      // p @ v: the logits' accumulator, rounded to bf16, is the A fragment
#pragma unroll
      for (int kc2 = 0; kc2 < KSW / 16; ++kc2) {
        const unsigned a[4] = {tg_pack(sc[2 * kc2][0], sc[2 * kc2][1]),
                               tg_pack(sc[2 * kc2][2], sc[2 * kc2][3]),
                               tg_pack(sc[2 * kc2 + 1][0], sc[2 * kc2 + 1][1]),
                               tg_pack(sc[2 * kc2 + 1][2], sc[2 * kc2 + 1][3])};
        const int key = kw * KSW + kc2 * 16 + (lane & 15);
        unsigned bv[HD / 16][4];  // V rows, transposed: every fragment of the step first
#pragma unroll
        for (int np = 0; np < HD / 16; ++np)
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(bv[np][0]), "=r"(bv[np][1]), "=r"(bv[np][2]), "=r"(bv[np][3])
                       : "r"(tg_saddr(vs + pa_off<HD>(key, np * 16 + (lane >> 4) * 8))));
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          pa_mma(o[2 * np], a, bv[np][0], bv[np][1]);
          pa_mma(o[2 * np + 1], a, bv[np][2], bv[np][3]);
        }
      }
    }
    tg_bar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// grid (ceil(ceil(R / 16) / NW), S, b * kvp); block NW * 32 consumers + one
// producer warp; dynamic shared memory PaShape<HD, NW>::smem(). Warp w owns
// m16 tile w / KW of its row group and key slice w % KW (KW = 4 or 2 with
// four warps, 1 with six). kmap / vmap:
// the pools (n_blocks * kvp * bs, HD) in boxes of bs rows x BOXC columns.
template <int HD, int NW, int KW>
__global__ void __launch_bounds__(NW * 32 + 32, NW == 4 ? 2 : 1)
paged_attn_split(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const PaArgs a) {
  using P = PaShape<HD, NW>;
  constexpr int CONS = NW * 32, STAGES = P::STAGES;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  unsigned char* base = pa_smem + ((1024 - (tg_saddr(pa_smem) & 1023)) & 1023);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(base);  // [stage][K, V][SLAB]
  __shared__ unsigned long long full[STAGES], empty[STAGES];
  __shared__ unsigned own[STAGES];  // the stage's pages that are the rank's

  const int rg = blockIdx.x, s = blockIdx.y, S = gridDim.y, bh = blockIdx.z;
  const int t = bh / a.kvp, h = bh % a.kvp, R = a.W * a.g, bs = a.bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // -- the pages this block reads: run s of the slot's needed pages ---------
  int pmax = -1, pmin = INT_MAX;
  for (int w = 0; w < a.W; ++w) {
    const int p = a.pos[(long)t * a.W + w];
    pmax = max(pmax, p);
    pmin = min(pmin, p);
  }
  const int pps = PA_KS / bs;  // pages a stage
  const int jlo = a.window ? max(0, pmin - a.window + 1) / bs : 0;
  const int jhi = pmax < 0 ? -1 : min(a.nb - 1, pmax / bs);
  int j0 = 0, j1 = -1;
  if (jhi >= jlo) {
    const int per = ((jhi - jlo + S) / S + pps - 1) / pps * pps;  // whole stages a run
    j0 = jlo + s * per;
    j1 = min(jhi, j0 + per - 1);
  }
  const int nst = j1 >= j0 ? (j1 - j0 + pps) / pps : 0;

  if (tid < STAGES) {
    tg_bar_init(&full[tid], 32);  // the producer's lanes (lane 0 with the boxes' bytes)
    tg_bar_init(&empty[tid], CONS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == NW) {
    // -- the producer warp: stage st into ring slot st % STAGES once every
    //    consumer is done with the slot's previous stage. Lane p < pps asks
    //    the TMA engine for page j0 + st * pps + p of K and V; a page past
    //    the run is written as zeros (so p @ v of its masked keys is 0)
    const long trow = (long)t * a.nb;
    int tb = j0 + lane <= j1 ? a.table[trow + j0 + lane] : 0;  // pages 0-31 of the run
    int tb_next = j0 + 32 + lane <= j1 ? a.table[trow + j0 + 32 + lane] : 0;
    const unsigned page_bytes = (unsigned)bs * HD * 2;
    for (int st = 0; st < nst; ++st) {
      const int slot = st % STAGES, pg0 = st * pps;
      if (st > 0 && (pg0 & 31) == 0) {
        tb = tb_next;
        tb_next = j0 + pg0 + 32 + lane <= j1 ? a.table[trow + j0 + pg0 + 32 + lane] : 0;
      }
      const int blk = __shfl_sync(0xffffffffu, tb, (pg0 & 31) + (lane < pps ? lane : 0)) - a.blk0;
      const int np = min(pps, j1 - j0 - pg0 + 1);  // pages of the run in this stage
      // the run's pages in this stage that are the rank's (all of them but
      // in partial mode)
      const bool mine = lane < np && blk >= 0 && blk < a.nloc;
      const unsigned bits = __ballot_sync(0xffffffffu, mine);
      if (st >= STAGES) tg_bar_wait(&empty[slot], (st / STAGES - 1) & 1);
      __nv_bfloat16* ks = ring + slot * 2 * P::SLAB;
      __nv_bfloat16* vs = ks + P::SLAB;
      for (int p = 0; p < pps; ++p)  // the others: zeros, before each lane arrives
        if (!((bits >> p) & 1u))
          for (int bx = 0; bx < HD / P::BOXC; ++bx)
            for (int e = lane * 8; e < bs * P::BOXC; e += 256) {
              const int off = (bx * PA_KS + p * bs) * P::BOXC + e;
              *reinterpret_cast<uint4*>(ks + off) = make_uint4(0u, 0u, 0u, 0u);
              *reinterpret_cast<uint4*>(vs + off) = make_uint4(0u, 0u, 0u, 0u);
            }
      if (lane == 0) {
        own[slot] = bits;
        tg_bar_arrive_tx(&full[slot], 2 * __popc(bits) * page_bytes);
      }
      __syncwarp();  // the bytes are expected before any box lands
      if (mine) {
        const int row = (blk * a.kvp + h) * bs;
#pragma unroll
        for (int bx = 0; bx < HD / P::BOXC; ++bx) {
          const int off = (bx * PA_KS + lane * bs) * P::BOXC;
          tg_tma(ks + off, &kmap, bx * P::BOXC, row, &full[slot]);
          tg_tma(vs + off, &vmap, bx * P::BOXC, row, &full[slot]);
        }
      }
      if (lane != 0) tg_bar_arrive(&full[slot]);
    }
    return;
  }

  // -- consumers: warp (m16 tile mt, key slice kw of KW) --------------------
  const int T16 = (R + 15) / 16, Tg = min(NW, T16 - rg * NW);  // m16 tiles of the block
  const int mt = warp / KW, kw = warp % KW;
  const bool live = mt < Tg;
  const int gq = lane >> 2, q = lane & 3;
  const int r0 = (rg * NW + mt) * 16 + gq, r1 = r0 + 8;  // this lane's rows of the window
  unsigned qf[HD / 16][4];  // q * scale rounded to bf16: the A fragments of q k^T
  int qp0 = -1, qp1 = -1;   // a row past R attends to nothing
  if (live) {
    const float sq = round_to<__nv_bfloat16>(a.scale);
    const __nv_bfloat16* qr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r1 : r0, w = r / a.g;
      qr[hh] = r < R ? a.q + ((((long)t * a.W + w) * a.kvp + h) * a.g + r % a.g) * HD : nullptr;
    }
    if (r0 < R) qp0 = a.pos[(long)t * a.W + r0 / a.g];
    if (r1 < R) qp1 = a.pos[(long)t * a.W + r1 / a.g];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16* src = qr[e & 1];
        float2 v = make_float2(0.f, 0.f);
        if (src != nullptr)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              src + kc * 16 + (e >> 1) * 8 + 2 * q));
        qf[kc][e] = tg_pack(round_to<__nv_bfloat16>(v.x * sq), round_to<__nv_bfloat16>(v.y * sq));
      }
  }
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  pa_consume<HD, STAGES, KW>(ring, full, empty, own, nst, j0 * bs, (j1 + 1) * bs, bs, qf,
                             qp0, qp1, a.window, live, kw, lane, m, l, o);

  // -- the key slices of a tile merged in order, through the drained ring ---
  float* Mo = reinterpret_cast<float*>(base);  // [warp][16][HD]
  float* Mm = Mo + NW * 16 * HD;               // [warp][16]: m, then exp(m - max)
  float* Ml = Mm + NW * 16;                    // [warp][16]
  float* Rm = Ml + NW * 16;                    // [row]: the row's max and sum
  float* Rl = Rm + NW * 16;
  long* Ro = reinterpret_cast<long*>(Rl + NW * 16);  // [row]: where it goes
  pa_consumer_sync(CONS);  // every consumer is done with the ring
  if (live) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(Mo + (warp * 16 + gq + 8 * hh) * HD + n * 8 + 2 * q) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    if (q == 0)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        Mm[warp * 16 + gq + 8 * hh] = m[hh];
        Ml[warp * 16 + gq + 8 * hh] = l[hh];
      }
  }
  pa_consumer_sync(CONS);
  for (int r = tid; r < Tg * 16; r += CONS) {  // a row's slices, in order
    const int w0 = (r >> 4) * KW, i = r & 15;
    float mx = -1e30f, ls = 0.f;
    for (int k = 0; k < KW; ++k) mx = fmaxf(mx, Mm[(w0 + k) * 16 + i]);
    for (int k = 0; k < KW; ++k) {
      const float f = __expf(Mm[(w0 + k) * 16 + i] - mx);
      Mm[(w0 + k) * 16 + i] = f;
      ls += Ml[(w0 + k) * 16 + i] * f;
    }
    Rm[r] = mx, Rl[r] = ls;
    const int row = rg * NW * 16 + r, w = row / a.g;
    Ro[r] = S == 1 ? (((long)t * a.W + w) * a.kvp + h) * a.g + row % a.g  // the query row
                   : (((long)bh * S + s) * R + row);
  }
  pa_consumer_sync(CONS);
  for (int e = tid; e < Tg * 16 * HD; e += CONS) {
    const int r = e / HD, c = e % HD, row = rg * NW * 16 + r;
    if (row >= R) continue;
    const int w0 = (r >> 4) * KW, i = r & 15;
    float acc = 0.f;
    for (int k = 0; k < KW; ++k) acc += Mo[((w0 + k) * 16 + i) * HD + c] * Mm[(w0 + k) * 16 + i];
    if (S == 1 && a.parts != nullptr) {
      a.parts[Ro[r] * (HD + 2) + c] = acc;
      if (c == 0) a.parts[Ro[r] * (HD + 2) + HD] = Rm[r], a.parts[Ro[r] * (HD + 2) + HD + 1] = Rl[r];
    } else if (S == 1) {
      a.out[Ro[r] * HD + c] = __float2bfloat16(acc / fmaxf(Rl[r], 1e-30f));
    } else {
      a.po[Ro[r] * HD + c] = acc;
      if (c == 0) a.pm[Ro[r]] = Rm[r], a.pl[Ro[r]] = Rl[r];
    }
  }
}

// out = the S partials of each (slot x kv head, row) folded in ascending
// split order (partial mode: the folded acc, m and l, undivided). grid
// (R, b * kvp); block HD.
__global__ void pa_merge(const PaArgs a, int S, int HD) {
  const int row = blockIdx.x, bh = blockIdx.y, c = threadIdx.x, R = a.W * a.g;
  const long p0 = (long)bh * S * R + row;
  float mx = -1e30f;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, a.pm[p0 + (long)s * R]);
  float ls = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const long pr = p0 + (long)s * R;
    const float f = __expf(a.pm[pr] - mx);
    ls += a.pl[pr] * f;
    acc += a.po[pr * HD + c] * f;
  }
  const int t = bh / a.kvp, h = bh % a.kvp, w = row / a.g;
  const long qr = (((long)t * a.W + w) * a.kvp + h) * a.g + row % a.g;
  if (a.parts != nullptr) {
    a.parts[qr * (HD + 2) + c] = acc;
    if (c == 0) a.parts[qr * (HD + 2) + HD] = mx, a.parts[qr * (HD + 2) + HD + 1] = ls;
  } else {
    a.out[qr * HD + c] = __float2bfloat16(acc / fmaxf(ls, 1e-30f));
  }
}

// out (n, HD) = the D partials of query rows row0 .. row0 + n - 1, parts
// (D, rows, HD + 2) f32, folded in ascending order: m = max m_d, l and acc
// each rescaled by exp(m_d - m) and summed, divided once (as pa_merge).
// grid (n); block HD.
__global__ void pa_fold(const float* __restrict__ parts, void* __restrict__ out, int D,
                        long rows, long row0, int HD, int dtype) {
  const long r = blockIdx.x, stride = rows * (HD + 2);
  const int c = threadIdx.x;
  const float* p = parts + (row0 + r) * (HD + 2);
  float mx = -1e30f;
  for (int d = 0; d < D; ++d) mx = fmaxf(mx, p[d * stride + HD]);
  float ls = 0.f, acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const float f = expf(p[d * stride + HD] - mx);
    ls += p[d * stride + HD + 1] * f;
    acc += p[d * stride + c] * f;
  }
  const float o = acc / fmaxf(ls, 1e-30f);
  if (dtype == DT_F32)
    static_cast<float*>(out)[r * HD + c] = o;
  else
    static_cast<__nv_bfloat16*>(out)[r * HD + c] = __float2bfloat16(o);
}

template <int HD, int NW, int KW>
static cudaError_t launch_split_nw(const CUtensorMap& kmap, const CUtensorMap& vmap,
                                   const PaArgs& a, int b, int S, cudaStream_t s) {
  constexpr size_t smem = PaShape<HD, NW>::smem();
  static bool attributes_set = false;  // once a process: the host calls cost microseconds
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_attn_split<HD, NW, KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attributes_set = true;
  }
  const int T16 = (a.W * a.g + 15) / 16;
  paged_attn_split<HD, NW, KW><<<dim3((T16 + NW - 1) / NW, S, b * a.kvp), NW * 32 + 32, smem,
                                 s>>>(kmap, vmap, a);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_split(const void* kp, const void* vp, const PaArgs& a, int b,
                                int n_blocks, int S, cudaStream_t s) {
  using P = PaShape<HD, 4>;
  const CUtensorMapSwizzle sw = P::SW ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const long rows = (long)n_blocks * a.kvp * a.bs;
  CUtensorMap kmap, vmap;
  cudaError_t e = tg_map_2d(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kp, rows, HD, P::BOXC,
                            a.bs, sw);
  if (e != cudaSuccess) return e;
  e = tg_map_2d(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vp, rows, HD, P::BOXC, a.bs, sw);
  if (e != cudaSuccess) return e;
  // four consumer warps for one or two m16 tiles (the keys split 4 or 2
  // ways), six for more, one tile each
  const int T16 = (a.W * a.g + 15) / 16;
  e = T16 == 1   ? launch_split_nw<HD, 4, 4>(kmap, vmap, a, b, S, s)
      : T16 == 2 ? launch_split_nw<HD, 4, 2>(kmap, vmap, a, b, S, s)
                 : launch_split_nw<HD, 6, 1>(kmap, vmap, a, b, S, s);
  if (e != cudaSuccess || S == 1) return e;
  pa_merge<<<dim3(a.W * a.g, b * a.kvp), HD, 0, s>>>(a, S, HD);
  return cudaGetLastError();
}

static int attention(const void* q, const void* k_pages, const void* v_pages,
                     const void* table, const void* pos, void* out, void* scratch, int b,
                     int W, int kvp, int g, int hd, int bs, int nb, int n_blocks, int window,
                     int S, float scale, int dtype, float* parts, int blk0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 0 || kvp <= 0 || W <= 0 || g <= 0) return (int)cudaGetLastError();
  if (dtype == DT_F32) {
    if (S != 1) return (int)cudaErrorInvalidValue;
    const int R = W * g;
    size_t smem = (size_t)(2 * R * hd + 2 * bs * hd + R * bs + 3 * R) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(paged_window_attn,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    paged_window_attn<<<dim3(b, kvp), ATT_THREADS, smem, s>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages, (const int*)table,
        (const int*)pos, (float*)out, W, kvp, g, hd, bs, nb, window, scale, blk0, n_blocks,
        parts);
    return (int)cudaGetLastError();
  }
  if (dtype != DT_BF16 || bs < 8 || PA_KS % bs || S < 1 || (S > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const long part = (long)b * kvp * S * W * g;
  float* po = (float*)scratch;
  PaArgs a{(const __nv_bfloat16*)q, (const int*)table, (const int*)pos, (__nv_bfloat16*)out,
           po, po ? po + part * hd : nullptr, po ? po + part * (hd + 1) : nullptr,
           W, kvp, g, bs, nb, window, scale, parts, blk0, n_blocks};
  switch (hd) {
    case 16: return (int)launch_split<16>(k_pages, v_pages, a, b, n_blocks, S, s);
    case 32: return (int)launch_split<32>(k_pages, v_pages, a, b, n_blocks, S, s);
    case 64: return (int)launch_split<64>(k_pages, v_pages, a, b, n_blocks, S, s);
    case 80: return (int)launch_split<80>(k_pages, v_pages, a, b, n_blocks, S, s);
    case 128: return (int)launch_split<128>(k_pages, v_pages, a, b, n_blocks, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q (b, W, kvp, g, hd); k/v pages (n_blocks, kvp, bs, hd); table (b, nb) i32;
// pos (b, W) i32 -> out (b, W, kvp, g, hd). q, pages and out share one dtype.
// bf16: hd in {16, 32, 64, 80, 128}, bs in {8, 16, 32, 64}, pages 16-byte
// aligned, S splits; scratch (b * kvp * S * R * (hd + 2) f32) when S > 1.
// f32: S must be 1, no scratch.
extern "C" int paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* pos, void* out,
                                      void* scratch, int b, int W, int kvp, int g, int hd,
                                      int bs, int nb, int n_blocks, int window, int S,
                                      float scale, int dtype, void* stream) {
  return attention(q, k_pages, v_pages, table, pos, out, scratch, b, W, kvp, g, hd, bs, nb,
                   n_blocks, window, S, scale, dtype, nullptr, 0, stream);
}

// The partial mode: the pages are global blocks blk0 .. blk0 + n_blocks - 1
// (the table's other ids are skipped), and parts (b, W, kvp, g, hd + 2) f32
// receives each query row's acc, m and l instead of o. Shapes and scratch
// as paged_window_attention.
extern "C" int paged_window_attention_partial(
    const void* q, const void* k_pages, const void* v_pages, const void* table, const void* pos,
    void* parts, void* scratch, int b, int W, int kvp, int g, int hd, int bs, int nb,
    int n_blocks, int blk0, int window, int S, float scale, int dtype, void* stream) {
  if (parts == nullptr) return (int)cudaErrorInvalidValue;
  return attention(q, k_pages, v_pages, table, pos, nullptr, scratch, b, W, kvp, g, hd, bs, nb,
                   n_blocks, window, S, scale, dtype, (float*)parts, blk0, stream);
}

// parts (D, rows, hd + 2) f32 -> out (n, hd) in dtype: query rows row0 ..
// row0 + n - 1 folded over the D partials.
extern "C" int paged_attention_fold(const void* parts, void* out, int D, long rows, long row0,
                                    long n, int hd, int dtype, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (hd > 1024 || D <= 0 || (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  pa_fold<<<dim3((unsigned)n), hd, 0, (cudaStream_t)stream>>>((const float*)parts, out, D, rows,
                                                              row0, hd, dtype);
  return (int)cudaGetLastError();
}
