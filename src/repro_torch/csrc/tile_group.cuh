// Tile-grouped row gather on tensor cores, for Hopper (sm_90a): the bf16-weight
// path of sparse_matmul_tokens, expert_down_matmul and (shared-list mode, 4.)
// sparse_matmul.
//
//   y[t, j] = sum_{i < nvalid[t]} sum_c a(t, i)[c] * w[idx[t, i] * tile + c, j]
//
// a(t, i) is row t's slice for list slot i: x[t, idx[t, i] * tile : +tile]
// for a (T, F) input (tokens mode), compact[t, i, :] for (T, K, tile) blocks
// (compact mode). Every valid slot counts, a tile listed twice included, as in
// the TPU kernels, which add one product per valid slot.
//
// Why the row gather of common.cuh is slow for these callers: it runs on
// CUDA-core FMAs (one shared load per two FMAs), and it reads a weight tile
// once per 16-row block only when all 16 rows name it at the same list slot,
// else once per row. Mixtral's router gives the 16 tokens of a block
// different experts at nearly every slot, and chunked-prefill windows read the
// whole weight once per window. Here a weight tile is read once per group of
// rows that lists it, and multiplied on tensor cores:
//
// 1. Chunks. Tile ids are cut into runs of R consecutive ids (R =
//    tiles_per_expert for expert_down_matmul: a run is an expert). Row t has
//    a (row, run) pair in run s when a valid slot names a tile of s. The
//    pairs of a run, rows ascending, are cut into chunks of TG_M = 64. With
//    one run (sparse_matmul_tokens, d_ff / tile <= 128 tiles) chunk c is rows
//    64c.. and the blocks write y. Otherwise row_runs writes each row's runs
//    as a 64-bit mask, and block (x, y) ranks the rows of run y / cpr (cpr =
//    ceil(T / 64), the upper bound, so the host needs no count and no sync)
//    to find its chunk y % cpr; a surplus block exits. tile_group_plan in
//    kernels/sparse_matmul.py is the same chunking in torch, for the tests.
// 2. tile_groups: one block per (BN columns, chunk), BN = 64 for
//    sparse_matmul_tokens and 128 for expert_down_matmul. Its prologue
//    counts, for every pair and tile of the run, the valid slots naming the
//    tile and the first of them, and walks the union of the pairs' tiles in
//    ascending id, a tile named c times by some pair c times: on walk r a
//    pair's A row holds its (r + 1)-th slot's slice, or reads as zero where
//    the pair names the tile r times or fewer. So a repeated tile adds exact
//    products once per slot. Producer warps (8, or 4 for f32 A) fill a
//    4-slot ring: the TMA engine copies the step's weight box (64 rows x BN
//    columns, zeros past D, 128-byte swizzle so ldmatrix reads it without
//    bank conflicts), the producers' cp.async copy the A rows that name the
//    tile; mbarriers hand slots between producers and the eight consumer
//    warps. Consumers multiply with bf16 mma.sync.m16n8k16 into f32: MW
//    warps of m16 pair tiles times 8 / MW column warps, MW = 1, 2 or 4 by
//    the chunk's size, so a chunk of a few tokens spreads its one m16 tile
//    over every warp. Each stage's products go to a fresh accumulator, added
//    to the total with an f32 add: the tensor cores' accumulation truncates,
//    and over the 2048 k16 steps of a 32768-row list (x 3 terms) its bias
//    reached 5e-5 of the sum on the card.
// 3. run_sum (more than one run): y[t] = row t's pair partials P[s * T + t]
//    summed in ascending run order, f32; a row with no run gets zeros.
// 4. Shared-list mode (SHARED, sparse_matmul): every row names the same
//    list idx (K,) with one nvalid, so chunk c is rows 64c.. with no
//    ranking and no counts, and the walk is the list's own valid slots
//    i < nvalid in list order (a tile listed twice is walked twice; pads
//    past nvalid are not walked; nvalid == 0 writes exact zeros). The
//    rows of a chunk are consecutive, so one producer thread asks the TMA
//    engine for the step's x as one box (64 rows x KS columns; 128-byte
//    swizzle for bf16 at KS = 64, which the consumers' fragments read
//    without bank conflicts; rows past T read as zeros and are never
//    written) beside the weight box, instead of the producers' cp.async.
//    BN = 32 (64-byte swizzled weight boxes) doubles the blocks of a
//    single chunk, for T <= 64.
//
// Operands: a bf16 A (x or compact blocks) is multiplied as it is; then the
// operands equal the reference's and only the order of the f32 sum differs.
// An f32 A against bf16 weights (an f32 x in tokens mode, f32 blocks in
// compact mode) is multiplied unrounded, as the reference's promoted dot
// does: the consumer warps split each staged A element v once into three
// bf16 terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)
// (each difference exact in f32; the sum is v to within 2^-24 |v|),
// and one mma is issued per term against the same weight fragment (the
// weight is exactly bf16). At Mixtral-8x22B width, T = 128 and top-2 that is
// 3 terms x 256 pairs x 16384 x 6144 x 2 = 155 GFLOP (a warp whose 16 pairs
// all lie past its chunk's end skips its mma), 0.16 ms at 989 TFLOP/s,
// under the 0.48 ms that the 1.6 GB of routed expert tiles take at 3.35 TB/s.
//
// What bounds it on the H100: the weight bytes, each listed tile read once
// per (chunk, column block), and the A rows read again by every column
// block. Measured on the card (PERF.md): kernel 3 is held by its
// producers' cp.async of the A rows (the TMA engine keeps the weight boxes
// ahead), kernel 10 with f32 blocks by the three terms' mma. No atomics in
// the arithmetic and a fixed order for each input: two calls
// give the same bits.
//
// Scratch (more than one run): the runs mask (T x 8 bytes) and the pair
// partials P (n_runs x T x D f32, sized by the upper bound); the wrapper
// cuts the rows into slabs so both stay under TG_SCRATCH_BYTES (32 MiB,
// kernels/sparse_matmul.py) whatever T and K are. One run needs none.
#pragma once

#include <cuda.h>
#include <limits.h>

#include "common.cuh"

#define TG_M 64            // pairs per chunk (4 m16 tiles)
#define TG_KS 64           // tile rows per ring stage (16 for tiles 64 does not divide)
#define TG_RMAX 128        // tile ids per run at most
#define TG_MAX_RUNS 64     // runs at most (a row's runs are one 64-bit mask)
#define TG_CONSUMERS 256   // 8 warps multiplying

// Shared memory: weight slabs of KS rows x BN columns as BN / 64 boxes of
// 64 columns written by the TMA engine with its 128-byte swizzle (row k's
// 16-byte chunk c at chunk c ^ (k % 8); 1024-byte aligned), then the ring's
// A rows as AT, then (f32 A) the bf16 terms of one stage's rows; rows
// padded by 8 elements. A ring of 4 slots, 3 for f32 A (its slots are twice
// as large, and its term planes take a slot's room).
template <typename AT, int BN, int KS> struct TgShape {
  static constexpr int TERMS = sizeof(AT) == 2 ? 1 : 3;  // bf16 terms of an A value
  static constexpr int STAGES = sizeof(AT) == 2 ? 4 : 3;
  static constexpr int PRODUCERS = 256;  // 8 warps issuing the ring's copies
  static constexpr int THREADS = TG_CONSUMERS + PRODUCERS;
  static constexpr int ASTR = KS + 8, PSTR = KS + 8;
  static constexpr int ABYTES = TG_M * ASTR * (int)sizeof(AT), WBYTES = KS * BN * 2;
  static constexpr int PBYTES = sizeof(AT) == 2 ? 0 : TERMS * TG_M * PSTR * 2;
  static constexpr size_t smem() {
    return 1024 + (size_t)STAGES * (ABYTES + WBYTES) + PBYTES + 2 * STAGES * 8 +
           (size_t)(2 * TG_M * TG_RMAX + TG_RMAX + 2 * TG_M) * sizeof(int) +
           TG_RMAX * sizeof(short);
  }
};

// the 16-byte chunk holding column n (a multiple of 8) of row k of a
// swizzled weight slab: BN / 64 boxes of 64 columns with the 128-byte
// swizzle, or (BN = 32) one box of 32 columns with the 64-byte swizzle
// (16-byte chunk c of row k at c ^ (k / 2 % 4))
template <int KS, int BN>
__device__ __forceinline__ int tg_wchunk(int k, int n) {
  if constexpr (BN == 32) return k * 4 + (((n >> 3) & 3) ^ ((k >> 1) & 3));
  else return (n >> 6) * KS * 8 + k * 8 + (((n >> 3) & 7) ^ (k & 7));
}

__device__ __forceinline__ unsigned tg_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void tg_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tg_saddr(dst)), "l"(src));
}
__device__ __forceinline__ void tg_bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tg_saddr(bar)), "r"(count));
}
__device__ __forceinline__ void tg_bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tg_saddr(bar)) : "memory");
}
__device__ __forceinline__ void tg_bar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tg_saddr(bar)),
               "r"(bytes)
               : "memory");
}
// one box of a 2-D tensor map (x = column, y = row) into shared memory by
// the TMA engine, completing on bar
__device__ __forceinline__ void tg_tma(void* dst, const CUtensorMap* map, int x, int y,
                                       unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(tg_saddr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(tg_saddr(bar))
      : "memory");
}
// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void tg_bar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(tg_saddr(bar))
               : "memory");
}
__device__ __forceinline__ void tg_bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tg_saddr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tg_mma(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned tg_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (the low half) = lo
  return *reinterpret_cast<unsigned*>(&v);
}

// The A fragment of one m16 x k16 bf16 slab: rows g and g + 8, columns 2q,
// 2q + 1 and 2q + 8, 2q + 9 from a; a row whose flag is false reads as
// exact zeros.
__device__ __forceinline__ void tg_afrag(const __nv_bfloat16* a, int str, bool n0, bool n1,
                                         unsigned* out) {
  out[0] = n0 ? *reinterpret_cast<const unsigned*>(a) : 0u;
  out[1] = n1 ? *reinterpret_cast<const unsigned*>(a + 8 * str) : 0u;
  out[2] = n0 ? *reinterpret_cast<const unsigned*>(a + 8) : 0u;
  out[3] = n1 ? *reinterpret_cast<const unsigned*>(a + 8 * str + 8) : 0u;
}

// The A fragment (mma.sync's m16 x k16 layout) of rows ra and ra + 8,
// columns kk + 2q, +1 and kk + 2q + 8, +9 of a slab of 128-byte rows with
// the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8), as the TMA
// engine writes it); a row whose flag is false reads as exact zeros.
__device__ __forceinline__ void tg_afrag_sw(const __nv_bfloat16* slab, int ra, int kk, int q,
                                            bool n0, bool n1, unsigned* out) {
  const char* r0 = reinterpret_cast<const char*>(slab) + ra * 128 + 4 * q;
  const char* r1 = r0 + 8 * 128;  // (ra + 8) % 8 == ra % 8: the same swizzle
  const int c0 = ((kk >> 3) ^ (ra & 7)) << 4, c1 = (((kk >> 3) + 1) ^ (ra & 7)) << 4;
  out[0] = n0 ? *reinterpret_cast<const unsigned*>(r0 + c0) : 0u;
  out[1] = n1 ? *reinterpret_cast<const unsigned*>(r1 + c0) : 0u;
  out[2] = n0 ? *reinterpret_cast<const unsigned*>(r0 + c1) : 0u;
  out[3] = n1 ? *reinterpret_cast<const unsigned*>(r1 + c1) : 0u;
}

// The consumer warps' own barrier (id 1; the producers never wait on it).
__device__ __forceinline__ void tg_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TG_CONSUMERS) : "memory");
}

// mask[t] = the runs (tile id / R) that row t's valid slots name, as bits.
// grid T; block 128.
__global__ void row_runs(const int* __restrict__ idx, int K, const int* __restrict__ nvalid,
                         int R, unsigned long long* __restrict__ mask) {
  __shared__ unsigned long long part[4];
  const int t = blockIdx.x, nv = nvalid[t];
  unsigned long long m = 0;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) m |= 1ull << (idx[(long)t * K + i] / R);
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)m);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ((unsigned long long)hi << 32) | lo;
  __syncthreads();
  if (threadIdx.x == 0) mask[t] = part[0] | part[1] | part[2] | part[3];
}

// The consumer warps of tile_groups: each walk step waits for its ring
// slot, multiplies and releases the slot. MW pair warps (m16 tiles) times 8
// / MW column warps: a warp owns 16 pairs and BN / 8 * MW / 8 n8 tiles, so a
// chunk of a few pairs spreads its one m16 tile over all 8 warps (and the
// SM's four schedulers). Each stage's products go to a fresh accumulator,
// added to acc with an f32 add: the tensor cores' f32 accumulation
// truncates, and over the thousands of k16 steps of a long list (32768 rows
// of w at Mixtral width, three terms each) its bias would reach 5e-5 of
// the sum. SHARED (shared-list mode): every row of the chunk names every
// step's tile, and the step's A is the TMA box (dense rows of KS values;
// 128-byte swizzled for bf16 at KS = 64).
template <typename AT, int BN, int KS, int MW, bool SHARED>
__device__ __forceinline__ void tg_consume(const AT* As, const __nv_bfloat16* Ws,
                                           __nv_bfloat16* Pl,
                                           unsigned long long* full, unsigned long long* empty,
                                           const int* cnt, const int* maxc, const short* list,
                                           const int* s_row, int nsteps, int nk, int len,
                                           long out_row0, int col0, int D, float* out, int warp,
                                           int lane) {
  using S = TgShape<AT, BN, KS>;
  constexpr int ASTR = S::ASTR, PSTR = S::PSTR, NT = BN / 8 * MW / 8, TERMS = S::TERMS;
  const int wm = MW == 1 ? 0 : MW == 2 ? warp >> 2 : warp & 3;
  const int wn = MW == 1 ? warp : MW == 2 ? warp & 3 : warp >> 2;
  const bool rows_live = wm * 16 < len;
  const int g = lane >> 2, q = lane & 3;
  const int ra = wm * 16 + g;  // this lane's A rows: ra and ra + 8
  const int n0 = wn * 8 * NT;  // the warp's first column in the block
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int cu = 0, crep = 0, ckh = 0;  // the step being consumed
  for (int step = 0; step < nsteps; ++step) {
    const int slot = step % S::STAGES;
    bool na = ra < len, nb = ra + 8 < len;
    if constexpr (!SHARED) {
      // a row that does not name the step's tile (or lies past the chunk)
      // holds stale data: masked to exact zeros
      const int r = list[cu];
      na = cnt[ra * TG_RMAX + r] > crep, nb = cnt[(ra + 8) * TG_RMAX + r] > crep;
      if (++ckh == nk) {
        ckh = 0;
        if (++crep == maxc[r]) crep = 0, ++cu;
      }
    }
    tg_bar_wait(&full[slot], (step / S::STAGES) & 1);
    const __nv_bfloat16* as;  // the stage's bf16 A, TERMS planes apart
    int astr, aplane;
    if constexpr (sizeof(AT) == 4) {
      // f32 rows: split each value once into its three bf16 terms, hi =
      // bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid) (each
      // difference exact in f32, their sum within 2^-24 |v| of v)
      tg_consumer_sync();  // every consumer is done with the last planes
      const int ct = warp * 32 + lane;
      for (int e = ct; e < len * (KS / 2); e += TG_CONSUMERS) {
        const int m = e / (KS / 2), c2 = (e % (KS / 2)) * 2;
        float2 v = *reinterpret_cast<const float2*>(
            As + slot * TG_M * ASTR + m * (SHARED ? KS : ASTR) + c2);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
          *reinterpret_cast<__nv_bfloat162*>(Pl + (p * TG_M + m) * PSTR + c2) = h;
          v.x -= __low2float(h), v.y -= __high2float(h);
        }
      }
      tg_consumer_sync();
      as = Pl + ra * PSTR + 2 * q, astr = PSTR, aplane = TG_M * PSTR;
    } else if constexpr (SHARED) {
      as = As + slot * TG_M * ASTR, astr = KS, aplane = 0;  // the box
      if constexpr (KS != 64) as += ra * KS + 2 * q;        // unswizzled rows
    } else {
      as = As + (slot * TG_M + ra) * ASTR + 2 * q, astr = ASTR, aplane = 0;
    }
    if (rows_live) {
      const __nv_bfloat16* ws = Ws + slot * KS * BN;
      float part[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        unsigned b[NT][2];  // n8 tile nt: k rows 0-7 and 8-15
        const int k = kk + (lane & 15);
        if constexpr (NT == 1) {
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                       : "=r"(b[0][0]), "=r"(b[0][1])
                       : "r"(tg_saddr(ws + 8 * tg_wchunk<KS, BN>(k, n0))));
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np)
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                : "=r"(b[2 * np][0]), "=r"(b[2 * np][1]), "=r"(b[2 * np + 1][0]),
                  "=r"(b[2 * np + 1][1])
                : "r"(tg_saddr(ws + 8 * tg_wchunk<KS, BN>(k, n0 + np * 16 + (lane >> 4) * 8))));
        }
#pragma unroll
        for (int p = TERMS - 1; p >= 0; --p) {  // smallest term first
          unsigned af[4];
          if constexpr (SHARED && sizeof(AT) == 2 && KS == 64)
            tg_afrag_sw(as, ra, kk, q, na, nb, af);
          else
            tg_afrag(as + p * aplane + kk, astr, na, nb, af);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) tg_mma(part[nt], af, b[nt][0], b[nt][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    }
    tg_bar_arrive(&empty[slot]);
  }
  if (!rows_live) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {  // each pair's f32 partial (or y row)
    const int col = col0 + n0 + nt * 8 + 2 * q;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ra + 8 * h;
      if (m >= len) continue;
      *reinterpret_cast<float2*>(out + (out_row0 + s_row[m]) * D + col) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// grid (ceil(D / BN), n_runs * ceil(T / TG_M)); block TgShape::THREADS; dynamic
// shared memory TgShape<AT, BN, KS>::smem(). Block (x, y) owns columns x * BN
// .. and chunk c = y % ceil(T / TG_M) of run s = y / ceil(T / TG_M): the
// rows whose runs mask has bit s, ascending, ranks c * TG_M .. (mask == NULL:
// one run, chunk c is rows c * TG_M .., and the block writes y; else it
// writes its pairs' partials to P[s * T + row]). A rows are AT, TERMS terms
// each: row t's slice of tile ti at a + t * a_row + ti * tile (tokens
// mode), of slot i at a + (t * K + i) * tile (compact != 0). SHARED: idx
// is the one list (K,), nvalid one int, mask NULL, and xmap the TMA map of a
// (T, F) in boxes of TG_M rows x KS columns (unread otherwise).
template <typename AT, int BN, int KS, bool SHARED>
__global__ void __launch_bounds__(TgShape<AT, BN, KS>::THREADS, 1)
tile_groups(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
            const AT* __restrict__ a, long a_row,
            int compact, const int* __restrict__ idx, int K, const int* __restrict__ nvalid,
            const unsigned long long* __restrict__ mask, int T, int R, int tile, int D,
            float* __restrict__ out) {
  using S = TgShape<AT, BN, KS>;
  constexpr int ASTR = S::ASTR, AVEC = 16 / (int)sizeof(AT), THREADS = S::THREADS;
  extern __shared__ __align__(16) unsigned char tg_smem[];
  unsigned char* base = tg_smem + ((1024 - (tg_saddr(tg_smem) & 1023)) & 1023);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(base);  // [stage][box][k][64]
  AT* As = reinterpret_cast<AT*>(base + S::STAGES * S::WBYTES);  // [stage][m][ASTR]
  __nv_bfloat16* Pl =  // [term][m][PSTR], f32 A only
      reinterpret_cast<__nv_bfloat16*>(base + S::STAGES * (S::ABYTES + S::WBYTES));
  // ring slot s: full[s] completes when its copies landed, empty[s] when
  // every consumer is done with it
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      base + S::STAGES * (S::ABYTES + S::WBYTES) + S::PBYTES);
  unsigned long long* empty = full + S::STAGES;
  int* cnt = reinterpret_cast<int*>(empty + S::STAGES);  // [m][TG_RMAX]: valid slots naming tile
  int* first = cnt + TG_M * TG_RMAX;                     // [m][TG_RMAX]: the first of them
  int* maxc = first + TG_M * TG_RMAX;                    // [TG_RMAX]
  int* s_row = maxc + TG_RMAX;                           // [m]
  int* s_nv = s_row + TG_M;                              // [m]
  short* list = reinterpret_cast<short*>(s_nv + TG_M);   // the union, ascending
  __shared__ int s_len, s_nsteps, s_warp[THREADS / 32];

  const int cpr = (T + TG_M - 1) / TG_M, run = blockIdx.y / cpr, c = blockIdx.y % cpr;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // -- the chunk's rows ------------------------------------------------------
  if (mask == nullptr) {
    if (tid < TG_M) s_row[tid] = c * TG_M + tid < T ? c * TG_M + tid : -1;
    if (tid == 0) s_len = min(TG_M, T - c * TG_M);
  } else {  // rank the rows of run `run` in ascending order, THREADS at a time
    if (tid < TG_M) s_row[tid] = -1;
    int ranked = 0;  // rows of the run before this round
    for (int tb = 0; tb < T; tb += THREADS) {
      const int t = tb + tid;
      const bool has = t < T && ((mask[t] >> run) & 1ull);
      const unsigned bal = __ballot_sync(0xffffffffu, has);
      __syncthreads();  // the previous round's s_warp is read
      if (lane == 0) s_warp[warp] = __popc(bal);
      __syncthreads();
      int before = ranked;
      for (int v = 0; v < warp; ++v) before += s_warp[v];
      const int rank = before + __popc(bal & ((1u << lane) - 1)) - c * TG_M;
      if (has && rank >= 0 && rank < TG_M) s_row[rank] = t;
      for (int v = 0; v < THREADS / 32; ++v) ranked += s_warp[v];
    }
    if (tid == 0) s_len = min(TG_M, ranked - c * TG_M);
  }
  __syncthreads();
  const int len = s_len;
  if (len <= 0) return;  // a surplus chunk of the upper-bound grid

  const int nk = tile / KS;
  if constexpr (SHARED) {
    // -- the list's valid slots, in list order: one producer thread asks the
    //    TMA engine for each step's weight and x boxes
    int* s_list = cnt;  // TG_M * TG_RMAX ints (the wrapper bounds K)
    const int nv = min(max(nvalid[0], 0), K);
    if (tid < S::STAGES) {
      tg_bar_init(&full[tid], 1);
      tg_bar_init(&empty[tid], TG_CONSUMERS);
    }
    for (int i = tid; i < nv; i += THREADS) s_list[i] = idx[i];
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    const int nsteps = nv * nk;
    if (warp >= TG_CONSUMERS / 32) {
      if (tid != TG_CONSUMERS) return;
      constexpr unsigned XBYTES = TG_M * KS * sizeof(AT);
      for (int step = 0; step < nsteps; ++step) {
        const int slot = step % S::STAGES;
        if (step >= S::STAGES) tg_bar_wait(&empty[slot], (step / S::STAGES - 1) & 1);
        const int k = s_list[step / nk] * tile + (step % nk) * KS;  // row of w, column of x
        tg_bar_arrive_tx(&full[slot], S::WBYTES + XBYTES);
#pragma unroll
        for (int bx = 0; bx < (BN + 63) / 64; ++bx)
          tg_tma(Ws + slot * KS * BN + bx * KS * 64, &wmap, col0 + bx * 64, k, &full[slot]);
        tg_tma(As + slot * TG_M * ASTR, &xmap, k, c * TG_M, &full[slot]);
      }
      return;
    }
    const int mw = max(BN == 32 ? 2 : 1, len <= 16 ? 1 : len <= 32 ? 2 : 4);
    if constexpr (BN >= 64)
      if (mw == 1)
        return tg_consume<AT, BN, KS, 1, true>(As, Ws, Pl, full, empty, cnt, maxc, list, s_row,
                                               nsteps, nk, len, 0, col0, D, out, warp, lane);
    if (mw == 2)
      return tg_consume<AT, BN, KS, 2, true>(As, Ws, Pl, full, empty, cnt, maxc, list, s_row,
                                             nsteps, nk, len, 0, col0, D, out, warp, lane);
    return tg_consume<AT, BN, KS, 4, true>(As, Ws, Pl, full, empty, cnt, maxc, list, s_row,
                                           nsteps, nk, len, 0, col0, D, out, warp, lane);
  } else {
    // -- per (pair, tile of the run): the valid slots naming it, and the first
    if (tid < S::STAGES) {
      tg_bar_init(&full[tid], S::PRODUCERS + 1);  // + the weight boxes' expect_tx
      tg_bar_init(&empty[tid], TG_CONSUMERS);
    }
    if (tid < TG_M) s_nv[tid] = tid < len ? nvalid[s_row[tid]] : 0;
    for (int e = tid; e < TG_M * TG_RMAX; e += THREADS) cnt[e] = 0, first[e] = INT_MAX;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    const int t0 = run * R;
    const int total = len * K;
    for (int e0 = tid; e0 < total; e0 += 4 * THREADS) {  // 4 loads in flight a thread
      int ti[4], mm[4], ii[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS;
        ti[u] = -1, mm[u] = 0, ii[u] = 0;
        if (e < total) {
          mm[u] = e / K, ii[u] = e - mm[u] * K;
          if (ii[u] < s_nv[mm[u]]) ti[u] = idx[(long)s_row[mm[u]] * K + ii[u]] - t0;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ti[u] >= 0 && ti[u] < R) {  // integer atomics: the same counts in any order
          atomicAdd(&cnt[mm[u] * TG_RMAX + ti[u]], 1);
          atomicMin(&first[mm[u] * TG_RMAX + ti[u]], ii[u]);
        }
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      int mc = 0;
      for (int m = 0; m < len; ++m) mc = max(mc, cnt[m * TG_RMAX + r]);
      maxc[r] = mc;
    }
    __syncthreads();
    if (warp == 0) {  // the union in ascending tile id, and the walk's steps
      int n = 0, steps = 0;
      for (int b = 0; b < R; b += 32) {
        const int r = b + lane;
        const int mc = r < R ? maxc[r] : 0;
        const unsigned live = __ballot_sync(0xffffffffu, mc > 0);
        if (mc > 0) list[n + __popc(live & ((1u << lane) - 1))] = (short)r;
        n += __popc(live);
        steps += mc;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) steps += __shfl_xor_sync(0xffffffffu, steps, o);
      if (lane == 0) s_nsteps = steps * nk;
    }
    __syncthreads();
    const int nsteps = s_nsteps;

    if (warp >= TG_CONSUMERS / 32) {
      // -- producers: step (u, rep, kh) of the walk into ring slot step % S,
      //    once every consumer is done with the slot's previous step. Thread
      //    pt copies A chunks pt, pt + PRODUCERS, .. (skipped where the row
      //    does not name the step's tile, which the consumers mask to zero,
      //    and past the chunk's rows, which are never stored); thread 0 asks the
      //    TMA engine for the step's weight boxes (zeros past column D)
      constexpr int ACH = TG_M * (KS / AVEC);
      constexpr int APT = (ACH + S::PRODUCERS - 1) / S::PRODUCERS;
      const int pt = tid - TG_CONSUMERS;
      int a_m[APT], a_t[APT], a_v[APT];
#pragma unroll
      for (int j = 0; j < APT; ++j) {
        const int e = pt + j * S::PRODUCERS;
        a_m[j] = e / (KS / AVEC), a_v[j] = (e % (KS / AVEC)) * AVEC;
        a_t[j] = e < ACH && a_m[j] < len ? s_row[a_m[j]] : -1;
      }
      int u = 0, rep = 0, kh = 0;
      for (int step = 0; step < nsteps; ++step) {
        const int slot = step % S::STAGES;
        if (step >= S::STAGES) tg_bar_wait(&empty[slot], (step / S::STAGES - 1) & 1);
        const int r = list[u], ti = t0 + r, k0 = kh * KS;
        if (pt == 0) {
          tg_bar_arrive_tx(&full[slot], S::WBYTES);
#pragma unroll
          for (int bx = 0; bx < BN / 64; ++bx)
            tg_tma(Ws + (slot * (BN / 64) + bx) * KS * 64, &wmap, col0 + bx * 64, ti * tile + k0,
                   &full[slot]);
        }
        AT* as = As + slot * TG_M * ASTR;
#pragma unroll
        for (int j = 0; j < APT; ++j) {
          if (a_t[j] < 0) continue;
          const int e = a_m[j] * TG_RMAX + r;
          if (cnt[e] <= rep) continue;
          const AT* src;
          if (compact) {
            int slot_i = first[e];
            if (rep > 0) {  // the (rep + 1)-th valid slot naming ti
              const long b = (long)a_t[j] * K;
              for (int i = slot_i + 1, seen = 0; i < s_nv[a_m[j]]; ++i)
                if (idx[b + i] == ti && ++seen == rep) { slot_i = i; break; }
            }
            src = a + ((long)a_t[j] * K + slot_i) * tile + k0 + a_v[j];
          } else {
            src = a + (long)a_t[j] * a_row + (long)ti * tile + k0 + a_v[j];
          }
          tg_cp16(as + a_m[j] * ASTR + a_v[j], src);
        }
        tg_bar_arrive_copies(&full[slot]);
        if (++kh == nk) {
          kh = 0;
          if (++rep == maxc[r]) rep = 0, ++u;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      return;
    }

    // -- consumers (8 warps), laid out by how many pairs the chunk holds ------
    const long out_row0 = mask == nullptr ? 0 : (long)run * T;
    const int mw = len <= 16 ? 1 : len <= 32 ? 2 : 4;
    if (mw == 1)
      tg_consume<AT, BN, KS, 1, false>(As, Ws, Pl, full, empty, cnt, maxc, list, s_row, nsteps,
                                       nk, len, out_row0, col0, D, out, warp, lane);
    else if (mw == 2)
      tg_consume<AT, BN, KS, 2, false>(As, Ws, Pl, full, empty, cnt, maxc, list, s_row, nsteps,
                                       nk, len, out_row0, col0, D, out, warp, lane);
    else
      tg_consume<AT, BN, KS, 4, false>(As, Ws, Pl, full, empty, cnt, maxc, list, s_row, nsteps,
                                       nk, len, out_row0, col0, D, out, warp, lane);
  }
}

// y[t, j] = sum over the runs s of row t (the bits of mask[t], ascending) of
// P[s * T + t, j], f32; rows with no run (nvalid == 0) get exact zeros.
// grid (T, ceil(D / 256)); block 256.
__global__ void run_sum(const float* __restrict__ P, const unsigned long long* __restrict__ mask,
                        int T, float* __restrict__ y, int D) {
  const int t = blockIdx.x, j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float acc = 0.f;
  for (unsigned long long m = mask[t]; m; m &= m - 1)
    acc += P[((long)(__ffsll((long long)m) - 1) * T + t) * D + j];
  y[(long)t * D + j] = acc;
}

typedef CUresult (*TgEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA tensor map of a row-major array of `rank` (2 or 3) dimensions of
// `type`, dims and box innermost first (cuTensorMapEncodeTiled, found
// through the runtime's entry-point query, so nothing links against
// libcuda); elements past an edge read as zeros.
static cudaError_t tg_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                          const void* base, int rank, const long* dims, const int* box,
                          CUtensorMapSwizzle swizzle) {
  static TgEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    }
  }
  if (rank < 2 || rank > 3) return cudaErrorInvalidValue;
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3], estr[3] = {1, 1, 1};
  cuuint64_t stride = elem_bytes;  // bytes between neighbours along dimension i
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i], b[i] = (cuuint32_t)box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), d, strides, b, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major 2-D matrix (rows, cols) read in boxes of box_rows x box_cols.
static cudaError_t tg_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                             const void* base, long rows, long cols, int box_cols, int box_rows,
                             CUtensorMapSwizzle swizzle) {
  const long dims[2] = {cols, rows};
  const int box[2] = {box_cols, box_rows};
  return tg_map(map, type, elem_bytes, base, 2, dims, box, swizzle);
}

// The tensor map of a bf16 matrix (rows, D), a weight or x, read in boxes of
// KS rows x 64 columns with the 128-byte swizzle.
static cudaError_t tg_weight_map(CUtensorMap* map, const __nv_bfloat16* w, long rows, int D,
                                 int KS) {
  return tg_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, rows, D, 64, KS,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename AT, int BN, int KS>
static cudaError_t launch_tile_groups_ks(const AT* a, long a_row, int compact,
                                         const __nv_bfloat16* w, long w_rows, const int* idx,
                                         int K, const int* nvalid,
                                         const unsigned long long* mask, int n_runs, int T, int R,
                                         int tile, int D, float* out, cudaStream_t stream) {
  constexpr size_t smem = TgShape<AT, BN, KS>::smem();
  CUtensorMap map;
  cudaError_t e = tg_weight_map(&map, w, w_rows, D, KS);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tile_groups<AT, BN, KS, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((D + BN - 1) / BN, n_runs * ((T + TG_M - 1) / TG_M));
  tile_groups<AT, BN, KS, false><<<grid, TgShape<AT, BN, KS>::THREADS, smem, stream>>>(
      map, map, a, a_row, compact, idx, K, nvalid, mask, T, R, tile, D, out);
  return cudaGetLastError();
}

// The tile-grouped product over T rows: with n_runs == 1 the blocks write y;
// otherwise row_runs fills mask (T) and the blocks write P (n_runs * T, D),
// which run_sum folds into y.
template <typename AT, int BN>
static cudaError_t launch_tile_groups(const AT* a, long a_row, int compact, const __nv_bfloat16* w,
                                      long w_rows, const int* idx, int K, const int* nvalid,
                                      int n_runs,
                                      unsigned long long* mask, float* P, float* y, int T, int R,
                                      int tile, int D, cudaStream_t stream) {
  if (T <= 0 || D <= 0) return cudaGetLastError();
  if (tile % 16 != 0 || D % 8 != 0 || R < 1 || R > TG_RMAX || n_runs < 1 ||
      n_runs > TG_MAX_RUNS)
    return cudaErrorInvalidValue;
  if (n_runs > 1 && (mask == nullptr || P == nullptr)) return cudaErrorInvalidValue;
  if (n_runs > 1) {
    row_runs<<<T, 128, 0, stream>>>(idx, K, nvalid, R, mask);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const unsigned long long* m = n_runs > 1 ? mask : nullptr;
  float* out = n_runs > 1 ? P : y;
  cudaError_t e =
      tile % TG_KS == 0
          ? launch_tile_groups_ks<AT, BN, TG_KS>(a, a_row, compact, w, w_rows, idx, K,
                                                        nvalid, m, n_runs, T, R, tile, D, out,
                                                        stream)
          : launch_tile_groups_ks<AT, BN, 16>(a, a_row, compact, w, w_rows, idx, K, nvalid,
                                                     m, n_runs, T, R, tile, D, out, stream);
  if (e != cudaSuccess || n_runs == 1) return e;
  run_sum<<<dim3(T, (D + 255) / 256), 256, 0, stream>>>(P, mask, T, y, D);
  return cudaGetLastError();
}

// Shared-list mode (sparse_matmul): y (T, D) = sum over the list's valid
// slots, in list order, of x[:, idx[i] * tile : +tile] @ w[idx[i] * tile : +tile, :].
// x (T, F) is AT (bf16, or f32 split into three bf16 terms), w (F, D) bf16;
// idx (K,) with K <= TG_M * TG_RMAX, nvalid one int on the device. One launch,
// no scratch.
template <typename AT, int BN, int KS>
static cudaError_t launch_tile_groups_shared_ks(const AT* x, const __nv_bfloat16* w,
                                                const int* idx, int K, const int* nvalid, int T,
                                                int F, int tile, int D, float* y,
                                                cudaStream_t stream) {
  constexpr size_t smem = TgShape<AT, BN, KS>::smem();
  CUtensorMap wmap, xmap;
  cudaError_t e = tg_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, F, D, BN == 32 ? 32 : 64,
                            KS, BN == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const bool swizzled = sizeof(AT) == 2 && KS == 64;  // the consumers' bf16 fragments
  const CUtensorMapDataType xt =
      sizeof(AT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  e = tg_map_2d(&xmap, xt, (int)sizeof(AT), x, T, F, KS, TG_M,
                swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  static bool attributes_set = false;  // once a process: the host calls cost microseconds
  if (!attributes_set) {
    e = cudaFuncSetAttribute(tile_groups<AT, BN, KS, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attributes_set = true;
  }
  const dim3 grid((D + BN - 1) / BN, (T + TG_M - 1) / TG_M);
  tile_groups<AT, BN, KS, true><<<grid, TgShape<AT, BN, KS>::THREADS, smem, stream>>>(
      wmap, xmap, x, (long)F, 0, idx, K, nvalid, nullptr, T, 1, tile, D, y);
  return cudaGetLastError();
}

template <typename AT, int BN>
static cudaError_t launch_tile_groups_shared(const AT* x, const __nv_bfloat16* w, const int* idx,
                                             int K, const int* nvalid, int T, int F, int tile,
                                             int D, float* y, cudaStream_t stream) {
  if (T <= 0 || D <= 0) return cudaGetLastError();
  if (tile % 16 != 0 || D % 8 != 0 || K > TG_M * TG_RMAX) return cudaErrorInvalidValue;
  return tile % TG_KS == 0
             ? launch_tile_groups_shared_ks<AT, BN, TG_KS>(x, w, idx, K, nvalid, T, F, tile, D, y,
                                                           stream)
             : launch_tile_groups_shared_ks<AT, BN, 16>(x, w, idx, K, nvalid, T, F, tile, D, y,
                                                        stream);
}
