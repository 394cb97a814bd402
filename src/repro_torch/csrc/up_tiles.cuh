// Up-projection over 128-column output tiles on tensor cores, for Hopper
// (sm_90a): the bf16 path at tile 128 of sparse_up_matmul
// (sparse_up_matmul.cu), fused_up_relu, fused_up_relu_tokens and
// fused_up_relu_window (fused_up_relu.cu), expert_up_matmul
// (expert_up_matmul.cu) and the up half of fused_sparse_ffn
// (fused_sparse_ffn.cu). bf16 x and bf16 weights only.
//
//   acc[t, 128 j + c] = sum_k x[t, k] * w[k, 128 j + c]        f32 sums
//
// for the rows that need output tile j of the weight w (d, F), or of a
// stack of E such matrices (expert_up_matmul), where tile id j names
// columns 128 (j % tpe) .. of matrix j / tpe, tpe = F / 128:
// - every row (fused_up_relu*): the epilogue stores h = max(acc - shift, 0)
//   as f32 (T, F) and folds max |h| over each group of G consecutive rows
//   and the tile's 128 lanes into scores[g, j], with atomicMax on the bits
//   of non-negative floats, whose order is the float order: the max is
//   exact in any order, also when a group's rows span blocks;
// - the rows whose valid list slots name tile j (sparse_up_matmul,
//   expert_up_matmul, fused_sparse_ffn): the epilogue writes
//   v = act(acc) [* acc_u] [* mask[t, 128 j + c]] to compact[t, i, :] for
//   every valid slot i of row t that names j (act the identity, no acc_u
//   and no mask for the bare products), so a tile listed twice fills both
//   slots, as the TPU kernels' per-slot blocks do; fused_sparse_ffn also
//   gets a bf16 copy of v for its down half. ut_rows writes exact zeros to
//   the slots past nvalid[t]: every element of compact is written.
//
// Design.
// 1. Rows. Block (c, j) owns output tile j and chunk c of the rows that
//    need it (at most UT_M = 64, one consumer warpgroup), over all of d.
//    With every row, chunk c is rows 64c.. . With lists, ut_rows first
//    writes a bitmap of the tiles each row's valid slots name, tile-major
//    ((n_tiles / 32, T) words, so a block's scan of its tile's bits is
//    coalesced), and the block ranks the rows whose bit j is set with a
//    ballot, ascending, to find its chunk. The grid holds the
//    upper bound, ceil(T / 64) chunks per tile, so the host needs no count
//    and no sync; a surplus block exits. A row that names no slot j costs
//    tile j no weight read. Over a stack (expert_up_matmul's global
//    ids, E * tpe of them: 1024 at Mixtral-8x22B, 32 words of bits a row)
//    the rows naming tile j are the tokens routed to expert j / tpe, since
//    expert_tile_lists lists every tile of a routed expert: the ranking
//    gives runs of one expert with no other change.
// 2. The ring. One producer warp fills a 4-slot ring: its lane 0 asks the
//    TMA engine for the step's weight slab (UT_KS = 64 rows of d x 128
//    columns, two 64-column boxes with the 128-byte swizzle, zeros past d)
//    and, when the chunk's rows are consecutive (every row, or a listed
//    chunk of rows r0 .. r0 + len - 1, as when every decode row names the
//    tile), for their x over the same 64 d rows as one box of 64 rows from
//    r0 with the same swizzle (rows past the chunk are never used); other
//    listed rows come by the lanes' cp.async into the swizzled places
//    (boxing consecutive listed chunks made fused_sparse_ffn at OPT-6.7B
//    decode a few percent faster in a trial build on the card).
//    mbarriers hand the slots between the producer and the consumer
//    warpgroup, which multiplies the 64 rows by the slab with four
//    wgmma.m64n128k16 (bf16 in, f32 out): the x fragments from registers
//    (loaded from the swizzled rows, no bank conflicts), the weight
//    straight from the swizzled slab through a
//    matrix descriptor, so no warp stages the weight through registers. A
//    stage sums into a fresh accumulator, added to the total in f32 (the
//    tensor cores' accumulation truncates; tile_group.cuh). Each weight
//    tile is read once per (tile, chunk), not once per (row, slot) as
//    ffn_up reads it; the chunks of one tile are neighbours in the grid
//    (blockIdx.x), so they run together and share the weight through L2.
//    Two blocks fit an SM (97 KB of shared memory each), so one block's
//    multiplies overlap the other's waits.
// 3. Stacked weights and the GLU. The weight map is 3-D, (F, d, E) with
//    boxes of 64 columns x UT_KS rows x 1 matrix, so rows past d of matrix
//    e read as zeros, not as matrix e + 1's first rows, at any d; one (d,
//    F) matrix is E = 1. With a GLU (fused_sparse_ffn's w_up) the gate's
//    and the up projection's slabs of each UT_KS rows of d take turns in
//    the ring (x copied with each), summed into two f32 accumulators;
//    with the fresh per-stage accumulator that is 192 registers of sums,
//    so that variant runs one block an SM (registers up to 255) instead
//    of two. Kept as the simpler of the two layouts the design allowed (a
//    second consumer warpgroup for the up projection would need its own
//    ring slabs and a block an SM as well); its time at OPT-6.7B width is
//    in PERF.md.
// 4. Small T. At T = 8 and F = 16384 the grid holds 128 blocks for 132
//    SMs. A split of d over blocks, with a second launch adding the ranges
//    in order, streamed the weight no faster on the card and added that
//    launch (0.0575 ms with two ranges against 0.0533 with one at T = 8,
//    PERF.md), so every block covers all of d: no scratch, one launch. No
//    float atomics in any sum: two calls give the same bits.
//
// What bounds it on the H100: the weight bytes, each needed tile read once
// from device memory (the whole 134 MB wu at OPT-6.7B width, 0.040 ms at
// 3.35 TB/s); the 2 T d F operations on the tensor cores take 0.017 ms at
// T = 128 (989 TFLOP/s). What the card showed (PERF.md): in a first design
// the x rows, copied by one warp's cp.async 16 bytes at a time, held every
// stage (mma.sync consumers), and a bulk copy a row was slower still; one
// TMA box a stage for x, and wgmma reading the weight from the slab, bring
// it within a few percent of the library's dense product at T = 8 and 128.
// Gathered rows (lists) still come by cp.async, each lane's places fixed
// for the block: sparse_up_matmul at large T is held by that copy. Over
// Mixtral-8x22B's stacked experts (expert_up_matmul) it takes 0.62 ms at
// T = 128 and 0.47 at T = 8, 1.27x and 1.12x the bound (the routed
// experts' tiles), where the all-experts einsum takes 2.57 (chip_smoke.py
// on one H100, PERF.md); fused_sparse_ffn's up half: PERF.md.
#pragma once

#include "tile_group.cuh"

#define UT_BN 128                      // output columns per block: one tile
#define UT_KS 64                       // d rows per ring stage
#define UT_STAGES 4
#define UT_WBYTES (UT_KS * UT_BN * 2)
#define UT_OSTR (UT_BN + 4)            // a staged f32 output row (lists)
#define UT_M 64                        // rows per chunk: one consumer warpgroup
#define UT_CONSUMERS 128
#define UT_THREADS (UT_CONSUMERS + 32) // + one producer warp
#define UT_ABYTES (UT_M * UT_KS * 2)   // UT_M x rows of 128 bytes, swizzled
#define UT_SMEM (1024 + UT_STAGES * (UT_WBYTES + UT_ABYTES) + 2 * UT_STAGES * 8)
// the list epilogue stages two f32 row blocks (GLU) in the drained ring
static_assert(2 * UT_M * UT_OSTR * 4 <= UT_STAGES * (UT_WBYTES + UT_ABYTES), "ring too small");

struct UtArgs {
  const __nv_bfloat16* x;  // (T, d), 16-byte aligned, d % 8 == 0
  int T, d, F;             // F: the columns of one weight matrix
  int E = 1;               // stacked weight matrices (expert_up_matmul)
  unsigned* bits;          // (n_words, T): row t names tile j; NULL: every row
  const int* idx;          // (T, K) tile ids, with bits
  const int* nvalid;       // (T,)
  int K;
  float* compact;          // (T, K, 128) (lists)
  int act = ACT_IDENTITY;  // lists: ACT_* applied to acc (identity: the bare product)
  float prm;
  const float* mask;       // lists, E == 1: (T, F) f32 multiplied into v, or NULL
  __nv_bfloat16* hb;       // lists: (T, K, 128) bf16 copy of compact's valid slots, or NULL
  float* h;                // (T, F) (every row)
  unsigned* scores;        // (ceil(T / G), F / 128) float bits, zeroed
  int G;
  float shift;
};

// bits[w * T + t] = the tiles 32w .. 32w + 31 that row t's valid slots name;
// the slots past nvalid[t] of compact (T, K, 128) are set to exact zeros.
// grid T; block 128; dynamic shared memory n_words * 4 bytes.
__global__ void ut_rows(const int* __restrict__ idx, int K, const int* __restrict__ nvalid,
                        int T, int n_words, unsigned* __restrict__ bits,
                        float* __restrict__ compact) {
  extern __shared__ unsigned s_bits[];
  const int t = blockIdx.x, nv = min(nvalid[t], K);
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) s_bits[w] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int ti = idx[(long)t * K + i];
    atomicOr(&s_bits[ti >> 5], 1u << (ti & 31));
  }
  float4* out = reinterpret_cast<float4*>(compact + (long)t * K * UT_BN);
  for (int e = nv * (UT_BN / 4) + threadIdx.x; e < K * (UT_BN / 4); e += blockDim.x)
    out[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) bits[(long)w * T + t] = s_bits[w];
}

// 16 bytes from global src to shared dst by cp.async, of which src_bytes
// (16 or 0) are read and the rest filled with zeros
__device__ __forceinline__ void ut_cp16_fill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tg_saddr(dst)), "l"(src),
               "r"(src_bytes));
}

// one box of a 3-D tensor map (x = column, y = row, z = matrix) into shared
// memory by the TMA engine, completing on bar
__device__ __forceinline__ void ut_tma3(void* dst, const CUtensorMap* map, int x, int y, int z,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tg_saddr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(tg_saddr(bar))
      : "memory");
}

// The matrix descriptor of a k16 x 128 slice of a weight slab: two 64-column
// TMA boxes 8 KB apart (leading byte offset), rows of 128 bytes in groups of
// 8 (1 KB, stride byte offset), the 128-byte swizzle; n-contiguous, so the
// wgmma reads it transposed.
__device__ __forceinline__ unsigned long long ut_desc(const __nv_bfloat16* p) {
  const unsigned long long lead = (UT_KS * 64 * 2) >> 4, stride = 1024 >> 4;
  return (unsigned long long)((tg_saddr(p) & 0x3FFFF) >> 4) | (lead << 16) | (stride << 32) |
         (1ull << 62);
}

// d (+)= a x b for the warpgroup's 64 rows x 128 columns x 16 of d: a the
// warp's m16 x k16 bf16 fragment (mma.sync's A layout), b a descriptor
// (ut_desc); accumulate == 0 overwrites d. d[4n .. 4n + 3] holds the n8
// tile n as mma.sync's C fragment does.
__device__ __forceinline__ void ut_wgmma(float (&d)[64], const unsigned (&a)[4],
                                         unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// keep the compiler from moving reads or writes of d across an asynchronous
// wgmma (it does not see that the instruction is still writing d)
__device__ __forceinline__ void ut_pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void ut_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(UT_CONSUMERS) : "memory");
}

// The consumer warpgroup: wait for each stage, multiply, release it; then
// the epilogue of the block's tile (compact, or h and the scores). GLU:
// even steps hold the gate's slab, odd steps the up projection's.
template <bool GLU>
__device__ __forceinline__ void ut_consume(const UtArgs& a, unsigned char* base,
                                           unsigned long long* full, unsigned long long* empty,
                                           const int* s_row, unsigned* s_max, int len, int nsteps,
                                           int j, int warp, int lane) {
  const __nv_bfloat16* Ws = reinterpret_cast<const __nv_bfloat16*>(base);
  const __nv_bfloat16* As =
      reinterpret_cast<const __nv_bfloat16*>(base + UT_STAGES * UT_WBYTES);
  const int g = lane >> 2, q = lane & 3;
  const int ra = warp * 16 + g;  // this lane's rows: ra, ra + 8
  const bool na = ra < len, nb = ra + 8 < len;  // rows past the chunk read as zeros
  float acc[64], part[64], accu[GLU ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if constexpr (GLU) {
#pragma unroll
    for (int i = 0; i < 64; ++i) accu[i] = 0.f;
  }
  for (int step = 0; step < nsteps; ++step) {
    const int slot = step % UT_STAGES;
    tg_bar_wait(&full[slot], (step / UT_STAGES) & 1);
    {
      unsigned af[UT_KS / 16][4];
      const __nv_bfloat16* as = As + slot * UT_M * UT_KS;
#pragma unroll
      for (int kk = 0; kk < UT_KS / 16; ++kk) tg_afrag_sw(as, ra, kk * 16, q, na, nb, af[kk]);
      const __nv_bfloat16* ws = Ws + slot * UT_KS * UT_BN;
      ut_pin(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < UT_KS / 16; ++kk)
        ut_wgmma(part, af[kk], ut_desc(ws + kk * 16 * 64), kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      ut_pin(part);
    }
    tg_bar_arrive(&empty[slot]);  // the slab is read
    if constexpr (GLU) {
      if (step & 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) accu[i] += part[i];
        continue;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  if (a.bits != nullptr) {
    // lists: stage the tile's rows (GLU: and the up projection's) in the
    // drained ring, then warp w writes rows w, w + nwarps, ..: v = act(acc)
    // [* acc_u] [* the row's mask], 4 columns a lane, to each valid slot of
    // the row that names j (a ballot over 32 slots at a time). The
    // activation is applied here, 4 values a lane, and not while staging:
    // its switch in the unrolled staging loop slowed the routine markedly
    // for every caller in a trial build on the card (PERF.md).
    float* O = reinterpret_cast<float*>(base);
    float* OU = O + UT_M * UT_OSTR;  // GLU: 2 x 33 KB within the 96 KB ring
    ut_consumer_sync();  // every consumer is done with the ring
#pragma unroll
    for (int nt = 0; nt < UT_BN / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i0 = 4 * nt + 2 * hh, o = (ra + 8 * hh) * UT_OSTR + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(O + o) = make_float2(acc[i0], acc[i0 + 1]);
        if constexpr (GLU) *reinterpret_cast<float2*>(OU + o) = make_float2(accu[i0], accu[i0 + 1]);
      }
    ut_consumer_sync();
    for (int m = warp; m < len; m += UT_CONSUMERS / 32) {
      const int t = s_row[m], nv = min(a.nvalid[t], a.K);
      float4 v = *reinterpret_cast<const float4*>(O + m * UT_OSTR + 4 * lane);
      if (a.act != ACT_IDENTITY) {
        v.x = apply_act(v.x, a.act, a.prm), v.y = apply_act(v.y, a.act, a.prm);
        v.z = apply_act(v.z, a.act, a.prm), v.w = apply_act(v.w, a.act, a.prm);
      }
      if constexpr (GLU) {
        const float4 u = *reinterpret_cast<const float4*>(OU + m * UT_OSTR + 4 * lane);
        v.x *= u.x, v.y *= u.y, v.z *= u.z, v.w *= u.w;
      }
      if (a.mask != nullptr) {
        const float4 mk =
            *reinterpret_cast<const float4*>(a.mask + (long)t * a.F + j * UT_BN + 4 * lane);
        v.x *= mk.x, v.y *= mk.y, v.z *= mk.z, v.w *= mk.w;
      }
      uint2 vb;  // v rounded to bf16 (to nearest even, as torch's cast)
      {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        vb.x = *reinterpret_cast<unsigned*>(&lo), vb.y = *reinterpret_cast<unsigned*>(&hi);
      }
      for (int i0 = 0; i0 < nv; i0 += 32) {
        const int i = i0 + lane;
        unsigned hit = __ballot_sync(0xffffffffu, i < nv && a.idx[(long)t * a.K + i] == j);
        for (; hit; hit &= hit - 1) {
          const long o = ((long)t * a.K + i0 + __ffs(hit) - 1) * UT_BN + 4 * lane;
          *reinterpret_cast<float4*>(a.compact + o) = v;
          if (a.hb != nullptr) *reinterpret_cast<uint2*>(a.hb + o) = vb;
        }
      }
    }
    return;
  }
  // every row: h = max(acc - shift, 0); a row's max |h| over the tile is
  // held by the 4 lanes of one warp, folded with two shuffles
  const int col0 = j * UT_BN;
  unsigned mx[2] = {0u, 0u};
#pragma unroll
  for (int nt = 0; nt < UT_BN / 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = ra + 8 * hh;
      const float v0 = fmaxf(acc[4 * nt + 2 * hh] - a.shift, 0.f);
      const float v1 = fmaxf(acc[4 * nt + 2 * hh + 1] - a.shift, 0.f);
      if (m < len)
        *reinterpret_cast<float2*>(a.h + (long)s_row[m] * a.F + col0 + nt * 8 + 2 * q) =
            make_float2(v0, v1);
      mx[hh] = max(mx[hh], max(__float_as_uint(fabsf(v0)), __float_as_uint(fabsf(v1))));
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = max(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = max(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    if (q == 0 && ra + 8 * hh < len) s_max[ra + 8 * hh] = mx[hh];
  }
  ut_consumer_sync();
  // the first row of each group in the chunk folds the group's rows
  const int m = warp * 32 + lane;
  if (m < len) {
    const int gr = s_row[m] / a.G;
    if (m == 0 || s_row[m - 1] / a.G != gr) {
      unsigned v = 0u;
      for (int r = m; r < len && s_row[r] / a.G == gr; ++r) v = max(v, s_max[r]);
      if (v) atomicMax(a.scores + (long)gr * (a.F / UT_BN) + j, v);
    }
  }
}

// grid (ceil(T / UT_M), E * F / UT_BN); block UT_THREADS; dynamic shared
// memory UT_SMEM. wmap: w (E, d, F) bf16 in boxes of 64 columns x UT_KS rows
// x 1 matrix; umap: the GLU's up projection (d, F) likewise (GLU only);
// xmap: x (T, d) in boxes of UT_M rows x 64 columns (every row).
template <bool GLU>
__global__ void __launch_bounds__(UT_THREADS, GLU ? 1 : 2)
up_tiles(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap umap,
         const __grid_constant__ CUtensorMap xmap, const UtArgs a) {
  extern __shared__ __align__(16) unsigned char ut_smem[];
  unsigned char* base = ut_smem + ((1024 - (tg_saddr(ut_smem) & 1023)) & 1023);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(base);  // [stage][box][k][64]
  __nv_bfloat16* As =
      reinterpret_cast<__nv_bfloat16*>(base + UT_STAGES * UT_WBYTES);  // [stage][m][64], swizzled
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(base + UT_STAGES * (UT_WBYTES + UT_ABYTES));
  unsigned long long* empty = full + UT_STAGES;
  __shared__ int s_row[UT_M], s_len, s_warp[UT_THREADS / 32];
  __shared__ unsigned s_max[UT_M];

  const int c = blockIdx.x, j = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // -- the chunk's rows ------------------------------------------------------
  if (tid < UT_M) s_max[tid] = 0u;
  if (a.bits == nullptr) {
    if (tid < UT_M) s_row[tid] = c * UT_M + tid < a.T ? c * UT_M + tid : -1;
    if (tid == 0) s_len = min(UT_M, a.T - c * UT_M);
  } else {  // rank the rows naming tile j in ascending order, THREADS at a time
    const unsigned* bw = a.bits + (long)(j >> 5) * a.T;
    const unsigned bit = 1u << (j & 31);
    if (tid < UT_M) s_row[tid] = -1;
    int ranked = 0;  // rows naming j before this round (the same in every thread)
    for (int tb = 0; tb < a.T && ranked < (c + 1) * UT_M; tb += UT_THREADS) {
      const int t = tb + tid;
      const bool has = t < a.T && (bw[t] & bit);
      const unsigned bal = __ballot_sync(0xffffffffu, has);
      __syncthreads();  // the previous round's s_warp is read
      if (lane == 0) s_warp[warp] = __popc(bal);
      __syncthreads();
      int before = ranked;
      for (int v = 0; v < warp; ++v) before += s_warp[v];
      const int rank = before + __popc(bal & ((1u << lane) - 1)) - c * UT_M;
      if (has && rank >= 0 && rank < UT_M) s_row[rank] = t;
      for (int v = 0; v < UT_THREADS / 32; ++v) ranked += s_warp[v];
    }
    if (tid == 0) s_len = min(UT_M, ranked - c * UT_M);
  }
  __syncthreads();
  const int len = s_len;
  // consecutive rows (every row, or a listed chunk of rows r0 .. r0 + len -
  // 1, as when every decode row names the tile) come as one x box
  const bool boxed =
      a.bits == nullptr || (len > 0 && s_row[len - 1] - s_row[0] == len - 1);
  if (tid < UT_STAGES) {
    // the producer's expect_tx (+ its lanes' cp.async of gathered rows)
    tg_bar_init(&full[tid], boxed ? 1 : 33);
    tg_bar_init(&empty[tid], UT_CONSUMERS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (len <= 0) return;  // a surplus chunk of the upper-bound grid
  const int nk = (a.d + UT_KS - 1) / UT_KS, nsteps = GLU ? 2 * nk : nk;

  if (warp == UT_CONSUMERS / 32) {
    // -- the producer warp: step s into ring slot s % UT_STAGES once every
    //    consumer is done with the slot's previous step. Lane 0 asks the TMA
    //    engine for the weight slab (GLU: the gate's at even steps, the up
    //    projection's at odd) and, when the chunk's rows are consecutive,
    //    for their x slab (one box of M rows; rows past T and columns past
    //    d read as zeros); gathered rows come by the lanes' cp.async, 16
    //    bytes at a time, zero-filled past d.
    const int tpe = a.F / UT_BN, e = j / tpe, col = (j % tpe) * UT_BN;  // tile j's matrix, columns
    // gathered rows: lane l copies 16-byte chunk l % 8 of rows l / 8 + 4i,
    // the same places every stage (sources advanced by k0)
    constexpr int RPL = UT_M / 4;  // rows a lane copies
    const int ch = lane & 7;
    const __nv_bfloat16* src[RPL];
    int dst[RPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int m = (lane >> 3) + 4 * i;
      src[i] = m < len && !boxed ? a.x + (long)s_row[m] * a.d + ch * 8 : nullptr;
      dst[i] = m * 128 + ((ch ^ (m & 7)) << 4);
    }
    for (int step = 0; step < nsteps; ++step) {
      const int slot = step % UT_STAGES, k0 = (GLU ? step >> 1 : step) * UT_KS;
      if (step >= UT_STAGES) tg_bar_wait(&empty[slot], (step / UT_STAGES - 1) & 1);
      __nv_bfloat16* as = As + slot * UT_M * UT_KS;
      if (lane == 0) {
        const CUtensorMap* m = GLU && (step & 1) ? &umap : &wmap;
        tg_bar_arrive_tx(&full[slot], UT_WBYTES + (boxed ? UT_ABYTES : 0));
        ut_tma3(Ws + (slot * 2) * UT_KS * 64, m, col, k0, e, &full[slot]);
        ut_tma3(Ws + (slot * 2 + 1) * UT_KS * 64, m, col + 64, k0, e, &full[slot]);
        if (boxed) tg_tma(as, &xmap, k0, s_row[0], &full[slot]);
      }
      if (boxed) continue;
      const bool in = k0 + ch * 8 < a.d;
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        if (src[i] != nullptr)
          ut_cp16_fill(reinterpret_cast<char*>(as) + dst[i], in ? src[i] + k0 : src[i],
                       in ? 16 : 0);
      tg_bar_arrive_copies(&full[slot]);
    }
    if (!boxed) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  ut_consume<GLU>(a, base, full, empty, s_row, s_max, len, nsteps, j, warp, lane);
}

// The tensor map of a stack of E bf16 (d, F) matrices in boxes of 64
// columns x UT_KS rows x 1 matrix, 128-byte swizzle.
static cudaError_t ut_weight_map(CUtensorMap* map, const __nv_bfloat16* w, int E, int d, int F) {
  const long dims[3] = {F, d, E};
  const int box[3] = {64, UT_KS, 1};
  return tg_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 3, dims, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool GLU>
static cudaError_t launch_up_tiles_grid(const UtArgs& a, const CUtensorMap& wmap,
                                        const CUtensorMap& umap, const CUtensorMap& xmap,
                                        int n_ids, cudaStream_t stream) {
  static bool attributes_set = false;  // once a process: the host calls cost microseconds
  if (!attributes_set) {
    cudaError_t e =
        cudaFuncSetAttribute(up_tiles<GLU>, cudaFuncAttributeMaxDynamicSharedMemorySize, UT_SMEM);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(up_tiles<GLU>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attributes_set = true;
  }
  const dim3 grid((a.T + UT_M - 1) / UT_M, n_ids);
  up_tiles<GLU><<<grid, UT_THREADS, UT_SMEM, stream>>>(wmap, umap, xmap, a);
  return cudaGetLastError();
}

// The up-projection over T rows in chunks of UT_M and the E * F / 128 tile
// ids of w (E, d, F) bf16 (E == 1: one (d, F) matrix); wu (d, F), the GLU's
// up projection, or NULL (lists only). With lists (a.bits != NULL), ut_rows
// first writes the bitmap and zeros compact's slots past nvalid.
static cudaError_t launch_up_tiles(const UtArgs& a, const __nv_bfloat16* w,
                                   const __nv_bfloat16* wu, cudaStream_t stream) {
  if (a.T <= 0 || (a.bits != nullptr && a.K <= 0)) return cudaGetLastError();
  if (a.F % UT_BN || a.d % 8 || a.E < 1 || (wu != nullptr && (a.bits == nullptr || a.E != 1)) ||
      (a.mask != nullptr && a.E != 1))
    return cudaErrorInvalidValue;
  const long n_ids = (long)a.E * (a.F / UT_BN);
  if (n_ids > 65535) return cudaErrorInvalidValue;  // the grid's y
  cudaError_t e;
  if (a.bits != nullptr) {
    const int n_words = (int)((n_ids + 31) / 32);
    ut_rows<<<a.T, 128, n_words * sizeof(unsigned), stream>>>(a.idx, a.K, a.nvalid, a.T, n_words,
                                                               a.bits, a.compact);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  CUtensorMap wmap, umap, xmap;
  e = ut_weight_map(&wmap, w, a.E, a.d, a.F);
  if (e != cudaSuccess) return e;
  umap = wmap;  // read only with a GLU
  if (wu != nullptr) {
    e = ut_weight_map(&umap, wu, 1, a.d, a.F);
    if (e != cudaSuccess) return e;
  }
  e = tg_weight_map(&xmap, a.x, a.T, a.d, UT_M);
  if (e != cudaSuccess) return e;
  return wu != nullptr ? launch_up_tiles_grid<true>(a, wmap, umap, xmap, (int)n_ids, stream)
                       : launch_up_tiles_grid<false>(a, wmap, umap, xmap, (int)n_ids, stream);
}
