// fused_up_relu, fused_up_relu_tokens, fused_up_relu_window: dense
// up-projection + shifted ReLU + tile-activity scores for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/fused_ffn.py (pallas_calls
// over F blocks with x resident in VMEM), which differ only in which rows
// share a score:
//
//   h = max(x @ wu - shift, 0)                                (T, F) f32
//   scores[g, j] = max over the rows of group g and the 128 lanes of tile j
//                  of |h|, a group being G consecutive rows:
//   fused_up_relu         G = T   one score row over all rows  (F / 128,)
//   fused_up_relu_tokens  G = 1   a score row per token        (T, F / 128)
//   fused_up_relu_window  G = W   a score row per slot's window (B, F / 128)
//
// On the port's paths fused_up_relu is the first half of ops.sparse_ffn_apply,
// whose scores pick the tiles of the gathered down-projection; the per-token
// and window variants are entry points of their own, as in the reference.
//
// What bounds it on the H100: the bytes of wu (134 MB in bf16 at OPT-6.7B,
// 0.040 ms at 3.35 TB/s). Its 2*T*d*F operations (17.2 GFLOP at T = 128)
// take 0.017 ms on bf16 tensor cores but 0.26 ms on f32 CUDA cores, which
// is what held the first design (up_relu below, on CUDA cores for both
// types) at 0.62 ms.
//
// Two routines, chosen by the type:
// - bf16: up_tiles (up_tiles.cuh) on tensor cores. A block owns one
//   128-column tile of wu (one score column) for 64 consecutive rows,
//   streams the tile and the rows through TMA boxes into an mbarrier ring
//   and multiplies with wgmma; its epilogue stores h and folds the tile's
//   scores. Every block covers all of d, at any T (up_tiles.cuh, "Small T").
// - f32 (the parity path, where engine streams must equal the CPU's and no
//   time is claimed): up_relu on CUDA cores. A block owns 64 output columns
//   and 16*TM rows (TM = 1, 4 or 8 by T), stages 32-row slices of x
//   (transposed) and wu in shared memory, and each thread accumulates a TM
//   x 4 tile in f32 registers; the next slice is loaded into registers while
//   the current one is used. When the grid would be too small to keep the
//   card's memory busy (small T), the d axis is split into S consecutive
//   ranges (kernels/fused_ffn.py up_relu_plan).
//
// With S ranges (f32) each block writes its raw partial sums to a (S, T, F)
// scratch and up_relu_finish adds them in range order. The block (or the
// finishing launch) that finishes h applies the shift and the ReLU and
// folds its values into the score of the row's group with an atomicMax on
// the bit patterns of non-negative floats, whose order is the float order:
// the max is exact whatever the order of the atomics, also when a group's
// rows fall in different blocks. With S > 1 only the finishing launch
// folds, after the row's h is final.
#include "up_tiles.cuh"

#define UR_BN 64                      // output columns per block (16 threads x 4)
#define UR_BK 32                      // rows of d staged per step
#define UR_TX 16                      // threads across the columns
#define UR_TY 16                      // threads across the rows
#define UR_THREADS (UR_TX * UR_TY)
#define UR_LANES 128                  // columns per activity score
#define UR_FIN_ROWS 32                // rows per block of the finishing launch

// 8 consecutive weight elements, kept raw in registers from the global load
// until the shared-memory store (so the load is not waited for early); f32
// only (bf16 runs up_tiles)
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void store(float* s) const {
    *reinterpret_cast<float4*>(s) = a;
    *reinterpret_cast<float4*>(s + 4) = b;
  }
};
// fold a warp's score candidates into *dst (bit patterns of floats >= 0)
__device__ __forceinline__ void max_to(unsigned* dst, unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0 && v) atomicMax(dst, v);
}

// the max over the 16 lanes of a half-warp (every lane of the warp calls it)
__device__ __forceinline__ unsigned half_warp_max(unsigned v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (F / UR_BN, ceil(T / (UR_TY * TM)), S); block UR_THREADS. Block z owns
// the d rows [z * kc, min(d, (z + 1) * kc)). part == NULL (S == 1): finish h
// and the scores here; else write the raw sums to part (S, T, F). scores is
// (ceil(T / G), F / UR_LANES), row r folding into score row r / G.
template <typename T, int TM>
__global__ void __launch_bounds__(UR_THREADS)
up_relu(const T* __restrict__ x, const T* __restrict__ wu, float* __restrict__ h,
        float* __restrict__ part, unsigned* __restrict__ scores, int Tn, int d, int F, int kc,
        int G, float shift) {
  constexpr int BM = UR_TY * TM;
  constexpr int XS = BM + 4;                       // padded row of the transposed x slice
  constexpr int XPT = BM * UR_BK / UR_THREADS;     // x elements each thread stages
  __shared__ __align__(16) float xs[UR_BK * XS];   // xs[k][m] = x[r0 + m, k0 + k]
  __shared__ __align__(16) float ws[UR_BK * UR_BN];
  const int tid = threadIdx.x, tx = tid % UR_TX, ty = tid / UR_TX;
  const int f0 = blockIdx.x * UR_BN, r0 = blockIdx.y * BM;
  const int k_beg = blockIdx.z * kc, k_end = min(d, k_beg + kc);
  const int wr = tid / (UR_BN / 8), wc = (tid % (UR_BN / 8)) * 8;  // this thread's 8 wu elements

  Raw8<T> wreg;
  T xreg[XPT];
  auto load = [&](int k0) {
    if (k0 + wr < k_end) wreg.load(wu + (long)(k0 + wr) * F + f0 + wc);
    else wreg.zero();
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + j * UR_THREADS, m = e / UR_BK, k = k0 + e % UR_BK;
      xreg[j] = (r0 + m < Tn && k < k_end) ? x[(long)(r0 + m) * d + k] : from_f32<T>(0.f);
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (k_beg < k_end) load(k_beg);
  for (int k0 = k_beg; k0 < k_end; k0 += UR_BK) {
    __syncthreads();  // the previous slice is consumed
    wreg.store(ws + wr * UR_BN + wc);
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + j * UR_THREADS;
      xs[(e % UR_BK) * XS + e / UR_BK] = to_f32(xreg[j]);
    }
    __syncthreads();
    if (k0 + UR_BK < k_end) load(k0 + UR_BK);
#pragma unroll
    for (int k = 0; k < UR_BK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(ws + k * UR_BN + tx * 4);
      float xv[TM];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(xs + k * XS + ty * TM + 4 * q);
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[i] = xs[k * XS + ty * TM + i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] += xv[i] * wv.x;
        acc[i][1] += xv[i] * wv.y;
        acc[i][2] += xv[i] * wv.z;
        acc[i][3] += xv[i] * wv.w;
      }
    }
  }

  const int c = f0 + tx * 4;
  if (part != nullptr) {  // a range of d: raw sums, finished by up_relu_finish
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty * TM + i;
      if (r < Tn)
        *reinterpret_cast<float4*>(part + ((long)blockIdx.z * Tn + r) * F + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    return;
  }
  // the 16 threads of a half-warp share their TM rows (one ty): each row's
  // max is reduced over them, then lane tx == 0 folds consecutive rows of
  // one group and makes one atomic per group
  const long nsc = F / UR_LANES;
  unsigned mx = 0u;
  int g_cur = -1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    unsigned m = 0u;
    if (r < Tn) {
      const float4 v = make_float4(fmaxf(acc[i][0] - shift, 0.f), fmaxf(acc[i][1] - shift, 0.f),
                                   fmaxf(acc[i][2] - shift, 0.f), fmaxf(acc[i][3] - shift, 0.f));
      *reinterpret_cast<float4*>(h + (long)r * F + c) = v;
      m = max(max(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y))),
              max(__float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w))));
    }
    m = half_warp_max(m);
    if (tx == 0 && r < Tn) {
      if (r / G != g_cur) {
        if (mx) atomicMax(scores + g_cur * nsc + f0 / UR_LANES, mx);
        mx = 0u;
        g_cur = r / G;
      }
      mx = max(mx, m);
    }
  }
  if (tx == 0 && mx) atomicMax(scores + g_cur * nsc + f0 / UR_LANES, mx);
}

// h[t, c] = max(sum over z < S of part[z, t, c] (in order) - shift, 0), and
// the scores of groups of G rows. grid (F / UR_LANES, ceil(T / UR_FIN_ROWS));
// block UR_LANES. Every thread walks the same rows, so the group changes are
// uniform across each warp.
__global__ void __launch_bounds__(UR_LANES)
up_relu_finish(const float* __restrict__ part, float* __restrict__ h,
               unsigned* __restrict__ scores, int Tn, int F, int S, int G, float shift) {
  const int c = blockIdx.x * UR_LANES + threadIdx.x;
  const int rb = blockIdx.y * UR_FIN_ROWS, re = min(Tn, rb + UR_FIN_ROWS);
  const long nsc = F / UR_LANES;
  unsigned mx = 0u;
  int g_cur = rb / G;
  for (int r = rb; r < re; ++r) {
    if (r / G != g_cur) {
      max_to(scores + g_cur * nsc + blockIdx.x, mx);
      mx = 0u;
      g_cur = r / G;
    }
    float acc = 0.f;
    for (int z = 0; z < S; ++z) acc += part[((long)z * Tn + r) * F + c];
    const float v = fmaxf(acc - shift, 0.f);
    h[(long)r * F + c] = v;
    mx = max(mx, __float_as_uint(fabsf(v)));
  }
  max_to(scores + g_cur * nsc + blockIdx.x, mx);
}

template <typename T, int TM>
static cudaError_t launch_tm(const T* x, const T* wu, float* h, float* part, unsigned* sc,
                             int Tn, int d, int F, int S, int kc, int G, float shift,
                             cudaStream_t st) {
  const dim3 grid(F / UR_BN, (Tn + UR_TY * TM - 1) / (UR_TY * TM), S);
  up_relu<T, TM><<<grid, UR_THREADS, 0, st>>>(x, wu, h, part, sc, Tn, d, F, kc, G, shift);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_up_relu(const T* x, const T* wu, float* h, float* part, unsigned* sc,
                                  int Tn, int d, int F, int S, int kc, int tm, int G,
                                  float shift, cudaStream_t st) {
  cudaError_t e;
  if (tm == 1) e = launch_tm<T, 1>(x, wu, h, part, sc, Tn, d, F, S, kc, G, shift, st);
  else if (tm == 4) e = launch_tm<T, 4>(x, wu, h, part, sc, Tn, d, F, S, kc, G, shift, st);
  else if (tm == 8) e = launch_tm<T, 8>(x, wu, h, part, sc, Tn, d, F, S, kc, G, shift, st);
  else return cudaErrorInvalidValue;
  if (e != cudaSuccess || part == nullptr) return e;
  up_relu_finish<<<dim3(F / UR_LANES, (Tn + UR_FIN_ROWS - 1) / UR_FIN_ROWS), UR_LANES, 0, st>>>(
      part, h, sc, Tn, F, S, G, shift);
  return cudaGetLastError();
}

// x (T, d); wu (d, F), F a multiple of 128, 16-byte aligned; outputs h (T, F)
// f32 and scores (n_groups, F / 128) f32, n_groups = ceil(T / G), zeroed here
// (+0.0, below every folded value). x and wu share one dtype. f32: tm rows
// per thread (1, 4 or 8), S ranges of kc rows of d (kernels/fused_ffn.py
// up_relu_plan), scratch (S, T, F) f32 when S > 1, else NULL. bf16: x
// 16-byte aligned, d % 8 == 0; tm, S, kc and scratch unused.
static int run_up_relu(const void* x, const void* wu, void* h, void* scores, void* scratch,
                       int T, int d, int F, int tm, int S, int kc, int G, int n_groups,
                       float shift, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* sc = (unsigned*)scores;
  if (F % UR_LANES || S < 1 || kc < 1 || G < 1 || n_groups < 0 ||
      (S > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t n_scores = (size_t)n_groups * (F / UR_LANES);
  cudaError_t e = cudaMemsetAsync(sc, 0, n_scores * sizeof(unsigned), st);
  if (e != cudaSuccess || T <= 0) return (int)e;
  float* part = S > 1 ? (float*)scratch : nullptr;
  if (dtype == DT_F32) {
    e = launch_up_relu((const float*)x, (const float*)wu, (float*)h, part, sc, T, d, F, S, kc,
                       tm, G, shift, st);
  } else if (dtype == DT_BF16) {
    UtArgs a = {};
    a.x = (const __nv_bfloat16*)x;
    a.T = T, a.d = d, a.F = F;
    a.h = (float*)h, a.scores = sc, a.G = G, a.shift = shift;
    e = launch_up_tiles(a, (const __nv_bfloat16*)wu, nullptr, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

// one score row over all T rows: scores (F / 128,)
extern "C" int fused_up_relu(const void* x, const void* wu, void* h, void* scores, void* scratch,
                             int T, int d, int F, int tm, int S, int kc, float shift, int dtype,
                             void* stream) {
  return run_up_relu(x, wu, h, scores, scratch, T, d, F, tm, S, kc, T > 0 ? T : 1, 1, shift,
                     dtype, stream);
}

// a score row per token: scores (T, F / 128)
extern "C" int fused_up_relu_tokens(const void* x, const void* wu, void* h, void* scores,
                                    void* scratch, int T, int d, int F, int tm, int S, int kc,
                                    float shift, int dtype, void* stream) {
  return run_up_relu(x, wu, h, scores, scratch, T, d, F, tm, S, kc, 1, T, shift, dtype, stream);
}

// x (B * W, d) holding each slot's W window tokens in a row: a score row per
// slot, the union over its W rows: scores (B, F / 128)
extern "C" int fused_up_relu_window(const void* x, const void* wu, void* h, void* scores,
                                    void* scratch, int T, int d, int F, int tm, int S, int kc,
                                    int W, float shift, int dtype, void* stream) {
  if (W < 1 || T % W) return (int)cudaErrorInvalidValue;
  return run_up_relu(x, wu, h, scores, scratch, T, d, F, tm, S, kc, W, T / W, shift, dtype,
                     stream);
}
