// Helpers shared by the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel file exposes a plain C interface loaded with ctypes
// (kernels/runtime.py): pointers and the stream arrive as void*, each entry
// point launches on the given stream, never synchronises, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/runtime.py (DTYPE_CODES)
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// round a float to T and back: the cast the reference makes when it feeds an
// f32 intermediate to a product in the weights' dtype (h.astype(wd.dtype))
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// activation enum shared with core/activations.py (ACT_*), applied in the
// epilogues of the FFN up-projections (ffn_up.cuh, up_tiles.cuh)
enum { ACT_RELU = 0, ACT_GELU_TANH = 1, ACT_GATED_SIGMOID = 2, ACT_SHIFTED_RELU = 3,
       ACT_FATRELU = 4, ACT_IDENTITY = 5 };

__device__ __forceinline__ float apply_act(float v, int act, float prm) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_GELU_TANH: {
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
    }
    case ACT_GATED_SIGMOID:
      return v / (1.f + expf(-prm * v));
    case ACT_SHIFTED_RELU:
      return fmaxf(v - prm, 0.f);
    case ACT_FATRELU:
      return v > prm ? v : 0.f;
    default:  // ACT_IDENTITY
      return v;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Per-row tile-gathered product on CUDA cores: the down-projection of
// fused_sparse_ffn, and the f32 x f32 path of sparse_matmul,
// sparse_matmul_tokens and expert_down_matmul (their bf16-weight path is
// tile_group.cuh):
//
//   y[t, j] = sum_{i < nvalid[t]} P[t, i, j],
//   P[t, i, j] = sum_c round_to<WT>(x_tile(t, i)[c]) * w[idx[t, i] * tile + c, j]
//
// An f32 x is rounded to the weights' type, as the reference rounds
// fused_sparse_ffn's h before its down-projection (h.astype(wd.dtype)).
//
// x_tile(t, i) is row t's slice for list slot i: at x + t*x_row + idx*tile
// for a (T, F) input, or at x + t*x_row + i*tile for a compact (T, K, tile)
// one. Row t's list is idx + t*idx_row with nvalid[t*nv_row]: per-row lists
// (idx_row = K, nv_row = 1), or one list shared by every row (both 0, the
// sparse_matmul kernel). Nothing assumes a list is sorted: slots are
// summed in list order whatever tiles they name. The TPU kernel walked the list on a sequential grid axis with the
// output resident; Hopper blocks run in no order, so the list is cut into
// S consecutive runs of `run` slots (S = ceil(K / run), chosen by the
// caller so the grid fills the card):
//
// 1. gather_runs: one block per (group of GATHER_ROWS rows, run s,
//    GATHER_COLS columns) walks the slots of its run IN LIST ORDER and
//    accumulates their products in f32 registers. A tile's rows are split
//    over the block's warps, summed in warp order at the end. When the active
//    rows of the group name the same tile at a slot (the rows of one slot's
//    prefill window share its union list; decode under a shared γ-window
//    list), each weight element is read once for all of them, otherwise once
//    per row. A row's arithmetic is the same either way. With S == 1 the
//    block writes y itself; otherwise it writes its run's sum R[t, s, :].
// 2. ordered_sum (S > 1 only): y[t, j] = R[t, 0, j] + R[t, 1, j] + ... in
//    run order, f32.
//
// No atomics, a fixed order for each shape, and exact zeros for a row with
// nvalid == 0. The scratch R is (T, S, D) f32, allocated by the caller
// (kernels/runtime.py gather_runs picks `run`): S is about 1024 blocks over
// (row groups x column groups), so R stays under 9 MB whatever T and K are,
// and is not needed at all when S == 1.
#define GATHER_ROWS 16   // rows per block
#define GATHER_COLS 64   // output columns per block: 2 per lane of a warp
#define GATHER_WARPS 8   // warps splitting the tile's rows

template <typename WT> struct Pair;
template <> struct Pair<float> {
  __device__ static float2 load(const float* p) { return *reinterpret_cast<const float2*>(p); }
};
template <> struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// grid (ceil(T / GATHER_ROWS), S, ceil(D / GATHER_COLS)); block (32, GATHER_WARPS).
// D must be even. out is y (T, D) when S == 1, else R (T, S, D). Dynamic
// shared memory: GATHER_ROWS * tile + GATHER_WARPS * GATHER_ROWS * GATHER_COLS floats.
template <typename XT, typename WT>
__global__ void __launch_bounds__(32 * GATHER_WARPS)
gather_runs(const XT* __restrict__ x, long x_row, int compact, const WT* __restrict__ w,
            const int* __restrict__ idx, long idx_row, const int* __restrict__ nvalid,
            int nv_row, float* __restrict__ out, int T, int K, int run, int tile, int D) {
  extern __shared__ float smem[];
  float* xs = smem;                          // [GATHER_ROWS][tile]
  float* part = smem + GATHER_ROWS * tile;   // [GATHER_WARPS][GATHER_ROWS][GATHER_COLS]
  __shared__ int s_tile[GATHER_ROWS];        // row's tile at slot i, -1 if inactive
  const int r0 = blockIdx.x * GATHER_ROWS, s = blockIdx.y, S = gridDim.y;
  const int nr = min(GATHER_ROWS, T - r0);
  const int lane = threadIdx.x, wp = threadIdx.y;
  const int tid = wp * 32 + lane, nthreads = 32 * GATHER_WARPS;
  const int j = blockIdx.z * GATHER_COLS + 2 * lane;  // this lane's two columns
  float p0[GATHER_ROWS], p1[GATHER_ROWS];
#pragma unroll
  for (int r = 0; r < GATHER_ROWS; ++r) p0[r] = p1[r] = 0.f;
  const int i_end = min(K, (s + 1) * run);
  for (int i = s * run; i < i_end; ++i) {
    __syncthreads();  // the previous slot's s_tile and xs are consumed
    if (tid < GATHER_ROWS)
      s_tile[tid] = (tid < nr && i < nvalid[(long)(r0 + tid) * nv_row])
                        ? idx[(long)(r0 + tid) * idx_row + i] : -1;
    __syncthreads();
    int common = -1;
    bool uniform = true;
    for (int r = 0; r < nr; ++r) {
      const int ti = s_tile[r];
      if (ti < 0) continue;
      if (common < 0) common = ti;
      else if (ti != common) uniform = false;
    }
    if (common < 0) continue;  // no row of the group uses slot i (block-uniform)
    for (int e = tid; e < GATHER_ROWS * tile; e += nthreads) {
      const int r = e / tile, c = e % tile, ti = s_tile[r];
      float v = 0.f;
      if (ti >= 0) {
        const XT* xr = x + (long)(r0 + r) * x_row + (compact ? (long)i * tile : (long)ti * tile);
        v = round_to<WT>(to_f32(xr[c]));
      }
      xs[e] = v;
    }
    __syncthreads();
    if (j >= D) continue;
    if (uniform) {
      const WT* wt = w + (long)common * tile * D + j;
#pragma unroll 4
      for (int c = wp; c < tile; c += GATHER_WARPS) {
        const float2 wv = Pair<WT>::load(wt + (long)c * D);
#pragma unroll
        for (int r = 0; r < GATHER_ROWS; ++r) {
          p0[r] += xs[r * tile + c] * wv.x;
          p1[r] += xs[r * tile + c] * wv.y;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < GATHER_ROWS; ++r) {
        if (r >= nr || s_tile[r] < 0) continue;
        const WT* wt = w + (long)s_tile[r] * tile * D + j;
        for (int c = wp; c < tile; c += GATHER_WARPS) {
          const float2 wv = Pair<WT>::load(wt + (long)c * D);
          p0[r] += xs[r * tile + c] * wv.x;
          p1[r] += xs[r * tile + c] * wv.y;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < GATHER_ROWS; ++r) {
    part[(wp * GATHER_ROWS + r) * GATHER_COLS + 2 * lane] = p0[r];
    part[(wp * GATHER_ROWS + r) * GATHER_COLS + 2 * lane + 1] = p1[r];
  }
  __syncthreads();
  // finalise: thread -> (row, column) pairs, warps summed in order; every
  // row of the group is written (zeros where the run holds no valid slot)
  for (int e = tid; e < GATHER_ROWS * GATHER_COLS; e += nthreads) {
    const int r = e / GATHER_COLS, col = e % GATHER_COLS;
    const int jj = blockIdx.z * GATHER_COLS + col;
    if (r >= nr || jj >= D) continue;
    float acc = 0.f;
    for (int g = 0; g < GATHER_WARPS; ++g) acc += part[(g * GATHER_ROWS + r) * GATHER_COLS + col];
    out[((long)(r0 + r) * S + s) * D + jj] = acc;
  }
}

// y[t, j] = sum over s < S of R[t, s, j], in run order.
// grid (T, ceil(D / 256)); block 256.
__global__ void ordered_sum(const float* __restrict__ R, float* __restrict__ y, int S, int D) {
  const int t = blockIdx.x, j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= D) return;
  const float* rt = R + (long)t * S * D + j;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += rt[(long)s * D];
  y[(long)t * D + j] = acc;
}

// R may be NULL when K <= run (S == 1): the blocks then write y directly.
template <typename XT, typename WT>
static cudaError_t launch_tile_gather_rows(const XT* x, long x_row, int compact, const WT* w,
                                           const int* idx, long idx_row, const int* nvalid,
                                           int nv_row, float* R, float* y, int T, int K,
                                           int run, int tile, int D, cudaStream_t stream) {
  if (T <= 0 || D <= 0) return cudaGetLastError();
  if (run < 1) return cudaErrorInvalidValue;
  const int S = K > 0 ? (K + run - 1) / run : 1;
  if (S > 1 && R == nullptr) return cudaErrorInvalidValue;
  size_t smem = (size_t)(GATHER_ROWS * tile + GATHER_WARPS * GATHER_ROWS * GATHER_COLS) *
                sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gather_runs<XT, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + GATHER_ROWS - 1) / GATHER_ROWS, S, (D + GATHER_COLS - 1) / GATHER_COLS);
  gather_runs<XT, WT><<<grid, dim3(32, GATHER_WARPS), smem, stream>>>(
      x, x_row, compact, w, idx, idx_row, nvalid, nv_row, S > 1 ? R : y, T, K, run, tile, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  ordered_sum<<<dim3(T, (D + 255) / 256), 256, 0, stream>>>(R, y, S, D);
  return cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
