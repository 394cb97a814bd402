// The CUDA-core up-projection of the list-driven FFN kernels (sm_90a): the
// f32 path (and tiles other than 128) of fused_sparse_ffn.cu,
// sparse_up_matmul.cu and expert_up_matmul.cu, so that in f32 the fused
// kernel and the unfused pair compute each gathered tile's dot products in
// the same order:
//
//   h_compact[t, i, c] = act(x_t . Wg[:, idx[t, i] * tile + c])
//                        [* (x_t . Wu[:, ...])] [* mask[t, ...]]
//
// for list slots i < nvalid[t], zeros past it. sparse_up_matmul and
// expert_up_matmul run it with ACT_IDENTITY, no Wu and no mask: the bare
// gathered product. bf16 at tile 128 runs up_tiles.cuh on tensor cores.
//
// The weights may be a stack of E (d, F) matrices (expert_up_matmul): a tile
// id names tile (id % tpe) of matrix id / tpe, with tpe = F / tile tiles per
// matrix. For one (d, F) matrix every id is below tpe and names its own
// columns, so the dense callers pass tpe = F / tile and read what they did.
#pragma once

#include "common.cuh"

#define UP_ROWS 8     // tokens per block
#define UP_COLS 128   // tile columns per pass (one per thread)
#define UP_GROUPS 4   // split the d rows of the product
#define UP_XCH 256    // x rows staged in shared memory per chunk

// offset of tile id ti's first column in a stack of (d, F) matrices
__device__ __forceinline__ long tile_base(int ti, int tpe, int d, int F, int tile) {
  return (long)(ti / tpe) * d * F + (long)(ti % tpe) * tile;
}

// grid (ceil(T / UP_ROWS), K); block (UP_COLS, UP_GROUPS). A block owns list
// slot i of UP_ROWS tokens. When the active tokens name the same tile at
// slot i (decode under a shared γ-window list), each weight element is read
// once for all of them; otherwise each token reads its own tile column.
// A token's arithmetic is the same either way. Dynamic shared memory:
// x chunk + partial sums, (UP_ROWS * UP_XCH + 2 * UP_GROUPS * UP_ROWS * UP_COLS)
// floats.
template <typename T>
__global__ void __launch_bounds__(UP_COLS * UP_GROUPS) ffn_up(const T* __restrict__ x, const T* __restrict__ wg,
                       const T* __restrict__ wu, const float* __restrict__ mask,
                       const int* __restrict__ idx, const int* __restrict__ nvalid,
                       float* __restrict__ h, int Tn, int d, int F, int K, int tile, int tpe,
                       int act, float prm) {
  extern __shared__ float smem[];
  float* xs = smem;                                 // [UP_ROWS][UP_XCH]
  float* pg = xs + UP_ROWS * UP_XCH;                // [UP_GROUPS][UP_ROWS][UP_COLS]
  float* pu = pg + UP_GROUPS * UP_ROWS * UP_COLS;   // [UP_GROUPS][UP_ROWS][UP_COLS]
  __shared__ int s_tile[UP_ROWS];                   // token's tile at slot i, -1 if padded
  const int r0 = blockIdx.x * UP_ROWS, i = blockIdx.y;
  const int nr = min(UP_ROWS, Tn - r0);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * UP_COLS + tx, nthreads = UP_COLS * UP_GROUPS;
  if (tid < UP_ROWS) {
    const int r = r0 + tid;
    s_tile[tid] = (tid < nr && i < nvalid[r]) ? idx[(long)r * K + i] : -1;
  }
  __syncthreads();
  int common = -1;
  bool uniform = true;
  for (int r = 0; r < nr; ++r) {
    const int ti = s_tile[r];
    if (ti < 0) continue;
    if (common < 0) common = ti;
    else if (ti != common) uniform = false;
  }
  for (int c0 = 0; c0 < tile; c0 += UP_COLS) {
    const int c = c0 + tx;
    float g[UP_ROWS], u[UP_ROWS];
#pragma unroll
    for (int r = 0; r < UP_ROWS; ++r) g[r] = u[r] = 0.f;
    for (int k0 = 0; k0 < d && common >= 0; k0 += UP_XCH) {
      const int kn = min(UP_XCH, d - k0);
      __syncthreads();  // previous chunk consumed
      for (int e = tid; e < UP_ROWS * UP_XCH; e += nthreads) {
        const int r = e / UP_XCH, k = e % UP_XCH;
        xs[e] = (s_tile[r] >= 0 && k < kn) ? to_f32(x[(long)(r0 + r) * d + k0 + k]) : 0.f;
      }
      __syncthreads();
      if (c < tile) {
        if (uniform) {
          const long col = tile_base(common, tpe, d, F, tile) + c;
#pragma unroll 4
          for (int k = ty; k < kn; k += UP_GROUPS) {
            const long off = (long)(k0 + k) * F + col;
            const float gv = to_f32(wg[off]);
            const float uv = wu != nullptr ? to_f32(wu[off]) : 0.f;
#pragma unroll
            for (int r = 0; r < UP_ROWS; ++r) {
              g[r] += xs[r * UP_XCH + k] * gv;
              u[r] += xs[r * UP_XCH + k] * uv;
            }
          }
        } else {
          for (int r = 0; r < nr; ++r) {
            if (s_tile[r] < 0) continue;
            const long col = tile_base(s_tile[r], tpe, d, F, tile) + c;
            float gs = g[r], us = u[r];
            for (int k = ty; k < kn; k += UP_GROUPS) {
              const long off = (long)(k0 + k) * F + col;
              gs += xs[r * UP_XCH + k] * to_f32(wg[off]);
              if (wu != nullptr) us += xs[r * UP_XCH + k] * to_f32(wu[off]);
            }
            g[r] = gs;
            u[r] = us;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < UP_ROWS; ++r) {
      pg[(ty * UP_ROWS + r) * UP_COLS + tx] = g[r];
      pu[(ty * UP_ROWS + r) * UP_COLS + tx] = u[r];
    }
    __syncthreads();
    for (int r = ty; r < nr && c < tile; r += UP_GROUPS) {
      const int ti = s_tile[r];
      float v = 0.f;  // padded slot: zeros in h_compact
      if (ti >= 0) {
        float sg = 0.f, su = 0.f;
        for (int gi = 0; gi < UP_GROUPS; ++gi) {
          sg += pg[(gi * UP_ROWS + r) * UP_COLS + tx];
          su += pu[(gi * UP_ROWS + r) * UP_COLS + tx];
        }
        v = apply_act(sg, act, prm);
        if (wu != nullptr) v *= su;
        if (mask != nullptr) v *= mask[(long)(r0 + r) * F + (long)ti * tile + c];
      }
      h[((long)(r0 + r) * K + i) * tile + c] = v;
    }
    __syncthreads();  // partial sums read before the next column pass
  }
}

template <typename T>
static cudaError_t launch_up(const T* x, const T* wg, const T* wu, const float* mask,
                             const int* idx, const int* nvalid, float* h, int Tn, int d,
                             int F, int K, int tile, int tpe, int act, float prm,
                             cudaStream_t s) {
  dim3 block(UP_COLS, UP_GROUPS);
  dim3 grid((Tn + UP_ROWS - 1) / UP_ROWS, K);
  size_t smem = (size_t)(UP_ROWS * UP_XCH + 2 * UP_GROUPS * UP_ROWS * UP_COLS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ffn_up<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (tpe < 1) return cudaErrorInvalidValue;
  if (Tn > 0 && K > 0)
    ffn_up<T><<<grid, block, smem, s>>>(x, wg, wu, mask, idx, nvalid, h, Tn, d, F, K, tile, tpe,
                                        act, prm);
  return cudaGetLastError();
}
