// sparse_matmul_tokens: per-row tile-gathered matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:sparse_matmul_tokens
// (a pallas_call whose scalar-prefetched tile list drives the weight
// BlockSpec, grid (T, D/block_d, K) with K sequential):
//
//   y[t] = sum_{i < nvalid[t]} x[t, tile_i] @ w[tile_i, :]      (T, D) f32
//
// On the serving path it is the window-union down-projection of chunked
// prefill / verify windows (models/transformer.py apply_ffn_window).
//
// What bounds it on the H100: the weight bytes. At full density one row
// needs the whole (F, D) weight (134 MB in bf16 at OPT-6.7B); the minimum
// for a step is each gathered weight tile read once from HBM. The design
// (launch_tile_gather_rows in common.cuh): each block owns 16 rows, 64
// output columns and one run of consecutive list slots, which it walks in
// list order, reading a weight tile once for the 16 rows when they share it
// (the rows of one slot's prefill window share its union list); a second
// launch sums the runs in order. The run scratch is (T, S, D) f32 with S
// chosen to fill the grid, under 9 MB at any T and K. Row groups of
// different slots still read shared tiles separately (from L2 when they run
// together). No tensor cores: CUDA-core f32 FMAs.
#include "common.cuh"

// x (T, F); w (F, D), D even; idx (T, K) i32; nvalid (T,) i32; scratch
// (T, ceil(K / run), D) f32, or NULL when run >= K -> y (T, D) f32. x is
// f32 or w's dtype.
extern "C" int sparse_matmul_tokens(const void* x, const void* w, const void* idx,
                                    const void* nvalid, void* scratch, void* y, int T, int F,
                                    int D, int K, int run, int tile, int x_dtype, int w_dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* P = (float*)scratch;
  float* out = (float*)y;
  cudaError_t e;
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    e = launch_tile_gather_rows((const float*)x, (long)F, 0, (const float*)w, ix, K, nv, 1,
                                P, out, T, K, run, tile, D, s);
  else if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    e = launch_tile_gather_rows((const __nv_bfloat16*)x, (long)F, 0,
                                (const __nv_bfloat16*)w, ix, K, nv, 1, P, out, T, K, run, tile, D, s);
  else if (x_dtype == DT_F32 && w_dtype == DT_BF16)
    e = launch_tile_gather_rows((const float*)x, (long)F, 0, (const __nv_bfloat16*)w, ix,
                                K, nv, 1, P, out, T, K, run, tile, D, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
