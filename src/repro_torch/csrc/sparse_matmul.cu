// sparse_matmul: tile-gathered matmul over ONE tile list shared by every row,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:sparse_matmul
// (a pallas_call over grid (D / block_d, K) with K sequential and the (T,
// block_d) output resident while the listed tiles accumulate into it):
//
//   y = sum_{i < nvalid} x[:, tile_i] @ w[tile_i, :]      (T, D) f32
//
// On the port's paths it is the down-projection of ops.sparse_ffn_apply,
// whose list comes from select_tiles_static: the top tiles in SCORE order,
// not ascending, with the zero-score tail past nvalid.
//
// The shared row gather of common.cuh with list stride 0: every row reads
// the one list and nvalid[0]. Blocks of 16 rows walk consecutive runs of
// the list in list order (whatever tiles it names), so each block reads a
// listed weight tile once for its 16 rows; a second launch sums the runs
// in order. What bounds it on the H100: the listed weight tiles, nvalid x
// tile x D elements, read once from HBM at best (the row groups of one
// column block share them through L2). CUDA-core f32 FMAs.
#include "common.cuh"

// x (T, F); w (F, D), D even; idx (K,) i32; nvalid (1,) i32; scratch
// (T, ceil(K / run), D) f32, or NULL when run >= K -> y (T, D) f32. x is f32
// (multiplied unrounded) or w's dtype.
extern "C" int sparse_matmul(const void* x, const void* w, const void* idx, const void* nvalid,
                             void* scratch, void* y, int T, int F, int D, int K, int run,
                             int tile, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* P = (float*)scratch;
  float* out = (float*)y;
  cudaError_t e;
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    e = launch_tile_gather_rows((const float*)x, (long)F, 0, (const float*)w, ix, 0L, nv, 0, P,
                                out, T, K, run, tile, D, s);
  else if (x_dtype == DT_BF16 && w_dtype == DT_BF16)
    e = launch_tile_gather_rows((const __nv_bfloat16*)x, (long)F, 0, (const __nv_bfloat16*)w,
                                ix, 0L, nv, 0, P, out, T, K, run, tile, D, s);
  else if (x_dtype == DT_F32 && w_dtype == DT_BF16)  // x unrounded, as the promoted dot
    e = launch_tile_gather_rows<float, __nv_bfloat16, false>(
        (const float*)x, (long)F, 0, (const __nv_bfloat16*)w, ix, 0L, nv, 0, P, out, T, K, run,
        tile, D, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
