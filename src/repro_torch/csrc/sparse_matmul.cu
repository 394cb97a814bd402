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
// What bounds it on the H100: the listed weight tiles, nvalid x tile x D
// elements read once from HBM (33.5 MB at OPT-6.7B width and density 0.25,
// 0.010 ms at 3.35 TB/s); 2 T x nvalid x tile x D operations, 34 GFLOP at
// T = 128 (0.035 ms on bf16 tensor cores, 0.5 ms on f32 CUDA cores).
//
// Two routines, chosen by the weights' dtype:
// - bf16 weights (bf16 x, or f32 x split into three bf16 terms, not
//   rounded): the shared-list mode of tile_groups (tile_group.cuh) on tensor
//   cores. Block (column block, chunk of 64 consecutive rows) walks the
//   list's valid slots in list order; one thread asks the TMA engine for
//   each step's weight box and x box, mbarriers hand the ring's slots to
//   eight mma.sync consumer warps. The chunks of a column block share its
//   weight tiles through L2. One launch, no scratch. BN = 32 columns a block
//   when the rows fit one chunk (T <= 64: 128 blocks at D = 4096 instead of
//   64), else 64 (the wrapper picks it from T).
// - f32 weights: the CUDA-core row gather of common.cuh (the f32 parity
//   path, no time claimed): blocks of 16 rows walk runs of the list in list
//   order, a second launch sums the runs in order.
#include "tile_group.cuh"

// f32 x (T, F), f32 w (F, D), D even; idx (K,) i32; nvalid (1,) i32; scratch
// (T, ceil(K / run), D) f32, or NULL when run >= K -> y (T, D) f32.
extern "C" int sparse_matmul(const void* x, const void* w, const void* idx, const void* nvalid,
                             void* scratch, void* y, int T, int F, int D, int K, int run,
                             int tile, void* stream) {
  return (int)launch_tile_gather_rows((const float*)x, (long)F, 0, (const float*)w,
                                      (const int*)idx, 0L, (const int*)nvalid, 0,
                                      (float*)scratch, (float*)y, T, K, run, tile, D,
                                      (cudaStream_t)stream);
}

// x (T, F) bf16, or f32 (multiplied unrounded, as three bf16 terms), 16-byte
// aligned; bf16 w (F, D), D % 8 == 0, tile % 16 == 0; idx (K,) i32 with
// K <= 8192; nvalid (1,) i32; bn 32 or 64 columns a block -> y (T, D) f32.
extern "C" int sparse_matmul_tc(const void* x, const void* w, const void* idx,
                                const void* nvalid, void* y, int T, int F, int D, int K,
                                int tile, int bn, int x_dtype, void* stream) {
  const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* out = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (bn != 32 && bn != 64) return (int)cudaErrorInvalidValue;
  if (x_dtype == DT_BF16) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    return (int)(bn == 32
                     ? launch_tile_groups_shared<__nv_bfloat16, 32>(xb, wb, ix, K, nv, T, F, tile,
                                                                    D, out, s)
                     : launch_tile_groups_shared<__nv_bfloat16, 64>(xb, wb, ix, K, nv, T, F, tile,
                                                                    D, out, s));
  }
  if (x_dtype == DT_F32) {
    const float* xf = (const float*)x;
    return (int)(bn == 32 ? launch_tile_groups_shared<float, 32>(xf, wb, ix, K, nv, T, F, tile, D,
                                                                 out, s)
                          : launch_tile_groups_shared<float, 64>(xf, wb, ix, K, nv, T, F, tile, D,
                                                                 out, s));
  }
  return (int)cudaErrorInvalidValue;
}
