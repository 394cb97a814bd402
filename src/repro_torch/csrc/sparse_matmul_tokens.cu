// sparse_matmul_tokens: per-row tile-gathered matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:sparse_matmul_tokens
// (a pallas_call whose scalar-prefetched tile list drives the weight
// BlockSpec, grid (T, D/block_d, K) with K sequential):
//
//   y[t] = sum_{i < nvalid[t]} x[t, tile_i] @ w[tile_i, :]      (T, D) f32
//
// On the serving path it is the window-union down-projection of chunked
// prefill / verify windows (models/transformer.py apply_ffn_window), one
// list per slot shared by the slot's W rows; also the unfused predictor
// FFN's down-projection.
//
// What bounds it on the H100: the weight bytes. At full density a row needs
// the whole (F, D) weight (134 MB in bf16 at OPT-6.7B, 0.040 ms at
// 3.35 TB/s); the minimum for a call is each listed weight tile read once.
// The FLOPs (2 T x listed units x D, 17 GFLOP at T = 128) need 0.26 ms on
// f32 CUDA cores but 0.017 ms on bf16 tensor cores.
//
// Two routines, chosen by the weights' dtype:
// - bf16 weights: tile_groups (tile_group.cuh) on tensor cores, an f32 x
//   split into three bf16 terms (not rounded). At d_ff /
//   tile <= 128 tiles every tile id is one run, so chunks are 64 consecutive
//   rows: a block reads each tile that any of its 64 rows lists once, for
//   all of them (at the serve shape, 8 windows x 16 rows, four windows
//   share one read), zero rows for a row that does not list it, and writes y.
//   At T = 128 its 2 chunks x 64 column blocks each move 2 MB of weight
//   (TMA) and 2 MB of x rows (cp.async, re-read by every column block):
//   512 MB into the SMs where the bound counts 134 MB.
// - f32 weights: the CUDA-core row gather of common.cuh (the f32 parity
//   path, where engine streams must equal the CPU's and no time is
//   claimed): blocks of 16 rows walk runs of list slots in list order, a
//   second launch sums the runs in order.
#include "tile_group.cuh"

// f32 x (T, F), f32 w (F, D), D even; idx (T, K) i32; nvalid (T,) i32; scratch
// (T, ceil(K / run), D) f32, or NULL when run >= K -> y (T, D) f32.
extern "C" int sparse_matmul_tokens(const void* x, const void* w, const void* idx,
                                    const void* nvalid, void* scratch, void* y, int T, int F,
                                    int D, int K, int run, int tile, void* stream) {
  return (int)launch_tile_gather_rows((const float*)x, (long)F, 0, (const float*)w,
                                      (const int*)idx, K, (const int*)nvalid, 1,
                                      (float*)scratch, (float*)y, T, K, run, tile, D,
                                      (cudaStream_t)stream);
}

// x (T, F) bf16, or f32 (multiplied unrounded, as three bf16 terms), and
// bf16 w (F, D), D % 8 == 0, tile % 16 == 0; idx (T, K), nvalid (T,) i32;
// runs of R tile ids, n_runs = ceil(F / tile / R) <= 64. With one run mask
// and P may be NULL; else mask (T,) u64 and P (n_runs * T, D) f32 are
// scratch -> y (T, D) f32.
extern "C" int sparse_matmul_tokens_tc(const void* x, const void* w, const void* idx,
                                       const void* nvalid, void* mask, void* P, void* y, int T,
                                       int F, int D, int K, int n_runs, int R, int tile,
                                       int x_dtype, void* stream) {
  const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  unsigned long long* m = (unsigned long long*)mask;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == DT_F32)
    return (int)launch_tile_groups<float, 64>((const float*)x, (long)F, 0, wb, (long)F, ix, K, nv,
                                              n_runs, m, (float*)P, (float*)y, T, R, tile, D, s);
  if (x_dtype == DT_BF16)
    return (int)launch_tile_groups<__nv_bfloat16, 64>((const __nv_bfloat16*)x, (long)F, 0, wb,
                                                      (long)F, ix, K, nv, n_runs, m, (float*)P,
                                                      (float*)y, T, R, tile, D, s);
  return (int)cudaErrorInvalidValue;
}
