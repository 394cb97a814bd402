// expert_down_matmul: expert-offset down-projection gather for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:expert_down_matmul
// (a pallas_call over grid (T, d / block_d, K) with K sequential and the
// token's output block resident while its listed blocks accumulate):
//
//   y[t] = sum over i < nvalid[t] of
//          compact[t, i, :] @ w[e, ft * tile : (ft + 1) * tile, :]   (T, d) f32
//   with (e, ft) = divmod(idx[t, i], F / tile)
//
// On the port's paths it is the down-projection of the grouped-gather MoE
// FFN (models/moe.py apply_moe_gathered), after expert_up_matmul and the
// activation, with each token's routing gate folded into its blocks. The
// stacked (E, F, d) weight viewed as one (E * F, d) matrix puts global tile
// id ti at rows ti * tile, so no expert arithmetic is needed.
//
// What bounds it on the H100: the weight bytes of the routed experts, each
// distinct listed tile (tile x d, 1.5 MB in bf16 at Mixtral-8x22B width)
// read once: 1.6 GB, 0.48 ms at 3.35 TB/s when a batch routes to all 8.
//
// Two routines, chosen by the weights' dtype:
// - bf16 weights: tile_groups (tile_group.cuh) on tensor cores, with runs of
//   tiles_per_expert tile ids, so a run is one expert and a chunk holds up to
//   64 tokens routed to it: each routed expert's tiles are read once per
//   chunk and 128-column block. Per token the experts' partials are summed
//   in ascending expert id (with top-2 a token has two, and a + b == b + a,
//   so that equals routing order). f32 blocks (the reference's promoted dot
//   keeps them unrounded) go through three bf16 terms each, split once
//   per ring stage; bf16 blocks are taken as they are. The three terms'
//   mma, not the bytes, hold the f32 case (PERF.md).
// - f32 weights: the CUDA-core row gather of common.cuh in compact mode (the
//   f32 parity path; no time is claimed): blocks of 16 tokens walk runs of
//   list slots in list order, a second launch sums the runs in order.
#include "tile_group.cuh"

// f32 compact (T, K, tile); f32 w (E, F, D) stacked, D even; idx (T, K) i32
// global tile ids below E * F / tile; nvalid (T,) i32; scratch
// (T, ceil(K / run), D) f32, or NULL when run >= K -> y (T, D) f32.
extern "C" int expert_down_matmul(const void* compact, const void* w, const void* idx,
                                  const void* nvalid, void* scratch, void* y, int T, int K,
                                  int tile, int D, int run, void* stream) {
  return (int)launch_tile_gather_rows((const float*)compact, (long)K * tile, 1,
                                      (const float*)w, (const int*)idx, K, (const int*)nvalid,
                                      1, (float*)scratch, (float*)y, T, K, run, tile, D,
                                      (cudaStream_t)stream);
}

// compact (T, K, tile) f32 (three bf16 terms) or bf16; bf16 w (E, F, D), D %
// 8 == 0, tile % 16 == 0; idx, nvalid as above; runs of R tile ids, n_runs =
// ceil(E * F / tile / R) <= 64. With one run mask and P may be NULL; else
// mask (T,) u64 and P (n_runs * T, D) f32 are scratch; w_rows = E * F -> y
// (T, D) f32.
extern "C" int expert_down_matmul_tc(const void* compact, const void* w, const void* idx,
                                     const void* nvalid, void* mask, void* P, void* y, int T,
                                     int K, int tile, int D, int n_runs, int R, int c_dtype,
                                     int w_rows, void* stream) {
  const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
  const int *ix = (const int*)idx, *nv = (const int*)nvalid;
  unsigned long long* m = (unsigned long long*)mask;
  cudaStream_t s = (cudaStream_t)stream;
  const long row = (long)K * tile;
  if (c_dtype == DT_F32)
    return (int)launch_tile_groups<float, 128>((const float*)compact, row, 1, wb, w_rows, ix, K,
                                               nv, n_runs, m, (float*)P, (float*)y, T, R, tile,
                                               D, s);
  if (c_dtype == DT_BF16)
    return (int)launch_tile_groups<__nv_bfloat16, 128>((const __nv_bfloat16*)compact, row, 1, wb,
                                                       w_rows, ix, K, nv, n_runs, m, (float*)P,
                                                       (float*)y, T, R, tile, D, s);
  return (int)cudaErrorInvalidValue;
}
