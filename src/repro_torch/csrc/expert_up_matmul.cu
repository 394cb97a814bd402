// expert_up_matmul: expert-offset up-projection gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:expert_up_matmul
// (a pallas_call over grid (T, K) whose scalar-prefetched tile list picks the
// expert and the column block of the stacked weight; slots past nvalid write
// zeros):
//
//   compact[t, i, :] = x_t @ w[e, :, ft * tile : (ft + 1) * tile],
//   (e, ft) = divmod(idx[t, i], F / tile), for i < nvalid[t]; zeros past it
//
// The lists come from expert_tile_lists (kernels/sparse_matmul.py): token t
// lists the tpe = F / tile tiles of each of its top-k experts in routing
// order, so K = top_k * tpe. On the port's paths it is the up-projection of
// the grouped-gather MoE FFN (models/moe.py apply_moe_gathered).
//
// It is ffn_up (ffn_up.cuh) with the identity activation, no second
// projection and no mask, reading tile id ti at tile_base(ti): matrix ti / tpe
// of the stack, columns (ti % tpe) * tile onwards, row stride F.
//
// What bounds it on the H100: weight bytes, each listed tile (d x tile) once
// per distinct (expert, tile) of the batch at best; at Mixtral-8x22B width a
// tile is 1.5 MB in bf16 and the 8 experts' stacked w holds 1.6 GB. A block
// serves 8 tokens and reads a tile once for all of them when they name the
// same tile at a slot (the same expert at that routing rank), else once per
// token (L2 catches part of the repeats). CUDA-core f32 FMAs; no tensor cores.
#include "ffn_up.cuh"

// x (T, d); w (E, d, F) stacked; idx (T, K) i32 global tile ids below
// E * F / tile; nvalid (T,) i32 -> compact (T, K, tile) f32, every element
// written. x and w share one dtype; F % tile == 0.
extern "C" int expert_up_matmul(const void* x, const void* w, const void* idx,
                                const void* nvalid, void* compact, int T, int d, int F, int K,
                                int tile, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* out = (float*)compact;
  if (tile < 1 || F % tile) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_up((const float*)x, (const float*)w, (const float*)nullptr, nullptr, ix, nv, out,
                  T, d, F, K, tile, F / tile, ACT_IDENTITY, 0.f, s);
  else if (dtype == DT_BF16)
    e = launch_up((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                  (const __nv_bfloat16*)nullptr, nullptr, ix, nv, out, T, d, F, K, tile,
                  F / tile, ACT_IDENTITY, 0.f, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
