// sparse_up_matmul: output-tile gathered up-projection for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:sparse_up_matmul
// (a pallas_call over grid (T, K) whose scalar-prefetched tile list picks
// the weight's column block; padded slots zero their block):
//
//   compact[t, i, :] = x_t @ w[:, idx[t, i] * tile : (idx[t, i] + 1) * tile]
//                      for i < nvalid[t], zeros past it       (T, K, tile) f32
//
// The masked scatter-add of the compact buffer into (T, F) is plain torch
// outside the kernel, as it is XLA outside the TPU kernel
// (kernels/fused_decode.py scatter_compact).
//
// On the serving path it is the predictor FFN's up-projection in its
// unfused lowering (models/transformer.py _ffn_decode_predicted, fused=False).
// It is ffn_up (ffn_up.cuh) with the identity activation, no second
// projection and no mask, so every tile's dot products are summed in the
// order fused_sparse_ffn sums them: the unfused pair (this kernel, then
// sparse_matmul_tokens) gives the fused kernel's result bit for bit.
//
// What bounds it on the H100: weight bytes, nvalid x tile x d per token in
// the worst case and each distinct gathered tile once at best. A block
// serves 8 tokens and reads a tile once for all of them when their lists
// name the same tile at a slot, else once per token. CUDA-core f32 FMAs.
#include "ffn_up.cuh"

// x (T, d); w (d, F); idx (T, K) i32; nvalid (T,) i32 -> compact (T, K, tile)
// f32, every element written. x and w share one dtype.
extern "C" int sparse_up_matmul(const void* x, const void* w, const void* idx,
                                const void* nvalid, void* compact, int T, int d, int F, int K,
                                int tile, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* out = (float*)compact;
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
