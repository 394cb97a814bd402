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
//
// What bounds it on the H100: the weight bytes, each tile that some row
// lists read once (134 MB at OPT-6.7B width with full lists, 0.040 ms at
// 3.35 TB/s); the operations (2 x listed slots x tile x d) are far below
// the tensor cores' rate.
//
// Two routines, chosen by the inputs:
// - bf16 x and w with tile 128: up_tiles (up_tiles.cuh) on tensor cores. A
//   block owns one weight tile and up to 64 of the rows that list it, found
//   on the device (ut_rows' bitmap, a ballot ranking): the tile is read once
//   per chunk of rows, through TMA into an mbarrier ring, multiplied with
//   wgmma, and written to every valid slot naming it. ffn_up, which this
//   replaces for bf16, read a tile once per token unless 8 tokens named it at
//   the same slot, with narrow loads on CUDA cores (6% of the memory rate).
// - otherwise (f32, or another tile): ffn_up (ffn_up.cuh) with the identity
//   activation, no second projection and no mask, so its dot products are
//   summed in the order fused_sparse_ffn sums them: in f32 the unfused pair
//   (this kernel, then sparse_matmul_tokens) gives the fused kernel's result
//   bit for bit. In bf16 the pair and fused_sparse_ffn run the same two
//   routines (up_tiles.cuh, then tile_group.cuh): h is the same bit for
//   bit, y agrees within the bf16 tolerance, since the fused kernel's down
//   half sums runs of tile ids (run_sum) where sparse_matmul_tokens walks
//   one run: max |diff| 1.7e-6 of 4.3 at T = 8 with full lists
//   (chip_smoke.py on one H100, PERF.md).
#include "ffn_up.cuh"
#include "up_tiles.cuh"

// x (T, d); w (d, F); idx (T, K) i32; nvalid (T,) i32 -> compact (T, K, tile)
// f32, every element written. x and w share one dtype. bf16 with tile 128:
// bits (ceil(F / 128 / 32), T) i32 scratch, x and w 16-byte aligned, d % 8
// == 0. Otherwise bits is unused.
extern "C" int sparse_up_matmul(const void* x, const void* w, const void* idx,
                                const void* nvalid, void* bits, void* compact, int T, int d,
                                int F, int K, int tile, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* out = (float*)compact;
  cudaError_t e;
  if (dtype == DT_BF16 && tile == UT_BN) {
    UtArgs a = {};
    a.x = (const __nv_bfloat16*)x;
    a.T = T, a.d = d, a.F = F;
    a.bits = (unsigned*)bits, a.idx = ix, a.nvalid = nv, a.K = K;
    a.compact = out;
    e = launch_up_tiles(a, (const __nv_bfloat16*)w, nullptr, s);
  } else if (dtype == DT_F32) {
    e = launch_up((const float*)x, (const float*)w, (const float*)nullptr, nullptr, ix, nv, out,
                  T, d, F, K, tile, F / tile, ACT_IDENTITY, 0.f, s);
  } else if (dtype == DT_BF16) {
    e = launch_up((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                  (const __nv_bfloat16*)nullptr, nullptr, ix, nv, out, T, d, F, K, tile,
                  F / tile, ACT_IDENTITY, 0.f, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
