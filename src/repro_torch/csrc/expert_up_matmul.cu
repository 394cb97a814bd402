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
// the grouped-gather MoE FFN (models/moe.py apply_moe_gathered), run twice
// there (gate and up of the GLU).
//
// What bounds it on the H100: the weight bytes of the routed experts, each
// listed tile (d x tile, 1.5 MB in bf16 at Mixtral-8x22B width) read once:
// the 8 experts' stacked w holds 1.6 GB, 0.48 ms at 3.35 TB/s when a batch
// routes to all of them. The operations, 2 T top_k F d (52 GFLOP at
// T = 128, top-2), take 0.05 ms on bf16 tensor cores (989 TFLOP/s).
//
// Two routines, chosen by the inputs:
// - bf16 x and w with tile 128: up_tiles (up_tiles.cuh) over the stacked
//   weight, its tile ids the global ids (E * tpe = 1024 at Mixtral-8x22B).
//   Block (c, j) owns global tile j and chunk c of the up to 64 tokens whose
//   lists name it, which are the tokens routed to expert j / tpe (every tile
//   of a routed expert is listed): the expert's tile is read once per chunk
//   of its tokens, through TMA (a 3-D map over (F, d, E), so a slab never
//   runs into the next expert's rows), into an mbarrier ring, multiplied
//   with wgmma, and written to the slot of each token naming it; the
//   tokens' x rows come by cp.async. ffn_up, which this replaces for bf16,
//   read a 1.5 MB tile once per (token, slot) unless the 8 tokens of a block
//   named it at the same slot, on CUDA cores: 10.82 ms on the card at
//   T = 128 against 2.57 for the all-experts einsum (PERF.md).
// - otherwise (f32, or another tile): ffn_up (ffn_up.cuh) with the identity
//   activation, no second projection and no mask, reading tile id ti at
//   tile_base(ti): matrix ti / tpe of the stack, columns (ti % tpe) * tile
//   onwards, row stride F (the f32 parity path; no time is claimed).
#include "ffn_up.cuh"
#include "up_tiles.cuh"

// x (T, d); w (E, d, F) stacked; idx (T, K) i32 global tile ids below
// E * F / tile; nvalid (T,) i32 -> compact (T, K, tile) f32, every element
// written. x and w share one dtype; F % tile == 0. bf16 with tile 128: bits
// (ceil(E * F / 128 / 32), T) i32 scratch, x and w 16-byte aligned, d % 8 ==
// 0. Otherwise bits is unused.
extern "C" int expert_up_matmul(const void* x, const void* w, const void* idx,
                                const void* nvalid, void* bits, void* compact, int T, int d,
                                int E, int F, int K, int tile, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* out = (float*)compact;
  if (tile < 1 || F % tile) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == DT_BF16 && tile == UT_BN) {
    UtArgs a = {};
    a.x = (const __nv_bfloat16*)x;
    a.T = T, a.d = d, a.F = F, a.E = E;
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
