// expert_down_matmul: expert-offset down-projection gather for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:expert_down_matmul
// (a pallas_call over grid (T, d / block_d, K) with K sequential and the
// token's output block resident while its listed blocks accumulate):
//
//   y[t] = sum over i < nvalid[t], in list order, of
//          compact[t, i, :] @ w[e, ft * tile : (ft + 1) * tile, :]   (T, d) f32
//   with (e, ft) = divmod(idx[t, i], F / tile)
//
// On the port's paths it is the down-projection of the grouped-gather MoE
// FFN (models/moe.py apply_moe_gathered), after expert_up_matmul and the
// activation, with each token's routing gate folded into its blocks.
//
// The shared row gather of common.cuh in its compact mode: the stacked
// (E, F, d) weight viewed as one (E * F, d) matrix puts global tile id ti at
// rows ti * tile, so no expert arithmetic is needed. Blocks of 16 tokens walk
// consecutive runs of the lists in list order and a second launch sums the
// runs in order (scratch under 9 MB, kernels/runtime.py gather_runs).
//
// Types: (f32 compact, f32 w), (bf16, bf16), and (f32 compact, bf16 w). In the
// last the reference's mixed dot promotes the bf16 weights to f32 and keeps
// compact unrounded, so the gather runs with ROUND_X = false.
//
// What bounds it on the H100: weight bytes, each distinct listed tile (tile x
// d, 1.5 MB in bf16 at Mixtral-8x22B width) once at best; a block reads a
// tile once for its 16 tokens when they name the same tile at a slot, else
// once per token. CUDA-core f32 FMAs; no tensor cores.
#include "common.cuh"

// compact (T, K, tile) f32 or bf16; w (E, F, D) stacked, D even; idx (T, K)
// i32 global tile ids below E * F / tile; nvalid (T,) i32; scratch
// (T, ceil(K / run), D) f32, or NULL when run >= K -> y (T, D) f32.
extern "C" int expert_down_matmul(const void* compact, const void* w, const void* idx,
                                  const void* nvalid, void* scratch, void* y, int T, int K,
                                  int tile, int D, int run, int c_dtype, int w_dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  float* P = (float*)scratch;
  float* out = (float*)y;
  const long row = (long)K * tile;
  cudaError_t e;
  if (c_dtype == DT_F32 && w_dtype == DT_F32)
    e = launch_tile_gather_rows((const float*)compact, row, 1, (const float*)w, ix, K, nv, 1, P,
                                out, T, K, run, tile, D, s);
  else if (c_dtype == DT_BF16 && w_dtype == DT_BF16)
    e = launch_tile_gather_rows((const __nv_bfloat16*)compact, row, 1, (const __nv_bfloat16*)w,
                                ix, K, nv, 1, P, out, T, K, run, tile, D, s);
  else if (c_dtype == DT_F32 && w_dtype == DT_BF16)
    e = launch_tile_gather_rows<float, __nv_bfloat16, false>(
        (const float*)compact, row, 1, (const __nv_bfloat16*)w, ix, K, nv, 1, P, out, T, K, run,
        tile, D, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
