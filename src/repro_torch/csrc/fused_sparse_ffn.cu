// fused_sparse_ffn: gather-up -> activation -> scatter-down decode FFN for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:fused_sparse_ffn
// (one pallas_call, grid (T, K) with K sequential, the output row resident
// in VMEM across the tile list). For token t and list slot i < nvalid[t]:
//
//   h = act(x_t @ Wg[:, tile_i]) [* (x_t @ Wu[:, tile_i])] [* mask[t, tile_i]]
//   h_compact[t, i] = h                      (zeros for i >= nvalid[t])
//   y_t += round_to<W>(h) @ Wd[tile_i, :]    in list order, f32
//
// Design. Hopper blocks run in no order, so the TPU's carried output block
// becomes launches on one stream: ffn_up writes h_compact (an output anyway)
// with one block per (group of 8 tokens, slot); the down-projection
// (launch_tile_gather_rows in common.cuh) walks consecutive runs of the list
// in list order, one run per block, and then sums the runs in order, with
// no atomics. Recomputing h per output chunk would multiply the
// up-projection work; the round trip of h_compact costs 2*T*K*tile*4 bytes
// and the run scratch stays under 9 MB, small beside the weights.
//
// What bounds it on the H100: weight bytes. At OPT-6.7B decode each token
// needs (2 or 3) x nvalid x tile x d weight bytes per layer; the minimum for
// a step is each gathered tile read once from HBM (about 268 MB per layer
// at full density, MLP). Both launches serve a group of tokens from one read
// of a tile whenever the group's lists name the same tile at a slot — the
// common case under γ-window reuse, where a refresh step lists every tile —
// and fall back to one read per token otherwise. CUDA-core f32 FMAs; no
// tensor cores yet.
#include "ffn_up.cuh"

// x (T, d); w_gate / w_up (d, F) (w_up may be NULL: plain MLP); wd (F, d_out),
// d_out even; mask (T, F) f32 or NULL; idx (T, K) i32; nvalid (T,) i32;
// scratch (T, ceil(K / run), d_out) f32, or NULL when run >= K. Outputs:
// h_compact (T, K, tile) f32,
// y (T, d_out) f32. x and the weights share one dtype.
extern "C" int fused_sparse_ffn(const void* x, const void* w_gate, const void* w_up,
                                const void* wd, const void* mask, const void* idx,
                                const void* nvalid, void* h_compact, void* scratch, void* y,
                                int T, int d, int F, int d_out, int K, int run, int tile,
                                int dtype,
                                int act, float act_param, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  const int* nv = (const int*)nvalid;
  const float* m = (const float*)mask;
  float* hc = (float*)h_compact;
  cudaError_t e;
  if (dtype == DT_F32) {
    e = launch_up((const float*)x, (const float*)w_gate, (const float*)w_up, m, ix, nv, hc, T,
                  d, F, K, tile, F / tile, act, act_param, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_tile_gather_rows((const float*)hc, (long)K * tile, 1, (const float*)wd, ix, K, nv,
                                1, (float*)scratch, (float*)y, T, K, run, tile, d_out, s);
  } else if (dtype == DT_BF16) {
    e = launch_up((const __nv_bfloat16*)x, (const __nv_bfloat16*)w_gate,
                  (const __nv_bfloat16*)w_up, m, ix, nv, hc, T, d, F, K, tile, F / tile, act,
                  act_param, s);
    if (e != cudaSuccess) return (int)e;
    e = launch_tile_gather_rows((const float*)hc, (long)K * tile, 1,
                                (const __nv_bfloat16*)wd, ix, K, nv, 1, (float*)scratch,
                                (float*)y, T, K, run, tile, d_out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
