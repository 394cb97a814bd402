// fused_sparse_ffn: gather-up -> activation -> scatter-down decode FFN for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py:fused_sparse_ffn
// (one pallas_call, grid (T, K) with K sequential, the output row resident
// in VMEM across the tile list). For token t and list slot i < nvalid[t]:
//
//   h = act(x_t @ Wg[:, tile_i]) [* (x_t @ Wu[:, tile_i])] [* mask[t, tile_i]]
//   h_compact[t, i] = h                      (zeros for i >= nvalid[t])
//   y_t += round_to<W>(h) @ Wd[tile_i, :]    f32, one product per valid slot
//
// Hopper blocks run in no order, so the TPU's carried output block becomes
// launches on one stream: an up half writes h_compact (an output anyway),
// a down half gathers the down-projection rows. Recomputing h per output
// block would multiply the up-projection work; the round trip of h costs
// T * K * tile * 6 bytes (f32 and a bf16 copy), small beside the weights.
//
// What bounds it on the H100: weight bytes. At OPT-6.7B decode the minimum
// for a step is each gathered tile of Wg [and Wu] and Wd read once from
// HBM (268 MB per layer at full density, MLP: 0.080 ms at 3.35 TB/s).
//
// Two routines, chosen by the inputs:
// - bf16 with tile 128: the two tensor-core routines the unfused predictor
//   pair runs. (a) Up half: up_tiles (up_tiles.cuh) in list mode. Block
//   (c, j) reads tile j of Wg [and Wu] once for the up to 64 rows whose
//   lists name it, through TMA into an mbarrier ring, multiplies with
//   wgmma, and its epilogue applies the activation, the GLU product and the
//   unit mask, writing h to every valid slot naming j, in f32 (h_compact)
//   and as a bf16 copy, which is the reference's h.astype(wd.dtype). (b)
//   Down half: tile_groups (tile_group.cuh) in compact mode over the bf16
//   copy, kernel 10's routine with one matrix: a block reads each tile of
//   Wd that its rows list once for all of them (a repeated tile once per
//   slot), multiplied with mma.sync. At decode (T = 8) one chunk of rows
//   gives only D / 128 column blocks, 32 at OPT width for 132 SMs, so the
//   wrapper cuts the tile ids into n_runs runs (kernels/fused_decode.py
//   down_runs), each a block of its own, and run_sum adds a row's runs in
//   ascending order. No host sync: ut_rows, up_tiles, row_runs,
//   tile_groups and run_sum on one stream. What the card showed
//   (chip_smoke.py on one H100, PERF.md): at OPT-6.7B decode, MLP + mask,
//   full lists, 0.114 ms against 0.353 for the CUDA-core pair this
//   replaces and 0.100 for the library's dense chain; one wave of down
//   blocks beat fewer runs (too few SMs busy) and more (two waves of one
//   block an SM), so down_runs aims at one wave. The halves run one after
//   the other, since the down half needs every h.
// - otherwise (f32, the parity path, where engine streams on the card must
//   equal the CPU's; or another tile): ffn_up (ffn_up.cuh), one block per
//   (group of 8 tokens, slot), then the CUDA-core row gather
//   (launch_tile_gather_rows, common.cuh) walking runs of the list in list
//   order and summing the runs in order. In f32 this is the unfused pair's
//   arithmetic bit for bit (sparse_up_matmul, sparse_matmul_tokens).
#include "ffn_up.cuh"
#include "up_tiles.cuh"

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

// bf16 x (T, d), w_gate / w_up (d, F) (w_up may be NULL: plain MLP), wd (F,
// d_out); tile 128, d % 8 == 0, d_out % 8 == 0, all 16-byte aligned; mask
// (T, F) f32 (16-byte aligned) or NULL; idx (T, K), nvalid (T,) i32; runs of
// R tile ids, n_runs = ceil(F / 128 / R) <= 64, R <= 128. Scratch: bits
// (ceil(F / 128 / 32), T) i32 and hb (T, K, 128) bf16; with n_runs > 1 also
// runs (T,) u64 and P (n_runs * T, d_out) f32, else both may be NULL.
// Outputs: h_compact (T, K, 128) f32, y (T, d_out) f32.
extern "C" int fused_sparse_ffn_tc(const void* x, const void* w_gate, const void* w_up,
                                   const void* wd, const void* mask, const void* idx,
                                   const void* nvalid, void* bits, void* hb, void* runs, void* P,
                                   void* h_compact, void* y, int T, int d, int F, int d_out,
                                   int K, int n_runs, int R, int act, float act_param,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  UtArgs a = {};
  a.x = (const __nv_bfloat16*)x;
  a.T = T, a.d = d, a.F = F;
  a.bits = (unsigned*)bits, a.idx = (const int*)idx, a.nvalid = (const int*)nvalid, a.K = K;
  a.compact = (float*)h_compact;
  a.act = act, a.prm = act_param, a.mask = (const float*)mask;
  a.hb = (__nv_bfloat16*)hb;
  cudaError_t e =
      launch_up_tiles(a, (const __nv_bfloat16*)w_gate, (const __nv_bfloat16*)w_up, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tile_groups<__nv_bfloat16, 128>(
      a.hb, (long)K * UT_BN, 1, (const __nv_bfloat16*)wd, (long)F, a.idx, K, a.nvalid, n_runs,
      (unsigned long long*)runs, (float*)P, (float*)y, T, R, UT_BN, d_out, s);
}
