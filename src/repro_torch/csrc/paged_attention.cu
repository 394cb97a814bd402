// paged_window_attention: attention of a W-token window read straight off
// the paged KV pool through the block table, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_window_attention (pallas_call, grid (b, nb) with the block axis
// sequential, the table as scalar prefetch, (m, l, acc) in VMEM scratch).
// Serving uses it for W = 1 decode (paged_decode_attention) and for the
// W-token chunked-prefill window.
//
// Semantics, as the reference's: q is scaled in its own dtype (q * scale
// rounded to q's dtype), logits and P@V accumulate in f32 with p rounded to
// the cache dtype for the product, query row r of the window attends to
// cache positions <= pos[t, r] (and > pos - window with a sliding window),
// masked probabilities are zeroed explicitly, and the output is
// acc / max(l, 1e-30) in q's dtype.
//
// Design. One block per (slot, kv head) runs the online softmax over that
// slot's blocks in sequence order — the loop inside the block replaces the
// TPU's sequential grid axis. Each K/V block (bs x hd) is staged in shared
// memory once and serves every query row of the window (W x g rows: the
// GQA group and the window share one read). Blocks wholly past the
// window's last position (or wholly before a sliding window) would
// contribute exactly nothing, so they are not read at all: table padding
// that points at the scratch block costs no bytes.
//
// What bounds it on the H100: the cache bytes (each owned K and V block
// read once); the work per byte is a few FLOPs.
#include "common.cuh"

#define ATT_THREADS 128

// grid (b, kvp); block ATT_THREADS. Dynamic shared memory (floats):
// q[R*hd] acc[R*hd] k[bs*hd] v[bs*hd] s[R*bs] m[R] l[R] corr[R], R = W*g.
template <typename T>
__global__ void paged_window_attn(const T* __restrict__ q, const T* __restrict__ kp,
                                  const T* __restrict__ vp, const int* __restrict__ table,
                                  const int* __restrict__ pos, T* __restrict__ out, int W,
                                  int kvp, int g, int hd, int bs, int nb, int window,
                                  float scale) {
  extern __shared__ float sm[];
  const int R = W * g;
  float* qs = sm;
  float* acc = qs + R * hd;
  float* ks = acc + R * hd;
  float* vs = ks + bs * hd;
  float* sc = vs + bs * hd;
  float* mr = sc + R * bs;
  float* lr = mr + R;
  float* cr = lr + R;
  const int t = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const float scale_q = round_to<T>(scale);  // the scale in q's dtype

  // q rows r = w * g + gi of head h; scaled in q's dtype
  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, c = e % hd, w = r / g, gi = r % g;
    const long qi = ((((long)t * W + w) * kvp + h) * g + gi) * hd + c;
    qs[e] = round_to<T>(to_f32(q[qi]) * scale_q);
    acc[e] = 0.f;
  }
  int pmax = -1, pmin = 0x7fffffff;
  for (int w = 0; w < W; ++w) {
    const int p = pos[(long)t * W + w];
    pmax = max(pmax, p);
    pmin = min(pmin, p);
  }
  for (int r = tid; r < R; r += blockDim.x) {
    mr[r] = -1e30f;
    lr[r] = 0.f;
  }
  __syncthreads();

  const long blk_elems = (long)kvp * bs * hd;
  for (int j = 0; j < nb; ++j) {
    const int k0 = j * bs;
    if (k0 > pmax) break;                               // wholly causal-masked
    if (window && k0 + bs - 1 <= pmin - window) continue;  // wholly before the window
    const long base = (long)table[(long)t * nb + j] * blk_elems + (long)h * bs * hd;
    for (int e = tid; e < bs * hd; e += blockDim.x) {
      ks[e] = to_f32(kp[base + e]);
      vs[e] = to_f32(vp[base + e]);
    }
    __syncthreads();
    // logits: one warp per (row, key), lanes split hd
    for (int pr = warp; pr < R * bs; pr += nwarp) {
      const int r = pr / bs, s = pr % bs;
      float d = 0.f;
      for (int c = lane; c < hd; c += 32) d += qs[r * hd + c] * ks[s * hd + c];
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) sc[pr] = d;
    }
    __syncthreads();
    // online softmax update, one thread per row
    for (int r = tid; r < R; r += blockDim.x) {
      const int qp = pos[(long)t * W + r / g];
      float mx = mr[r];
      for (int s = 0; s < bs; ++s) {
        const int kpos = k0 + s;
        const bool valid = kpos <= qp && (!window || kpos > qp - window);
        mx = fmaxf(mx, valid ? sc[r * bs + s] : -1e30f);
      }
      float lsum = 0.f;
      for (int s = 0; s < bs; ++s) {
        const int kpos = k0 + s;
        const bool valid = kpos <= qp && (!window || kpos > qp - window);
        const float p = valid ? expf(sc[r * bs + s] - mx) : 0.f;
        lsum += p;
        sc[r * bs + s] = round_to<T>(p);  // p in the cache dtype for P@V
      }
      const float corr = expf(mr[r] - mx);
      lr[r] = lr[r] * corr + lsum;
      cr[r] = corr;
      mr[r] = mx;
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += blockDim.x) {
      const int r = e / hd, c = e % hd;
      float pv = 0.f;
      for (int s = 0; s < bs; ++s) pv += sc[r * bs + s] * vs[s * hd + c];
      acc[e] = acc[e] * cr[r] + pv;
    }
    __syncthreads();
  }
  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, c = e % hd, w = r / g, gi = r % g;
    const long oi = ((((long)t * W + w) * kvp + h) * g + gi) * hd + c;
    out[oi] = from_f32<T>(acc[e] / fmaxf(lr[r], 1e-30f));
  }
}

template <typename T>
static cudaError_t launch_attn(const T* q, const T* kp, const T* vp, const int* table,
                               const int* pos, T* out, int b, int W, int kvp, int g, int hd,
                               int bs, int nb, int window, float scale, cudaStream_t s) {
  const int R = W * g;
  size_t smem = (size_t)(2 * R * hd + 2 * bs * hd + R * bs + 3 * R) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_window_attn<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (b > 0 && kvp > 0)
    paged_window_attn<T><<<dim3(b, kvp), ATT_THREADS, smem, s>>>(q, kp, vp, table, pos, out, W,
                                                                 kvp, g, hd, bs, nb, window,
                                                                 scale);
  return cudaGetLastError();
}

// q (b, W, kvp, g, hd); k/v pages (n_blocks, kvp, bs, hd); table (b, nb) i32;
// pos (b, W) i32 -> out (b, W, kvp, g, hd). q, pages and out share one dtype.
extern "C" int paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* pos, void* out, int b,
                                      int W, int kvp, int g, int hd, int bs, int nb,
                                      int window, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_attn((const float*)q, (const float*)k_pages, (const float*)v_pages,
                    (const int*)table, (const int*)pos, (float*)out, b, W, kvp, g, hd, bs, nb,
                    window, scale, s);
  else if (dtype == DT_BF16)
    e = launch_attn((const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
                    (const __nv_bfloat16*)v_pages, (const int*)table, (const int*)pos,
                    (__nv_bfloat16*)out, b, W, kvp, g, hd, bs, nb, window, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}
