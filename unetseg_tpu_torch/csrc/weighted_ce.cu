// weighted_ce: the train loss's fused weighted softmax cross-entropy.
//
//   forward   out[p]         = (logsumexp(logits[p, :]) - logits[p, t]) * w
//   backward  dlogits[p, c]  = (softmax(logits[p, :])[c] - [c == t]) * w * g[p]
//
// with t and w read from the UNCROPPED (B, Ht, Wt) target and weight frames
// at (row_off + y, col_off + x): the train step's center crop costs no copy.
//
// Replaces the TPU kernels unetseg_tpu/ops/pallas/wce.py:_call_fwd and
// :_call_bwd (the train step's logits (4, 324, 324, C) f32, C = 2, or 3 with
// --three-class; targets int32 and weights f32 (4, 512, 512)). The arithmetic
// is theirs in f32, max-shifted, with d_logits written in the logits' dtype
// as _bwd_kernel writes them, in the form of a log-softmax and its gradient
// (the JAX step's default loss, which the plain version in
// ops/kernels/wce.py computes): with z = logit - max and
// ls = log(sum(exp(z))), loss = (ls - z_t) * w and
// d_c = exp(z_c - ls) * wg - [c == t] wg, each product and difference
// rounded on its own (__fmul_rn / __fsub_rn: no FMA). ops/kernels/wce.py
// says why this form and not _bwd_kernel's (e / sum(e) - onehot) * wg.
//
// Both passes are bound by memory: per pixel the forward reads C logits and
// a target and a weight and writes one f32 (8.4 MB at the train step's
// shapes), the backward also reads g and writes C values (11.8 MB); a few
// microseconds at 3.35 TB/s. One thread per pixel, consecutive threads on
// consecutive pixels, so every load and store is coalesced; a pixel's C
// classes are looped over and re-read from L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Geo {
  int B, H, W, C, Ht, Wt, row_off, col_off;
};

// index of logits pixel i = (b, y, x) in the uncropped target / weight frame
__device__ __forceinline__ size_t frame_index(size_t i, const Geo& g) {
  const size_t hw = (size_t)g.H * g.W;
  const int b = (int)(i / hw);
  const int r = (int)(i % hw);
  const int y = r / g.W, x = r % g.W;
  return ((size_t)b * g.Ht + (y + g.row_off)) * g.Wt + (x + g.col_off);
}

template <typename T>
__device__ __forceinline__ float row_max(const T* lg, int C) {
  float m = to_f(lg[0]);
  for (int c = 1; c < C; ++c) m = fmaxf(m, to_f(lg[c]));
  return m;
}

template <typename T>
__global__ void wce_fwd_kernel(const T* __restrict__ logits,
                               const int* __restrict__ targets,
                               const float* __restrict__ weights, Geo g,
                               float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)g.B * g.H * g.W) return;
  const T* lg = logits + i * g.C;
  const size_t f = frame_index(i, g);
  const int t = targets[f];
  const float m = row_max(lg, g.C);
  float s = 0.f, zt = 0.f;
  for (int c = 0; c < g.C; ++c) {
    const float z = to_f(lg[c]) - m;
    s += expf(z);
    if (c == t) zt = z;  // a target outside [0, C) picks nothing, as the one-hot
  }
  out[i] = (logf(s) - zt) * weights[f];
}

template <typename T>
__global__ void wce_bwd_kernel(const T* __restrict__ logits,
                               const int* __restrict__ targets,
                               const float* __restrict__ weights,
                               const float* __restrict__ gin, Geo g,
                               T* __restrict__ dlogits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)g.B * g.H * g.W) return;
  const T* lg = logits + i * g.C;
  const size_t f = frame_index(i, g);
  const int t = targets[f];
  const float m = row_max(lg, g.C);
  float s = 0.f;
  for (int c = 0; c < g.C; ++c) s += expf(to_f(lg[c]) - m);
  const float ls = logf(s);
  const float wg = weights[f] * gin[i];
  T* d = dlogits + i * g.C;
  for (int c = 0; c < g.C; ++c) {
    const float pwg = __fmul_rn(expf((to_f(lg[c]) - m) - ls), wg);
    store(d + c, c == t ? __fsub_rn(pwg, wg) : pwg);
  }
}

unsigned blocks_for(const Geo& g, int threads) {
  const size_t n = (size_t)g.B * g.H * g.W;
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// logits (B,H,W,C) f32 (is_bf16 = 0) or bf16 (1), contiguous; targets
// (B,Ht,Wt) int32 and weights (B,Ht,Wt) f32 read at (row_off, col_off) ->
// out (B,H,W) f32. Returns the launch's CUDA error.
extern "C" int weighted_ce_fwd(const void* logits, int is_bf16,
                               const void* targets, const void* weights, int B,
                               int H, int W, int C, int Ht, int Wt,
                               int row_off, int col_off, void* out,
                               void* stream) {
  const Geo g{B, H, W, C, Ht, Wt, row_off, col_off};
  const int threads = 256;
  const unsigned blocks = blocks_for(g, threads);
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    wce_fwd_kernel<<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)logits, (const int*)targets,
        (const float*)weights, g, (float*)out);
  else
    wce_fwd_kernel<<<blocks, threads, 0, st>>>(
        (const float*)logits, (const int*)targets, (const float*)weights, g,
        (float*)out);
  return (int)cudaGetLastError();
}

// As weighted_ce_fwd, plus g (B,H,W) f32, the loss's cotangent per pixel ->
// dlogits (B,H,W,C) in the logits' dtype.
extern "C" int weighted_ce_bwd(const void* logits, int is_bf16,
                               const void* targets, const void* weights,
                               const void* gin, int B, int H, int W, int C,
                               int Ht, int Wt, int row_off, int col_off,
                               void* dlogits, void* stream) {
  const Geo g{B, H, W, C, Ht, Wt, row_off, col_off};
  const int threads = 256;
  const unsigned blocks = blocks_for(g, threads);
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    wce_bwd_kernel<<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)logits, (const int*)targets,
        (const float*)weights, (const float*)gin, g, (__nv_bfloat16*)dlogits);
  else
    wce_bwd_kernel<<<blocks, threads, 0, st>>>(
        (const float*)logits, (const int*)targets, (const float*)weights,
        (const float*)gin, g, (float*)dlogits);
  return (int)cudaGetLastError();
}
