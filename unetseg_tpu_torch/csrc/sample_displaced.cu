// sample_displaced: the elastic augmentation's resampler. For every output
// pixel, the image sampled bilinearly and the label mask sampled nearest at
// an absolute coordinate (yy, xx), with scipy's 'reflect' boundary
// (d c b a | a b c d | d c b a) for taps outside the frame.
//
// Replaces the TPU kernel unetseg_tpu/ops/pallas/elastic.py:sample_displaced
// (the train step's images and masks (4,512,512), coordinates (4,512,512)
// f32), and is held to the f32 gather path of
// unetseg_tpu/ops/elastic.py:elastic_deform_batch, not to the TPU kernel's
// bf16 one-hot matmuls: the same taps, the same weights, the same product
// order, and the nearest tap by round-half-to-even (rintf, as jnp.round).
//
// Per pixel: 8 bytes of coordinates in, 4 image taps and 1 label tap
// gathered, 8 bytes out; a 4 x 512^2 batch moves ~25 MB, so the kernel is
// bound by memory latency on the gathers. The displacement field is smooth,
// so neighbouring threads gather from neighbouring source pixels and the
// taps mostly hit L1/L2. One thread per output pixel, consecutive threads on
// consecutive columns; reflection is computed in-kernel on the unpadded
// frame, so the reflect-padded pack the TPU path builds is never written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect(int i, int n) {
  // scipy 'reflect' for any integer index: period 2n, mirrored half
  int m = i % (2 * n);
  if (m < 0) m += 2 * n;
  return m >= n ? 2 * n - 1 - m : m;
}

__global__ void sample_displaced_kernel(const float* __restrict__ img,
                                        const int* __restrict__ mask,
                                        const float* __restrict__ yy,
                                        const float* __restrict__ xx, int B,
                                        int H, int W,
                                        float* __restrict__ img_out,
                                        int* __restrict__ mask_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * W) return;
  const int b = (int)(i / ((size_t)H * W));
  const float y = yy[i], x = xx[i];
  const float y0f = floorf(y), x0f = floorf(x);
  const float ty = y - y0f, tx = x - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const int r0 = reflect(y0, H), r1 = reflect(y0 + 1, H);
  const int c0 = reflect(x0, W), c1 = reflect(x0 + 1, W);
  const float* im = img + (size_t)b * H * W;
  const float p00 = im[(size_t)r0 * W + c0], p01 = im[(size_t)r0 * W + c1];
  const float p10 = im[(size_t)r1 * W + c0], p11 = im[(size_t)r1 * W + c1];
  // the gather path's order: ((p * (1 - ty)) * (1 - tx)), summed left to right
  const float v = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(p00, 1.f - ty), 1.f - tx),
                          __fmul_rn(__fmul_rn(p01, 1.f - ty), tx)),
                __fmul_rn(__fmul_rn(p10, ty), 1.f - tx)),
      __fmul_rn(__fmul_rn(p11, ty), tx));
  img_out[i] = v;
  // nearest: the +1 row / column of the patch when round(coord) > floor
  const int rn = rintf(y) > y0f ? r1 : r0;
  const int cn = rintf(x) > x0f ? c1 : c0;
  mask_out[i] = mask[(size_t)b * H * W + (size_t)rn * W + cn];
}

}  // namespace

// img (B,H,W) f32, mask (B,H,W) int32, yy/xx (B,H,W) f32 absolute
// coordinates -> img_out (B,H,W) f32, mask_out (B,H,W) int32. Returns the
// launch's CUDA error.
extern "C" int sample_displaced_f32(const void* img, const void* mask,
                                    const void* yy, const void* xx, int B,
                                    int H, int W, void* img_out,
                                    void* mask_out, void* stream) {
  const size_t n = (size_t)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sample_displaced_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)mask, (const float*)yy,
      (const float*)xx, B, H, W, (float*)img_out, (int*)mask_out);
  return (int)cudaGetLastError();
}
