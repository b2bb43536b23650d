// tconv2x2_bias: 2x2 stride-2 transposed conv + bias,
// out[b, 2r+dy, 2j+dx, co] = bias[co] + sum_ci x[b, r, j, ci] W[ci, co, dy, dx]
// with W in torch's ConvTranspose2d layout (CI, CO, 2, 2). Flax applies its
// kernel spatially flipped (out[2r+dy, 2j+dx] += Wf[1-dy, 1-dx] x[r, j]);
// utils/flax_bridge.py does that flip when it converts the weights, so
// torch-layout weights give the Flax result here.
//
// Replaces the TPU kernel unetseg_tpu/ops/pallas/conv3x3.py:tconv2x2_phase2
// (up3 on the serving path: (B,260,260,128) -> (B,520,520,64)).
//
// One CI -> 4*CO product per input pixel: 4.4 GFLOP per 700^2 tile against
// 52 MB of traffic. A block takes 4 input rows x 16 columns and all four
// taps: eight warps, each one tap (dy, dx) x two input rows, run
// mma.m16n8k16.bf16 over 32-channel slices staged in shared memory, and
// store the pixel shuffle directly: the warp's lanes write 16 contiguous
// bytes of each output pixel.
#include "conv_mma.cuh"

namespace {

constexpr int TR = 4;  // input rows per block

__global__ void __launch_bounds__(unet::THREADS)
tconv2x2_kernel(const __nv_bfloat16* __restrict__ x, int H, int W, int CI,
                const __nv_bfloat16* __restrict__ w,  // (4, CO, CI)
                const float* __restrict__ bias, int CO,
                __nv_bfloat16* __restrict__ y) {
  using namespace unet;
  __shared__ __align__(16) __nv_bfloat16 in_s[TR * TW * KP];
  __shared__ __align__(16) __nv_bfloat16 w_s[4 * NCO * KP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tap = warp & 3, mrow = (warp >> 2) * 2;
  const int x0 = blockIdx.x * TW, r0 = blockIdx.y * TR;
  const int n_co_blk = CO / NCO;
  const int b = blockIdx.z / n_co_blk;
  const int co0 = (blockIdx.z % n_co_blk) * NCO;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  for (int c = 0; c < CI; c += KC) {
    for (int i = tid; i < TR * TW * (KC / 8); i += THREADS) {
      const int v = i % (KC / 8), pix = i / (KC / 8);
      const int iy = r0 + pix / TW, ix = x0 + pix % TW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (iy < H && ix < W) {
        const size_t off = ((size_t)b * H + iy) * W + ix;
        val = *reinterpret_cast<const uint4*>(x + off * CI + c + v * 8);
      }
      *reinterpret_cast<uint4*>(in_s + pix * KP + v * 8) = val;
    }
    for (int i = tid; i < 4 * NCO * (KC / 8); i += THREADS) {
      const int v = i % (KC / 8), rest = i / (KC / 8);
      const int co = rest % NCO, tp = rest / NCO;
      const size_t off = ((size_t)tp * CO + co0 + co) * CI + c + v * 8;
      *reinterpret_cast<uint4*>(w_s + (tp * NCO + co) * KP + v * 8) =
          *reinterpret_cast<const uint4*>(w + off);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* base = in_s + ((mrow + m) * TW) * KP + kk + 2 * t;
        a[m][0] = ld_u32(base + g * KP);
        a[m][1] = ld_u32(base + (g + 8) * KP);
        a[m][2] = ld_u32(base + g * KP + 8);
        a[m][3] = ld_u32(base + (g + 8) * KP + 8);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* wb = w_s + (tap * NCO + n * 8 + g) * KP + kk + 2 * t;
        uint32_t bf[2] = {ld_u32(wb), ld_u32(wb + 8)};
        mma_bf16_16816(acc[0][n], a[0], bf);
        mma_bf16_16816(acc[1][n], a[1], bf);
      }
    }
    __syncthreads();
  }

  const int dy = tap >> 1, dx = tap & 1;
  const int Ho = 2 * H, Wo = 2 * W;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = r0 + mrow + m;
    if (r >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: pixel column g, h = 1: g + 8
      const int j = x0 + g + 8 * h;
      if (j >= W) continue;
      const size_t off = ((size_t)b * Ho + 2 * r + dy) * Wo + 2 * j + dx;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int co = n * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(y + off * CO + co0 + co) =
            __floats2bfloat162_rn(acc[m][n][2 * h] + bias[co0 + co],
                                  acc[m][n][2 * h + 1] + bias[co0 + co + 1]);
      }
    }
  }
}

}  // namespace

// x (B,H,W,CI) bf16; w (4,CO,CI) bf16 with w[2*dy+dx, co, ci] = W[ci,co,dy,dx];
// bias (CO,) f32 -> y (B,2H,2W,CO) bf16. Returns the launch's CUDA error.
extern "C" int tconv2x2_bias_bf16(const void* x, const void* w,
                                  const void* bias, void* y, int B, int H,
                                  int W, int CI, int CO, void* stream) {
  dim3 grid((W + unet::TW - 1) / unet::TW, (H + TR - 1) / TR,
            B * (CO / unet::NCO));
  tconv2x2_kernel<<<grid, unet::THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, H, W, CI, (const __nv_bfloat16*)w,
      (const float*)bias, CO, (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}
