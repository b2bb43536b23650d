// conv3x3_bias_relu: valid 3x3 conv + bias + ReLU, optionally with the 2x2
// max-pool of the output fused into the epilogue. With relu == 0 it writes
// the pre-activation conv + bias (the train step's pre-BatchNorm z).
//
// Replaces the TPU kernels unetseg_tpu/ops/pallas/conv3x3.py:conv3x3_phase2
// (stem, and enc0 conv1 + pool0 on the serving path; stem, enc0 conv1 and
// dec3 conv1 with relu=False in the train step), conv3x3.py:conv3x3_lanes
// through the conv3x3_dense wrapper (tier-2 enc1 and dec2 convs, enc1
// conv1 with the pool) and conv_cblock.py:conv3x3_cblock through the
// conv3x3_cblock wrapper (the middle convs with CO % 128 == 0). The TPU
// needed three kernels for three layouts; on NHWC they are one function.
//
// CI >= 32 (enc0 conv1, 64 -> 64 channels at 696^2 outputs, up to enc4's
// 1024 -> 1024): the implicit GEMM on wgmma fed by a TMA ring of
// conv_fwd_wgmma.cu, the pool in its epilogue, so the skip is written once
// and never re-read.
//
// CI == 1 (the stem, 1 -> 64 channels): 0.56 GFLOP against a 62 MB output
// per tile, so bound by the output write. No padding of CI to a tile:
// each thread computes a 2x2 quad of pixels for 8 channels with FMAs from a
// 4x4 input patch and the 9 x 64 taps held in shared memory, and writes
// 16-byte vectors; the 8 threads of one pixel write its 128 contiguous
// bytes. With fuse_pool the quad's max is written too (full quads only:
// odd sizes floor).
//
// conv3x3_mma_reference_bf16 keeps the mma.sync implicit GEMM of
// conv_mma.cuh that the multi-channel path ran before (one or two sources,
// the pool): enc0_fused.cu and dec_tail.cu sum in its order, so the tests
// and chip_smoke.py hold them to it bit for bit, and chip_smoke.py times it
// beside the wgmma kernel. No path launches it.
#include "conv_fwd_wgmma.cuh"

namespace {

constexpr int STEM_THREADS = 256;
constexpr int STEM_QUADS = STEM_THREADS / 8;  // quads per block (8 threads each)

__global__ void __launch_bounds__(STEM_THREADS)
stem_kernel(const __nv_bfloat16* __restrict__ x, int H, int W,
            const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
            int relu, int Ho, int Wo, int CO, __nv_bfloat16* __restrict__ y,
            __nv_bfloat16* __restrict__ pooled) {
  __shared__ float w_s[9][64];
  __shared__ float b_s[64];
  const int tid = threadIdx.x;
  const int n_co_blk = CO / 64;
  const int b = blockIdx.z / n_co_blk;
  const int co0 = (blockIdx.z % n_co_blk) * 64;
  for (int i = tid; i < 9 * 64; i += STEM_THREADS) {
    const int co = i % 64, tap = i / 64;
    w_s[tap][co] = __bfloat162float(w[(size_t)(co0 + co) * 9 + tap]);
  }
  if (tid < 64) b_s[tid] = bias[co0 + tid];
  __syncthreads();

  const int cg = tid % 8;  // channels co0 + 8*cg .. +7
  const int qx = blockIdx.x * STEM_QUADS + tid / 8;
  const int qy = blockIdx.y;
  const int oy = 2 * qy, ox = 2 * qx;
  if (ox >= Wo) return;

  float p[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int iy = oy + r, ix = ox + c;
      p[r][c] = (iy < H && ix < W)
                    ? __bfloat162float(x[((size_t)b * H + iy) * W + ix])
                    : 0.f;
    }

  float acc[4][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float bb = b_s[cg * 8 + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][k] = bb;
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wv = w_s[tap][cg * 8 + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q][k] += wv * p[(q >> 1) + ky][(q & 1) + kx];
    }
  }

  __align__(16) __nv_bfloat162 out[4][4];  // [quad pixel][channel pair]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[q][k] = __floats2bfloat162_rn(unet::act(acc[q][2 * k], relu),
                                        unet::act(acc[q][2 * k + 1], relu));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int py = oy + (q >> 1), px = ox + (q & 1);
    if (py < Ho && px < Wo) {
      const size_t off = ((size_t)b * Ho + py) * Wo + px;
      *reinterpret_cast<uint4*>(y + off * CO + co0 + cg * 8) =
          *reinterpret_cast<const uint4*>(out[q]);
    }
  }
  if (pooled != nullptr && oy + 1 < Ho && ox + 1 < Wo) {
    __align__(16) __nv_bfloat162 m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = __hmax2(__hmax2(out[0][k], out[1][k]), __hmax2(out[2][k], out[3][k]));
    const int Hp = Ho / 2, Wp = Wo / 2;
    const size_t off = ((size_t)b * Hp + qy) * Wp + qx;
    *reinterpret_cast<uint4*>(pooled + off * CO + co0 + cg * 8) =
        *reinterpret_cast<const uint4*>(m);
  }
}

}  // namespace

// x (B,H,W,CI) bf16, w (CO,3,3,CI) bf16, bias (CO,) f32 -> y (B,H-2,W-2,CO)
// bf16 and, when pooled is not null, pooled (B,(H-2)/2,(W-2)/2,CO) bf16;
// relu == 0 skips the ReLU. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int conv3x3_bias_relu_bf16(const void* x, const void* w,
                                      const void* bias, void* y, void* pooled,
                                      int B, int H, int W, int CI, int CO,
                                      int relu, void* stream) {
  const int Ho = H - 2, Wo = W - 2;
  if (CI == 1) {
    const int Hq = (Ho + 1) / 2, Wq = (Wo + 1) / 2;
    dim3 grid((Wq + STEM_QUADS - 1) / STEM_QUADS, Hq, B * (CO / 64));
    stem_kernel<<<grid, STEM_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, H, W, (const __nv_bfloat16*)w,
        (const float*)bias, relu, Ho, Wo, CO, (__nv_bfloat16*)y,
        (__nv_bfloat16*)pooled);
    return (int)cudaGetLastError();
  }
  unet::Src s0{(const __nv_bfloat16*)x, H, W, CI, 0, 0};
  unet::Src s1{nullptr, 0, 0, 0, 0, 0};
  return unet::launch_conv_fwd_wgmma(s0, s1, w, bias, relu, B, Ho, Wo, CO, y, pooled, stream);
}

// The mma.sync forward: s0 (B,H0,W0,C0) read at (off_y, off_x) and, when
// C1 > 0, s1 (B,H1,W1,C1) at (0, 0), bf16; w (CO,3,3,C0+C1) bf16, bias
// (CO,) f32 -> y (B,Ho,Wo,CO) bf16 and, when pooled is not null, its 2x2
// max-pool. Returns the launch's CUDA error.
extern "C" int conv3x3_mma_reference_bf16(const void* s0, int H0, int W0, int C0, int off_y,
                                          int off_x, const void* s1, int H1, int W1, int C1,
                                          const void* w, const void* bias, void* y,
                                          void* pooled, int B, int Ho, int Wo, int CO,
                                          int relu, void* stream) {
  unet::Src a{(const __nv_bfloat16*)s0, H0, W0, C0, off_y, off_x};
  unet::Src b{(const __nv_bfloat16*)s1, H1, W1, C1, 0, 0};
  return unet::launch_conv3x3_mma<unet::MODE_STORE>(a, b, w, bias, relu, B, Ho, Wo, CO, y,
                                                    pooled, nullptr, nullptr, 0, nullptr,
                                                    stream);
}
