// tconv2x2_bias: 2x2 stride-2 transposed conv + bias,
// out[b, 2r+dy, 2j+dx, co] = bias[co] + sum_ci x[b, r, j, ci] W[ci, co, dy, dx]
// with W in torch's ConvTranspose2d layout (CI, CO, 2, 2). Flax applies its
// kernel spatially flipped (out[2r+dy, 2j+dx] += Wf[1-dy, 1-dx] x[r, j]);
// utils/flax_bridge.py does that flip when it converts the weights, so
// torch-layout weights give the Flax result here.
//
// Replaces the TPU kernel unetseg_tpu/ops/pallas/conv3x3.py:tconv2x2_phase2
// (up3 on the serving path: (B,260,260,128) -> (B,520,520,64); in the train
// step (4,164,164,128) -> (4,328,328,64)).
//
// GEMM view: M = B h w input pixels, K = CI, N = 4 CO with the columns in
// (dy, dx, co) order: the wrapper passes W as (4 CO, CI), row (2 dy + dx)
// CO + co. The 2 CO columns of one dy are output pixels (2r+dy, 2j) and
// (2r+dy, 2j+1), contiguous in NHWC, so every 64 columns of a pixel are 128
// contiguous bytes of the output. At 16 tiles of 700^2: 71 GFLOP against
// 277 MB read and 554 MB written, about 85 operations a byte against the
// H100's ~295 (989 TFLOP/s over 3.35 TB/s): bound by bytes, two thirds of
// them the output.
//
// Design: a persistent grid of one block per SM walks tiles of 128
// consecutive input pixels (across rows and images) x 256 GEMM columns. A
// producer warp streams the tile's A, 128 pixels x 64 channels a stage, by
// TMA from a 2-D (B h w, CI) view into a 4-stage ring (slices past CI and
// pixels past the last read zeros), running a tile ahead, since K has only
// CI / 64 slices. The weight tile, 256 columns x 64 channels a slice, is
// copied once per block and stays resident where it is the only column
// group and has at most two slices (CI <= 128: every launch of the U-Net);
// otherwise it streams through a 2-stage ring of its own with the tiles.
// Two consumer warpgroups each take 64 pixels and issue, per k16 step, two
// wgmma.m64n128k16 (one per 128-column half: per dy when CO = 64) with both
// operands K-major in the 128-byte swizzle; one group stays in flight and a
// stage is released once the group that read it has completed. Epilogue:
// per 64 columns, bias, rounded to bf16 into a 16-pixel x 128-byte shared
// tile per warp, then stored as whole 128-byte rows of 16-byte vectors at
// the pixel-shuffle address with the streaming hint (st.global.cs), while
// the producer loads the next tile. Measured variants (PERF.md): 2 to 8 A
// stages within the noise at the serving shape, 3-4 the fastest at the
// train shape; the streaming hint between 2% slower and 17% faster than
// plain stores over three calls.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int ROW = SLICE * 2;                         // one pixel's 64 channels: 128 bytes
constexpr int MT = 128;                                // input pixels a tile
constexpr int NG = 256;                                // GEMM columns a block holds
constexpr int CONSUMERS = 2;                           // warpgroups, 64 pixels each
constexpr int TC_THREADS = CONSUMERS * 128 + 32;       // + the producer warp
constexpr int AST = 4, WST = 2;                        // A and weight stages
constexpr int A_STAGE = MT * ROW;                      // 16 KB
constexpr int W_STAGE = NG * ROW;                      // 32 KB
constexpr int EPI_ROWS = 16;                           // pixels a consumer warp holds
constexpr int EPI_BYTES = CONSUMERS * 4 * EPI_ROWS * ROW;
constexpr int TC_SMEM = 1024 + AST * A_STAGE + WST * W_STAGE + EPI_BYTES + 2 * (AST + WST) * 8;
static_assert(TC_SMEM <= SMEM_PER_BLOCK, "stages exceed the 227 KB a block can use");

__global__ void __launch_bounds__(TC_THREADS, 1)
tconv2x2_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, int slices,
                      const float* __restrict__ bias, int H, int W, int CO, int npix,
                      __nv_bfloat16* __restrict__ y) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t wbase = base + AST * A_STAGE, ebase = wbase + WST * W_STAGE;
  const uint32_t afull0 = ebase + EPI_BYTES, aempty0 = afull0 + 8 * AST;
  const uint32_t wfull0 = aempty0 + 8 * AST, wempty0 = wfull0 + 8 * WST;
  const int tid = threadIdx.x;
  const int nb = 4 * CO / NG;  // column groups
  const int ntiles = (npix + MT - 1) / MT * nb;
  // the one column group's weights, loaded once: stage s holds slice s
  const bool resident = nb == 1 && slices <= WST;

  if (tid == 0) {
    for (int s = 0; s < AST; ++s) {
      mbar_init(afull0 + 8 * s, 1);
      mbar_init(aempty0 + 8 * s, CONSUMERS * 4);  // one arrive per consumer warp
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(wfull0 + 8 * s, 1);
      mbar_init(wempty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp: one thread issues the copies
    if (tid == CONSUMERS * 128) {
      if (resident)
        for (int s = 0; s < slices; ++s) {
          mbar_expect_tx(wfull0 + 8 * s, W_STAGE);
          tma_load_2d(wbase + s * W_STAGE, &wmap, wfull0 + 8 * s, s * SLICE, 0);
        }
      int ai = 0, wi = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int n0 = (t % nb) * NG, p0 = (t / nb) * MT;
        for (int s = 0; s < slices; ++s) {
          const int as = ai % AST;
          if (ai >= AST) mbar_wait(aempty0 + 8 * as, (ai / AST - 1) & 1);
          mbar_expect_tx(afull0 + 8 * as, A_STAGE);
          tma_load_2d(base + as * A_STAGE, &xmap, afull0 + 8 * as, s * SLICE, p0);
          ++ai;
          if (!resident) {
            const int ws = wi % WST;
            if (wi >= WST) mbar_wait(wempty0 + 8 * ws, (wi / WST - 1) & 1);
            mbar_expect_tx(wfull0 + 8 * ws, W_STAGE);
            tma_load_2d(wbase + ws * W_STAGE, &wmap, wfull0 + 8 * ws, s * SLICE, n0);
            ++wi;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns pixels 64 wg .. 64 wg + 63 of a tile
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  uint8_t* etile = smem_raw + (ebase - smem_u32(smem_raw)) + (wg * 4 + warp) * EPI_ROWS * ROW;
  float acc[2][64];  // the two 128-column halves
  int ai = 0, wi = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n0 = (t % nb) * NG, p0 = (t / nb) * MT;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    for (int s = 0; s < slices; ++s) {
      const int as = ai % AST, ws = resident ? s : wi % WST;
      mbar_wait(afull0 + 8 * as, (ai / AST) & 1);
      mbar_wait(wfull0 + 8 * ws, resident ? 0 : (wi / WST) & 1);
      const uint32_t a0 = base + as * A_STAGE + wg * 64 * ROW, b0 = wbase + ws * W_STAGE;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes along the 128-byte row
        const uint64_t da = sw128_desc(a0 + kk * 32, 16, 8 * ROW);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_n128(acc[h], da, sw128_desc(b0 + h * 128 * ROW + kk * 32, 16, 8 * ROW));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (s > 0) {  // the group before this one is done: release its stages
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) {
          mbar_arrive(aempty0 + 8 * ((ai - 1) % AST));
          if (!resident) mbar_arrive(wempty0 + 8 * ((wi - 1) % WST));
        }
      }
      ++ai;
      if (!resident) ++wi;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) {
      mbar_arrive(aempty0 + 8 * ((ai - 1) % AST));
      if (!resident) mbar_arrive(wempty0 + 8 * ((wi - 1) % WST));
    }
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // Epilogue. Accumulator 4j + h of half hh is tile row 16 warp + g (+8
    // for h >= 2) of the warpgroup's 64, column 128 hh + 8j + 2q + (h & 1).
    // Lanes 8i..8i+7 store rows lane / 8 + 4 k, k = 0..3: the output offset
    // of each row's pixel (2r, 2j) in units of 64 channels (CO is a
    // multiple of 64), or -1 past the last pixel.
    int obase[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + wg * 64 + EPI_ROWS * warp + (lane >> 3) + 4 * k;
      const int b = p / (H * W), rem = p - b * (H * W), r = rem / W, j = rem - r * W;
      obase[k] = p < npix ? ((b * 2 * H + 2 * r) * 2 * W + 2 * j) * (CO / SLICE) : -1;
    }
#pragma unroll
    for (int c = 0; c < NG / SLICE; ++c) {  // 64-column chunks: 128 bytes of one output pixel row
      const int col = n0 + c * SLICE, dy = col / (2 * CO), off = col - dy * 2 * CO;
      const int co0 = off % CO;
      const float* a = acc[c >> 1] + (c & 1) * 32;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + co0 + 8 * jj + 2 * q));
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(a[4 * jj] + bb.x, a[4 * jj + 1] + bb.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(a[4 * jj + 2] + bb.x, a[4 * jj + 3] + bb.y);
        uint8_t* e = etile + g * ROW + ((jj ^ g) << 4) + 4 * q;  // 16-byte chunks swizzled by row
        *reinterpret_cast<__nv_bfloat162*>(e) = h0;            // row g
        *reinterpret_cast<__nv_bfloat162*>(e + 8 * ROW) = h1;  // row g + 8
      }
      __syncwarp();
      const long long shift = (long long)dy * 2 * W * CO + off + 8 * (lane & 7);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = (lane >> 3) + 4 * k, cc = lane & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(etile + r * ROW + ((cc ^ (r & 7)) << 4));
        if (obase[k] >= 0)  // streaming: written once, read by the next kernel
          __stcs(reinterpret_cast<uint4*>(y + (long long)obase[k] * SLICE + shift), v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x (B,H,W,CI) bf16; w (4 CO, CI) bf16 with w[(2 dy + dx) CO + co, ci] =
// W[ci, co, dy, dx]; bias (CO,) f32 -> y (B,2H,2W,CO) bf16. CI a multiple of
// 32, CO of 64, 16-byte aligned contiguous tensors. Returns the launch's
// CUDA error, or -(the CUresult) of a failed tensor-map encoding.
extern "C" int tconv2x2_bias_bf16(const void* x, const void* w,
                                  const void* bias, void* y, int B, int H,
                                  int W, int CI, int CO, void* stream) {
  const long long npix = (long long)B * H * W;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)CI, (cuuint64_t)npix};
  const cuuint64_t wdims[2] = {(cuuint64_t)CI, (cuuint64_t)4 * CO};
  const cuuint64_t strides[1] = {(cuuint64_t)CI * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)SLICE, (cuuint32_t)MT};
  const cuuint32_t wbox[2] = {(cuuint32_t)SLICE, (cuuint32_t)NG};
  int e = bf16_map(&xmap, x, 2, xdims, strides, xbox);
  if (e == 0) e = bf16_map(&wmap, w, 2, wdims, strides, wbox);
  if (e != 0) return e;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tconv2x2_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (npix + MT - 1) / MT * (4 * CO / NG);
  const int slices = (CI + SLICE - 1) / SLICE;
  tconv2x2_wgmma_kernel<<<(int)(tiles < sms ? tiles : sms), TC_THREADS, TC_SMEM,
                          (cudaStream_t)stream>>>(xmap, wmap, slices, (const float*)bias, H, W, CO,
                                                  (int)npix, (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}
