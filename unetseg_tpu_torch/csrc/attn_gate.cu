// attn_gate: the attention gate of the Attention U-Net's skips (Oktay et
// al., arXiv:1804.03999, Eq. 1-2, in 2-D), on the gated net's serving path
// (infer/kernel_net.py, ModelConfig.skip_gates). It replaces no TPU kernel:
// the JAX package has no gated net. For decoder step i, with x the skip
// (B, Hs, Ws, F) read at its centre-crop offset (off_y, off_x) over (2h,
// 2w) pixels and g the up-conv's input (B, h, w, 2F):
//
//   alpha[b, r, c] = sigmoid(psi . ReLU(Wx * x2x2(b, r, c) + Wg g[b, r, c] + bg) + bpsi)
//
// with x2x2 the 2x2 patch at (off_y + 2r, off_x + 2c) (Wx a 2x2 stride-2
// conv F -> F/2, no bias), Wg a 1x1 conv 2F -> F/2 and psi a 1x1 conv F/2
// -> 1; then x_hat = upsample2x(alpha) * x, bilinear with align_corners
// false, written as a compact (B, 2h, 2w, F) tensor that dec_conv0 reads at
// offset (0, 0).
//
// attn_gate_kernel, one launch a level: a GEMM of M = B h w pixels, K = 4F
// (the patch, (dy, dx, ci) order) + 2F (g), N = F / 2 (32..256), f32
// accumulation, with the epilogue bg, ReLU, the dot with psi over the N
// outputs, bpsi and the sigmoid: one f32 a pixel. At 16 tiles of 700^2 the
// four levels take 116 GFLOP against 1.61 GB of x crops and g: about 72
// operations a byte against the H100's ~295, so bytes bound it (0.48 ms).
// Design: a persistent grid of one block per SM walks tiles of 8 x 16
// pixels of g's grid (one image). A producer warp streams each tile's K in
// 64-channel slices by TMA into a 4-stage ring, each stage the A slice
// (128 pixels x 128 bytes) and the weights' slice (N rows x 128 bytes):
// the x slices through four 4-D maps whose base is the crop's corner moved
// by (dy, dx) and whose W and H strides are two pixels and two rows, so a
// plain box brings the 128 pixels (2r + dy, 2c + dx) as 128 contiguous
// rows; past h or w the maps read zeros, and nothing is stored there. Two
// consumer warpgroups each take 64 pixels (4 rows of the tile) and issue,
// per k16 step, wgmma m64nNk16 (two m64n128k16 at N = 256), both operands
// K-major in the 128-byte swizzle; one group stays in flight. The
// epilogue reduces each pixel's N outputs across the 4 lanes that hold
// them. One kernel serves the four widths (a switch on N), so the
// profiler names one kernel.
//
// attn_gate_apply_kernel: x_hat, 16 bytes a thread (8 channels), bilinear
// weights 0, 1/4 or 3/4 from alpha's 4 neighbours (PyTorch's
// upsample_bilinear2d: source y / 2 - 1/4 clamped at 0); reads the crop and
// writes it once, 2.15 GB at 16 x 700^2 (0.64 ms bound).
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int ROW = SLICE * 2;                       // one pixel's 64 channels: 128 bytes
constexpr int TH = 8, TW = 16;                       // a tile: 8 rows x 16 columns of g's grid
constexpr int MT = TH * TW;                          // 128 pixels
constexpr int CONSUMERS = 2;                         // warpgroups, 64 pixels each
constexpr int AG_THREADS = CONSUMERS * 128 + 32;     // + the producer warp
constexpr int MAX_N = 256;                           // F / 2 at F = 512
constexpr int STAGES = 4;
constexpr int A_STAGE = MT * ROW;                    // 16 KB
constexpr int STAGE = A_STAGE + MAX_N * ROW;         // + the weights' slice: 48 KB
constexpr int AG_SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + 2 * MAX_N * 4;
static_assert(AG_SMEM <= SMEM_PER_BLOCK, "stages exceed the 227 KB a block can use");

// D (64 x 32, f32) += A (64 x 16) B (16 x 32), both K-major in shared memory.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// One k16 step of a 64 x NW half: NW = 128, 64 or 32 columns.
template <int NW>
__device__ __forceinline__ void mma_half(float (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 128) wgmma_n128(d, da, db);
  else if constexpr (NW == 64) wgmma_n64(d, da, db);
  else wgmma_n32(d, da, db);
}

struct Maps {
  CUtensorMap x[4];  // the crop's (dy, dx) = (j / 2, j % 2) pixels: (F, w, h, B)
  CUtensorMap g;     // (2F, w, h, B)
  CUtensorMap w;     // the weights (N, 6F): (6F, N)
};

// The consumers' part for N = F / 2 output columns: the tiles' GEMMs and
// the epilogue. Returns when the block's tiles are done.
template <int N>
__device__ __forceinline__ void consume(uint32_t base, uint32_t full0, uint32_t empty0,
                                        const float* sbg, const float* spsi, float bpsi,
                                        int slices, int h, int w, int ntw, int tpi, int ntiles,
                                        float* __restrict__ alpha) {
  constexpr int H = N > 128 ? 2 : 1, NW = N > 128 ? 128 : N;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, q = lane & 3;
  float acc[H][NW / 2];
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[hh][i] = 0.f;
    for (int s = 0; s < slices; ++s) {
      const int st = it % STAGES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      const uint32_t a0 = base + st * STAGE + wg * 64 * ROW, b0 = base + st * STAGE + A_STAGE;
#pragma unroll
      for (int hh = 0; hh < H; ++hh) fence_regs(acc[hh]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes along the 128-byte row
        const uint64_t da = sw128_desc(a0 + kk * 32, 16, 8 * ROW);
#pragma unroll
        for (int hh = 0; hh < H; ++hh)
          mma_half<NW>(acc[hh], da, sw128_desc(b0 + hh * 128 * ROW + kk * 32, 16, 8 * ROW));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int hh = 0; hh < H; ++hh) fence_regs(acc[hh]);
      if (s > 0) {  // the group before this one is done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      ++it;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
#pragma unroll
    for (int hh = 0; hh < H; ++hh) fence_regs(acc[hh]);

    // Epilogue. Accumulator 4j + e of half hh is the warpgroup's row 16
    // warp + g8 (+ 8 for e >= 2), column 128 hh + 8j + 2q + (e & 1): each
    // row's N columns lie in the 4 lanes of its q.
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int hh = 0; hh < H; ++hh)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = hh * 128 + 8 * j + 2 * q;
        const float b0v = sbg[c], b1v = sbg[c + 1], p0 = spsi[c], p1 = spsi[c + 1];
        s0 += p0 * fmaxf(acc[hh][4 * j] + b0v, 0.f) + p1 * fmaxf(acc[hh][4 * j + 1] + b1v, 0.f);
        s1 += p0 * fmaxf(acc[hh][4 * j + 2] + b0v, 0.f) +
              p1 * fmaxf(acc[hh][4 * j + 3] + b1v, 0.f);
      }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const int b = t / tpi, rem = t - b * tpi;
    const int r = (rem / ntw) * TH + wg * 4 + warp, c = (rem % ntw) * TW + g8 + (q == 1 ? 8 : 0);
    if (q < 2 && r < h && c < w) {
      const float z = (q == 0 ? s0 : s1) + bpsi;
      alpha[((long long)b * h + r) * w + c] = 1.f / (1.f + expf(-z));
    }
  }
}

__global__ void __launch_bounds__(AG_THREADS, 1)
attn_gate_kernel(const __grid_constant__ Maps maps, int F, int h, int w, int ntiles,
                 const float* __restrict__ bg, const float* __restrict__ psi,
                 const float* __restrict__ bpsi, float* __restrict__ alpha) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t full0 = base + STAGES * STAGE, empty0 = full0 + 8 * STAGES;
  float* sbg = reinterpret_cast<float*>(smem_raw + (empty0 + 8 * STAGES - smem_u32(smem_raw)));
  float* spsi = sbg + MAX_N;
  const int tid = threadIdx.x, N = F / 2;
  const int nsx = F / SLICE, slices = 6 * nsx;  // K slices: 4 of x per (dy, dx), 2 of g
  const int ntw = (w + TW - 1) / TW, tpi = ((h + TH - 1) / TH) * ntw;

  for (int i = tid; i < N; i += AG_THREADS) {
    sbg[i] = bg[i];
    spsi[i] = psi[i];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp: one thread issues the copies
    if (tid == CONSUMERS * 128) {
      const int bytes = A_STAGE + N * ROW;
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int b = t / tpi, rem = t - b * tpi;
        const int r0 = (rem / ntw) * TH, c0 = (rem % ntw) * TW;
        for (int s = 0; s < slices; ++s) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t dst = base + st * STAGE, bar = full0 + 8 * st;
          mbar_expect_tx(bar, bytes);
          if (s < 4 * nsx)
            tma_load_4d(dst, &maps.x[s / nsx], bar, (s % nsx) * SLICE, c0, r0, b);
          else
            tma_load_4d(dst, &maps.g, bar, (s - 4 * nsx) * SLICE, c0, r0, b);
          tma_load_2d(dst + A_STAGE, &maps.w, bar, s * SLICE, 0);
          ++it;
        }
      }
    }
    return;
  }
  const float bp = __ldg(bpsi);
  switch (N) {
    case 256: consume<256>(base, full0, empty0, sbg, spsi, bp, slices, h, w, ntw, tpi, ntiles, alpha); break;
    case 128: consume<128>(base, full0, empty0, sbg, spsi, bp, slices, h, w, ntw, tpi, ntiles, alpha); break;
    case 64: consume<64>(base, full0, empty0, sbg, spsi, bp, slices, h, w, ntw, tpi, ntiles, alpha); break;
    default: consume<32>(base, full0, empty0, sbg, spsi, bp, slices, h, w, ntw, tpi, ntiles, alpha); break;
  }
}

__global__ void __launch_bounds__(256)
attn_gate_apply_kernel(const __nv_bfloat16* __restrict__ x, int Hs, int Ws, int F, int off_y,
                       int off_x, const float* __restrict__ alpha, int h, int w,
                       __nv_bfloat16* __restrict__ y, long long nvec) {
  const int cv = F / 8, H2 = 2 * h, W2 = 2 * w;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long p = v / cv;
    const int ch = (int)(v - p * cv) * 8;
    const int xx = (int)(p % W2);
    const long long t = p / W2;
    const int yy = (int)(t % H2), b = (int)(t / H2);
    // PyTorch's upsample_bilinear2d, align_corners false, scale 1/2
    const float sy = fmaxf(0.5f * (yy + 0.5f) - 0.5f, 0.f), sx = fmaxf(0.5f * (xx + 0.5f) - 0.5f, 0.f);
    const int y0 = (int)sy, x0 = (int)sx;
    const int y1 = y0 + (y0 < h - 1 ? 1 : 0), x1 = x0 + (x0 < w - 1 ? 1 : 0);
    const float ly1 = sy - y0, lx1 = sx - x0, ly0 = 1.f - ly1, lx0 = 1.f - lx1;
    const float* ab = alpha + (long long)b * h * w;
    const float a = ly0 * (lx0 * __ldg(ab + y0 * w + x0) + lx1 * __ldg(ab + y0 * w + x1)) +
                    ly1 * (lx0 * __ldg(ab + y1 * w + x0) + lx1 * __ldg(ab + y1 * w + x1));
    const long long src = (((long long)b * Hs + off_y + yy) * Ws + off_x + xx) * F + ch;
    uint4 u = __ldcs(reinterpret_cast<const uint4*>(x + src));  // read once
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(e[k]);
      e[k] = __floats2bfloat162_rn(a * f.x, a * f.y);
    }
    *reinterpret_cast<uint4*>(y + p * F + ch) = u;
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

// x (B, Hs, Ws, F) bf16 read at (off_y, off_x) over (2h, 2w) pixels; g (B,
// h, w, 2F) bf16; wgt (F/2, 6F) bf16, row n = [Wx[n, :, dy, dx] for (dy, dx)
// in (0,0), (0,1), (1,0), (1,1); Wg[n, :]]; bg, psi (F/2,) f32; bpsi (1,)
// f32 -> alpha (B, h, w) f32. F in {64, 128, 256, 512}, 16-byte aligned
// contiguous tensors. Returns the launch's CUDA error, or -(the CUresult)
// of a failed tensor-map encoding.
extern "C" int attn_gate_bf16(const void* x, int Hs, int Ws, int F, int off_y, int off_x,
                              const void* g, int B, int h, int w, const void* wgt,
                              const void* bg, const void* psi, const void* bpsi, void* alpha,
                              void* stream) {
  const int N = F / 2;
  Maps maps;
  const cuuint32_t abox[4] = {(cuuint32_t)SLICE, (cuuint32_t)TW, (cuuint32_t)TH, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)F, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)4 * F, (cuuint64_t)4 * Ws * F,
                                  (cuuint64_t)2 * Hs * Ws * F};  // bytes: two pixels, two rows
  int e = 0;
  for (int j = 0; j < 4 && e == 0; ++j) {
    const __nv_bfloat16* corner = reinterpret_cast<const __nv_bfloat16*>(x) +
                                  ((long long)(off_y + j / 2) * Ws + off_x + j % 2) * F;
    e = bf16_map(&maps.x[j], corner, 4, xdims, xstrides, abox);
  }
  if (e == 0) e = nhwc_map(&maps.g, g, B, h, w, 2 * F, TW, TH);
  if (e == 0) {
    const cuuint64_t wdims[2] = {(cuuint64_t)6 * F, (cuuint64_t)N};
    const cuuint64_t wstrides[1] = {(cuuint64_t)12 * F};
    const cuuint32_t wbox[2] = {(cuuint32_t)SLICE, (cuuint32_t)N};
    e = bf16_map(&maps.w, wgt, 2, wdims, wstrides, wbox);
  }
  if (e != 0) return e;
  int sms = 0;
  cudaError_t err = (cudaError_t)sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               AG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = B * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  attn_gate_kernel<<<ntiles < sms ? ntiles : sms, AG_THREADS, AG_SMEM, (cudaStream_t)stream>>>(
      maps, F, h, w, ntiles, (const float*)bg, (const float*)psi, (const float*)bpsi,
      (float*)alpha);
  return (int)cudaGetLastError();
}

// x as attn_gate_bf16's; alpha (B, h, w) f32 -> y (B, 2h, 2w, F) bf16 =
// upsample2x(alpha) * x at (off_y, off_x). F a multiple of 8.
extern "C" int attn_gate_apply_bf16(const void* x, int Hs, int Ws, int F, int off_y, int off_x,
                                    const void* alpha, int B, int h, int w, void* y,
                                    void* stream) {
  const long long nvec = (long long)B * 4 * h * w * (F / 8);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const long long want = (nvec + 255) / 256, cap = (long long)sms * 16;
  attn_gate_apply_kernel<<<(int)(want < cap ? want : cap), 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, Hs, Ws, F, off_y, off_x, (const float*)alpha, h, w,
      (__nv_bfloat16*)y, nvec);
  return (int)cudaGetLastError();
}
