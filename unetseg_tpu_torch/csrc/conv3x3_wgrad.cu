// conv3x3_wgrad: the weight gradient of a valid 3x3 conv,
// dw[co, ci, ky, kx] = sum_{b,y,x} g[b, y, x, co] x[b, y+ky, x+kx, ci],
// f32 accumulation, with one or two input sources (the decoder-entry conv
// reads its skip at the crop offset, then the up tensor: channels
// [0, s0.C) from s0 and [s0.C, s0.C + s1.C) from s1).
//
// Replaces the TPU kernels
// unetseg_tpu/ops/pallas/conv3x3_train.py:conv3x3_phase2_dw (the train
// step's stem, x (4,512,512,1), g (4,510,510,64); enc0 conv1 and dec3 conv1,
// CI = CO = 64) and :conv3x3_dec0_dw (dec3 conv0: skip (4,508,508,64) read
// at (90, 90), up (4,328,328,64), g (4,326,326,64) -> (64,128,3,3)).
//
// A GEMM with M = CO, N = 9 taps x CI and a long K = B*Ho*Wo (1.03 M
// pixels at enc0): 76 GFLOP against ~400 MB of reads, tensor-core bound.
// The Pallas kernels carry one accumulator block across a sequential grid;
// Hopper's blocks run in parallel, so K is split instead: block (chunk,
// ci-slice, co-block) walks a fixed range of 8x16-pixel output tiles and
// keeps its 64 x (9 x 32) partial sums in registers, then writes them to a
// (chunk, CO, 9, CI) f32 scratch; a second kernel sums the chunks in a fixed
// order into the OIHW result. No atomics, so results repeat bit for bit.
// Per tile the block copies the g tile (128 pixels x 64 co) and the
// (8+2)x(16+2) x-window (x 32 ci) into shared memory as they lie in device
// memory, one pixel's channels per padded row (16-byte vectors, rows padded
// so that eight rows hit distinct banks). K runs over pixels, so both mma
// operands need pixel pairs in a register: ldmatrix.trans loads them
// transposed straight from those rows, and since it takes one address per
// pixel row, a tap's window shift (ky, kx) costs nothing. Eight warps, each
// one m16 slice of CO x half of the 36 n8 tiles (tap, 8 channels), run
// mma.m16n8k16 along a tile row of 16 pixels per K step. The staging is
// not pipelined; instead the launch bounds cap registers at 128 so that two
// blocks share an SM and one's copies overlap the other's mma (1.65x over
// one block per SM on an H100, bit-identical: the summation order is
// unchanged).
//
// CI == 1 (the stem) has N = 9 only: a separate FMA kernel, thread per
// output channel, four thread groups per block each over a quarter of the
// tile's pixels, summed in shared memory in a fixed order.
#include "conv_mma.cuh"

namespace {

constexpr int WTH = 8, WTW = 16;          // output pixels per tile
constexpr int WPIX = WTH * WTW;           // 128: K per tile
constexpr int WROWS = WTH + 2, WCOLS = WTW + 2;
constexpr int WWIN = WROWS * WCOLS;       // 180 window pixels
constexpr int WCI = 32;                   // input channels per block
constexpr int GS_P = unet::NCO + 8;       // g row (one pixel): 72 bf16 = 144 B
constexpr int XS_P = WCI + 8;             // x row (one pixel): 40 bf16 = 80 B
constexpr int NT = 9 * WCI / 8;           // 36 n8 tiles (tap, 8 channels)
constexpr int NT_W = NT / 2;              // 18 per warp

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void tile_origin(long long tile, int nty, int ntx,
                                            int& b, int& y0, int& x0) {
  const long long per_b = (long long)nty * ntx;
  b = (int)(tile / per_b);
  const int r = (int)(tile % per_b);
  y0 = (r / ntx) * WTH;
  x0 = (r % ntx) * WTW;
}

__global__ void __launch_bounds__(unet::THREADS, 2)
wgrad_mma_kernel(unet::Src s0, unet::Src s1,
                 const __nv_bfloat16* __restrict__ g, int B, int Ho, int Wo,
                 int CO, int nchunks, float* __restrict__ partial) {
  using namespace unet;
  __shared__ __align__(16) __nv_bfloat16 gs[WPIX * GS_P];  // [pixel][co]
  __shared__ __align__(16) __nv_bfloat16 xs[WWIN * XS_P];  // [pixel][ci]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int lq = lane >> 3, li = lane & 7;  // ldmatrix: matrix, row
  const int mt = warp & 3, nh = warp >> 2;
  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * WCI;
  const int co0 = blockIdx.z * NCO;
  const int CI = s0.C + s1.C;
  const Src s = ci0 < s0.C ? s0 : s1;
  const int cs = ci0 < s0.C ? ci0 : ci0 - s0.C;

  const int nty = (Ho + WTH - 1) / WTH, ntx = (Wo + WTW - 1) / WTW;
  const long long ntiles = (long long)B * nty * ntx;
  const long long t_begin = ntiles * chunk / nchunks;
  const long long t_end = ntiles * (chunk + 1) / nchunks;

  float acc[NT_W][4];
#pragma unroll
  for (int j = 0; j < NT_W; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (long long tile = t_begin; tile < t_end; ++tile) {
    int b, y0, x0;
    tile_origin(tile, nty, ntx, b, y0, x0);
    // g tile -> gs[pixel][co]; pixels outside the output are zeros
    for (int i = tid; i < WPIX * (NCO / 8); i += THREADS) {
      const int v = i % (NCO / 8), pix = i / (NCO / 8);
      const int oy = y0 + pix / WTW, ox = x0 + pix % WTW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (oy < Ho && ox < Wo) {
        const size_t off = ((size_t)b * Ho + oy) * Wo + ox;
        val = *reinterpret_cast<const uint4*>(g + off * CO + co0 + v * 8);
      }
      *reinterpret_cast<uint4*>(gs + pix * GS_P + v * 8) = val;
    }
    // x window -> xs[window pixel][ci]; outside the source: zeros
    for (int i = tid; i < WWIN * (WCI / 8); i += THREADS) {
      const int v = i % (WCI / 8), p = i / (WCI / 8);
      const int iy = y0 + p / WCOLS + s.off_y, ix = x0 + p % WCOLS + s.off_x;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (iy < s.H && ix < s.W) {
        const size_t off = ((size_t)b * s.H + iy) * s.W + ix;
        val = *reinterpret_cast<const uint4*>(s.p + off * s.C + cs + v * 8);
      }
      *reinterpret_cast<uint4*>(xs + p * XS_P + v * 8) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int r = 0; r < WTH; ++r) {  // K step: one tile row of 16 pixels
      // A = g^T (co x pixel): matrices (pixels 0-7 | 8-15) x (co +0 | +8)
      uint32_t a[4];
      ldsm_x4_trans(a, gs + (r * WTW + (lq >> 1) * 8 + li) * GS_P + mt * 16 + (lq & 1) * 8);
#pragma unroll
      for (int j = 0; j < NT_W; j += 2) {
        // B (pixel x ci) for n8 tiles j and j + 1, same tap: matrices
        // (pixels 0-7 | 8-15) x (channels c8 | c8 + 1)
        const int nt = nh * NT_W + j;
        const int tap = nt >> 2, c8 = nt & 3;
        const int ky = tap / 3, kx = tap % 3;
        const int wp = (r + ky) * WCOLS + (lq & 1) * 8 + li + kx;
        uint32_t bq[4];
        ldsm_x4_trans(bq, xs + wp * XS_P + (c8 + (lq >> 1)) * 8);
        mma_bf16_16816(acc[j], a, bq);
        mma_bf16_16816(acc[j + 1], a, bq + 2);
      }
    }
    __syncthreads();
  }

  // partial[chunk][co][tap][ci], this block's (64 co) x (9 taps x 32 ci)
#pragma unroll
  for (int j = 0; j < NT_W; ++j) {
    const int nt = nh * NT_W + j;
    const int tap = nt >> 2, ci = ci0 + (nt & 3) * 8 + 2 * t;
    const int co = co0 + mt * 16 + gq;
    float* p0 = partial + (((size_t)chunk * CO + co) * 9 + tap) * CI + ci;
    float* p1 = p0 + (size_t)8 * 9 * CI;  // co + 8
    *reinterpret_cast<float2*>(p0) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(p1) = make_float2(acc[j][2], acc[j][3]);
  }
}

constexpr int STEM_PARTS = unet::THREADS / unet::NCO;  // 4 pixel groups

__global__ void __launch_bounds__(unet::THREADS)
wgrad_stem_kernel(const __nv_bfloat16* __restrict__ x, int H, int W,
                  const __nv_bfloat16* __restrict__ g, int B, int Ho, int Wo,
                  int CO, int nchunks, float* __restrict__ partial) {
  using namespace unet;
  __shared__ __align__(16) __nv_bfloat16 gs[WPIX * NCO];  // [pixel][co]
  __shared__ float xs[WWIN];
  __shared__ float red[STEM_PARTS][9][NCO];

  const int tid = threadIdx.x;
  const int co = tid % NCO, part = tid / NCO;
  const int chunk = blockIdx.x;
  const int co0 = blockIdx.z * NCO;
  const int nty = (Ho + WTH - 1) / WTH, ntx = (Wo + WTW - 1) / WTW;
  const long long ntiles = (long long)B * nty * ntx;
  const long long t_begin = ntiles * chunk / nchunks;
  const long long t_end = ntiles * (chunk + 1) / nchunks;

  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;

  for (long long tile = t_begin; tile < t_end; ++tile) {
    int b, y0, x0;
    tile_origin(tile, nty, ntx, b, y0, x0);
    for (int i = tid; i < WPIX * (NCO / 8); i += THREADS) {
      const int v = i % (NCO / 8), pix = i / (NCO / 8);
      const int oy = y0 + pix / WTW, ox = x0 + pix % WTW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (oy < Ho && ox < Wo) {
        const size_t off = ((size_t)b * Ho + oy) * Wo + ox;
        val = *reinterpret_cast<const uint4*>(g + off * CO + co0 + v * 8);
      }
      *reinterpret_cast<uint4*>(gs + pix * NCO + v * 8) = val;
    }
    for (int p = tid; p < WWIN; p += THREADS) {
      const int iy = y0 + p / WCOLS, ix = x0 + p % WCOLS;
      xs[p] = (iy < H && ix < W)
                  ? __bfloat162float(x[((size_t)b * H + iy) * W + ix])
                  : 0.f;
    }
    __syncthreads();
    for (int pix = part; pix < WPIX; pix += STEM_PARTS) {
      const float gv = __bfloat162float(gs[pix * NCO + co]);
      const int r = pix / WTW, c = pix % WTW;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        acc[k] += gv * xs[(r + k / 3) * WCOLS + c + k % 3];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) red[part][k][co] = acc[k];
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float v = red[0][k][co];
#pragma unroll
      for (int q = 1; q < STEM_PARTS; ++q) v += red[q][k][co];
      partial[((size_t)chunk * CO + co0 + co) * 9 + k] = v;
    }
  }
}

// dw[co][ci][tap] = sum over chunks, in chunk order, of
// partial[chunk][co][tap][ci]; threads walk the partial layout so the reads
// coalesce.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    int nchunks, int CO, int CI,
                                    float* __restrict__ dw) {
  const int n = CO * 9 * CI;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int c = 0; c < nchunks; ++c) v += partial[(size_t)c * n + i];
  const int ci = i % CI, tap = (i / CI) % 9, co = i / (CI * 9);
  dw[((size_t)co * CI + ci) * 9 + tap] = v;
}

}  // namespace

// s0 (B,H0,W0,C0) read at (off_y0, off_x0) and, when C1 > 0, s1
// (B,H1,W1,C1) at (0, 0), both bf16; g (B,Ho,Wo,CO) bf16; partial: f32
// scratch of nchunks*CO*9*(C0+C1) -> dw (CO, C0+C1, 3, 3) f32. Needs
// CO % 64 == 0 and either C0 == 1, C1 == 0 (the stem kernel) or C0 and C1
// multiples of 32. Returns the first failing launch's CUDA error.
extern "C" int conv3x3_wgrad_bf16(const void* x0, int H0, int W0, int C0,
                                  int off_y0, int off_x0, const void* x1,
                                  int H1, int W1, int C1, const void* g, int B,
                                  int Ho, int Wo, int CO, int nchunks,
                                  void* partial, void* dw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int CI = C0 + C1;
  if (C0 == 1 && C1 == 0) {
    dim3 grid(nchunks, 1, CO / unet::NCO);
    wgrad_stem_kernel<<<grid, unet::THREADS, 0, st>>>(
        (const __nv_bfloat16*)x0, H0, W0, (const __nv_bfloat16*)g, B, Ho, Wo,
        CO, nchunks, (float*)partial);
  } else {
    unet::Src s0{(const __nv_bfloat16*)x0, H0, W0, C0, off_y0, off_x0};
    unet::Src s1{(const __nv_bfloat16*)x1, H1, W1, C1, 0, 0};
    dim3 grid(nchunks, CI / WCI, CO / unet::NCO);
    wgrad_mma_kernel<<<grid, unet::THREADS, 0, st>>>(
        s0, s1, (const __nv_bfloat16*)g, B, Ho, Wo, CO, nchunks,
        (float*)partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = CO * 9 * CI;
  wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)partial, nchunks, CO, CI, (float*)dw);
  return (int)cudaGetLastError();
}
