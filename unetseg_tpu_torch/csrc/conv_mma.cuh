// Implicit-GEMM valid 3x3 convolution on Hopper tensor cores (mma.sync).
//
// Shared by conv3x3_bias_relu.cu, dec_conv0.cu, conv3x3_head.cu and
// conv3x3_dgrad.cu; enc0_fused.cu and dec_tail.cu build their mma.sync
// reference kernels from its pieces (staging, fragment loads, tile loop,
// epilogues);
// tconv2x2_bias.cu and conv3x3_wgrad.cu use its constants and mma helper.
// NHWC bf16 activations, weights (CO, 3, 3, CI) bf16 ("OHWI"), f32 bias,
// f32 accumulation. GEMM view: M = output pixels, N = output channels,
// K = 9 taps x CI.
//
// A block owns a 16x16 tile of output pixels and 64 output channels.
// Each step stages a 32-channel slice of the (16+2)x(16+2) input window
// and of the 9 x 64 weight taps in shared memory (rows padded to 40 bf16 so
// the fragment loads below hit 32 distinct banks), then eight warps each run
// two m16 tiles (two output rows) x eight n8 tiles with
// mma.m16n8k16.bf16. The epilogue adds the bias (none when `bias` is null),
// applies ReLU when `relu` is set, rounds to bf16 into a shared tile and
// from there writes coalesced 16-byte vectors, plus optionally the 2x2
// max-pool of the tile (MODE_STORE) or the 1x1 head on the rounded
// activation in f32 (MODE_HEAD).
//
// Two input sources: channels [0, s0.C) come from s0 read at
// (off_y, off_x) and channels [s0.C, s0.C + s1.C) from s1, so the decoder
// entry reads its skip at the crop offset and never materialises the crop
// or the concat. A source offset may be negative: rows and columns outside
// the source read as zeros, so the input gradient (conv3x3_dgrad.cu) runs
// this kernel on g at offset (-2, -2) without materialising the zero pad.
// Requirements (checked by the Python wrappers): s0.C and
// s1.C multiples of 32, CO a multiple of 64 (MODE_HEAD: CO == 64),
// 16-byte aligned pointers, contiguous tensors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unet {

constexpr int TW = 16;            // output columns per block (one m16 tile)
constexpr int TH = 16;            // output rows per block (8 warps x 2 rows)
constexpr int KC = 32;            // input channels staged per step
constexpr int KP = KC + 8;        // padded smem row, bf16 (80 bytes)
constexpr int NCO = 64;           // output channels per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int IN_ROWS = TH + 2;
constexpr int IN_COLS = TW + 2;
constexpr int OUT_P = NCO + 8;    // padded 64-channel pixel row in smem, bf16 (144 bytes)
constexpr int MAX_NC = 4;         // head classes
constexpr int MODE_STORE = 0;
constexpr int MODE_HEAD = 1;

constexpr int W_SLICE = 9 * NCO * KP;  // bf16 of one staged weight slice
constexpr int CONV_SMEM =
    (IN_ROWS * IN_COLS * KP + W_SLICE) * (int)sizeof(__nv_bfloat16);
constexpr int TILE_BYTES = TH * TW * OUT_P * 2;  // the epilogue's shared tile
static_assert(TILE_BYTES + MAX_NC * NCO * 4 <= CONV_SMEM,
              "epilogue tile must fit in the staging buffers");

struct Src {
  const __nv_bfloat16* p;
  int H, W, C, off_y, off_x;
};

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of an m16 x k16 tile: `lo` and `hi` point at column 2t of the
// fragment's rows g and g + 8.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* lo,
                                       const __nv_bfloat16* hi) {
  a[0] = ld_u32(lo);
  a[1] = ld_u32(hi);
  a[2] = ld_u32(lo + 8);
  a[3] = ld_u32(hi + 8);
}

// B fragment of a k16 x n8 tile: `p` points at row 2t of the fragment's
// column g (a weight row of the staged slice).
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* p) {
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// Stage channels [cs, cs + KC) of the ROWS x COLS window of s whose corner
// is (y0 + s.off_y, x0 + s.off_x) into in_s, one KP-padded row per pixel;
// pixels outside s read as zeros.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_window(__nv_bfloat16* in_s, Src s, int b,
                                             int y0, int x0, int cs, int tid) {
  for (int i = tid; i < ROWS * COLS * (KC / 8); i += THREADS) {
    const int v = i % (KC / 8), pix = i / (KC / 8);
    const int iy = y0 + pix / COLS + s.off_y;
    const int ix = x0 + pix % COLS + s.off_x;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W) {
      const size_t off = ((size_t)b * s.H + iy) * s.W + ix;
      val = *reinterpret_cast<const uint4*>(s.p + off * s.C + cs + v * 8);
    }
    *reinterpret_cast<uint4*>(in_s + pix * KP + v * 8) = val;
  }
}

// Stage input channels [c, c + KC) of output channels [co0, co0 + NCO) of
// w (CO, 3, 3, CI) into w_s, one KP-padded row per (tap, co).
__device__ __forceinline__ void stage_weights(__nv_bfloat16* w_s,
                                              const __nv_bfloat16* __restrict__ w,
                                              int co0, int CI, int c, int tid) {
  for (int i = tid; i < 9 * NCO * (KC / 8); i += THREADS) {
    const int v = i % (KC / 8), rest = i / (KC / 8);
    const int co = rest % NCO, tap = rest / NCO;
    const size_t off = ((size_t)(co0 + co) * 9 + tap) * CI + c + v * 8;
    *reinterpret_cast<uint4*>(w_s + (tap * NCO + co) * KP + v * 8) =
        *reinterpret_cast<const uint4*>(w + off);
  }
}

// One staged KC-channel slice into the accumulators of a 16x16 output
// tile: warp `warp` owns output rows 2 warp and 2 warp + 1. The input tile
// in_s holds COLS pixels per row and STRIDE bf16 per pixel, the slice at
// channel c_off of each pixel.
template <int COLS, int STRIDE>
__device__ __forceinline__ void mma_slice(float (&acc)[2][8][4],
                                          const __nv_bfloat16* in_s, int c_off,
                                          const __nv_bfloat16* w_s, int warp,
                                          int g, int t) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* base =
            in_s + ((warp * 2 + m + ky) * COLS + kx) * STRIDE + c_off + kk + 2 * t;
        load_a(a[m], base + g * STRIDE, base + (g + 8) * STRIDE);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bf[2];
        load_b(bf, w_s + (tap * NCO + n * 8 + g) * KP + kk + 2 * t);
        mma_bf16_16816(acc[0][n], a[0], bf);
        mma_bf16_16816(acc[1][n], a[1], bf);
      }
    }
  }
}

// Epilogue of a 16x16 tile: acc + bias (a null bias adds 0), ReLU when
// relu, rounded to bf16 into out_s, one OUT_P-padded row per pixel.
__device__ __forceinline__ void tile_to_smem(__nv_bfloat16* out_s,
                                             const float (&acc)[2][8][4],
                                             const float* __restrict__ bias,
                                             int relu, int co0, int warp, int g,
                                             int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int row = warp * 2 + m;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int co = n * 8 + 2 * t;
      const float b0 = bias ? bias[co0 + co] : 0.f;
      const float b1 = bias ? bias[co0 + co + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(out_s + (row * TW + g) * OUT_P + co) =
          __floats2bfloat162_rn(act(acc[m][n][0] + b0, relu),
                                act(acc[m][n][1] + b1, relu));
      *reinterpret_cast<__nv_bfloat162*>(out_s + (row * TW + g + 8) * OUT_P + co) =
          __floats2bfloat162_rn(act(acc[m][n][2] + b0, relu),
                                act(acc[m][n][3] + b1, relu));
    }
  }
}

// Coalesced store of the shared tile to y (B, Ho, Wo, CO) at channels
// [co0, co0 + NCO), and its 2x2 max-pool to pooled when it is not null.
__device__ __forceinline__ void store_tile(const __nv_bfloat16* out_s,
                                           __nv_bfloat16* __restrict__ y,
                                           __nv_bfloat16* __restrict__ pooled,
                                           int b, int y0, int x0, int Ho, int Wo,
                                           int CO, int co0, int tid) {
  __syncthreads();
  for (int i = tid; i < TH * TW * (NCO / 8); i += THREADS) {
    const int v = i % (NCO / 8), pix = i / (NCO / 8);
    const int oy = y0 + pix / TW, ox = x0 + pix % TW;
    if (oy < Ho && ox < Wo) {
      const size_t off = ((size_t)b * Ho + oy) * Wo + ox;
      *reinterpret_cast<uint4*>(y + off * CO + co0 + v * 8) =
          *reinterpret_cast<const uint4*>(out_s + pix * OUT_P + v * 8);
    }
  }
  if (pooled == nullptr) return;
  // Tiles start at even rows and columns, so every 2x2 window lies in
  // one tile; odd sizes floor (Hp = Ho / 2).
  const int Hp = Ho / 2, Wp = Wo / 2;
  for (int i = tid; i < (TH / 2) * (TW / 2) * (NCO / 8); i += THREADS) {
    const int v = i % (NCO / 8), q = i / (NCO / 8);
    const int qr = q / (TW / 2), qc = q % (TW / 2);
    const int py = y0 / 2 + qr, px = x0 / 2 + qc;
    if (py < Hp && px < Wp) {
      const int p00 = (2 * qr) * TW + 2 * qc;
      uint4 r = *reinterpret_cast<const uint4*>(out_s + p00 * OUT_P + v * 8);
      const int others[3] = {p00 + 1, p00 + TW, p00 + TW + 1};
      __nv_bfloat162* rv = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint4 o = *reinterpret_cast<const uint4*>(out_s + others[k] * OUT_P + v * 8);
        const __nv_bfloat162* ov = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) rv[j] = __hmax2(rv[j], ov[j]);
      }
      const size_t off = ((size_t)b * Hp + py) * Wp + px;
      *reinterpret_cast<uint4*>(pooled + off * CO + co0 + v * 8) = r;
    }
  }
}

// 1x1 head on the shared tile (the bf16-rounded activation), f32 products
// and sums, to logits (B, Ho, Wo, NC); hw_s holds MAX_NC x NCO floats.
__device__ __forceinline__ void head_tile(const __nv_bfloat16* out_s, float* hw_s,
                                          const float* __restrict__ head_w,
                                          const float* __restrict__ head_b,
                                          int NC, float* __restrict__ logits,
                                          int b, int y0, int x0, int Ho, int Wo,
                                          int tid) {
  for (int i = tid; i < NC * NCO; i += THREADS) hw_s[i] = head_w[i];
  __syncthreads();
  for (int pix = tid; pix < TH * TW; pix += THREADS) {
    const int oy = y0 + pix / TW, ox = x0 + pix % TW;
    if (oy >= Ho || ox >= Wo) continue;
    float l[MAX_NC];
#pragma unroll
    for (int k = 0; k < MAX_NC; ++k) l[k] = k < NC ? head_b[k] : 0.f;
    for (int co = 0; co < NCO; co += 2) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(out_s + pix * OUT_P + co));
#pragma unroll
      for (int k = 0; k < MAX_NC; ++k)
        if (k < NC) l[k] += v.x * hw_s[k * NCO + co] + v.y * hw_s[k * NCO + co + 1];
    }
    const size_t off = ((size_t)b * Ho + oy) * Wo + ox;
    for (int k = 0; k < NC; ++k) logits[off * NC + k] = l[k];
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv3x3_mma_kernel(Src s0, Src s1, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, int relu, int Ho, int Wo,
                   int CO, __nv_bfloat16* __restrict__ y,
                   __nv_bfloat16* __restrict__ pooled,
                   const float* __restrict__ head_w,
                   const float* __restrict__ head_b, int NC,
                   float* __restrict__ logits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = in_s + IN_ROWS * IN_COLS * KP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int n_co_blk = CO / NCO;
  const int b = blockIdx.z / n_co_blk;
  const int co0 = (blockIdx.z % n_co_blk) * NCO;
  const int CI = s0.C + s1.C;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  for (int c = 0; c < CI; c += KC) {
    const Src s = c < s0.C ? s0 : s1;
    const int cs = c < s0.C ? c : c - s0.C;
    stage_window<IN_ROWS, IN_COLS>(in_s, s, b, y0, x0, cs, tid);
    stage_weights(w_s, w, co0, CI, c, tid);
    __syncthreads();
    mma_slice<IN_COLS, KP>(acc, in_s, 0, w_s, warp, g, t);
    __syncthreads();
  }

  // Epilogue: bias (+ ReLU), rounded to bf16, into a shared (TH*TW, NCO)
  // tile over the staging buffers.
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(smem);
  tile_to_smem(out_s, acc, bias, relu, co0, warp, g, t);
  if (MODE == MODE_STORE) {
    store_tile(out_s, y, pooled, b, y0, x0, Ho, Wo, CO, co0, tid);
  } else {
    head_tile(out_s, reinterpret_cast<float*>(smem + TILE_BYTES), head_w, head_b,
              NC, logits, b, y0, x0, Ho, Wo, tid);
  }
}

template <int MODE>
inline int launch_conv3x3_mma(Src s0, Src s1, const void* w, const void* bias,
                              int relu, int B, int Ho, int Wo, int CO, void* y,
                              void* pooled, const void* head_w,
                              const void* head_b, int NC, void* logits,
                              void* stream) {
  auto kernel = conv3x3_mma_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * (CO / NCO));
  kernel<<<grid, THREADS, CONV_SMEM, (cudaStream_t)stream>>>(
      s0, s1, (const __nv_bfloat16*)w, (const float*)bias, relu, Ho, Wo, CO,
      (__nv_bfloat16*)y, (__nv_bfloat16*)pooled,
      (const float*)head_w, (const float*)head_b, NC, (float*)logits);
  return (int)cudaGetLastError();
}

}  // namespace unet
