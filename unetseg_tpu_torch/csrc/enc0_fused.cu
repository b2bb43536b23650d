// enc0_fused: the stem conv (1 -> 64 channels) + bias + ReLU, enc0 conv1
// (64 -> 64) + bias + ReLU and the 2x2 max-pool of conv1 in one kernel;
// the stem activation never reaches device memory.
//
// Replaces the TPU kernel unetseg_tpu/ops/pallas/conv3x3.py:enc0_fused_phase2
// (serving path with fused_enc0: x (B,700,700,1) -> skip0 (B,696,696,64)
// and pooled (B,348,348,64)).
//
// About 36 GFLOP per 700^2 tile, almost all of it conv1's, against 79 MB
// of traffic (x in, skip0 and pooled out): tensor-core bound. The chained
// kernels write the 62 MB stem activation and read it again per tile.
//
// enc0_fused_bf16 launches enc0_fused_kernel of conv_fwd_wgmma.cu (the note
// there): bands of 32 output rows walked 8 columns a step on a persistent
// grid; a stem warpgroup computes the stem on the FMA units into one of two
// shared tiles (the two halo columns carried from the step before) while
// two consumer warpgroups run conv1 from the other as the fused tail's
// transposed wgmma product, its nine weight taps resident; the 2x2 pool
// from the accumulator registers; TMA tensor stores. Its skip0 and pooled
// equal the counted chain conv3x3_bias_relu (stem_rows_kernel) ->
// conv3x3_bias_relu with the pool (the windowed wgmma form) bit for bit.
//
// enc0_fused_mma_reference_bf16 keeps the mma.sync kernel it replaced
// (uncounted, on no path; chip_smoke.py times it beside the new kernel and
// holds it to the mma.sync chain bit for bit): enc0_fused_mma_kernel, whose
// block owns a 16x16 tile of conv1 outputs and all 64 channels:
//   1. the (16+4)^2 input patch and the stem taps go to shared memory as
//      f32, and the stem runs on the FMA units for the (16+2)^2 pixels
//      conv1 reads (a one-pixel halo, recomputed at tile seams: 1.27x the
//      stem's work), each value rounded to bf16 into a shared tile, as the
//      chained stem stores it;
//   2. conv1 runs from that tile with conv_mma.cuh's tile loop, its weight
//      staged 32 input channels at a time between two barriers;
//   3. conv_mma.cuh's epilogue adds the bias, applies ReLU, stores skip0
//      and the 2x2 max-pool (tiles start at even rows and columns; odd
//      sizes floor).
// The stem and conv1 sum in the order of the stem kernel and the mma.sync
// conv (32-channel slices, taps, k16 steps), so its result equals the stem
// kernel chained with conv3x3_mma_reference, bit for bit. Two 256-thread
// blocks an SM, no asynchronous copy, the stem between barriers: 17% of its
// operations bound.
#include "conv_fwd_wgmma.cuh"

namespace {

using namespace unet;

constexpr int HALO = TH + 2;  // stem rows and columns a tile's conv1 reads
constexpr int XIN = TH + 4;   // input rows and columns the stem reads
constexpr int STEM_BYTES = HALO * HALO * OUT_P * 2;
constexpr int ENC0_SMEM =
    STEM_BYTES + W_SLICE * 2 + (XIN * XIN + 9 * NCO + NCO) * 4;
static_assert(TILE_BYTES <= STEM_BYTES, "the epilogue tile reuses the stem tile");

__global__ void __launch_bounds__(THREADS, 2)
enc0_fused_mma_kernel(const __nv_bfloat16* __restrict__ x, int H, int W,
                  const __nv_bfloat16* __restrict__ w0,
                  const float* __restrict__ b0,
                  const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, int Ho, int Wo,
                  __nv_bfloat16* __restrict__ y,
                  __nv_bfloat16* __restrict__ pooled) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (HALO^2, OUT_P)
  __nv_bfloat16* w_s = h_s + HALO * HALO * OUT_P;               // conv1 slice
  float* x_s = reinterpret_cast<float*>(w_s + W_SLICE);         // (XIN, XIN)
  float* w0_s = x_s + XIN * XIN;                                // (9, NCO)
  float* b0_s = w0_s + 9 * NCO;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z;

  for (int i = tid; i < XIN * XIN; i += THREADS) {
    const int iy = y0 + i / XIN, ix = x0 + i % XIN;
    x_s[i] = (iy < H && ix < W) ? __bfloat162float(x[((size_t)b * H + iy) * W + ix])
                                : 0.f;
  }
  for (int i = tid; i < 9 * NCO; i += THREADS) {
    const int co = i % NCO, tap = i / NCO;
    w0_s[i] = __bfloat162float(w0[co * 9 + tap]);
  }
  if (tid < NCO) b0_s[tid] = b0[tid];
  stage_weights(w_s, w1, 0, NCO, 0, tid);
  __syncthreads();

  // 1. the stem: one pixel of the halo tile and 8 channels per item
  for (int i = tid; i < HALO * HALO * (NCO / 8); i += THREADS) {
    const int cg = i % (NCO / 8), pix = i / (NCO / 8);
    const int r = pix / HALO, c = pix % HALO;
    float p[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) p[tap] = x_s[(r + tap / 3) * XIN + c + tap % 3];
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = b0_s[cg * 8 + k];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += w0_s[tap * NCO + cg * 8 + k] * p[tap];
    __align__(16) __nv_bfloat162 out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = __floats2bfloat162_rn(fmaxf(acc[2 * k], 0.f), fmaxf(acc[2 * k + 1], 0.f));
    *reinterpret_cast<uint4*>(h_s + pix * OUT_P + cg * 8) =
        *reinterpret_cast<const uint4*>(out);
  }

  // 2. conv1 from the stem tile, 32 input channels per weight slice
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  for (int c = 0; c < NCO; c += KC) {
    if (c > 0) stage_weights(w_s, w1, 0, NCO, c, tid);
    __syncthreads();
    mma_slice<HALO, OUT_P>(acc, h_s, c, w_s, warp, g, t);
    __syncthreads();
  }

  // 3. bias + ReLU into a shared tile over the stem tile, skip0 and pool
  tile_to_smem(h_s, acc, b1, /*relu=*/1, 0, warp, g, t);
  store_tile(h_s, y, pooled, b, y0, x0, Ho, Wo, NCO, 0, tid);
}

}  // namespace

// x (B,H,W,1) bf16; w0 (64,3,3,1) bf16, b0 (64,) f32; w1 (64,3,3,64) bf16,
// b1 (64,) f32 -> y (B,H-4,W-4,64) bf16 and pooled (B,(H-4)/2,(W-4)/2,64)
// bf16, through the mma.sync kernel. Returns the launch's CUDA error.
extern "C" int enc0_fused_mma_reference_bf16(const void* x, const void* w0, const void* b0,
                                             const void* w1, const void* b1, void* y,
                                             void* pooled, int B, int H, int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      enc0_fused_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ENC0_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int Ho = H - 4, Wo = W - 4;
  dim3 grid((Wo + unet::TW - 1) / unet::TW, (Ho + unet::TH - 1) / unet::TH, B);
  enc0_fused_mma_kernel<<<grid, unet::THREADS, ENC0_SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, H, W, (const __nv_bfloat16*)w0, (const float*)b0,
      (const __nv_bfloat16*)w1, (const float*)b1, Ho, Wo, (__nv_bfloat16*)y,
      (__nv_bfloat16*)pooled);
  return (int)cudaGetLastError();
}

// The same function through enc0_fused_kernel (conv_fwd_wgmma.cu). Returns
// the launch's CUDA error, or -(the CUresult) of a failed tensor-map
// encoding.
extern "C" int enc0_fused_bf16(const void* x, const void* w0, const void* b0, const void* w1,
                               const void* b1, void* y, void* pooled, int B, int H, int W,
                               void* stream) {
  return unet::launch_enc0_fused_wgmma(x, w0, b0, w1, b1, y, pooled, B, H, W, stream);
}
