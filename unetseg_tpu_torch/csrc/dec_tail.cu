// dec_tail: the whole decoder tail in one kernel: the decoder-entry conv
// ReLU(conv3x3(concat(crop(skip), up)) + b0), the next conv ReLU(conv3x3
// (.) + b1) and the 1x1 head; only the f32 logits reach device memory.
//
// Replaces the TPU kernel unetseg_tpu/ops/pallas/conv3x3.py:dec_tail_phase2
// (serving path with dec_fuse="tail": skip0 (B,696,696,64) read at offset
// (88, 88), up (B,520,520,64) -> logits (B,516,516,NC) f32).
//
// About 59 GFLOP per 700^2 tile against 71 MB of traffic (the skip's crop
// and up read once, the logits written): tensor-core bound. The chained
// kernels write conv0's 34 MB activation and read it again per tile.
//
// dec_tail_bf16 launches dec_tail_kernel of conv_fwd_wgmma.cu (the
// transposed wgmma product fed by a TMA ring, conv0's tile kept in shared
// memory, bands of 30 logits rows walked 8 columns a step: the note
// there), whose logits equal the wgmma chain dec_conv0 -> conv3x3_head bit
// for bit.
//
// dec_tail_mma_reference_bf16 keeps the mma.sync kernel it replaced
// (uncounted, on no path; chip_smoke.py times it beside the new kernel and
// holds it to the mma.sync chain bit for bit): dec_tail_mma_kernel, whose
// block owns a 16x16 tile of logits:
//   1. conv0 over the (16+2)^2 pixels conv1 reads (a one-pixel halo,
//      recomputed at tile seams: 1.27x conv0's work), its K loop staging
//      32-channel slices of the (16+4)^2 windows of the skip (at the crop
//      offset, any parity) and of up, as conv_mma.cuh's two sources do.
//      The 324 pixels are 21 m16 tiles in row-major order, three per warp
//      (warps 5-7 two), each fragment row addressing its own pixel. Bias and
//      ReLU, rounded to bf16 into a shared tile, as the chained kernel
//      stores conv0's output;
//   2. conv1 from that tile with conv_mma.cuh's tile loop;
//   3. conv_mma.cuh's head epilogue: bias, ReLU, rounded to bf16, the 1x1
//      head in f32 (NC <= MAX_NC).
// Every sum runs in the mma.sync chained kernels' order (32-channel slices,
// taps, k16 steps), so its logits equal conv3x3_mma_reference's entry conv
// then its head bit for bit. Shared memory: conv0's tile 46.7 KB, the
// windows 32 KB, a weight slice 46 KB: one block (eight warps) per SM; the
// weights restaged every 32 channels between two barriers (221 KB per 256
// logits), 15% of its operations bound.
#include "conv_fwd_wgmma.cuh"

namespace {

using namespace unet;

constexpr int HALO = TH + 2;              // conv0 rows and columns per tile
constexpr int WIN = HALO + 2;             // input rows and columns per tile
constexpr int HPIX = HALO * HALO;         // conv0 pixels per tile
constexpr int MT = (HPIX + 15) / 16;      // m16 tiles over them
constexpr int MTW = (MT + WARPS - 1) / WARPS;  // m16 tiles per warp, at most
constexpr int H_BYTES = HPIX * OUT_P * 2;
constexpr int WIN_BYTES = WIN * WIN * KP * 2;
constexpr int TAIL_SMEM = H_BYTES + WIN_BYTES + W_SLICE * 2;
static_assert(TILE_BYTES + MAX_NC * NCO * 4 <= WIN_BYTES + W_SLICE * 2,
              "the head epilogue reuses the staging buffers");
static_assert(MTW == 3 && MT - 2 * WARPS <= WARPS, "three m16 tiles per warp");

__global__ void __launch_bounds__(THREADS)
dec_tail_mma_kernel(Src s0, Src s1, const __nv_bfloat16* __restrict__ w0,
                const float* __restrict__ b0, const __nv_bfloat16* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ head_w,
                const float* __restrict__ head_b, int NC, int Ho, int Wo,
                float* __restrict__ logits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (HPIX, OUT_P)
  __nv_bfloat16* in_s = h_s + HPIX * OUT_P;                      // (WIN^2, KP)
  __nv_bfloat16* w_s = in_s + WIN * WIN * KP;                    // weight slice

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const int CI = s0.C + s1.C;
  // the last m16 tile of warps 5-7 (tile 21-23) lies past the 324 pixels
  const int n_tiles = warp + 2 * WARPS < MT ? 3 : 2;

  // 1. conv0. Fragment rows g and g + 8 of m16 tile j are the pixels
  // p = 16 (warp + 8 j) + g (+ 8) of the halo tile, p = r * HALO + c, whose
  // 3x3 window starts at window pixel r * WIN + c.
  int p_lo[MTW], a_lo[MTW], a_hi[MTW];
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    p_lo[j] = 16 * (warp + j * WARPS) + g;
    const int lo = min(p_lo[j], HPIX - 1), hi = min(p_lo[j] + 8, HPIX - 1);
    a_lo[j] = ((lo / HALO) * WIN + lo % HALO) * KP + 2 * t;
    a_hi[j] = ((hi / HALO) * WIN + hi % HALO) * KP + 2 * t;
  }
  float acc0[MTW][8][4];
#pragma unroll
  for (int j = 0; j < MTW; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc0[j][n][i] = 0.f;

  for (int c = 0; c < CI; c += KC) {
    const Src s = c < s0.C ? s0 : s1;
    const int cs = c < s0.C ? c : c - s0.C;
    stage_window<WIN, WIN>(in_s, s, b, y0, x0, cs, tid);
    stage_weights(w_s, w0, 0, CI, c, tid);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int tap_off = ((tap / 3) * WIN + tap % 3) * KP;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t bf[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          load_b(bf[n], w_s + (tap * NCO + n * 8 + g) * KP + kk + 2 * t);
#pragma unroll
        for (int j = 0; j < MTW; ++j) {
          if (j < n_tiles) {
            uint32_t a[4];
            load_a(a, in_s + a_lo[j] + tap_off + kk, in_s + a_hi[j] + tap_off + kk);
#pragma unroll
            for (int n = 0; n < 8; ++n) mma_bf16_16816(acc0[j][n], a, bf[n]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    if (j >= n_tiles) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int co = n * 8 + 2 * t;
      const float bb0 = b0[co], bb1 = b0[co + 1];
      if (p_lo[j] < HPIX)
        *reinterpret_cast<__nv_bfloat162*>(h_s + p_lo[j] * OUT_P + co) =
            __floats2bfloat162_rn(fmaxf(acc0[j][n][0] + bb0, 0.f),
                                  fmaxf(acc0[j][n][1] + bb1, 0.f));
      if (p_lo[j] + 8 < HPIX)
        *reinterpret_cast<__nv_bfloat162*>(h_s + (p_lo[j] + 8) * OUT_P + co) =
            __floats2bfloat162_rn(fmaxf(acc0[j][n][2] + bb0, 0.f),
                                  fmaxf(acc0[j][n][3] + bb1, 0.f));
    }
  }

  // 2. conv1 from conv0's tile (the first weight slice's barrier also
  // publishes the tile)
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  for (int c = 0; c < NCO; c += KC) {
    stage_weights(w_s, w1, 0, NCO, c, tid);
    __syncthreads();
    mma_slice<HALO, OUT_P>(acc, h_s, c, w_s, warp, g, t);
    __syncthreads();
  }

  // 3. bias + ReLU into a shared tile over the staging buffers, then the head
  tile_to_smem(in_s, acc, b1, /*relu=*/1, 0, warp, g, t);
  head_tile(in_s, reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(in_s) + TILE_BYTES),
            head_w, head_b, NC, logits, b, y0, x0, Ho, Wo, tid);
}

}  // namespace

// skip (B,Hs,Ws,CIs), up (B,Hu,Wu,CIu) bf16; w0 (64,3,3,CIs+CIu) bf16, b0
// (64,) f32; w1 (64,3,3,64) bf16, b1 (64,) f32; head_w (NC,64) f32
// (bf16-rounded values), head_b (NC,) f32 -> logits (B,Hu-4,Wu-4,NC) f32.
// Returns the launch's CUDA error.
extern "C" int dec_tail_mma_reference_bf16(const void* skip, int Hs, int Ws, int CIs,
                             int row_off, int col_off, const void* up, int Hu,
                             int Wu, int CIu, const void* w0, const void* b0,
                             const void* w1, const void* b1, const void* head_w,
                             const void* head_b, int NC, void* logits, int B,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dec_tail_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TAIL_SMEM);
  if (err != cudaSuccess) return (int)err;
  unet::Src s0{(const __nv_bfloat16*)skip, Hs, Ws, CIs, row_off, col_off};
  unet::Src s1{(const __nv_bfloat16*)up, Hu, Wu, CIu, 0, 0};
  const int Ho = Hu - 4, Wo = Wu - 4;
  dim3 grid((Wo + unet::TW - 1) / unet::TW, (Ho + unet::TH - 1) / unet::TH, B);
  dec_tail_mma_kernel<<<grid, unet::THREADS, TAIL_SMEM, (cudaStream_t)stream>>>(
      s0, s1, (const __nv_bfloat16*)w0, (const float*)b0,
      (const __nv_bfloat16*)w1, (const float*)b1, (const float*)head_w,
      (const float*)head_b, NC, Ho, Wo, (float*)logits);
  return (int)cudaGetLastError();
}

// The same function through dec_tail_kernel (conv_fwd_wgmma.cu). Returns
// the launch's CUDA error, or -(the CUresult) of a failed tensor-map
// encoding.
extern "C" int dec_tail_bf16(const void* skip, int Hs, int Ws, int CIs, int row_off, int col_off,
                             const void* up, int Hu, int Wu, int CIu, const void* w0,
                             const void* b0, const void* w1, const void* b1, const void* head_w,
                             const void* head_b, int NC, void* logits, int B, void* stream) {
  unet::Src s0{(const __nv_bfloat16*)skip, Hs, Ws, CIs, row_off, col_off};
  unet::Src s1{(const __nv_bfloat16*)up, Hu, Wu, CIu, 0, 0};
  return unet::launch_dec_tail_wgmma(s0, s1, w0, b0, w1, b1, head_w, head_b, NC, B, Hu - 4,
                                     Wu - 4, logits, stream);
}
