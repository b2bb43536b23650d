// conv3x3_dgrad: the input gradient of a valid 3x3 conv,
// dx[b, y, x, ci] = sum_{ky,kx,co} g[b, y-ky, x-kx, co] w[co, ci, ky, kx],
// i.e. the valid 3x3 conv of g zero-padded by 2 on each side with the
// kernel flipped in (ky, kx) and CI <-> CO transposed.
//
// Replaces the TPU kernel
// unetseg_tpu/ops/pallas/conv3x3_train.py:conv3x3_phase2_dx (the train
// step's enc0 conv1, g (4,508,508,64) -> dx (4,510,510,64); dec3 conv1,
// (4,324,324,64) -> (4,326,326,64); dec3 conv0, (4,326,326,64) -> the
// concat gradient (4,328,328,128)).
//
// About 2 * 9 * 64 * 64 FLOP per dx pixel (76 GFLOP at enc0) against
// ~265 MB of traffic, so tensor-core bound like the forward conv. It runs
// the forward's implicit GEMM (conv_mma.cuh) unchanged: g is the source,
// read at offset (-2, -2), and the window loader's zero fill for rows and
// columns outside g stands in for the pad, which is never materialised.
// The flipped, transposed kernel is a 74 KB re-layout done by the wrapper.
// No bias, no ReLU, bf16 store with f32 accumulation.
#include "conv_mma.cuh"

// g (B,Hg,Wg,CO) bf16; wt (CI,3,3,CO) bf16, wt[ci,ky,kx,co] =
// w[co,ci,2-ky,2-kx] -> dx (B,Hg+2,Wg+2,CI) bf16. Needs CO % 32 == 0 and
// CI % 64 == 0. Returns the launch's CUDA error.
extern "C" int conv3x3_dgrad_bf16(const void* g, const void* wt, void* dx,
                                  int B, int Hg, int Wg, int CO, int CI,
                                  void* stream) {
  unet::Src s0{(const __nv_bfloat16*)g, Hg, Wg, CO, -2, -2};
  unet::Src s1{nullptr, 0, 0, 0, 0, 0};
  return unet::launch_conv3x3_mma<unet::MODE_STORE>(
      s0, s1, wt, nullptr, /*relu=*/0, B, Hg + 2, Wg + 2, CI, dx, nullptr,
      nullptr, nullptr, 0, nullptr, stream);
}
