// conv3x3_dgrad: the input gradient of a valid 3x3 conv,
// dx[b, y, x, ci] = sum_{ky,kx,co} g[b, y-ky, x-kx, co] w[co, ci, ky, kx],
// i.e. the valid 3x3 conv of g zero-padded by 2 on each side with the
// kernel flipped in (ky, kx) and CI <-> CO transposed.
//
// Replaces the TPU kernels unetseg_tpu/ops/pallas/conv3x3_train.py:74
// conv3x3_phase2_dx (the train step's enc0 conv1, g (4,508,508,64) -> dx
// (4,510,510,64); dec3 conv1, (4,324,324,64) -> (4,326,326,64); dec3
// conv0, (4,326,326,64) -> the concat gradient (4,328,328,128)) and :266
// conv3x3_dense_dx (tier 2: g of 128 channels into dx of 64, 128 or 256).
//
// 2 * 9 * CO * CI FLOP per dx pixel (76 GFLOP at enc0) against ~265 MB of
// traffic: on an H100 (989 TFLOP/s bf16, 3.35 TB/s) bytes bound the
// 64-channel cases by a hair and operations the rest, like the forward
// convs of the same widths. So it runs the forward's wgmma kernels
// (conv_fwd_wgmma.cu, under the names conv_dgrad_kernel and
// conv_dgrad_im2col_kernel): g is the source, read at (-2, -2); the TMA
// copies zero-fill every row and column outside g, which stands in for the
// pad, never materialised, and the outputs past g's far edges (dx is 2
// larger each way) are units like any other, their stores masked. dx with
// 64 channels takes the windowed form at N = 64, 128 and 256 channels the
// im2col form at N = 128, its bounding box moved to (-2, -2) .. (0, 0).
// No bias (instantiations of their own without it, so the forward's
// epilogue is untouched), no ReLU, bf16 store with f32 accumulation. The
// flipped, transposed kernel is a 74 KB re-layout done by the wrapper: wt
// (CI, 3, 3, CO) is the forward's OHWI layout with O = dx channels and I
// = g channels.
#include "conv_fwd_wgmma.cuh"

// g (B,Hg,Wg,CO) bf16; wt (CI,3,3,CO) bf16, wt[ci,ky,kx,co] =
// w[co,ci,2-ky,2-kx] -> dx (B,Hg+2,Wg+2,CI) bf16. Needs CO % 32 == 0 and
// CI % 64 == 0. Returns the launch's CUDA error, or -(the CUresult) of a
// failed tensor-map encoding.
extern "C" int conv3x3_dgrad_bf16(const void* g, const void* wt, void* dx,
                                  int B, int Hg, int Wg, int CO, int CI,
                                  void* stream) {
  return unet::launch_conv_dgrad_wgmma(g, B, Hg, Wg, CO, wt, CI, dx, stream);
}
