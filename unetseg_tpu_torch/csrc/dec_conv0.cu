// dec_conv0: the decoder-entry conv, ReLU(conv3x3(concat(crop(skip), up)) + b),
// with neither the crop nor the concat materialised (relu == 0: the train
// step's pre-BatchNorm z, without the ReLU).
//
// Replaces the TPU kernels
// unetseg_tpu/ops/pallas/conv3x3.py:dec_conv0_phase2 (dec3 conv0 on the
// serving path: skip (B,696,696,64) read at offset (88, 88), up
// (B,520,520,64) -> (B,518,518,64)) and, through the dec_conv0_dense
// wrapper, conv3x3.py:dec_conv0_lanes (tier-2 dec2 conv0: skip1
// (B,344,344,128) at offset (40, 40), up2 (B,264,264,128) ->
// (B,262,262,128)).
//
// About 40 GFLOP per 700^2 tile (K = 9 x 128) against ~140 MB of traffic, so
// tensor-core bound. It runs the implicit GEMM of conv_fwd_wgmma.cu with two
// sources: the K loop first walks the skip's 64-channel slices, copied at
// the crop offset (a TMA box coordinate: any offset, odd ones included),
// then the up tensor's, with the weight's input channels split the same way
// (skip first, as the trained concat-conv kernel orders them). The crop and
// the concat cost no device-memory traffic at all.
#include "conv_fwd_wgmma.cuh"

// skip (B,Hs,Ws,CIs), up (B,Hu,Wu,CIu) bf16; w (CO,3,3,CIs+CIu) bf16;
// bias (CO,) f32 -> y (B,Hu-2,Wu-2,CO) bf16. Returns the launch's CUDA error.
extern "C" int dec_conv0_bf16(const void* skip, int Hs, int Ws, int CIs,
                              int row_off, int col_off, const void* up, int Hu,
                              int Wu, int CIu, const void* w, const void* bias,
                              void* y, int B, int CO, int relu, void* stream) {
  unet::Src s0{(const __nv_bfloat16*)skip, Hs, Ws, CIs, row_off, col_off};
  unet::Src s1{(const __nv_bfloat16*)up, Hu, Wu, CIu, 0, 0};
  return unet::launch_conv_fwd_wgmma(s0, s1, w, bias, relu, B, Hu - 2, Wu - 2, CO, y, nullptr,
                                     stream);
}
