// conv3x3_head: the last decoder conv (3x3 + bias + ReLU) with the 1x1
// classifier head fused into its epilogue; only f32 logits are written.
//
// Replaces the TPU kernel
// unetseg_tpu/ops/pallas/conv3x3.py:conv3x3_head_phase2 (dec3 conv1 + outc
// on the serving path: (B,518,518,64) -> (B,516,516,2) f32).
//
// About 20 GFLOP per 700^2 tile, tensor-core bound. The unfused chain would
// write and re-read the 64-channel activation (34 MB per tile each way).
// conv3x3_head_bf16 runs the implicit GEMM of conv_fwd_wgmma.cu (windowed,
// N = 64: CO must be 64) with its head epilogue: bias and ReLU rounded to
// bf16 in shared memory, as the unfused path stores the activation, then
// the head in f32, writing 4 NC bytes per pixel.
#include "conv_fwd_wgmma.cuh"

// x (B,H,W,CI) bf16; w (64,3,3,CI) bf16; bias (64,) f32; head_w (NC,64) f32
// (bf16-rounded values); head_b (NC,) f32 -> logits (B,H-2,W-2,NC) f32.
// Returns the launch's CUDA error, or -(the CUresult) of a failed
// tensor-map encoding.
extern "C" int conv3x3_head_bf16(const void* x, const void* w, const void* bias,
                                 const void* head_w, const void* head_b,
                                 void* logits, int B, int H, int W, int CI,
                                 int NC, void* stream) {
  unet::Src s0{(const __nv_bfloat16*)x, H, W, CI, 0, 0};
  return unet::launch_conv_head_wgmma(s0, w, bias, head_w, head_b, NC, B, H - 2, W - 2, logits,
                                      stream);
}
