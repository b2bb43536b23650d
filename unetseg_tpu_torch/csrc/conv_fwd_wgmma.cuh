// The forward implicit-GEMM 3x3 convolution on wgmma fed by a TMA ring
// (conv_fwd_wgmma.cu): the multi-channel path of conv3x3_bias_relu.cu
// (conv3x3_bias_relu, conv3x3_dense, conv3x3_cblock), dec_conv0.cu
// (dec_conv0, dec_conv0_dense), conv3x3_head.cu (conv3x3_head),
// conv3x3_dgrad.cu (conv3x3_dgrad, conv3x3_dense_dgrad), dec_tail.cu
// (dec_tail) and enc0_fused.cu (enc0_fused).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unet {

constexpr int MAX_NC = 4;  // head classes

// A convolution's input: NHWC bf16 at p, read at (off_y, off_x); rows and
// columns outside it read as zeros.
struct Src {
  const __nv_bfloat16* p;
  int H, W, C, off_y, off_x;
};

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : v;
}

// y (B, Ho, Wo, CO) = act(conv3x3(concat(s0 at (s0.off_y, s0.off_x), s1)) +
// bias) in bf16, and its 2x2 max-pool (B, Ho/2, Wo/2, CO) when pooled is
// not null; act is ReLU when relu, else the identity. s0.C and s1.C
// multiples of 32 (s1.C may be 0; s1 is read at (0, 0)), CO a multiple of
// 64, weights (CO, 3, 3, s0.C + s1.C) bf16, bias (CO,) f32, 16-byte
// aligned contiguous tensors. Returns the launch's CUDA error, or -(the
// CUresult) of a failed tensor-map encoding.
int launch_conv_fwd_wgmma(Src s0, Src s1, const void* w, const void* bias, int relu, int B,
                          int Ho, int Wo, int CO, void* y, void* pooled, void* stream);

// dx (B, Hg + 2, Wg + 2, CI) bf16 = the input gradient of a valid 3x3
// conv: the forward's kernels under their dgrad names on g (B, Hg, Wg, CO)
// bf16 read at (-2, -2), no bias, no ReLU; wt (CI, 3, 3, CO) bf16 the
// flipped, transposed weights, wt[ci, ky, kx, co] = w[co, ci, 2 - ky, 2 -
// kx]. CO a multiple of 32, CI of 64. Returns as launch_conv_fwd_wgmma.
int launch_conv_dgrad_wgmma(const void* g, int B, int Hg, int Wg, int CO, const void* wt, int CI,
                            void* dx, void* stream);

// logits (B, Ho, Wo, nc) f32 = the 1x1 head (head_w (nc, 64) f32 holding
// bf16 values, head_b (nc,) f32; 1 <= nc <= MAX_NC) over ReLU(conv3x3(s0)
// + bias) rounded to bf16, s0 read at (0, 0); 64 output channels, weights
// (64, 3, 3, s0.C) bf16, bias (64,) f32. Returns as launch_conv_fwd_wgmma.
int launch_conv_head_wgmma(Src s0, const void* w, const void* bias, const void* head_w,
                           const void* head_b, int nc, int B, int Ho, int Wo, void* logits,
                           void* stream);

// logits (B, Ho, Wo, nc) f32 = the 1x1 head over ReLU(conv3x3(c0) + b1)
// rounded to bf16, c0 = ReLU(conv3x3(concat(s0 at (s0.off_y, s0.off_x),
// s1)) + b0) rounded to bf16 and kept in shared memory (the fused decoder
// tail); Ho = s1.H - 4, Wo = s1.W - 4; 64 output channels for both convs,
// w0 (64, 3, 3, s0.C + s1.C), w1 (64, 3, 3, 64) bf16, head as
// launch_conv_head_wgmma. Returns as launch_conv_fwd_wgmma.
int launch_dec_tail_wgmma(Src s0, Src s1, const void* w0, const void* b0, const void* w1,
                          const void* b1, const void* head_w, const void* head_b, int nc, int B,
                          int Ho, int Wo, void* logits, void* stream);

// skip0 (B, H - 4, W - 4, 64) = ReLU(conv3x3(h, w1) + b1) rounded to
// bf16 and, where H - 4 and W - 4 are both at least 2, pooled (B, (H -
// 4) / 2, (W - 4) / 2, 64) its 2x2 max-pool, h = ReLU(conv3x3(x, w0) + b0)
// rounded to bf16 and kept in shared memory (the fused enc0); x (B, H, W,
// 1) bf16, w0 (64, 3, 3, 1), w1 (64, 3, 3, 64) bf16, b0 and b1 (64,) f32.
// Returns as launch_conv_fwd_wgmma.
int launch_enc0_fused_wgmma(const void* x, const void* w0, const void* b0, const void* w1,
                            const void* b1, void* y, void* pooled, int B, int H, int W,
                            void* stream);

}  // namespace unet
