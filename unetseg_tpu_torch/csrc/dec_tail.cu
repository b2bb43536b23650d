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
#include "conv_fwd_wgmma.cuh"

// skip (B,Hs,Ws,CIs), up (B,Hu,Wu,CIu) bf16; w0 (64,3,3,CIs+CIu) bf16, b0
// (64,) f32; w1 (64,3,3,64) bf16, b1 (64,) f32; head_w (NC,64) f32
// (bf16-rounded values), head_b (NC,) f32 -> logits (B,Hu-4,Wu-4,NC) f32,
// through dec_tail_kernel (conv_fwd_wgmma.cu). Returns the launch's CUDA
// error, or -(the CUresult) of a failed tensor-map encoding.
extern "C" int dec_tail_bf16(const void* skip, int Hs, int Ws, int CIs, int row_off, int col_off,
                             const void* up, int Hu, int Wu, int CIu, const void* w0,
                             const void* b0, const void* w1, const void* b1, const void* head_w,
                             const void* head_b, int NC, void* logits, int B, void* stream) {
  unet::Src s0{(const __nv_bfloat16*)skip, Hs, Ws, CIs, row_off, col_off};
  unet::Src s1{(const __nv_bfloat16*)up, Hu, Wu, CIu, 0, 0};
  return unet::launch_dec_tail_wgmma(s0, s1, w0, b0, w1, b1, head_w, head_b, NC, B, Hu - 4,
                                     Wu - 4, logits, stream);
}
