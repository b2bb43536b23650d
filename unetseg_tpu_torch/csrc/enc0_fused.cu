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
#include "conv_fwd_wgmma.cuh"

// x (B,H,W,1) bf16; w0 (64,3,3,1) bf16, b0 (64,) f32; w1 (64,3,3,64) bf16,
// b1 (64,) f32 -> y (B,H-4,W-4,64) bf16 and pooled (B,(H-4)/2,(W-4)/2,64)
// bf16, through enc0_fused_kernel (conv_fwd_wgmma.cu). Returns the launch's
// CUDA error, or -(the CUresult) of a failed tensor-map encoding.
extern "C" int enc0_fused_bf16(const void* x, const void* w0, const void* b0, const void* w1,
                               const void* b1, void* y, void* pooled, int B, int H, int W,
                               void* stream) {
  return unet::launch_enc0_fused_wgmma(x, w0, b0, w1, b1, y, pooled, B, H, W, stream);
}
