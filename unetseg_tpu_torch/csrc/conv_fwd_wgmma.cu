// conv_fwd_wgmma: the forward valid 3x3 convolution as an implicit GEMM on
// wgmma, fed by a TMA ring: y = act(conv3x3(concat(crop(s0), s1)) + bias)
// in bf16, optionally with its 2x2 max-pool.
//
// Replaces, behind the wrappers of ops/kernels/conv3x3.py, the multi-channel
// forward of five TPU kernels (unetseg_tpu/ops/pallas/): conv3x3.py:377
// conv3x3_phase2 with CI >= 32 (enc0 conv1 + pool when serving, enc0 conv1
// and dec3 conv1 with relu=False in the train step; wrapper
// conv3x3_bias_relu), conv3x3.py:190 conv3x3_lanes (conv3x3_dense),
// conv_cblock.py:118 conv3x3_cblock (conv3x3_cblock), conv3x3.py:893
// dec_conv0_phase2 (dec_conv0) and conv3x3.py:1170 dec_conv0_lanes
// (dec_conv0_dense). On NHWC the five are one function; the C entries of
// conv3x3_bias_relu.cu and dec_conv0.cu launch it. With the 1x1 head in
// its epilogue it also replaces conv3x3.py:540 conv3x3_head_phase2 (entry
// conv3x3_head.cu), and on the output gradient read at (-2, -2) with no
// bias the input gradients conv3x3_train.py:74 conv3x3_phase2_dx and :266
// conv3x3_dense_dx (entry conv3x3_dgrad.cu; kernels conv_dgrad_kernel and
// conv_dgrad_im2col_kernel, the same code under names of their own). Its
// rings and epilogues, with conv0's tile kept in shared memory and conv1
// and the head after it, also replace conv3x3.py:1026 dec_tail_phase2
// (entry dec_tail.cu, kernel dec_tail_kernel); the tail's transposed conv1
// with resident weights, after a stem on the FMA units into a shared tile
// and with the 2x2 pool from registers, replaces conv3x3.py:663
// enc0_fused_phase2 (entry enc0_fused.cu, kernel enc0_fused_kernel).
//
// GEMM view: M = output pixels, N = output channels, K = 9 taps x CI.
// On an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) bytes bound enc0 conv1 (571
// GFLOP over 2.2 GB per 16 tiles of 700^2), just above its operations, and
// operations bound every conv from 128 channels on. What bounds the kernel
// (chip_smoke.py, H100 80GB HBM3 at 700 W): at 64 output channels (N = 64) each wgmma.m64n64k16 reads 4 KB of
// shared memory per 32 clocks of tensor work, all of an SM's 128 bytes a
// clock, and a tile of one 64-channel slice is nine stages between a
// pipeline fill and an epilogue: enc0 conv1 + pool runs at 430 TFLOP/s,
// half its bound. From 128 channels on the ring runs at 600-800 TFLOP/s;
// at 1024 channels (enc4, 36^2 outputs) the windowed 8x8 units fill 0.81
// of their tiles, which the im2col form does not waste.
//
// Two forms, one ring design. One producer warp issues TMA copies into
// mbarrier rings; two consumer warpgroups of two m64 units each issue
// wgmma.m64nNk16 with both operands K-major in the 128-byte swizzle (64
// channels = one 128-byte row a pixel); N = 128 output channels a block,
// 64 where 128 does not divide CO. Each (tap, 64-channel slice) stage is 4
// x 2 wgmmas; one group stays in flight, and a stage is released on its
// "empty" mbarrier (one arrive per consumer warp) once the group that read
// it has completed. The B tile of a (tap, slice) is a box of a 3-D (CO, 9,
// CI) view of the OHWI weights, so a slice past CI (32- and 96-channel
// sources) reads zeros, not the next tap. A persistent grid of one block
// per SM walks the tiles (unit group, N block), N blocks fastest; the
// producer runs ahead into the next tile while the consumers store this one.
// - im2col form (one source, no pool, N = 128): a unit is 64 consecutive output
//   pixels, a tile 256 across rows and images, so no width wastes rows.
//   Per (tap, slice) a stage holds the tile's 256 x 64 A, copied by TMA's
//   im2col mode (bounding box: the output positions moved by the source's
//   offset, so the dgrad's (-2, -2) reads zeros past g's edges; the tap is
//   the copy's (kx, ky) offset), and the weight tile. It copies 9x the
//   window's A bytes and runs faster all the same: 0.63-0.69x the windowed
//   time at enc4c1,
//   0.80x at enc4c0, 0.84-0.86x at dec0c1, 0.89-0.96x at 128-512 channels.
// - windowed form (the fused pool, whose 2x2 windows span two output rows;
//   two sources): a unit is 8x8 output pixels, each core matrix (8 rows of
//   A) the 8 pixels of one output row; units consecutive in (image, unit
//   row, unit column) order. Per slice of one source a window stage holds
//   each unit's 10x10-pixel window (4-D NHWC map; the crop offset is a box
//   coordinate, the copy's zero fill covers image edges), shared by the 9
//   taps; the weights have their own, deeper ring. The tap is a descriptor
//   offset: A for tap (ky, kx) is the window with its start moved by (10 ky
//   + kx) x 128 bytes and a stride byte offset of 10 x 128. wgmma swizzles
//   on the address bits as TMA wrote them, so a start on any 128-byte row
//   needs no base offset (the card tests hold every tap alone against the
//   plain version).
// - Head variant (conv3x3_head, the last decoder conv with the 1x1
//   classifier: 64 -> 64 channels at 516^2 when serving): the windowed
//   form at N = 64 as a template instantiation of its own (HEAD), its
//   epilogue rounding bias + ReLU to bf16 into the warp's tile as below and
//   then running the 1x1 head on it in f32 (head_rows): only nc f32 logits
//   a pixel reach device memory. Its nine weight taps (one 64-channel
//   slice) fit the weight stages: they are copied once per block and stay
//   resident instead of streaming through the ring every tile (11% faster
//   at 16 x 516^2).
// - Fused decoder tail (dec_tail_kernel, entry dec_tail.cu): conv0, conv1
//   and the head in one kernel, conv0's tile kept in shared memory; the
//   product transposed (M = channels, N = pixels): its note below.
// - Fused enc0 (enc0_fused_kernel, entry enc0_fused.cu): a stem warpgroup
//   on the FMA units fills one of two shared h tiles while two consumer
//   warpgroups run enc0 conv1 from the other as the tail's transposed
//   product with its nine weight taps resident, the 2x2 pool from the
//   accumulator registers, TMA tensor stores: its note below.
// - Epilogue: bias, ReLU when relu, rounded to bf16 into a 16-pixel x
//   64-channel shared tile per consumer warp, 64 channels at a time, then
//   stored as whole 128-byte pixel rows of 16-byte vectors, and the 2x2
//   pool from the same tile (windowed units hold two output rows a warp;
//   unit origins are even; odd sizes floor). Channel pairs stored straight
//   from the registers, 16 bytes of each of 8 pixels a warp instruction,
//   took 1.2-1.7x the time at 64-256 channels (PERF.md).
//
// The five faults of the mma.sync kernel it replaced: (1)
// mma.sync m16n8k16 -> wgmma m64nNk16; (2) 256 threads staging through
// registers between two barriers -> TMA into rings the producer keeps
// ahead; (3) 64 output channels a block, the window re-staged CO/64 times,
// 36 KB of weights a 32-channel step -> 128 channels a block, a window per
// 64-channel slice shared by 9 taps (windowed) or one A tile per tap for
// 256 pixels (im2col); (4) a fixed 16x16 tile, 56-73% fill at 36-82 ->
// 256 consecutive pixels (im2col) or 8x8 units in a list (81-100%); (5)
// fragments reloaded from shared memory per k16 -> wgmma reads both
// operands from shared memory once per m64.
#include "conv_fwd_wgmma.cuh"

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int UNIT = 8;                          // output pixels per unit side
constexpr int WIN = UNIT + 2;                    // window pixels per unit side
constexpr int ROW = SLICE * 2;                   // one pixel's slice: 128 bytes
constexpr int WIN_BYTES = WIN * WIN * ROW;       // 12800
constexpr int WIN_SLOT = (WIN_BYTES + 1023) / 1024 * 1024;
constexpr int CONSUMERS = 2;                     // warpgroups
constexpr int FWD_THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int UPW = 2;                           // units a consumer warpgroup
constexpr int EPI_ROWS = 16;                     // A rows a consumer warp holds
constexpr int EPI_BYTES = CONSUMERS * 4 * EPI_ROWS * ROW;  // a warp's 16 x 64 bf16 each

constexpr int HEAD_BYTES = unet::MAX_NC * SLICE * 4;  // the head variant's f32 1x1 weights

// Shared memory of a configuration: 1 KB alignment slack, the window and
// weight stages, the epilogue's tiles, a full and an empty mbarrier per
// stage, and the head variant's 1x1 weights.
constexpr int fwd_smem(int n, int wst, int bst, bool head = false) {
  return 1024 + wst * CONSUMERS * UPW * WIN_SLOT + bst * n * ROW + EPI_BYTES +
         2 * (wst + bst) * 8 + (head ? HEAD_BYTES : 0);
}

// The 1x1 head of the head variant: nc <= MAX_NC classes, weights (nc, 64)
// f32 holding bf16 values, bias (nc,) f32, logits (B, Ho, Wo, nc) f32.
struct Head {
  const float* w;
  const float* b;
  float* logits;
  int nc;
};

// Image b and origin (uy, ux) of unit ui, units in (image, row, column) order.
__device__ __forceinline__ void unit_origin(int ui, int nuy, int nux, int& b, int& uy, int& ux) {
  const int per_b = nuy * nux;
  b = ui / per_b;
  const int r = ui - b * per_b;
  uy = (r / nux) * UNIT;
  ux = (r % nux) * UNIT;
}

// What a consumer thread of conv_fwd_kernel reads besides its accumulators.
struct Consumer {
  uint32_t base, bbase, wfull0, wempty0, bfull0, bempty0;
  uint8_t* etile;  // this warp's 16 x 64 bf16 epilogue tile
  int slices, units, nuy, nux, nb, Ho, Wo, CO, relu, wg, warp, lane, npix;
  const float* bias;
  __nv_bfloat16* y;
  __nv_bfloat16* pooled;
  bool resident;  // weight stage s * 9 + tap holds (tap, slice s) for good
};

// The ring loop of one tile into acc; the ring counters wi (window stages)
// and bi (weight stages) run on across tiles.
template <int N, int WST, int BST>
__device__ __forceinline__ void mainloop(float (&acc)[UPW][N / 2], const Consumer& f, int& wi,
                                         int& bi) {
  constexpr int W_STAGE = CONSUMERS * UPW * WIN_SLOT, B_STAGE = N * ROW;
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[u][i] = 0.f;
  for (int s = 0; s < f.slices; ++s) {
    const int ws = wi % WST;
    mbar_wait(f.wfull0 + 8 * ws, (wi / WST) & 1);
    const uint32_t wbase = f.base + ws * W_STAGE + f.wg * UPW * WIN_SLOT;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int bs = f.resident ? s * 9 + tap : bi % BST;
      mbar_wait(f.bfull0 + 8 * bs, f.resident ? 0 : (bi / BST) & 1);
      const uint32_t a0 = wbase + ((tap / 3) * WIN + tap % 3) * ROW;
      const uint32_t b0 = f.bbase + bs * B_STAGE;
#pragma unroll
      for (int u = 0; u < UPW; ++u) fence_regs(acc[u]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes along the 128-byte row
        const uint64_t db = sw128_desc(b0 + kk * 32, 16, 8 * ROW);
#pragma unroll
        for (int u = 0; u < UPW; ++u)
          wgmma_n<N>(acc[u], sw128_desc(a0 + u * WIN_SLOT + kk * 32, 16, WIN * ROW), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < UPW; ++u) fence_regs(acc[u]);
      if (s > 0 || tap > 0) {  // the group before this one is done: release its stages
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (f.lane == 0) {
          if (!f.resident) mbar_arrive(f.bempty0 + 8 * ((bi - 1) % BST));
          if (tap == 0) mbar_arrive(f.wempty0 + 8 * ((wi - 1) % WST));
        }
      }
      ++bi;
    }
    ++wi;
  }
}

// Waits for the tile's last group and releases its stages.
template <int WST, int BST>
__device__ __forceinline__ void drain(const Consumer& f, int wi, int bi) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (f.lane == 0) {
    if (!f.resident) mbar_arrive(f.bempty0 + 8 * ((bi - 1) % BST));
    mbar_arrive(f.wempty0 + 8 * ((wi - 1) % WST));
  }
}

// The head variant's epilogue of one unit's 16 rows in this warp's tile
// (bias, ReLU and bf16 rounding done): lane (half, r) = (lane / 16, lane %
// 16) takes row r's channels 32 half .. 32 half + 31 (a quarter warp reads
// eight rows' 16-byte chunks: no bank conflict) against the head weights
// in shared memory (one address per quarter warp: a broadcast), f32
// products and sums; a shuffle adds the two halves and half 0 writes the
// pixel's nc logits, where the pixel lies in rows [0, y_end) and columns
// [x_begin, Wo) (the fused tail's band edges). The 64-channel activation
// is never stored.
__device__ __forceinline__ void head_rows(const Consumer& f, const Head& hd, const float* hw,
                                          int b, int uy, int ux, int y_end, int x_begin = 0) {
  const int r = f.lane & 15, half = f.lane >> 4;
  float l[unet::MAX_NC];
#pragma unroll
  for (int n = 0; n < unet::MAX_NC; ++n) l[n] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * half + k;  // channels 8c .. 8c + 7
    const uint4 v = *reinterpret_cast<const uint4*>(f.etile + r * ROW + ((c ^ (r & 7)) << 4));
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 a0 = __bfloat1622float2(a2[2 * e]), a1 = __bfloat1622float2(a2[2 * e + 1]);
#pragma unroll
      for (int n = 0; n < unet::MAX_NC; ++n) {
        if (n < hd.nc) {
          const float4 w = *reinterpret_cast<const float4*>(hw + n * SLICE + 8 * c + 4 * e);
          l[n] = fmaf(a1.y, w.w, fmaf(a1.x, w.z, fmaf(a0.y, w.y, fmaf(a0.x, w.x, l[n]))));
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < unet::MAX_NC; ++n) l[n] += __shfl_xor_sync(0xffffffffu, l[n], 16);
  const int oy = uy + 2 * f.warp + (r >> 3), ox = ux + (r & 7);
  if (half == 0 && oy < y_end && ox >= x_begin && ox < f.Wo) {
    float* out = hd.logits + (((size_t)b * f.Ho + oy) * f.Wo + ox) * hd.nc;
#pragma unroll
    for (int n = 0; n < unet::MAX_NC; ++n)
      if (n < hd.nc) out[n] = l[n] + __ldg(hd.b + n);
  }
}

// Epilogue of tile t. Accumulator 4j + h of this thread is A row 16 warp +
// g (+8 for h >= 2): unit pixel (2 warp (+1), g); column 8j + 2q + (h & 1).
// Per 64 of the N columns, the warp rounds its 16 rows into its own shared
// tile (16-byte chunks swizzled by row: conflict-free both ways), then
// stores whole 128-byte pixel rows and their 2x2 pool.
// With LINEAR a unit is 64 consecutive output pixels (the im2col kernel's
// rows, across rows and images) and there is no pool. With HEAD (N = 64)
// the rounded tile goes through the 1x1 head (head_rows) instead of being
// stored. Without BIAS (the input gradient) nothing is added: the
// epilogue adds -0.0f, the exact identity of f32 addition, which the
// compiler drops.
template <int N, bool LINEAR = false, bool HEAD = false, bool BIAS = true>
__device__ __forceinline__ void epilogue(float (&acc)[UPW][N / 2], const Consumer& f, int t,
                                         const Head& hd = Head{}, const float* hw = nullptr) {
  const int n0 = (t % f.nb) * N, grp = t / f.nb;
  const int g = f.lane >> 2, q = f.lane & 3;
#pragma unroll
  for (int u = 0; u < UPW; ++u) fence_regs(acc[u]);
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int ui = grp * CONSUMERS * UPW + f.wg * UPW + u;
    if (ui >= f.units) continue;
    int b = 0, uy = 0, ux = 0;
    if (!LINEAR) unit_origin(ui, f.nuy, f.nux, b, uy, ux);
#pragma unroll
    for (int h = 0; h < N / SLICE; ++h) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = h * 8 + jj;
        const float2 bb =
            BIAS ? __ldg(reinterpret_cast<const float2*>(f.bias + n0 + 8 * j + 2 * q))
                 : make_float2(-0.f, -0.f);
        const float* a = acc[u] + 4 * j;
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(unet::act(a[0] + bb.x, f.relu),
                                                        unet::act(a[1] + bb.y, f.relu));
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(unet::act(a[2] + bb.x, f.relu),
                                                        unet::act(a[3] + bb.y, f.relu));
        uint8_t* e = f.etile + g * ROW + ((jj ^ g) << 4) + 4 * q;
        *reinterpret_cast<__nv_bfloat162*>(e) = h0;             // row g
        *reinterpret_cast<__nv_bfloat162*>(e + 8 * ROW) = h1;   // row g + 8
      }
      __syncwarp();
      if constexpr (HEAD) {
        head_rows(f, hd, hw, b, uy, ux, f.Ho);
      } else {
        // row r of the tile is unit pixel (2 warp + r / 8, r % 8); lanes
        // 8i..8i+7 store one pixel's 128 bytes
#pragma unroll
        for (int i = f.lane; i < EPI_ROWS * 8; i += 32) {
          const int r = i >> 3, c = i & 7;
          const uint4 v =
              *reinterpret_cast<const uint4*>(f.etile + r * ROW + ((c ^ (r & 7)) << 4));
          if (LINEAR) {
            const int pix = ui * 64 + EPI_ROWS * f.warp + r;
            if (pix < f.npix)
              *reinterpret_cast<uint4*>(f.y + (size_t)pix * f.CO + n0 + h * SLICE + 8 * c) = v;
            continue;
          }
          const int oy = uy + 2 * f.warp + (r >> 3), ox = ux + (r & 7);
          if (oy < f.Ho && ox < f.Wo)
            *reinterpret_cast<uint4*>(f.y + (((size_t)b * f.Ho + oy) * f.Wo + ox) * f.CO + n0 +
                                      h * SLICE + 8 * c) = v;
        }
        // pooled pixel (warp, lane / 8) of the unit, chunk lane % 8
        if (!LINEAR && f.pooled != nullptr) {
          const int p = f.lane >> 3, c = f.lane & 7;
          const int py = uy / 2 + f.warp, px = ux / 2 + p;
          if (py < f.Ho / 2 && px < f.Wo / 2) {
            uint4 m = *reinterpret_cast<const uint4*>(f.etile + 2 * p * ROW + ((c ^ (2 * p)) << 4));
            __nv_bfloat162* mv = reinterpret_cast<__nv_bfloat162*>(&m);
#pragma unroll
            for (int k = 1; k < 4; ++k) {
              const int r = 2 * p + (k & 1) + 8 * (k >> 1);
              uint4 o = *reinterpret_cast<const uint4*>(f.etile + r * ROW + ((c ^ (r & 7)) << 4));
              const __nv_bfloat162* ov = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
              for (int v = 0; v < 4; ++v) mv[v] = __hmax2(mv[v], ov[v]);
            }
            const size_t pix = ((size_t)b * (f.Ho / 2) + py) * (f.Wo / 2) + px;
            *reinterpret_cast<uint4*>(f.pooled + pix * f.CO + n0 + h * SLICE + 8 * c) = m;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The windowed form's block (see the note at the top); the tensor maps are
// the kernel's __grid_constant__ parameters. BIAS as in epilogue.
template <int N, int WST, int BST, bool HEAD, bool BIAS>
__device__ __forceinline__ void fwd_block(const CUtensorMap& xmap0, const CUtensorMap& xmap1,
                                          const CUtensorMap& wmap, int C0, int off_y, int off_x,
                                          int slices0, int slices, const float* __restrict__ bias,
                                          int relu, int B, int Ho, int Wo, int CO,
                                          __nv_bfloat16* __restrict__ y,
                                          __nv_bfloat16* __restrict__ pooled, const Head& hd) {
  constexpr int UPB = CONSUMERS * UPW;
  constexpr int W_STAGE = UPB * WIN_SLOT, B_STAGE = N * ROW;
  constexpr int NACC = N / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t bbase = base + WST * W_STAGE, ebase = bbase + BST * B_STAGE;
  const uint32_t wfull0 = ebase + EPI_BYTES, wempty0 = wfull0 + 8 * WST;
  const uint32_t bfull0 = wempty0 + 8 * WST, bempty0 = bfull0 + 8 * BST;
  float* hw = reinterpret_cast<float*>(smem_raw + (bempty0 + 8 * BST - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int nux = (Wo + UNIT - 1) / UNIT, nuy = (Ho + UNIT - 1) / UNIT;
  const int units = B * nuy * nux;
  const int nb = CO / N;
  const int ntiles = (units + UPB - 1) / UPB * nb;
  // the head variant (one N block): its weight taps fit the weight stages
  // and are copied once, not once a tile
  const bool resident = HEAD && nb == 1 && slices * 9 <= BST;

  if (tid == 0) {
    for (int s = 0; s < WST; ++s) {
      mbar_init(wfull0 + 8 * s, 1);
      mbar_init(wempty0 + 8 * s, CONSUMERS * 4);  // one arrive per consumer warp
    }
    for (int s = 0; s < BST; ++s) {
      mbar_init(bfull0 + 8 * s, 1);
      mbar_init(bempty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (HEAD)
    for (int i = tid; i < hd.nc * SLICE; i += FWD_THREADS) hw[i] = hd.w[i];
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp: one thread issues the copies
    if (tid == CONSUMERS * 128) {
      if (resident)
        for (int i = 0; i < slices * 9; ++i) {
          mbar_expect_tx(bfull0 + 8 * i, B_STAGE);
          tma_load_3d(bbase + i * B_STAGE, &wmap, bfull0 + 8 * i, (i / 9) * SLICE, i % 9, 0);
        }
      int wi = 0, bi = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int n0 = (t % nb) * N, grp = t / nb;
        for (int s = 0; s < slices; ++s) {
          const bool second = s >= slices0;
          const CUtensorMap* xmap = second ? &xmap1 : &xmap0;
          const int cs = (second ? s - slices0 : s) * SLICE;  // channel in the source
          const int ci0 = second ? C0 + cs : cs;               // channel in the weights
          const int oy = second ? 0 : off_y, ox = second ? 0 : off_x;
          const int ws = wi % WST;
          if (wi >= WST) mbar_wait(wempty0 + 8 * ws, (wi / WST - 1) & 1);
          mbar_expect_tx(wfull0 + 8 * ws, UPB * WIN_BYTES);
          for (int u = 0; u < UPB; ++u) {
            // the last group's missing units load a real unit and store nothing
            const int ui = min(grp * UPB + u, units - 1);
            int b, uy, ux;
            unit_origin(ui, nuy, nux, b, uy, ux);
            tma_load_4d(base + ws * W_STAGE + u * WIN_SLOT, xmap, wfull0 + 8 * ws, cs, ux + ox,
                        uy + oy, b);
          }
          ++wi;
          for (int tap = 0; tap < 9 && !resident; ++tap) {
            const int bs = bi % BST;
            if (bi >= BST) mbar_wait(bempty0 + 8 * bs, (bi / BST - 1) & 1);
            mbar_expect_tx(bfull0 + 8 * bs, B_STAGE);
            tma_load_3d(bbase + bs * B_STAGE, &wmap, bfull0 + 8 * bs, ci0, tap, n0);
            ++bi;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns units wg * UPW .. wg * UPW + UPW - 1
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const Consumer f{base, bbase, wfull0, wempty0, bfull0, bempty0,
                   smem_raw + (ebase - smem_u32(smem_raw)) + (wg * 4 + warp) * EPI_ROWS * ROW,
                   slices, units, nuy, nux, nb, Ho, Wo, CO, relu, wg, warp, tid & 31,
                   B * Ho * Wo, bias, y, pooled, resident};
  // One set of accumulators, and the two warpgroups in step. A second set
  // for N = 64, with a tile's epilogue between the next tile's first wgmma
  // group and its wait, made ptxas serialize the wgmma groups (its C7518
  // warning) and took 1.9x the time; starting the second warpgroup 2 or 4
  // weight stages behind the first, so that their epilogues do not
  // coincide, changed nothing (PERF.md).
  float acc[UPW][NACC];
  int wi = 0, bi = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    mainloop<N, WST, BST>(acc, f, wi, bi);
    drain<WST, BST>(f, wi, bi);
    epilogue<N, false, HEAD, BIAS>(acc, f, t, hd, hw);
  }
}

template <int N, int WST, int BST, bool HEAD = false>
__global__ void __launch_bounds__(FWD_THREADS, 1)
conv_fwd_kernel(const __grid_constant__ CUtensorMap xmap0,
                const __grid_constant__ CUtensorMap xmap1,
                const __grid_constant__ CUtensorMap wmap, int C0, int off_y, int off_x,
                int slices0, int slices, const float* __restrict__ bias, int relu, int B,
                int Ho, int Wo, int CO, __nv_bfloat16* __restrict__ y,
                __nv_bfloat16* __restrict__ pooled, const Head hd) {
  fwd_block<N, WST, BST, HEAD, true>(xmap0, xmap1, wmap, C0, off_y, off_x, slices0, slices, bias,
                                     relu, B, Ho, Wo, CO, y, pooled, hd);
}

// The same block without the bias under the input gradient's own name, so
// that a profile tells the dgrad (conv3x3_dgrad.cu) from the forward convs.
template <int N, int WST, int BST>
__global__ void __launch_bounds__(FWD_THREADS, 1)
conv_dgrad_kernel(const __grid_constant__ CUtensorMap xmap0,
                  const __grid_constant__ CUtensorMap xmap1,
                  const __grid_constant__ CUtensorMap wmap, int C0, int off_y, int off_x,
                  int slices0, int slices, const float* __restrict__ bias, int relu, int B,
                  int Ho, int Wo, int CO, __nv_bfloat16* __restrict__ y,
                  __nv_bfloat16* __restrict__ pooled, const Head hd) {
  fwd_block<N, WST, BST, false, false>(xmap0, xmap1, wmap, C0, off_y, off_x, slices0, slices, bias,
                                       relu, B, Ho, Wo, CO, y, pooled, hd);
}

// The im2col form's block (one source read at (off_y, off_x), no pool; see
// the note at the top). BIAS as in epilogue.
template <int N, int ST, bool BIAS>
__device__ __forceinline__ void im2col_block(const CUtensorMap& xmap, const CUtensorMap& wmap,
                                             int slices, int off_y, int off_x,
                                             const float* __restrict__ bias, int relu, int B,
                                             int Ho, int Wo, int CO,
                                             __nv_bfloat16* __restrict__ y) {
  constexpr int UPB = CONSUMERS * UPW, MT = UPB * 64;
  constexpr int A_BYTES = MT * ROW, STAGE = A_BYTES + N * ROW, NACC = N / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ebase = base + ST * STAGE, full0 = ebase + EPI_BYTES, empty0 = full0 + 8 * ST;
  const int tid = threadIdx.x;
  const int npix = B * Ho * Wo, units = (npix + 63) / 64, nb = CO / N;
  const int ntiles = (units + UPB - 1) / UPB * nb;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    if (tid == CONSUMERS * 128) {
      int i = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int n0 = (t % nb) * N, p0 = (t / nb) * MT;
        const int w0 = p0 % Wo, h0 = (p0 / Wo) % Ho, b0 = p0 / (Ho * Wo);
        for (int s = 0; s < slices; ++s) {
          for (int tap = 0; tap < 9; ++tap, ++i) {
            const int st = i % ST;
            if (i >= ST) mbar_wait(empty0 + 8 * st, (i / ST - 1) & 1);
            mbar_expect_tx(full0 + 8 * st, STAGE);
            tma_load_im2col_4d(base + st * STAGE, &xmap, full0 + 8 * st, s * SLICE, w0 + off_x,
                               h0 + off_y, b0, (uint16_t)(tap % 3), (uint16_t)(tap / 3));
            tma_load_3d(base + st * STAGE + A_BYTES, &wmap, full0 + 8 * st, s * SLICE, tap, n0);
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const Consumer f{base, 0, 0, 0, 0, 0,
                   smem_raw + (ebase - smem_u32(smem_raw)) + (wg * 4 + warp) * EPI_ROWS * ROW,
                   slices, units, 0, 0, nb, Ho, Wo, CO, relu, wg, warp, tid & 31, npix,
                   bias, y, nullptr, false};
  float acc[UPW][NACC];
  int i = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
#pragma unroll
    for (int u = 0; u < UPW; ++u)
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[u][k] = 0.f;
    for (int k = 0; k < 9 * slices; ++k, ++i) {
      const int st = i % ST;
      mbar_wait(full0 + 8 * st, (i / ST) & 1);
      const uint32_t a0 = base + st * STAGE + wg * UPW * 64 * ROW;
      const uint32_t b0 = base + st * STAGE + A_BYTES;
#pragma unroll
      for (int u = 0; u < UPW; ++u) fence_regs(acc[u]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(b0 + kk * 32, 16, 8 * ROW);
#pragma unroll
        for (int u = 0; u < UPW; ++u)
          wgmma_n<N>(acc[u], sw128_desc(a0 + u * 64 * ROW + kk * 32, 16, 8 * ROW), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < UPW; ++u) fence_regs(acc[u]);
      if (k > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (f.lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % ST));
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (f.lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % ST));
    epilogue<N, true, false, BIAS>(acc, f, t);
  }
}

template <int N, int ST>
__global__ void __launch_bounds__(FWD_THREADS, 1)
conv_fwd_im2col_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, int slices, int off_y, int off_x,
                       const float* __restrict__ bias, int relu, int B, int Ho, int Wo, int CO,
                       __nv_bfloat16* __restrict__ y) {
  im2col_block<N, ST, true>(xmap, wmap, slices, off_y, off_x, bias, relu, B, Ho, Wo, CO, y);
}

template <int N, int ST>
__global__ void __launch_bounds__(FWD_THREADS, 1)
conv_dgrad_im2col_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, int slices, int off_y,
                         int off_x, const float* __restrict__ bias, int relu, int B, int Ho,
                         int Wo, int CO, __nv_bfloat16* __restrict__ y) {
  im2col_block<N, ST, false>(xmap, wmap, slices, off_y, off_x, bias, relu, B, Ho, Wo, CO, y);
}

// Dynamic shared memory of the im2col form: its stages, the epilogue's
// tiles and a full and an empty mbarrier per stage.
constexpr int im2col_smem(int n, int st) {
  return 1024 + st * (CONSUMERS * UPW * 64 * ROW + n * ROW) + EPI_BYTES + 2 * st * 8;
}

// dgrad: the kernel under the input gradient's name, without the bias.
template <int N, int ST>
int launch_im2col(unet::Src s0, const CUtensorMap& wmap, int slices, const float* bias, int relu,
                  int B, int Ho, int Wo, int CO, __nv_bfloat16* y, int sms, cudaStream_t st,
                  bool dgrad) {
  constexpr int smem = im2col_smem(N, ST);
  static_assert(smem <= SMEM_PER_BLOCK, "stages exceed the 227 KB a block can use");
  CUtensorMap xmap;
  const int e = nhwc_im2col_map(&xmap, s0.p, B, s0.H, s0.W, s0.C, CONSUMERS * UPW * 64, s0.off_y,
                                s0.off_x, Ho, Wo);
  if (e != 0) return e;
  auto kernel = dgrad ? conv_dgrad_im2col_kernel<N, ST> : conv_fwd_im2col_kernel<N, ST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = ((long long)B * Ho * Wo + 63) / 64;
  const long long tiles = (units + CONSUMERS * UPW - 1) / (CONSUMERS * UPW) * (CO / N);
  kernel<<<(int)(tiles < sms ? tiles : sms), FWD_THREADS, smem, st>>>(
      xmap, wmap, slices, s0.off_y, s0.off_x, bias, relu, B, Ho, Wo, CO, y);
  return (int)cudaGetLastError();
}

// dgrad: the kernel under the input gradient's name, without the bias
// (not with HEAD).
template <int N, int WST, int BST, bool HEAD = false>
int launch(const CUtensorMap& xmap0, const CUtensorMap& xmap1, const CUtensorMap& wmap, int C0,
           int off_y, int off_x, int slices0, int slices, const float* bias, int relu, int B,
           int Ho, int Wo, int CO, __nv_bfloat16* y, __nv_bfloat16* pooled, int sms,
           cudaStream_t st, bool dgrad, const Head& hd = Head{}) {
  constexpr int smem = fwd_smem(N, WST, BST, HEAD);
  static_assert(smem <= SMEM_PER_BLOCK, "stages exceed the 227 KB a block can use");
  auto kernel = conv_fwd_kernel<N, WST, BST, HEAD>;
  if (dgrad && !HEAD) kernel = conv_dgrad_kernel<N, WST, BST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)B * ((Ho + UNIT - 1) / UNIT) * ((Wo + UNIT - 1) / UNIT);
  const long long tiles = (units + CONSUMERS * UPW - 1) / (CONSUMERS * UPW) * (CO / N);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, FWD_THREADS, smem, st>>>(xmap0, xmap1, wmap, C0, off_y, off_x, slices0, slices,
                                          bias, relu, B, Ho, Wo, CO, y, pooled, hd);
  return (int)cudaGetLastError();
}

// The OHWI weights (CO, 3, 3, CI) as a (CO, 9, CI) map: a box is one tap's
// N x 64 tile, N = 128 where it divides CO, else 64.
int weight_map(CUtensorMap* wmap, const void* w, int CI, int CO) {
  const cuuint64_t dims[3] = {(cuuint64_t)CI, 9, (cuuint64_t)CO};
  const cuuint64_t strides[2] = {(cuuint64_t)CI * 2, (cuuint64_t)9 * CI * 2};
  const cuuint32_t box[3] = {(cuuint32_t)SLICE, 1, (cuuint32_t)(CO % 128 == 0 ? 128 : 64)};
  return bf16_map(wmap, w, 3, dims, strides, box);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Both forms behind one rule: one source, no pool and N = 128 take the
// im2col form (a 2x2 pool window spans two output rows, Wo pixels apart,
// so it needs the windowed units; at N = 64 the im2col form measured 0-4%
// slower than the windowed one), the rest the windowed form. The source's
// offset reaches either: the windowed copies start at the unit's origin
// plus the offset, the im2col map's bounding box and copies are moved by
// it. dgrad launches the same code without the bias under the input
// gradient's names.
int route(unet::Src s0, unet::Src s1, const void* w, const void* bias, int relu, int B, int Ho,
          int Wo, int CO, void* y, void* pooled, void* stream, bool dgrad) {
  const int CI = s0.C + s1.C;
  CUtensorMap xmap0, xmap1, wmap;
  int sms = 0;
  int e = nhwc_map(&xmap0, s0.p, B, s0.H, s0.W, s0.C, WIN, WIN);
  if (e == 0 && s1.C > 0) e = nhwc_map(&xmap1, s1.p, B, s1.H, s1.W, s1.C, WIN, WIN);
  if (e == 0) e = weight_map(&wmap, w, CI, CO);
  if (e == 0) e = sm_count(&sms);
  if (e != 0) return e;
  if (s1.C == 0) xmap1 = xmap0;
  const int slices0 = (s0.C + SLICE - 1) / SLICE;
  const int slices = slices0 + (s1.C + SLICE - 1) / SLICE;
  const float* b = (const float*)bias;
  __nv_bfloat16* yo = (__nv_bfloat16*)y;
  __nv_bfloat16* po = (__nv_bfloat16*)pooled;
  cudaStream_t st = (cudaStream_t)stream;
  if (s1.C == 0 && pooled == nullptr && CO % 128 == 0)
    return launch_im2col<128, 4>(s0, wmap, slices, b, relu, B, Ho, Wo, CO, yo, sms, st, dgrad);
  if (CO % 128 != 0)
    return launch<64, 2, 13>(xmap0, xmap1, wmap, s0.C, s0.off_y, s0.off_x, slices0, slices, b, relu,
                             B, Ho, Wo, CO, yo, po, sms, st, dgrad);
  return launch<128, 2, 6>(xmap0, xmap1, wmap, s0.C, s0.off_y, s0.off_x, slices0, slices, b, relu,
                           B, Ho, Wo, CO, yo, po, sms, st, dgrad);
}

// ------------------------------------------------------- the fused decoder tail
// dec_tail_kernel: conv0 = ReLU(conv3x3(concat(crop(skip), up)) + b0)
// rounded to bf16, conv1 = ReLU(conv3x3(conv0) + b1) rounded to bf16 and the
// 1x1 head in f32, in one kernel (entry dec_tail.cu); conv0 never leaves
// shared memory. A band is TB_OUT logits rows (TB_ROWS = TB_OUT + 2 conv0
// rows, 16 a consumer warpgroup) walked TB_STEP columns a step: a step
// computes conv0 for TB_ROWS rows x TB_STEP new columns, keeps the two
// columns before them from the step before (the "carry"), and conv1 + head
// for TB_ROWS rows x TB_STEP logits columns, of which the first TB_OUT rows
// are stored.
// - The product is transposed: M = the 64 output channels (the (tap,
//   slice) weight tile as A, K-major), N = the warpgroup's 16 rows x 8
//   columns of pixels (B, K-major: each core matrix one row's 8 pixels,
//   rows TB_PITCH pixels apart by the stride byte offset; the tap is a
//   descriptor offset), one wgmma.m64n128k16 per k16 step. Per 64 x 128 x
//   16 it reads 6 KB of shared memory, where the windowed form of the
//   other convs (M = pixels, two 8x8 units a warpgroup, N = 64 channels)
//   reads 8 KB for the same work. Built in the windowed form, the tail
//   took 1.93-1.94 ms against 1.51-1.54 at 16 x 516^2 (PERF.md).
// - conv0 reads, per 64-channel slice of the skip (at its crop offset, a
//   box coordinate) and of up, one (TB_ROWS + 2) x TB_PITCH window stage,
//   shared by both warpgroups and the nine taps; its (tap, slice) weight
//   tiles and conv1's nine taps stream through one weight ring (conv1's
//   73.7 KB would not fit beside the windows, conv0's tile and the ring).
// - conv0's epilogue rounds bias + ReLU to bf16 and writes it transposed
//   (stmatrix .trans) into the shared tile h (TB_ROWS + 2 rows of TB_PITCH
//   pixels, 128 bytes a pixel, 16-byte chunk c of pixel P at c ^ (P & 7):
//   the 128-byte swizzle TMA would have written), columns 2..9; columns
//   0..1 are the previous step's 8..9, copied first. conv1's B for tap
//   (ky, kx) starts at h pixel (16 wg + ky) x TB_PITCH + kx. Rows past
//   TB_ROWS and the carry of a band's first step are never written: they
//   feed only logits that are not stored.
// - conv1's epilogue writes the rounded activation of the warpgroup's 128
//   pixels transposed into its tile, then runs the head variant's
//   head_rows on it. Only nc f32 logits a pixel reach device memory.
// - Every sum runs in the order of the chain dec_conv0 -> conv3x3_head
//   (the same slices, taps and k16 steps; the tensor core sums a k16 step
//   the same way for either operand order), and the epilogues do the
//   chain's arithmetic, so the logits equal the chain's bit for bit (the
//   card tests and chip_smoke.py check it).
// - A persistent grid of one block per SM: the steps in (image, band,
//   column step) order are cut into one contiguous range per block; a
//   range that starts inside a band first computes conv0 of the step before
//   (a "prime" step, no conv1) for its carry. The producer warp runs ahead
//   into the next step's windows and weights while the consumers run an
//   epilogue.
// Recompute: conv0 computes TB_ROWS rows per TB_OUT logits rows (1.067x),
// 1.12x with the image's edge and the prime steps at 16 x 516^2
// (ops/kernels/conv3x3.py dec_tail_plan mirrors the walk).
constexpr int TB_OUT = 30, TB_ROWS = TB_OUT + 2, TB_STEP = UNIT, TB_PITCH = TB_STEP + 2;
constexpr int TB_UNITS = TB_ROWS / UNIT;                     // 4 m64 units a step
constexpr int TB_WIN_BYTES = (TB_ROWS + 2) * TB_PITCH * ROW;  // 43520
constexpr int TB_WIN_SLOT = (TB_WIN_BYTES + 1023) / 1024 * 1024;
constexpr int TB_H_BYTES = (TB_ROWS + 2) * TB_PITCH * ROW;
constexpr int TB_WST = 2, TB_BST = 8;        // window and weight stages
constexpr int TB_B_STAGE = SLICE * ROW;     // one (tap, slice) tile: 8 KB
// the head's activation tiles: a warpgroup's 128 pixels
constexpr int TB_EPI_BYTES = CONSUMERS * 2 * UNIT * UNIT * ROW;
constexpr int TB_SMEM = 1024 + TB_WST * TB_WIN_SLOT + TB_BST * TB_B_STAGE + TB_H_BYTES +
                        TB_EPI_BYTES + 2 * (TB_WST + TB_BST) * 8 + HEAD_BYTES;
static_assert(TB_SMEM <= SMEM_PER_BLOCK, "the tail's stages exceed the 227 KB a block can use");
static_assert(TB_UNITS == CONSUMERS * UPW, "two units a consumer warpgroup");
static_assert((TB_WST * TB_WIN_SLOT + TB_BST * TB_B_STAGE) % 1024 == 0, "h on a 1 KB atom");

// Image, band and column step of step t, steps in (image, band, step) order.
__device__ __forceinline__ void tail_step(int t, int nbands, int nj, int& b, int& band, int& j) {
  j = t % nj;
  band = (t / nj) % nbands;
  b = t / (nj * nbands);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// Four 8x8 bf16 matrices from the mma fragment registers (thread: row
// lane / 4, columns 2 (lane % 4), +1) into shared memory transposed:
// thread 8i + k gives the address of matrix i's stored row k (its column k).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The transposed product's tap (ky, kx) = (tap / 3, tap % 3) as a descriptor
// start in a tile of TB_PITCH-pixel rows, 128 bytes a pixel.
__device__ __forceinline__ uint32_t tap_offset(int tap) {
  return ((tap / 3) * TB_PITCH + tap % 3) * ROW;
}

// One tap of the transposed product: acc (64 channels x 128 pixels) += the
// 64 x 64 weight tile of descriptor da (K-major, rows 128 bytes apart)
// times the 16 rows x 8 pixels of descriptor db (K-major: each core matrix
// one row's 8 pixels, rows TB_PITCH pixels apart), four k16 steps of
// wgmma.m64n128k16; a k16 step moves both starts by 32 bytes, 2 in the
// descriptor's 16-byte units. The caller fences and commits.
__device__ __forceinline__ void tap_n128(float (&acc)[64], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n128(acc, da + 2 * kk, db + 2 * kk);
}

__device__ __forceinline__ uint64_t weight_desc(uint32_t w) { return sw128_desc(w, 16, 8 * ROW); }
__device__ __forceinline__ uint64_t pixel_desc(uint32_t px) {
  return sw128_desc(px, 16, TB_PITCH * ROW);
}

// bias + ReLU of two accumulators, rounded to bf16 and packed (a low).
__device__ __forceinline__ uint32_t relu_bf16x2(float a, float b, float bias) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(unet::act(a + bias, 1), unet::act(b + bias, 1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The transposed form's epilogue of a warpgroup's 64 channels x 128
// pixels: accumulator 4j + i of this thread is channel 16 warp + g (+8 for
// i >= 2), pixel 8j + 2q + (i & 1) (row j of the warpgroup's 16, column 2q
// (+1)). pack_transposed rounds bias + ReLU to bf16: pk[2j] holds channel
// 16 warp + g at row j, columns 2q (low) and 2q + 1, pk[2j + 1] the same
// for channel + 8 (blo and bhi their biases).
__device__ __forceinline__ void pack_transposed(const float (&acc)[64], float blo, float bhi,
                                                uint32_t (&pk)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pk[2 * j] = relu_bf16x2(acc[4 * j], acc[4 * j + 1], blo);
    pk[2 * j + 1] = relu_bf16x2(acc[4 * j + 2], acc[4 * j + 3], bhi);
  }
}

// store_packed writes them through stmatrix .trans, each pixel's 16-byte
// chunk of 8 channels to pixel(j, column) of a 128-byte-row tile, chunk c
// at c ^ (pixel & 7); then rounded(j, r) sees r = pk[2j .. 2j + 3], rows j
// and j + 1 (j even; the fused enc0's 2x2 pool).
struct NoRounded {
  __device__ void operator()(int, const uint32_t (&)[4]) const {}
};

template <typename PixelOf, typename Rounded = NoRounded>
__device__ __forceinline__ void store_packed(const uint32_t (&pk)[32], uint32_t tile, int warp,
                                             int lane, PixelOf pixel,
                                             Rounded rounded = Rounded()) {
  const int mi = lane >> 3, k = lane & 7;
  const int c = 2 * warp + (mi & 1);
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    const uint32_t r[4] = {pk[2 * j], pk[2 * j + 1], pk[2 * j + 2], pk[2 * j + 3]};
    const int pix = pixel(j + (mi >> 1), k);
    stmatrix_x4_trans(tile + pix * ROW + ((c ^ (pix & 7)) << 4), r);
    rounded(j, r);
  }
}

// Both, with the channels' biases from bias.
template <typename PixelOf>
__device__ __forceinline__ void store_transposed(const float (&acc)[64], const float* bias,
                                                 uint32_t tile, int warp, int lane,
                                                 PixelOf pixel) {
  const int g = lane >> 2;
  uint32_t pk[32];
  pack_transposed(acc, __ldg(bias + 16 * warp + g), __ldg(bias + 16 * warp + g + 8), pk);
  store_packed(pk, tile, warp, lane, pixel);
}

__global__ void __launch_bounds__(FWD_THREADS, 1)
dec_tail_kernel(const __grid_constant__ CUtensorMap xmap0,
                const __grid_constant__ CUtensorMap xmap1,
                const __grid_constant__ CUtensorMap w0map,
                const __grid_constant__ CUtensorMap w1map,
                int C0, int off_y, int off_x, int slices0, int slices,
                const float* __restrict__ bias0, const float* __restrict__ bias1, int B, int Ho,
                int Wo, int nbands, int nj, const Head hd) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t bbase = base + TB_WST * TB_WIN_SLOT;
  const uint32_t hbase = bbase + TB_BST * TB_B_STAGE;
  const uint32_t ebase = hbase + TB_H_BYTES;
  const uint32_t wfull0 = ebase + TB_EPI_BYTES, wempty0 = wfull0 + 8 * TB_WST;
  const uint32_t bfull0 = wempty0 + 8 * TB_WST, bempty0 = bfull0 + 8 * TB_BST;
  float* hw = reinterpret_cast<float*>(smem_raw + (bempty0 + 8 * TB_BST - raw));
  uint8_t* hs = smem_raw + (hbase - raw);

  const int tid = threadIdx.x;
  const int total = B * nbands * nj;
  const int t_begin = (int)((long long)total * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  int b0_, band0_, j0_;
  tail_step(t_begin, nbands, nj, b0_, band0_, j0_);
  const int prime = t_begin < t_end && j0_ > 0;  // conv0 of the step before, for the carry

  if (tid == 0) {
    for (int s = 0; s < TB_WST; ++s) {
      mbar_init(wfull0 + 8 * s, 1);
      mbar_init(wempty0 + 8 * s, CONSUMERS * 4);  // one arrive per consumer warp
    }
    for (int s = 0; s < TB_BST; ++s) {
      mbar_init(bfull0 + 8 * s, 1);
      mbar_init(bempty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < hd.nc * SLICE; i += FWD_THREADS) hw[i] = hd.w[i];
  __syncthreads();

  if (tid >= CONSUMERS * 128) {  // the producer warp: one thread issues the copies
    if (tid == CONSUMERS * 128) {
      int wi = 0, bi = 0;
      const auto weight = [&](const CUtensorMap* map, int ci0, int tap) {
        const int bs = bi % TB_BST;
        if (bi >= TB_BST) mbar_wait(bempty0 + 8 * bs, (bi / TB_BST - 1) & 1);
        mbar_expect_tx(bfull0 + 8 * bs, TB_B_STAGE);
        tma_load_3d(bbase + bs * TB_B_STAGE, map, bfull0 + 8 * bs, ci0, tap, 0);
        ++bi;
      };
      for (int t = t_begin - prime; t < t_end; ++t) {
        int b, band, j;
        tail_step(t < t_begin ? t_begin : t, nbands, nj, b, band, j);
        if (t < t_begin) --j;  // the prime step
        for (int s = 0; s < slices; ++s) {
          const bool second = s >= slices0;
          const int cs = (second ? s - slices0 : s) * SLICE;  // channel in the source
          const int oy = second ? 0 : off_y, ox = second ? 0 : off_x;
          const int ws = wi % TB_WST;
          if (wi >= TB_WST) mbar_wait(wempty0 + 8 * ws, (wi / TB_WST - 1) & 1);
          mbar_expect_tx(wfull0 + 8 * ws, TB_WIN_BYTES);
          tma_load_4d(base + ws * TB_WIN_SLOT, second ? &xmap1 : &xmap0, wfull0 + 8 * ws, cs,
                      j * TB_STEP + ox, band * TB_OUT + oy, b);
          ++wi;
          for (int tap = 0; tap < 9; ++tap) weight(&w0map, second ? C0 + cs : cs, tap);
        }
        if (t >= t_begin)
          for (int tap = 0; tap < 9; ++tap) weight(&w1map, 0, tap);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 16 wg .. 16 wg + 15 of the band
  // (units 2 wg, 2 wg + 1), warp w of it channels 16w .. 16w + 15
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  Consumer f{};  // head_rows' view: f.warp 0, the etile set per pass
  f.Ho = Ho;
  f.Wo = Wo;
  f.lane = lane;
  // the offset of this warpgroup's first row in a window or in h
  const uint32_t a_unit0 = (uint32_t)(UPW * wg * UNIT * TB_PITCH * ROW);
  const uint32_t etw = ebase + wg * 2 * UNIT * UNIT * ROW;  // the head's tile
  float acc[64];
  int wi = 0, bi = 0;

  // one wgmma group: the warpgroup's two units x 4 k16 steps on weight
  // stage bi; the group before it is done after, and its stages released
  const auto group = [&](uint32_t a0, bool release_prev, bool window_prev) {
    const int bs = bi % TB_BST;
    mbar_wait(bfull0 + 8 * bs, (bi / TB_BST) & 1);
    const uint32_t b0 = bbase + bs * TB_B_STAGE;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tap_n128(acc, weight_desc(b0), pixel_desc(a0));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_regs(acc);
    if (release_prev) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0) {
        mbar_arrive(bempty0 + 8 * ((bi - 1) % TB_BST));
        if (window_prev) mbar_arrive(wempty0 + 8 * ((wi - 1) % TB_WST));
      }
    }
    ++bi;
  };
  // the last group of a conv: wait for it, release its stages
  const auto drain = [&](bool window) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if (lane == 0) {
      mbar_arrive(bempty0 + 8 * ((bi - 1) % TB_BST));
      if (window) mbar_arrive(wempty0 + 8 * ((wi - 1) % TB_WST));
    }
  };
  const auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  };

  for (int t = t_begin - prime; t < t_end; ++t) {
    int b, band, j;
    tail_step(t < t_begin ? t_begin : t, nbands, nj, b, band, j);
    if (t < t_begin) --j;

    // conv0 over the window stages
    zero();
    for (int s = 0; s < slices; ++s) {
      const int ws = wi % TB_WST;
      mbar_wait(wfull0 + 8 * ws, (wi / TB_WST) & 1);
      const uint32_t wbase = base + ws * TB_WIN_SLOT + a_unit0;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        group(wbase + tap_offset(tap), s > 0 || tap > 0, tap == 0);
      ++wi;
    }
    drain(true);

    // conv1 of the step before has read h (every consumer passed its drain)
    consumers_sync();
    // the carry of this warp's channels (chunks 2 warp, 2 warp + 1) in the
    // warpgroup's 16 rows: columns 8, 9 -> 0, 1; then conv0's epilogue into
    // columns 2..9
    uint4 v[2];
    int pd[2], cd[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = lane + 32 * e, row = UPW * wg * UNIT + (i >> 2);
      const int c = 2 * warp + (i & 1), ps = row * TB_PITCH + TB_STEP + ((i >> 1) & 1);
      v[e] = *reinterpret_cast<const uint4*>(hs + ps * ROW + ((c ^ (ps & 7)) << 4));
      pd[e] = ps - TB_STEP;
      cd[e] = c;
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<uint4*>(hs + pd[e] * ROW + ((cd[e] ^ (pd[e] & 7)) << 4)) = v[e];
    __syncwarp();
    store_transposed(acc, bias0, hbase, warp, lane, [&](int row, int col) {
      return (UPW * wg * UNIT + row) * TB_PITCH + 2 + col;
    });
    fence_proxy_async_shared();  // the generic writes of h before wgmma reads them
    consumers_sync();
    if (t < t_begin) continue;  // the prime step: conv0 only

    // conv1 from h over the nine weight stages
    zero();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap)
      group(hbase + a_unit0 + tap_offset(tap), tap > 0, false);
    drain(false);

    const int y0 = band * TB_OUT, y_end = min(y0 + TB_OUT, Ho);
    // the activation of the warpgroup's 128 pixels into its tile, then the
    // head: warp w takes pixels 32w .. 32w + 31, 16 (two rows) a pass
    store_transposed(acc, bias1, etw, warp, lane,
                     [](int row, int col) { return row * UNIT + col; });
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      f.etile = smem_raw + (etw - raw) + (32 * warp + 16 * pass) * ROW;
      head_rows(f, hd, hw, b, y0 + UPW * wg * UNIT + 4 * warp + 2 * pass, j * TB_STEP - 2,
                y_end);
    }
  }
}

// ------------------------------------------------------------ the fused enc0
// enc0_fused_kernel: the stem h = ReLU(conv3x3(x, w0) + b0) (1 -> 64
// channels) rounded to bf16, skip0 = ReLU(conv3x3(h, w1) + b1) (64 -> 64)
// rounded to bf16 and its 2x2 max-pool, in one kernel (entry
// enc0_fused.cu); h never leaves shared memory. A step is E0_OUT output
// rows x E0_STEP columns of one image (16 rows a consumer warpgroup), bands
// starting at multiples of E0_OUT, so every 2x2 pool window lies inside
// one warpgroup; steps in (image, band, column step) order, a contiguous
// range of them per block of a persistent grid of one block per SM. A step
// needs of the step before only the stem's carry (below): a block's first
// step, and each band's first, compute all of h.
// - Warp-specialised: a stem warpgroup computes h into one of two tiles
//   and copies x; two consumer warpgroups run conv1 from the other tile.
//   mbarriers pass the tiles: hfull (the stem's 128 threads done) and
//   hempty (both consumers' conv1 done). While a consumer warpgroup's conv1
//   of step k + 1 runs on the tensor core (36 wgmmas in one group), it
//   stores step k's tiles; then it waits for the group and rounds its
//   accumulators (bias, ReLU, bf16) into registers. The code between a
//   group's issue and its wait has no branch (the stores are predicated;
//   a block's last step issues a conv1 that is never stored), so ptxas
//   keeps the group asynchronous. (With the stem on the consumers'
//   warps, between the taps or after the issue, it did not hide under the
//   tensor core's work: PERF.md.)
// - The stem on the FMA units: E0_H_ROWS rows (the E0_ROWS that conv1
//   reads, then padding) of the TB_PITCH h columns a step. Where the block's
//   step before is the same band's column step j - 1 (the carry), columns
//   0 and 1 are that step's columns 8 and 9, copied from the other h tile,
//   and the stem computes columns 2..9; else all ten. Units (segment of
//   E0_SEG rows, column), thread (unit lane, channel group cg) walking two
//   or three of them with the 3x3 window sliding down the column (three
//   new x values a row), for channels 8 cg .. 8 cg + 7, with the 72 stem
//   weights and 8 biases in registers. The arithmetic is
//   stem_rows_kernel's (conv3x3_bias_relu.cu): f32 from the bias, the nine
//   taps in order by FMA, ReLU, rounded by __floats2bfloat162_rn: the same
//   bits, carried or computed. h is written as TMA would have written it
//   (16-byte chunk c of pixel P at c ^ (P & 7) from a 1 KB-aligned base),
//   as the tail's conv0 tile. Recomputing the two halo columns in every
//   step (1.41x the pixels conv1 reads at 16 x 700^2) kept the stem the
//   longest part; the carry (1.14x) took the kernel 14% faster (PERF.md).
// - x: a row of 700 bf16 values is 1,400 bytes, not a multiple of 16, so a
//   2-D tensor map of x is illegal, and 38 1-D TMA copies a step cost the
//   stem warpgroup 6% of the kernel's time (PERF.md). Instead a step's
//   E0_XROWS rows come as E0_X_CHUNKS 16-byte loads a row of the flat
//   input, from the 16-byte boundary at or before the row's first value,
//   one load a stem thread, into rows E0_X_ROW bytes apart of one of two
//   stages: loaded into registers two steps ahead and stored into the
//   stage the stem has just read, so the next barrier publishes it. Rows
//   and columns past the image's edge read the next row's values or zeros
//   (past the input's end); they feed only outputs that are not stored.
// - conv1 as the transposed product (the tail's conv1: tap_n128, M = 64
//   channels of the weight tile, N = the warpgroup's 16 rows x 8 columns,
//   the tap a descriptor start), its nine 8 KB weight taps copied once per
//   block by TMA and resident. It sums taps 0..8, k16 steps 0..3, the
//   order of the windowed N = 64 form that conv3x3_bias_relu runs for enc0
//   conv1 + pool (the tensor core sums a k16 step the same way for either
//   operand order).
// - Epilogue: the rounded values through stmatrix .trans into the
//   warpgroup's 16 x 8 skip0 tile (store_packed); the pool from the
//   registers: a thread holds channels 16 warp + g (+8) at rows j, j + 1
//   and columns 2q, 2q + 1, so a 2x2 window is four of its own rounded
//   values, taken in the chained epilogue's order (rounding and ReLU are
//   monotone: the chain's bits), into the warpgroup's 8 x 4 pooled tile.
//   One thread of the warpgroup stores both tiles by TMA tensor stores
//   (boxes clipped at the ragged edges; odd sizes floor) as one bulk group,
//   read before the next step's tiles are written.
// So skip0 and pooled equal the counted chain conv3x3_bias_relu (the stem,
// stem_rows_kernel) -> conv3x3_bias_relu with the pool (the windowed wgmma
// form) bit for bit (the card tests and chip_smoke.py check it).
// ops/kernels/conv3x3.py enc0_fused_plan and enc0_fused_steps mirror the
// walk.
constexpr int E0_OUT = 32, E0_STEP = UNIT;          // output rows x columns a step
constexpr int E0_THREADS = (CONSUMERS + 1) * 128;    // two consumer warpgroups, the stem's
constexpr int E0_ROWS = E0_OUT + 2;                  // h rows conv1 reads
constexpr int E0_SEG = 9, E0_NSEG = 4;              // h rows a stem unit walks, segments
constexpr int E0_H_ROWS = E0_NSEG * E0_SEG;          // h rows the stem computes
constexpr int E0_XROWS = E0_H_ROWS + 2;              // x rows they read
constexpr int E0_H_SLOT = (E0_H_ROWS * TB_PITCH * ROW + 1023) / 1024 * 1024;
constexpr int E0_X_CHUNKS = 3;  // 16-byte loads of 8 values a row: >= 7 + E0_STEP + 4 values
constexpr int E0_X_ROW = 128;   // bytes between staged x rows
constexpr int E0_X_STAGE = E0_XROWS * E0_X_ROW;
constexpr int E0_W_BYTES = 9 * TB_B_STAGE;           // conv1's nine taps, resident
constexpr int E0_TILE = 2 * UNIT * UNIT * ROW;       // a warpgroup's 16 x 8 skip0 pixels
constexpr int E0_PTILE = UNIT * UNIT / 2 * ROW;      // its 8 x 4 pooled pixels
constexpr int E0_SMEM = 1024 + E0_W_BYTES + 2 * E0_H_SLOT + CONSUMERS * (E0_TILE + E0_PTILE) +
                        2 * E0_X_STAGE + 5 * 8;
static_assert(E0_SMEM <= SMEM_PER_BLOCK, "the fused enc0 exceeds the 227 KB a block can use");
static_assert(E0_OUT == CONSUMERS * 2 * UNIT, "16 output rows a warpgroup");
static_assert(E0_H_ROWS >= E0_ROWS, "every h pixel conv1 reads");
static_assert(E0_XROWS * E0_X_CHUNKS <= 128, "a load a stem thread");
static_assert(8 * E0_X_CHUNKS >= 7 + E0_STEP + 4 && 16 * E0_X_CHUNKS <= E0_X_ROW,
              "a row's loads cover its 12 values from the 16-byte boundary before them");
static_assert((E0_W_BYTES + 2 * E0_H_SLOT) % 1024 == 0, "the output tiles on a 1 KB atom");

__device__ __forceinline__ void st_shared_b16(uint32_t addr, __nv_bfloat16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(__bfloat16_as_ushort(v)) : "memory");
}

// Step m of a block's walk, m >= n repeating step n - 1 (the x loads past
// the block's last step, never used).
struct E0Walk {
  int b, band, j, m;
};

__device__ __forceinline__ void e0_next(E0Walk& w, int n, int nbands, int nj) {
  if (w.m + 1 < n && ++w.j == nj) {
    w.j = 0;
    if (++w.band == nbands) {
      w.band = 0;
      ++w.b;
    }
  }
  ++w.m;
}

// The stem of one unit (segment: h rows r0 .. r0 + E0_SEG - 1, column c)
// of the step whose flat x index of row 0, column 0 is row0, channels 8 cg
// .. 8 cg + 7, from the staged x rows xs into the h tile hs, the 3x3 window
// sliding down the column: x rows r, r + 1, r + 2 of it at win[r % 3].
struct E0Stem {
  const uint8_t* xs;
  uint8_t* hs;
  int row0, W, r0, c, cg;
  float win[3][3];
};

// x row r into v (the row's first value sits at (its flat index & 7) in the
// staged row)
__device__ __forceinline__ void e0_x_row(const E0Stem& st, int r, float (&v)[3]) {
  const __nv_bfloat16* xr = reinterpret_cast<const __nv_bfloat16*>(st.xs + r * E0_X_ROW) +
                            ((st.row0 + r * st.W) & 7) + st.c;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) v[kx] = __bfloat162float(xr[kx]);
}

__device__ __forceinline__ void e0_stem_begin(E0Stem& st) {
  e0_x_row(st, st.r0, st.win[0]);
  e0_x_row(st, st.r0 + 1, st.win[1]);
}

// Rows I .. END - 1 of the unit (window slots (I + ky) % 3).
template <int I, int END>
__device__ __forceinline__ void e0_stem_rows(E0Stem& st, const float (&sw)[9][8],
                                             const float (&sb)[8]) {
  if constexpr (I < END) {
    e0_x_row(st, st.r0 + I + 2, st.win[(I + 2) % 3]);
    float a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = sb[k];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] += sw[tap][k] * st.win[(I + tap / 3) % 3][tap % 3];
    __align__(16) __nv_bfloat162 o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = __floats2bfloat162_rn(unet::act(a[2 * k], 1), unet::act(a[2 * k + 1], 1));
    const int p = (st.r0 + I) * TB_PITCH + st.c;
    *reinterpret_cast<uint4*>(st.hs + p * ROW + ((st.cg ^ (p & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(o);
    e0_stem_rows<I + 1, END>(st, sw, sb);
  }
}

// x: the input, xn = B H W values; wmap: w1 as the (64, 9, 64) view (box
// one tap); ymap: skip0 (B, Ho, Wo, 64), boxes of 64 x E0_STEP x 16; pmap:
// pooled (B, Ho / 2, Wo / 2, 64), boxes of 64 x E0_STEP / 2 x 8 (used when
// pool_out).
__global__ void __launch_bounds__(E0_THREADS, 1)
enc0_fused_kernel(const __nv_bfloat16* __restrict__ x, int xn,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap,
                  const __grid_constant__ CUtensorMap pmap, const __nv_bfloat16* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ b1, int H, int W,
                  int Ho, int Wo, int nbands, int nj, int total, int pool_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t wbase = (raw + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t hbase = wbase + E0_W_BYTES;
  const uint32_t tbase = hbase + 2 * E0_H_SLOT;
  const uint32_t pbase = tbase + CONSUMERS * E0_TILE;
  const uint32_t xbase = pbase + CONSUMERS * E0_PTILE;
  const uint32_t wfull = xbase + 2 * E0_X_STAGE, hfull0 = wfull + 8, hempty0 = hfull0 + 16;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t_begin = (int)((long long)total * blockIdx.x / gridDim.x);
  const int n = (int)((long long)total * (blockIdx.x + 1) / gridDim.x) - t_begin;
  E0Walk first;
  tail_step(t_begin, nbands, nj, first.b, first.band, first.j);
  first.m = 0;

  if (tid == 0) {
    mbar_init(wfull, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(hfull0 + 8 * s, 1);
      mbar_init(hempty0 + 8 * s, CONSUMERS);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // ---- the stem warpgroup
    const int st_tid = tid - CONSUMERS * 128;
    E0Walk st = first, ld = first;  // the steps of the stem and of the x copies
    const auto row0 = [&](const E0Walk& s) {
      return (s.b * H + s.band * E0_OUT) * W + s.j * E0_STEP;
    };
    // this thread's 16 bytes of step ld.m's x rows: row xr, values 8 xc ..
    // 8 xc + 7 from the row's 16-byte boundary; zeros past the input's end
    const int xr = st_tid / E0_X_CHUNKS, xc = st_tid % E0_X_CHUNKS;
    const bool loader = xr < E0_XROWS;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    const auto load_x = [&]() {
      const int i = ((row0(ld) + xr * W) & ~7) + 8 * xc;
      e0_next(ld, n, nbands, nj);
      if (!loader) return;
      if (i + 8 <= xn) {
        xv = __ldg(reinterpret_cast<const uint4*>(x + i));
        return;
      }
      __align__(16) __nv_bfloat16 v[8];
      for (int e = 0; e < 8; ++e) v[e] = i + e < xn ? x[i + e] : __float2bfloat16(0.f);
      xv = *reinterpret_cast<const uint4*>(v);
    };
    // ... into x stage s
    const auto store_x = [&](int s) {
      if (loader)
        *reinterpret_cast<uint4*>(smem_raw + (xbase + s * E0_X_STAGE - raw) + xr * E0_X_ROW +
                                  16 * xc) = xv;
    };
    if (st_tid == 0) {
      mbar_expect_tx(wfull, E0_W_BYTES);
      for (int tap = 0; tap < 9; ++tap)
        tma_load_3d(wbase + tap * TB_B_STAGE, &wmap, wfull, 0, tap, 0);
    }
    load_x();
    store_x(0);
    load_x();
    store_x(1);
    load_x();  // step 2's, stored once step 0's stem has read stage 0
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + CONSUMERS) : "memory");

    const int cg = st_tid & 7, lane16 = st_tid >> 3;  // units lane16 and lane16 + 16
    float sw[9][8], sb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sb[k] = b0[8 * cg + k];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) sw[tap][k] = __bfloat162float(w0[(8 * cg + k) * 9 + tap]);
    }
    E0Stem stl;
    stl.W = W;
    stl.cg = cg;
    for (int m = 0; m < n; ++m) {
      const int s = m & 1;
      if (m >= 2) mbar_wait(hempty0 + 8 * s, ((m >> 1) - 1) & 1);  // conv1 of step m - 2 done
      stl.xs = smem_raw + (xbase + s * E0_X_STAGE - raw);
      stl.hs = smem_raw + (hbase + s * E0_H_SLOT - raw);
      stl.row0 = row0(st);
      // the carry: after this band's column step j - 1 (the block's step
      // m - 1, in the other tile) h columns 0, 1 are its columns 8, 9
      const bool carry = m >= 1 && st.j > 0;
      const int c0 = carry ? 2 : 0, ncols = TB_PITCH - c0;
      if (carry) {
        const uint8_t* prev = smem_raw + (hbase + (s ^ 1) * E0_H_SLOT - raw);
        for (int i = st_tid; i < E0_H_ROWS * 2 * 8; i += 128) {
          const int r = i >> 4, cc = (i >> 3) & 1, ch = i & 7;
          const int ps = r * TB_PITCH + E0_STEP + cc, pd = r * TB_PITCH + cc;
          *reinterpret_cast<uint4*>(stl.hs + pd * ROW + ((ch ^ (pd & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(prev + ps * ROW + ((ch ^ (ps & 7)) << 4));
        }
      }
      // units (segment, column) of the new columns: 32 with the carry, 40
      // without
      for (int u = lane16; u < E0_NSEG * ncols; u += 16) {
        stl.r0 = E0_SEG * (u / ncols);
        stl.c = c0 + u % ncols;
        e0_stem_begin(stl);
        e0_stem_rows<0, E0_SEG>(stl, sw, sb);
      }
      fence_proxy_async_shared();  // the stem's writes before wgmma reads them
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + CONSUMERS) : "memory");
      if (st_tid == 0) mbar_arrive(hfull0 + 8 * s);
      // step m + 2's x rows into the stage this stem has read (the next
      // step's barrier publishes them), step m + 3's into registers
      store_x(s);
      load_x();
      e0_next(st, n, nbands, nj);
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg owns output rows 16 wg .. 16
  // wg + 15 of each step, warp w of it channels 16 w .. 16 w + 15
  const int g = lane >> 2, q = lane & 3;
  const float blo = b1[16 * warp + g], bhi = b1[16 * warp + g + 8];
  const uint64_t da = weight_desc(wbase);
  const uint64_t db0 = pixel_desc(hbase + (uint32_t)(2 * UNIT * wg * TB_PITCH * ROW));
  float acc[64];
  // conv1 of step m on h tile m & 1 as one wgmma group; a step past the
  // block's last (m = n) reads a tile no stem wrote and is never stored
  const auto conv1 = [&](int m) {
    const uint64_t db = db0 + (uint64_t)((m & 1) * (E0_H_SLOT >> 4));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      tap_n128(acc, da + tap * (TB_B_STAGE >> 4), db + (tap_offset(tap) >> 4));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_regs(acc);
  };
  // wait for it, free its h tile for the stem, round it into pk
  uint32_t pk[32];
  const auto conv1_done = [&](int m) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if ((tid & 127) == 0) mbar_arrive(hempty0 + 8 * (m & 1));
    pack_transposed(acc, blo, bhi, pk);
  };
  const uint32_t tile = tbase + wg * E0_TILE, ptile = pbase + wg * E0_PTILE;
  const bool storer = (tid & 127) == 0;  // issues the warpgroup's stores
  E0Walk ep = first;                     // the epilogue's step

  mbar_wait(hfull0, 0);
  mbar_wait(wfull, 0);
  conv1(0);
  conv1_done(0);
  for (int k = 0; k < n; ++k) {
    // conv1 of step k + 1 runs while this warpgroup stores step k's tiles
    if (k + 1 < n) mbar_wait(hfull0 + 8 * ((k + 1) & 1), ((k + 1) >> 1) & 1);
    conv1(k + 1);
    bulk_wait_read<0>();  // the stores of step k - 1 have read the tiles
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // skip0 into the tile; pooled pixel (j / 2, q) of the warpgroup's 8 x 4
    // from rows j, j + 1 of each of the thread's two channels
    store_packed(pk, tile, warp, lane, [](int row, int c) { return row * UNIT + c; },
                 [&](int jr, const uint32_t (&r)[4]) {
                   const int pp = (jr >> 1) * (UNIT / 2) + q;
#pragma unroll
                   for (int h = 0; h < 2; ++h) {
                     const __nv_bfloat162 u = *reinterpret_cast<const __nv_bfloat162*>(&r[h]);
                     const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r[h + 2]);
                     st_shared_b16(ptile + pp * ROW + (((2 * warp + h) ^ (pp & 7)) << 4) + 2 * g,
                                   __hmax(__hmax(__hmax(u.x, u.y), v.x), v.y));
                   }
                 });
    fence_proxy_async_shared();  // the tiles' writes before the TMA stores read them
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // boxes wholly past the edge (the last band's second half) are not stored
    const int oy = ep.band * E0_OUT + 2 * UNIT * wg, ox = ep.j * E0_STEP;
    tma_store_4d_if(storer && oy < Ho, &ymap, tile, 0, ox, oy, ep.b);
    tma_store_4d_if(storer && pool_out && oy / 2 < Ho / 2 && ox / 2 < Wo / 2, &pmap, ptile, 0,
                    ox / 2, oy / 2, ep.b);
    bulk_commit_if(storer);
    conv1_done(k + 1);
    e0_next(ep, n, nbands, nj);
  }
  bulk_wait<0>();  // the last stores are done
}

}  // namespace

namespace unet {

int launch_conv_fwd_wgmma(Src s0, Src s1, const void* w, const void* bias, int relu, int B,
                          int Ho, int Wo, int CO, void* y, void* pooled, void* stream) {
  return route(s0, s1, w, bias, relu, B, Ho, Wo, CO, y, pooled, stream, false);
}

int launch_conv_dgrad_wgmma(const void* g, int B, int Hg, int Wg, int CO, const void* wt, int CI,
                            void* dx, void* stream) {
  const Src none{nullptr, 0, 0, 0, 0, 0};
  const Src src{(const __nv_bfloat16*)g, Hg, Wg, CO, -2, -2};
  return route(src, none, wt, nullptr, 0, B, Hg + 2, Wg + 2, CI, dx, nullptr, stream, true);
}

int launch_conv_head_wgmma(Src s0, const void* w, const void* bias, const void* head_w,
                           const void* head_b, int nc, int B, int Ho, int Wo, void* logits,
                           void* stream) {
  CUtensorMap xmap, wmap;
  int sms = 0;
  int e = nhwc_map(&xmap, s0.p, B, s0.H, s0.W, s0.C, WIN, WIN);
  if (e == 0) e = weight_map(&wmap, w, s0.C, SLICE);
  if (e == 0) e = sm_count(&sms);
  if (e != 0) return e;
  const int slices = (s0.C + SLICE - 1) / SLICE;
  const Head hd{(const float*)head_w, (const float*)head_b, (float*)logits, nc};
  return launch<64, 2, 13, true>(xmap, xmap, wmap, s0.C, 0, 0, slices, slices,
                                 (const float*)bias, 1, B, Ho, Wo, SLICE, nullptr, nullptr, sms,
                                 (cudaStream_t)stream, false, hd);
}

int launch_dec_tail_wgmma(Src s0, Src s1, const void* w0, const void* b0, const void* w1,
                          const void* b1, const void* head_w, const void* head_b, int nc, int B,
                          int Ho, int Wo, void* logits, void* stream) {
  CUtensorMap xmap0, xmap1, w0map, w1map;
  int sms = 0;
  int e = nhwc_map(&xmap0, s0.p, B, s0.H, s0.W, s0.C, TB_PITCH, TB_ROWS + 2);
  if (e == 0) e = nhwc_map(&xmap1, s1.p, B, s1.H, s1.W, s1.C, TB_PITCH, TB_ROWS + 2);
  if (e == 0) e = weight_map(&w0map, w0, s0.C + s1.C, SLICE);
  if (e == 0) e = weight_map(&w1map, w1, SLICE, SLICE);
  if (e == 0) e = sm_count(&sms);
  if (e != 0) return e;
  cudaError_t err =
      cudaFuncSetAttribute(dec_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TB_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int slices0 = (s0.C + SLICE - 1) / SLICE;
  const int slices = slices0 + (s1.C + SLICE - 1) / SLICE;
  const int nbands = (Ho + TB_OUT - 1) / TB_OUT;
  const int nj = (Wo + 2 + TB_STEP - 1) / TB_STEP;  // step j stores logits columns 8j - 2 .. 8j + 5
  const long long steps = (long long)B * nbands * nj;
  const int grid = (int)(steps < sms ? steps : sms);
  const Head hd{(const float*)head_w, (const float*)head_b, (float*)logits, nc};
  dec_tail_kernel<<<grid, FWD_THREADS, TB_SMEM, (cudaStream_t)stream>>>(
      xmap0, xmap1, w0map, w1map, s0.C, s0.off_y, s0.off_x, slices0, slices, (const float*)b0,
      (const float*)b1, B, Ho, Wo, nbands, nj, hd);
  return (int)cudaGetLastError();
}

int launch_enc0_fused_wgmma(const void* x, const void* w0, const void* b0, const void* w1,
                            const void* b1, void* y, void* pooled, int B, int H, int W,
                            void* stream) {
  const int Ho = H - 4, Wo = W - 4;
  const int pool = Ho >= 2 && Wo >= 2;  // else nothing to pool
  // flat x indices up to the last step's rows past the image
  if ((long long)(B * (long long)H + E0_XROWS) * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, ymap, pmap;
  int sms = 0;
  int e = weight_map(&wmap, w1, SLICE, SLICE);
  if (e == 0) e = nhwc_map(&ymap, y, B, Ho, Wo, SLICE, E0_STEP, E0_OUT / 2);
  if (e == 0 && pool) e = nhwc_map(&pmap, pooled, B, Ho / 2, Wo / 2, SLICE, E0_STEP / 2, E0_OUT / 4);
  if (e == 0) e = sm_count(&sms);
  if (e != 0) return e;
  if (!pool) pmap = ymap;
  cudaError_t err =
      cudaFuncSetAttribute(enc0_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, E0_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nbands = (Ho + E0_OUT - 1) / E0_OUT, nj = (Wo + E0_STEP - 1) / E0_STEP;
  const int total = B * nbands * nj;
  const int grid = total < sms ? total : sms;
  enc0_fused_kernel<<<grid, E0_THREADS, E0_SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, B * H * W, wmap, ymap, pmap, (const __nv_bfloat16*)w0,
      (const float*)b0, (const float*)b1, H, W, Ho, Wo, nbands, nj, total, pool);
  return (int)cudaGetLastError();
}

}  // namespace unet
