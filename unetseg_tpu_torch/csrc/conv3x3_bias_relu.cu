// conv3x3_bias_relu: valid 3x3 conv + bias + ReLU, optionally with the 2x2
// max-pool of the output fused into the epilogue. With relu == 0 it writes
// the pre-activation conv + bias (the train step's pre-BatchNorm z).
//
// Replaces the TPU kernels unetseg_tpu/ops/pallas/conv3x3.py:conv3x3_phase2
// (stem, and enc0 conv1 + pool0 on the serving path; stem, enc0 conv1 and
// dec3 conv1 with relu=False in the train step), conv3x3.py:conv3x3_lanes
// through the conv3x3_dense wrapper (tier-2 enc1 and dec2 convs, enc1
// conv1 with the pool) and conv_cblock.py:conv3x3_cblock through the
// conv3x3_cblock wrapper (the middle convs with CO % 128 == 0). The TPU
// needed three kernels for three layouts; on NHWC they are one function.
//
// CI >= 32 (enc0 conv1, 64 -> 64 channels at 696^2 outputs, up to enc4's
// 1024 -> 1024): the implicit GEMM on wgmma fed by a TMA ring of
// conv_fwd_wgmma.cu, the pool in its epilogue, so the skip is written once
// and never re-read.
//
// CI == 1 (the stem, 1 -> 64 channels; serving (16,700,700,1) ->
// (16,698,698,64) with bias and ReLU, train (4,512,512,1) -> (4,510,510,64)
// with relu=False): 4.5 GFMA against a 998 MB output per serving call, so
// bound by the output write (0.303 ms at 3.35 TB/s on an H100), with the
// FMAs (about 0.15 ms of the card's f32 rate) to hide under it. The row
// kernel (stem_rows_kernel): a persistent grid of three 256-thread blocks
// per SM (two with the pool tiles) walks strips of two output rows x
// STEM_SW columns (per 64 output channels), in (image, row pair, column
// segment, channel block) order.
// - Input: the strip's four input rows (STEM_SW + 16 values each, from the
//   16-byte boundary at or before the row's first value) come by four 1-D
//   TMA copies of the flat input into a double-buffered stage, issued two
//   strips ahead on an mbarrier per stage; a row that runs past its
//   image's edge reads the next row or zeros and feeds only outputs that
//   are never stored.
// - Arithmetic: thread (quad q, channel group cg) computes a 2x2 quad of
//   pixels for 8 channels: f32 from the accumulator's bias, the nine taps
//   in order by FMA (weights in shared memory as f32, laid out so that the
//   eight channel groups of a quarter warp read 128 contiguous bytes),
//   rounded by __floats2bfloat162_rn.
// - Output: each quad's four pixels go as 16-byte vectors into a shared
//   tile of whole 128-byte pixel rows (two rows x STEM_SW pixels x 64
//   channels, STEM_TILES buffers; eight lanes write one pixel's 128 bytes,
//   no bank conflict), the 2x2 max of the rounded quad into a pool tile
//   (in shared memory only when pooled).
//   One thread stores each tile with a TMA tensor store (the box clipped
//   to the output at ragged edges), commits it as a bulk group and, before
//   the next strip writes the other buffer, waits until the store before
//   has read it: a strip's stores run under the next strip's FMAs (26%
//   faster than the block copying the tile out with 16-byte st.global, a
//   warp 512 contiguous bytes; PERF.md).
// Odd sizes floor under the pool (the TMA box of the pooled map clips the
// last half quad). CO is any multiple of 64.
//
#include "conv_fwd_wgmma.cuh"

#include "hopper.cuh"

namespace {

constexpr int STEM_THREADS = 256;

// The row kernel: a strip is two output rows (one row of 2x2 quads) x
// STEM_SW columns of one 64-channel block; a TMA box is at most 256 wide.
constexpr int STEM_SW = 128;
// input values a staged row: from the 16-byte boundary at or before the
// strip's first input value, so >= 7 + STEM_SW + 2, a 16-byte multiple
constexpr int STEM_IN = STEM_SW + 16;
constexpr int STEM_IN_ROW = (STEM_IN * 2 + 127) / 128 * 128;  // its bytes, 128-byte aligned
constexpr int STEM_TILE = 2 * STEM_SW * 128;  // two rows x STEM_SW pixels x 64 bf16 channels
constexpr int STEM_PTILE = STEM_SW / 2 * 128;  // the pool tile: STEM_SW / 2 pooled pixels
constexpr int STEM_PAIRS = STEM_SW / 2 * 8;    // (quad, channel group) pairs of a strip
constexpr int STEM_TILES = 2;          // output (and pool) tile buffers
constexpr int STEM_BLOCKS_PER_SM = 3;  // at most; fewer where the shared memory does not fit

// Dynamic shared memory of the row kernel at CO output channels: 1 KB of
// alignment slack, the output tiles, the pool tiles when pooled, two input
// stages of four rows, the weights (9 x CO) and bias (CO) in f32, two
// mbarriers.
constexpr int stem_smem(int co, bool pool) {
  return 1024 + STEM_TILES * (STEM_TILE + (pool ? STEM_PTILE : 0)) + 2 * 4 * STEM_IN_ROW +
         10 * co * 4 + 16;
}

struct Strip {
  int b, qy, c0, cb;  // image, quad row (output rows 2 qy, 2 qy + 1), first column, channel block
};

// Strip i in (image, quad row, column segment, channel block) order.
__device__ __forceinline__ Strip strip_of(int i, int nq, int nseg, int ncb) {
  Strip s;
  s.cb = i % ncb;
  i /= ncb;
  s.c0 = (i % nseg) * STEM_SW;
  i /= nseg;
  s.qy = i % nq;
  s.b = i / nq;
  return s;
}

// Flat index of the first input value of the strip's input row r (input
// rows 2 qy .. 2 qy + 3 from column c0 on).
__device__ __forceinline__ int stem_row_start(const Strip& s, int r, int H, int W) {
  return (s.b * H + 2 * s.qy + r) * W + s.c0;
}

// The strip's four input rows by four 1-D TMA copies on the stage's
// mbarrier, each STEM_IN values of the flat (B H W) input from the 16-byte
// boundary at or before the row's first value, which then sits at (start
// & 7) in the staged row (a copy that starts off a 16-byte boundary is an
// illegal instruction on an H100); past the end of the input they read
// zeros.
__device__ __forceinline__ void stem_load(const CUtensorMap* xmap, uint32_t dst, uint32_t bar,
                                          const Strip& s, int H, int W) {
  hopper::mbar_expect_tx(bar, 4 * STEM_IN * 2);
  for (int r = 0; r < 4; ++r)
    hopper::tma_load_1d(dst + r * STEM_IN_ROW, xmap, bar, stem_row_start(s, r, H, W) & ~7);
}

// See the note at the top. xmap: the input as a flat 1-D bf16 map (box
// STEM_IN); ymap: y (B, Ho, Wo, CO) with boxes of 64 channels x STEM_SW x
// 2 rows; pmap: the pooled output, boxes of 64 x STEM_SW / 2 x 1 (used
// when pool).
__global__ void __launch_bounds__(STEM_THREADS, STEM_BLOCKS_PER_SM)
stem_rows_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap pmap, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, int relu, int pool, int B, int H, int W, int Ho,
                 int Wo, int CO) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // [output tiles][pool tiles when pooled][input stages][weights][bias][mbarriers]
  uint8_t* tiles = smem_raw + (base - raw);
  uint8_t* ptiles = tiles + STEM_TILES * STEM_TILE;
  const int stage_off = STEM_TILES * (STEM_TILE + (pool ? STEM_PTILE : 0));
  const uint8_t* stages = tiles + stage_off;
  const uint32_t stage0 = base + stage_off;
  float* w_s = reinterpret_cast<float*>(tiles + stage_off + 8 * STEM_IN_ROW);
  float* b_s = w_s + 9 * CO;
  const uint32_t bar0 = hopper::smem_u32(b_s + CO);

  const int tid = threadIdx.x;
  const int nq = (Ho + 1) / 2, nseg = (Wo + STEM_SW - 1) / STEM_SW, ncb = CO / 64;
  const int strips = B * nq * nseg * ncb;
  // w_s as float4s: ((tap ncb + cb) 2 + h) 8 + cg holds channels 64 cb + 8 cg
  // + 4 h .. + 3, so the eight channel groups of a quarter warp read 128
  // contiguous bytes
  for (int i = tid; i < 9 * CO; i += STEM_THREADS) {
    const int tap = i / CO, co = i % CO;
    const int cb = co / 64, cg = (co % 64) / 8, h = (co % 8) / 4;
    w_s[(((tap * ncb + cb) * 2 + h) * 8 + cg) * 4 + co % 4] =
        __bfloat162float(w[(size_t)co * 9 + tap]);
  }
  for (int i = tid; i < CO; i += STEM_THREADS) b_s[i] = bias[i];
  if (tid == 0) {
    hopper::mbar_init(bar0, 1);
    hopper::mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < 2; ++k) {
      const int i = blockIdx.x + k * gridDim.x;
      if (i < strips)
        stem_load(&xmap, stage0 + k * 4 * STEM_IN_ROW, bar0 + 8 * k, strip_of(i, nq, nseg, ncb),
                  H, W);
    }

  const int cg = tid & 7;  // channels 8 cg .. 8 cg + 7 of the strip's block
  int k = 0;
  for (int i = blockIdx.x; i < strips; i += gridDim.x, ++k) {
    const int buf = k & 1, tb = k % STEM_TILES;  // input stage, output tile
    const Strip s = strip_of(i, nq, nseg, ncb);
    uint8_t* tile = tiles + tb * STEM_TILE;
    uint8_t* ptile = ptiles + tb * STEM_PTILE;
    const uint8_t* in = stages + buf * 4 * STEM_IN_ROW;
    const float4* wv = reinterpret_cast<const float4*>(w_s) + s.cb * 16 + cg;
    const float* bb = b_s + s.cb * 64 + cg * 8;
    hopper::mbar_wait(bar0 + 8 * buf, (k >> 1) & 1);
    int e[4];  // where each input row's first value sits in its staged row
#pragma unroll
    for (int r = 0; r < 4; ++r) e[r] = stem_row_start(s, r, H, W) & 7;
#pragma unroll 1
    for (int p = tid; p < STEM_PAIRS; p += STEM_THREADS) {
      const int q = p >> 3;         // quad: strip columns 2q, 2q + 1
      if (s.c0 + 2 * q >= Wo) break;  // past the edge (q only grows): nothing to store
      float px[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat16* row =
            reinterpret_cast<const __nv_bfloat16*>(in + r * STEM_IN_ROW) + e[r] + 2 * q;
#pragma unroll
        for (int j = 0; j < 4; ++j) px[r][j] = __bfloat162float(row[j]);
      }
      float acc[4][8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float b = bb[kk];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u][kk] = b;
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const float4 w0 = wv[tap * ncb * 16], w1 = wv[tap * ncb * 16 + 8];
        const float wk[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u][kk] += wk[kk] * px[(u >> 1) + ky][(u & 1) + kx];
      }
      __align__(16) __nv_bfloat162 out[4][4];  // [quad pixel][channel pair]
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          out[u][kk] = __floats2bfloat162_rn(unet::act(acc[u][2 * kk], relu),
                                             unet::act(acc[u][2 * kk + 1], relu));
#pragma unroll
      for (int u = 0; u < 4; ++u)  // tile row u / 2, pixel 2q + u % 2: 16 of its 128 bytes
        *reinterpret_cast<uint4*>(tile + ((u >> 1) * STEM_SW + 2 * q + (u & 1)) * 128 + cg * 16) =
            *reinterpret_cast<const uint4*>(out[u]);
      if (pool) {
        __align__(16) __nv_bfloat162 m[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          m[kk] = __hmax2(__hmax2(out[0][kk], out[1][kk]), __hmax2(out[2][kk], out[3][kk]));
        *reinterpret_cast<uint4*>(ptile + q * 128 + cg * 16) = *reinterpret_cast<const uint4*>(m);
      }
    }
    hopper::fence_proxy_async_shared();  // the tile's writes before the TMA store reads them
    __syncthreads();
    if (tid == 0) {
      hopper::tma_store_4d(&ymap, hopper::smem_u32(tile), s.cb * 64, s.c0, 2 * s.qy, s.b);
      if (pool)
        hopper::tma_store_4d(&pmap, hopper::smem_u32(ptile), s.cb * 64, s.c0 / 2, s.qy, s.b);
      hopper::bulk_commit();
      const int next = i + 2 * gridDim.x;  // this stage's next strip
      if (next < strips)
        stem_load(&xmap, stage0 + buf * 4 * STEM_IN_ROW, bar0 + 8 * buf,
                  strip_of(next, nq, nseg, ncb), H, W);
      // the store STEM_TILES - 1 strips back has read the tile the next
      // strip writes
      hopper::bulk_wait_read<STEM_TILES - 1>();
    }
    __syncthreads();
  }
  if (tid == 0) hopper::bulk_wait<0>();  // the last stores are done
}

int launch_stem(const void* x, const void* w, const void* bias, void* y, void* pooled, int B,
                int H, int W, int CO, int relu, cudaStream_t st) {
  const int Ho = H - 2, Wo = W - 2;
  const int pool = pooled != nullptr && Ho >= 2 && Wo >= 2;  // else nothing to store
  CUtensorMap xmap, ymap, pmap;
  const cuuint64_t xdim[1] = {(cuuint64_t)B * H * W}, xstride[1] = {0};
  const cuuint32_t xbox[1] = {(cuuint32_t)STEM_IN};
  int e = hopper::bf16_map(&xmap, x, 1, xdim, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0)
    e = hopper::nhwc_map(&ymap, y, B, Ho, Wo, CO, STEM_SW, 2, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == 0 && pool)
    e = hopper::nhwc_map(&pmap, pooled, B, Ho / 2, Wo / 2, CO, STEM_SW / 2, 1,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  if (!pool) pmap = ymap;
  const int smem = stem_smem(CO, pool);
  if (smem > hopper::SMEM_PER_BLOCK) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(stem_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // as many blocks as fit on an SM at once (up to STEM_BLOCKS_PER_SM): a
  // block that waits for another to finish would run its strips late
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_rows_kernel, STEM_THREADS,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  per_sm = per_sm < 1 ? 1 : (per_sm > STEM_BLOCKS_PER_SM ? STEM_BLOCKS_PER_SM : per_sm);
  const long long strips =
      (long long)B * ((Ho + 1) / 2) * ((Wo + STEM_SW - 1) / STEM_SW) * (CO / 64);
  const int grid = (int)(strips < per_sm * sms ? strips : per_sm * sms);
  stem_rows_kernel<<<grid, STEM_THREADS, smem, st>>>(
      xmap, ymap, pmap, (const __nv_bfloat16*)w, (const float*)bias, relu, pool, B, H, W, Ho, Wo,
      CO);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,H,W,CI) bf16, w (CO,3,3,CI) bf16, bias (CO,) f32 -> y (B,H-2,W-2,CO)
// bf16 and, when pooled is not null, pooled (B,(H-2)/2,(W-2)/2,CO) bf16;
// relu == 0 skips the ReLU. CI == 1 runs the row kernel, CI >= 32 the wgmma
// forward. Returns the CUDA error code of the launch (0 on success), or
// -(the CUresult) of a failed tensor-map encoding.
extern "C" int conv3x3_bias_relu_bf16(const void* x, const void* w,
                                      const void* bias, void* y, void* pooled,
                                      int B, int H, int W, int CI, int CO,
                                      int relu, void* stream) {
  const int Ho = H - 2, Wo = W - 2;
  if (CI == 1)
    return launch_stem(x, w, bias, y, pooled, B, H, W, CO, relu, (cudaStream_t)stream);
  unet::Src s0{(const __nv_bfloat16*)x, H, W, CI, 0, 0};
  unet::Src s1{nullptr, 0, 0, 0, 0, 0};
  return unet::launch_conv_fwd_wgmma(s0, s1, w, bias, relu, B, Ho, Wo, CO, y, pooled, stream);
}
