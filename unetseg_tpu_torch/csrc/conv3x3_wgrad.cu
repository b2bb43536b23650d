// conv3x3_wgrad: the weight gradient of a valid 3x3 conv,
// dw[co, ci, ky, kx] = sum_{b,y,x} g[b, y, x, co] x[b, y+ky, x+kx, ci],
// f32 accumulation, with one or two input sources (the decoder-entry conv
// reads its skip at the crop offset, then the up tensor: channels
// [0, s0.C) from s0 and [s0.C, s0.C + s1.C) from s1).
//
// Replaces four TPU kernels of unetseg_tpu/ops/pallas/conv3x3_train.py:
// conv3x3_phase2_dw (the stem, enc0 conv1 and dec3 conv1), conv3x3_dec0_dw
// (dec3 conv0: skip read at (90, 90)), conv3x3_dense_dw (tier 2's enc1 conv0
// and conv1, dec2 conv1) and conv3x3_dec0_dense_dw (dec2 conv0: skip1 read
// at (41, 41)). On NHWC the four are one function.
//
// A GEMM with M = CO, N = 9 taps x CI and a long K = B*Ho*Wo (1.03 M
// pixels at enc0 conv1). On an H100 SXM (989 TFLOP/s bf16 dense, 3.35
// TB/s) operations bound it at 128 channels; at 64 channels (enc0 conv1:
// 76 GFLOP against 265 MB of reads) bytes and operations take about the
// same time. The Pallas kernels carry one accumulator block across a
// sequential grid; Hopper's blocks run in parallel, so K is split: block
// (chunk, ci slice, co block) walks a fixed range of 4x16-pixel output
// tiles, down the columns of tiles (faster than along the rows at 64
// channels, where each byte of x and g is read by one block only), and
// writes its 64 x (9 x 64) partial sums to a (chunk, CO, 9, CI) f32
// scratch; a second kernel sums the chunks in a fixed order into the OIHW
// result. No atomics, so results repeat bit for bit.
//
// The multi-channel kernel (CI a multiple of 32 per source, CO of 64):
// - wgmma with both operands in shared memory. A = g^T is stored
//   [pixel][co] and B = the x window [pixel][ci]: both MN-major, one
//   128-byte row per pixel (64 channels), in the 128-byte swizzle. A block
//   owns a 64-channel ci slice of one source (channels past the source's
//   C are zero-filled and not written) and 64 output channels.
// - An asynchronous ring of STAGES stages: one producer warp issues two
//   TMA copies per stage (4-D NHWC tensor maps; g's 4x16-pixel tile and
//   the 6x18-pixel x window at the crop offset), completion counted in
//   bytes on the stage's "full" mbarrier. The copy's out-of-bounds zero
//   fill takes the place of bounds checks; the crop offset is a box
//   coordinate, so odd offsets cost nothing.
// - Three consumer warpgroups, one per ky, each hold 64 co x (3 kx x 64
//   ci) f32 accumulators (96 registers a thread). For a K step of 16
//   pixels (tile row r) the warpgroup issues one wgmma.m64n192k16: A is the
//   tile row, B starts at window pixel (r + ky, 0) and its three 64-column
//   blocks (kx = 0, 1, 2) lie one 128-byte row apart (the descriptor's
//   leading byte offset). One wgmma group stays in flight; each warp
//   releases a stage on its "empty" mbarrier once the group that read it
//   has completed.
// - The tap shift: the descriptor of tap row (r + ky) starts off the 1 KB
//   swizzle atom, at any 128-byte row. wgmma applies the 128-byte swizzle
//   to the shared-memory address bits, as TMA wrote it, so the start needs
//   no base offset (on an H100, setting the descriptor's base offset to
//   the row's phase gave wrong sums). The alternative, three
//   column-shifted copies of the window per stage so that every tap starts
//   on an atom, moves 36 KB a stage instead of 13.5 KB.
// Per stage and SM: 4.7 MFLOP against 21.5 KB of copies, ~0.6 us at the
// tensor cores' peak, fed from L2 at ~35 GB/s an SM. The faults of the
// mma.sync kernel this replaced: staging through registers with a barrier
// before the mma (now TMA into a ring the producer keeps ahead), B reloaded
// from shared memory per m16 slice (now wgmma reads both operands from
// shared memory once per 64 rows of M), and mma.sync's rate (now wgmma's).
// One block per SM: 416 threads at up to 152 registers; no setmaxnreg is
// needed, the producer warp idles at the registers it was given.
//
// CI == 1 (the stem: x (4,512,512,1), g (4,510,510,64) in the train step)
// is the product dw[co, tap] = sum_p g[p, co] x[p + tap]: M = 64 output
// channels, N = 9 taps, K = 1.04 M pixels, 1.2 GFLOP against 135 MB of
// reads, nearly all of them g: bound by bytes (0.040 ms at 3.35 TB/s). The
// TMA kernel (wgrad_stem_tma_kernel) streams g and hides the arithmetic
// under the copies:
// - One producer warp fills a ring of ST_STAGES stages. A stage is one
//   tile of ST_H x ST_W g pixels x 64 channels (a 4-D NHWC box, 128 bytes a
//   pixel, 128-byte swizzle, zeros past the edges) and the tile's ST_H + 2
//   x rows (128-byte aligned in shared memory, as a tensor copy's
//   destination must be), each by a 1-D copy of the flat input from the
//   16-byte boundary at or before the row's first value (a copy that starts
//   off the boundary is an illegal instruction on an H100); a row that runs
//   past its image's edge reads the next row or zeros and meets only zero g.
// - Four consumer warps, one per tile row, run mma.sync m16n8k16 on each
//   16-pixel K step: A = g^T (64 co x 16 pixels) by four ldmatrix.x4.trans
//   from the swizzled tile, B = the step's 16 x 16 im2col of x (nine taps,
//   seven zero columns) built in registers straight from the staged rows,
//   4 + 4 two-byte loads a thread. Per 16 pixels x 64 channels a warp
//   issues 4 ldmatrix, at most 8 loads and 8 mma: the 2.1 GFLOP of padded
//   tensor work is a few microseconds of the card's rate, far under the
//   copies. wgmma.m64n16k16 would issue fewer instructions still; mma.sync
//   keeps the B operand in registers and needs no second shared layout.
// - A persistent grid of one block per SM over whole-wave split-K chunks
//   (ops/kernels/conv3x3_train.py wgrad_chunks); at the end the four warps'
//   sums meet in shared memory in a fixed order, and the reduce kernel
//   below sums the chunks: the same bits on every launch.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------- stem (CI 1)
constexpr int ST_H = 4, ST_W = 64;        // g pixels per TMA stem tile
constexpr int ST_PIX = ST_H * ST_W;
constexpr int ST_G_BYTES = ST_PIX * SLICE * 2;  // 64 channels, 128 bytes a pixel
// x values a staged row: from the 16-byte boundary at or before the tile's
// first input value, so >= 7 + ST_W + 2, a multiple of 8
constexpr int ST_XIN = ST_W + 16;
// a staged row's bytes: a tensor copy's shared destination is 128-byte aligned
constexpr int ST_XROW = (ST_XIN * 2 + 127) / 128 * 128;
constexpr int ST_X_BYTES = (ST_H + 2) * ST_XIN * 2;  // what the copies bring
constexpr int ST_STAGE = ST_G_BYTES + ((ST_H + 2) * ST_XROW + 1023) / 1024 * 1024;
constexpr int ST_STAGES = 6;
constexpr int ST_WARPS = ST_H;                       // consumer warps, one per tile row
constexpr int ST_THREADS = ST_WARPS * 32 + 32;       // + the producer warp
constexpr int ST_RED_BYTES = ST_WARPS * 64 * 9 * 4;  // the warps' sums
constexpr int ST_SMEM = 1024 + ST_STAGES * ST_STAGE + ST_RED_BYTES + 2 * ST_STAGES * 8;
static_assert(ST_SMEM <= SMEM_PER_BLOCK, "stem stages exceed the 227 KB a block can use");

// Image b and origin of a tile, the tiles of an image in row-major order of
// (nty, ntx) tiles of th x tw; with the roles of rows and columns swapped
// the order goes down the columns.
__device__ __forceinline__ void tile_origin(long long tile, int th, int tw, int nty, int ntx,
                                            int& b, int& y0, int& x0) {
  const long long per_b = (long long)nty * ntx;
  b = (int)(tile / per_b);
  const int r = (int)(tile % per_b);
  y0 = (r / ntx) * th;
  x0 = (r % ntx) * tw;
}

// ------------------------------------------------------ multi-channel wgmma
constexpr int GT_H = 4, GT_W = 16;              // output pixels per tile: K = 64
constexpr int WIN_H = GT_H + 2, WIN_W = GT_W + 2;
constexpr int CSL = SLICE;                       // channels per ci slice / co block
constexpr int ROW = CSL * 2;                     // one pixel's slice: 128 bytes
constexpr int G_BYTES = GT_H * GT_W * ROW;       // 8192
constexpr int X_BYTES = WIN_H * WIN_W * ROW;     // the 6x18 window: 13824
constexpr int STAGES = 8;
constexpr int X_SLOT = (X_BYTES + 1023) / 1024 * 1024;
constexpr int STAGE_BYTES = G_BYTES + X_SLOT;
constexpr int CONSUMERS = 3;                     // warpgroups, one per ky
constexpr int MMA_THREADS = CONSUMERS * 128;
constexpr int WG_THREADS = MMA_THREADS + 32;     // + the producer warp
constexpr int NACC = 96;                         // 64 x 192 f32 over 128 threads
constexpr int WG_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(WG_SMEM <= SMEM_PER_BLOCK, "stages exceed the 227 KB a block can use");

// D (64 x 192, f32) += A (64 x 16) B (16 x 192), both MN-major in shared
// memory (imm-trans-a = imm-trans-b = 1).
__device__ __forceinline__ void wgmma_192(float (&d)[NACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}


__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap xmap0,
                   const __grid_constant__ CUtensorMap xmap1, int C0, int C1, int off_y,
                   int off_x, int slices0, int B, int Ho, int Wo, int CO, int nchunks,
                   float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t full0 = base + STAGES * STAGE_BYTES;          // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const bool second = (int)blockIdx.y >= slices0;  // slice of s1
  const int cs = ((int)blockIdx.y - (second ? slices0 : 0)) * CSL;  // channel in the source
  const int co0 = blockIdx.z * CSL;
  const int nty = (Ho + GT_H - 1) / GT_H, ntx = (Wo + GT_W - 1) / GT_W;
  const long long ntiles = (long long)B * nty * ntx;
  const long long t_begin = ntiles * chunk / nchunks;
  const int n = (int)(ntiles * (chunk + 1) / nchunks - t_begin);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, MMA_THREADS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= MMA_THREADS) {  // the producer warp: one thread issues the copies
    if (tid == MMA_THREADS) {
      const CUtensorMap* xmap = second ? &xmap1 : &xmap0;
      const int oy = second ? 0 : off_y, ox = second ? 0 : off_x;
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, (i / STAGES - 1) & 1);
        // down each column of tiles first: a window shares two rows with
        // the one before it, which the copy then finds in L2
        int b, y0, x0;
        tile_origin(t_begin + i, GT_W, GT_H, ntx, nty, b, x0, y0);
        const uint32_t full = full0 + 8 * s, gs = base + s * STAGE_BYTES;
        mbar_expect_tx(full, G_BYTES + X_BYTES);
        tma_load_4d(gs, &gmap, full, co0, x0, y0, b);
        tma_load_4d(gs + G_BYTES, xmap, full, cs, x0 + ox, y0 + oy, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup ky
  const int ky = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const uint32_t gs = base + s * STAGE_BYTES, xs = gs + G_BYTES;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < GT_H; ++r) {
      const uint64_t da = sw128_desc(gs + r * GT_W * ROW, 0, 8 * ROW);
      // B: window row r + ky from column 0; block kx starts kx rows later
      wgmma_192(acc, da, sw128_desc(xs + (r + ky) * WIN_W * ROW, ROW, 8 * ROW));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_regs(acc);
    if (i > 0) {  // the group before this one is done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % STAGES));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);

  // partial[chunk][co][tap][ci]: accumulator 4j + h of this thread is row
  // 16 warp + lane/4 (+8 for h >= 2), column 8j + 2 (lane % 4) + (h & 1),
  // and column n is kx = n / 64, channel cs + n % 64 of the source
  const int csrc = second ? C1 : C0, cbase = second ? C0 : 0, CI = C0 + C1;
  const int co = co0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int c = cs + (j % 8) * 8 + 2 * (lane & 3);
    if (c >= csrc) continue;
    const int tap = ky * 3 + j / 8;
    float* p0 = partial + (((size_t)chunk * CO + co) * 9 + tap) * CI + cbase + c;
    float* p1 = p0 + (size_t)8 * 9 * CI;  // co + 8
    *reinterpret_cast<float2*>(p0) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(p1) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Four 8x8 bf16 matrices of shared memory, transposed, into the mma.sync
// fragment registers: thread 8i + r gives row r of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (m16 x n8, f32) += a (m16 x k16) b (k16 x n8), bf16 fragments in registers.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values as one mma.sync operand register (a in the low half).
__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(a) |
         (uint32_t)*reinterpret_cast<const unsigned short*>(b) << 16;
}

// Flat index of the first x value of staged row r of the tile at (b, y0,
// x0): input row y0 + r of image b from column x0 (past the last row of the
// image it runs on into the next image, or past the input's end).
__device__ __forceinline__ int stem_x_start(int b, int y0, int x0, int r, int H, int W) {
  return (b * H + y0 + r) * W + x0;
}

// The stem's weight gradient (see the note at the top). gmap: g (B, Ho,
// Wo, CO) with boxes of 64 channels x ST_W x ST_H; xmap: x as a flat 1-D
// bf16 map, box ST_XIN. partial[chunk][co][tap] f32.
__global__ void __launch_bounds__(ST_THREADS, 1)
wgrad_stem_tma_kernel(const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap xmap, int H, int W, int B, int Ho,
                      int Wo, int CO, int nchunks, float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's 1 KB atom
  const uint32_t full0 = base + ST_STAGES * ST_STAGE + ST_RED_BYTES;
  const uint32_t empty0 = full0 + 8 * ST_STAGES;
  uint8_t* sbase = smem_raw + (base - raw);
  float* red = reinterpret_cast<float*>(sbase + ST_STAGES * ST_STAGE);  // [warp][co][tap]

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int co0 = blockIdx.z * SLICE;
  const int nty = (Ho + ST_H - 1) / ST_H, ntx = (Wo + ST_W - 1) / ST_W;
  const long long ntiles = (long long)B * nty * ntx;
  const long long t_begin = ntiles * chunk / nchunks;
  const int n = (int)(ntiles * (chunk + 1) / nchunks - t_begin);

  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, ST_WARPS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= ST_WARPS * 32) {  // the producer warp: one thread issues the copies
    if (tid == ST_WARPS * 32) {
      for (int i = 0; i < n; ++i) {
        const int s = i % ST_STAGES;
        if (i >= ST_STAGES) mbar_wait(empty0 + 8 * s, (i / ST_STAGES - 1) & 1);
        int b, y0, x0;
        tile_origin(t_begin + i, ST_H, ST_W, nty, ntx, b, y0, x0);
        const uint32_t full = full0 + 8 * s, gs = base + s * ST_STAGE;
        mbar_expect_tx(full, ST_G_BYTES + ST_X_BYTES);
        tma_load_4d(gs, &gmap, full, co0, x0, y0, b);
        for (int r = 0; r < ST_H + 2; ++r)
          tma_load_1d(gs + ST_G_BYTES + r * ST_XROW, &xmap, full,
                      stem_x_start(b, y0, x0, r, H, W) & ~7);
      }
    }
    return;
  }

  // ---- consumers: warp w takes row w of every tile
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // this lane's ldmatrix matrix and row
  // B columns: n8 tile 0 holds taps 0..7 (this lane's column g is tap g),
  // n8 tile 1 tap 8 in column 0 (lanes 0..3) and zeros
  const int ky = g / 3, kx = g % 3;
  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[m][j][h] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % ST_STAGES;
    mbar_wait(full0 + 8 * s, (i / ST_STAGES) & 1);
    int b, y0, x0;
    tile_origin(t_begin + i, ST_H, ST_W, nty, ntx, b, y0, x0);
    const uint32_t gs = base + s * ST_STAGE;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(sbase + s * ST_STAGE + ST_G_BYTES);
    // the staged rows of taps g and 8; a row's first value sits at (start & 7)
    constexpr int XR = ST_XROW / 2;  // bf16 values a staged row
    const __nv_bfloat16* xa =
        xs + (warp + ky) * XR + (stem_x_start(b, y0, x0, warp + ky, H, W) & 7) + kx;
    const __nv_bfloat16* x8 =
        xs + (warp + 2) * XR + (stem_x_start(b, y0, x0, warp + 2, H, W) & 7) + 2;
#pragma unroll
    for (int st = 0; st < ST_W / 16; ++st) {
      const int k0 = st * 16 + 2 * q;  // B rows 2q, 2q + 1 and 2q + 8, 2q + 9
      uint32_t b0[2], b1[2];
      b0[0] = pack_bf16(xa + k0, xa + k0 + 1);
      b0[1] = pack_bf16(xa + k0 + 8, xa + k0 + 9);
      b1[0] = g == 0 ? pack_bf16(x8 + k0, x8 + k0 + 1) : 0u;
      b1[1] = g == 0 ? pack_bf16(x8 + k0 + 8, x8 + k0 + 9) : 0u;
      // A = g^T: matrix mi is channels 16m + 8 (mi & 1) .. + 7 of pixels
      // 8 (mi >> 1) .. + 7 of the step; pixel k's 16-byte chunk c sits at
      // c ^ (k & 7) (the 128-byte swizzle)
      const int k = warp * ST_W + st * 16 + mr + 8 * (mi >> 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = 2 * m + (mi & 1);
        uint32_t a[4];
        ldmatrix_x4_trans(a, gs + k * 128 + ((c ^ (k & 7)) << 4));
        mma_bf16_16816(acc[m][0], a, b0);
        mma_bf16_16816(acc[m][1], a, b1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // accumulator h of (m, j) is channel 16m + g (+8 for h >= 2), tap 8j +
  // 2q + (h & 1); the warps' sums meet in a fixed order
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int tap = 8 * j + 2 * q + (h & 1), co = 16 * m + g + 8 * (h >> 1);
        if (tap < 9) red[(warp * SLICE + co) * 9 + tap] = acc[m][j][h];
      }
  asm volatile("bar.sync 1, %0;\n" ::"n"(ST_WARPS * 32) : "memory");
  for (int o = tid; o < SLICE * 9; o += ST_WARPS * 32) {
    float v = red[o];
#pragma unroll
    for (int w = 1; w < ST_WARPS; ++w) v += red[w * SLICE * 9 + o];
    partial[((size_t)chunk * CO + co0) * 9 + o] = v;  // o = co * 9 + tap
  }
}

constexpr int RED_OUT = 32;  // outputs per reduce block

// dw[co][ci][tap] = the sum over chunks of partial[chunk][co][tap][ci] in
// an order fixed by nchunks alone: part q of PARTS (blockDim = 32 PARTS)
// of an output sums chunks q, q + PARTS, ... into four running sums (four
// loads in flight), then part 0 adds the parts in order. Neighbouring
// threads read neighbouring outputs, so the reads coalesce.
template <int PARTS>
__global__ void __launch_bounds__(RED_OUT * PARTS)
wgrad_reduce_kernel(const float* __restrict__ partial, int nchunks, int CO, int CI,
                    float* __restrict__ dw) {
  __shared__ float red[PARTS][RED_OUT];
  const int n = CO * 9 * CI;
  const int o = threadIdx.x % RED_OUT, part = threadIdx.x / RED_OUT;
  const int i = blockIdx.x * RED_OUT + o;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (i < n) {
    const float* p = partial + i;
    int c = part;
    for (; c + 3 * PARTS < nchunks; c += 4 * PARTS) {
      s0 += p[(size_t)c * n];
      s1 += p[(size_t)(c + PARTS) * n];
      s2 += p[(size_t)(c + 2 * PARTS) * n];
      s3 += p[(size_t)(c + 3 * PARTS) * n];
    }
    for (; c < nchunks; c += PARTS) s0 += p[(size_t)c * n];
  }
  red[part][o] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  if (part == 0 && i < n) {
    float v = red[0][o];
#pragma unroll
    for (int q = 1; q < PARTS; ++q) v += red[q][o];
    const int ci = i % CI, tap = (i / CI) % 9, co = i / (CI * 9);
    dw[((size_t)co * CI + ci) * 9 + tap] = v;
  }
}

// The two-pass sum of the chunks' partials into dw (CO, CI, 3, 3).
int launch_reduce(const float* partial, int nchunks, int CO, int CI, float* dw, cudaStream_t st) {
  const int n = CO * 9 * CI;
  // parts per output: eight where each gets four chunks or more (at 16
  // chunks, eight parts of two chunks were slower than four parts of four)
  const dim3 rgrid((n + RED_OUT - 1) / RED_OUT);
  if (nchunks >= 32)
    wgrad_reduce_kernel<8><<<rgrid, RED_OUT * 8, 0, st>>>(partial, nchunks, CO, CI, dw);
  else
    wgrad_reduce_kernel<4><<<rgrid, RED_OUT * 4, 0, st>>>(partial, nchunks, CO, CI, dw);
  return (int)cudaGetLastError();
}

int launch_stem(const void* x, int H, int W, const void* g, int B, int Ho, int Wo, int CO,
                int nchunks, float* partial, cudaStream_t st) {
  CUtensorMap gmap, xmap;
  int e = nhwc_map(&gmap, g, B, Ho, Wo, CO, ST_W, ST_H);
  const cuuint64_t xdim[1] = {(cuuint64_t)B * H * W}, xstride[1] = {0};
  const cuuint32_t xbox[1] = {(cuuint32_t)ST_XIN};
  if (e == 0) e = bf16_map(&xmap, x, 1, xdim, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(wgrad_stem_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nchunks, 1, CO / SLICE);
  wgrad_stem_tma_kernel<<<grid, ST_THREADS, ST_SMEM, st>>>(gmap, xmap, H, W, B, Ho, Wo, CO,
                                                          nchunks, partial);
  return (int)cudaGetLastError();
}

}  // namespace

// s0 (B,H0,W0,C0) read at (off_y0, off_x0) and, when C1 > 0, s1
// (B,H1,W1,C1) at (0, 0), both bf16; g (B,Ho,Wo,CO) bf16; partial: f32
// scratch of nchunks*CO*9*(C0+C1) -> dw (CO, C0+C1, 3, 3) f32. Needs
// CO % 64 == 0 and either C0 == 1, C1 == 0 (the stem kernel) or C0 and C1
// multiples of 32, 16-byte aligned contiguous tensors. Returns the first
// failing launch's CUDA error, or -(the CUresult) of a failed tensor-map
// encoding.
extern "C" int conv3x3_wgrad_bf16(const void* x0, int H0, int W0, int C0,
                                  int off_y0, int off_x0, const void* x1,
                                  int H1, int W1, int C1, const void* g, int B,
                                  int Ho, int Wo, int CO, int nchunks,
                                  void* partial, void* dw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int CI = C0 + C1;
  if (C0 == 1 && C1 == 0) {
    const int e = launch_stem(x0, H0, W0, g, B, Ho, Wo, CO, nchunks, (float*)partial, st);
    if (e != 0) return e;
  } else {
    CUtensorMap gmap, xmap0, xmap1;
    int e = nhwc_map(&gmap, g, B, Ho, Wo, CO, GT_W, GT_H);
    if (e == 0) e = nhwc_map(&xmap0, x0, B, H0, W0, C0, WIN_W, WIN_H);
    if (e == 0 && C1 > 0) e = nhwc_map(&xmap1, x1, B, H1, W1, C1, WIN_W, WIN_H);
    if (e != 0) return e;
    if (C1 == 0) xmap1 = xmap0;
    const int slices0 = (C0 + CSL - 1) / CSL, slices1 = (C1 + CSL - 1) / CSL;
    cudaError_t err = cudaFuncSetAttribute(
        wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(nchunks, slices0 + slices1, CO / CSL);
    wgrad_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(
        gmap, xmap0, xmap1, C0, C1, off_y0, off_x0, slices0, B, Ho, Wo, CO, nchunks,
        (float*)partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_reduce((const float*)partial, nchunks, CO, CI, (float*)dw, st);
}
