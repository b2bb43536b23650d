// bn_relu: train-mode BatchNorm+ReLU over an NHWC bf16 activation, forward
// and backward, each in three launches.
//
// Replaces no TPU kernel: the JAX package's make_bn_relu_nhwc
// (unetseg_tpu/ops/fused_bn.py) is a custom VJP in XLA, which fuses it. The
// port's plain version (ops/kernels/bn_relu.py `bn_relu_fwd_plain`,
// `bn_relu_bwd_plain`) issues some 30 operator calls a BatchNorm, each a pass
// over the activation or a C-sized vector; these kernels take its place on
// the card. The formulas are the plain version's, with its tie conventions:
// the ReLU's gradient is 1 above 0, 0.5 at 0 and 0 below, and so is the
// variance clamp's.
//
// The activation z is a matrix of N = B*H*W rows and C channels (64-1024 in
// the U-Net; N from 2,304 to 1,040,400 at batch 4 and 512^2).
//   forward   1 stats     per-chunk partials of s = sum z, sq = sum z*z (f32)
//             2 finalize  the chunks summed in a fixed order; mean, variance,
//                         unbiasing factor, new running statistics and the
//                         per-channel a = gamma / sqrt(var + eps), b = beta -
//                         mean * a, all in f32
//             3 apply     y = max(a * z + b, 0), once rounded to bf16
//   backward  1 stats     t = a * z + b rebuilt by the forward's arithmetic,
//                         gp = gy * tie(t); partials of G1 = sum gp * z and
//                         G2 = sum gp
//             2 finalize  dgamma, dbeta, the running statistics' cotangents,
//                         dvar, dmean and the coefficients of dz
//             3 dz        dz = gp * a + ds + 2 * dsq * z (the statistics term
//                         0 on masked items), once rounded to bf16
// With a process group one more launch sums a rank's partials in the
// finalize stage's order, the wrapper adds those sums up over the ranks, and
// stage 2 takes the group's sums as one chunk.
//
// Bound: memory. The forward reads z twice and writes y (3 passes), the
// backward reads gy and z twice and writes dz (5 passes): at the 18
// BatchNorms of a batch-4 step, 351 M elements, 8 x 0.70 GB = 5.6 GB, 1.68 ms
// at 3.35 TB/s. The design keeps every intermediate in registers and every
// elementwise product in f32:
// - a thread owns 8 channels and moves 16 bytes a row; the threads of a
//   block span up to 256 channels and the rest of the block's 256 threads
//   take further rows, so a warp reads 512 contiguous bytes;
// - blocks take row chunks x channel groups, some 4 blocks an SM over the
//   132 SMs, the same for every input of one (N, C): each thread walks its
//   chunk's rows 4 at a time, 4 loads in flight;
// - a stats block reduces its threads' sums in shared memory in a fixed
//   order and writes one row of f32 partials a chunk; the finalize stage
//   sums the chunks in a fixed order. No float atomics: the same inputs give
//   the same bits on every run.
// Masked items (item_mask 0) are skipped by the forward's statistics, never
// multiplied, so their contents never reach a sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // a block of the passes over the activation
constexpr int VEC = 8;            // channels a thread owns: 16 bytes of bf16
constexpr int UNROLL = 4;         // rows a thread loads before it computes
constexpr int FIN_THREADS = 1024; // finalize: 32 channels x 32 warps
// rows of the saved per-channel f32 buffer (ops/kernels/bn_relu.py SAVED)
enum Saved { A = 0, B, MEAN, INV, VAR_RAW, N, UNBIAS, SAVED_ROWS };
// rows of the dz coefficients: a, ds, 2 dsq
enum Coef { CA = 0, CS, CQ, COEF_ROWS };

// threads of a block across channels: the largest power of two up to 32
// whose 8-channel slices fit in C
int lanes_of(int c) {
  int tc = 1;
  while (tc < 32 && 2 * tc * VEC <= c) tc *= 2;
  return tc;
}

struct Geo {
  int tc, tr, tx, ty;  // lanes across channels, rows at a time, this thread's
  int ch;              // this thread's first channel
  long long lo, hi;    // this block's rows
};

__device__ __forceinline__ Geo geo(int tc, long long n_rows, long long per_chunk) {
  Geo g;
  g.tc = tc;
  g.tr = THREADS / tc;
  g.tx = threadIdx.x % tc;
  g.ty = threadIdx.x / tc;
  g.ch = (blockIdx.y * tc + g.tx) * VEC;
  g.lo = (long long)blockIdx.x * per_chunk;
  g.hi = g.lo + per_chunk < n_rows ? g.lo + per_chunk : n_rows;
  return g;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& u, float v[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float v[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// 8 channels of a per-channel f32 row
__device__ __forceinline__ void load_row(const float* __restrict__ p, int ch, float v[VEC]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p + ch));
  const float4 y = __ldg(reinterpret_cast<const float4*>(p + ch + 4));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
}

// The ReLU's gradient factor: 1 above 0, 0.5 at 0, 0 below.
__device__ __forceinline__ float tie(float t) { return t > 0.f ? 1.f : (t < 0.f ? 0.f : 0.5f); }

// Walk rows [lo, hi) of this thread (ty, ty + tr, ...), UNROLL rows a step:
// f(rows, count) loads and handles up to UNROLL rows.
template <typename F>
__device__ __forceinline__ void walk(long long lo, long long hi, int ty, int tr, F f) {
  long long r = lo + ty;
  for (; r + (UNROLL - 1) * (long long)tr < hi; r += UNROLL * (long long)tr) {
    long long rows[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) rows[u] = r + u * (long long)tr;
    f(rows, UNROLL);
  }
  for (; r < hi; r += tr) {
    long long rows[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) rows[u] = r;
    f(rows, 1);
  }
}

// Sum two per-thread 8-channel vectors over the block's rows (threads of one
// tx) in a fixed order and write them as this chunk's partials: part[0][k][ch]
// and part[1][k][ch] of a [2][chunks][c] f32 buffer.
__device__ __forceinline__ void block_partials(const Geo& g, int c, int chunks,
                                               const float s[VEC], const float q[VEC],
                                               float* __restrict__ part) {
  __shared__ float red[2][THREADS * VEC];
  const int width = g.tc * VEC;  // channels of this block
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[0][g.ty * width + g.tx * VEC + j] = s[j];
    red[1][g.ty * width + g.tx * VEC + j] = q[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * width; k += THREADS) {
    const int which = k / width, col = k % width;
    const int ch = blockIdx.y * width + col;
    float acc = 0.f;
    for (int r = 0; r < g.tr; ++r) acc += red[which][r * width + col];
    if (ch < c) part[((long long)which * chunks + blockIdx.x) * c + ch] = acc;
  }
}

// Stage 1 of the forward: partials of s and sq over each chunk's rows,
// skipping the rows of masked items (mask may be null: every item counts).
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const __nv_bfloat16* __restrict__ z, const uint8_t* __restrict__ mask,
                 long long n_rows, int c, long long hw, long long per_chunk, int tc,
                 int chunks, float* __restrict__ part) {
  const Geo g = geo(tc, n_rows, per_chunk);
  float s[VEC] = {}, q[VEC] = {};
  if (g.ch < c) {
    // the chunk's rows item by item, so that a masked item is skipped whole
    long long seg = g.lo;
    while (seg < g.hi) {
      const long long item = seg / hw;
      const long long end = (item + 1) * hw < g.hi ? (item + 1) * hw : g.hi;
      if (mask == nullptr || mask[item]) {
        walk(seg, end, g.ty, g.tr, [&](const long long* rows, int n) {
          uint4 u[UNROLL];
#pragma unroll
          for (int i = 0; i < UNROLL; ++i)
            if (i < n) u[i] = load16(z + rows[i] * c + g.ch);
#pragma unroll
          for (int i = 0; i < UNROLL; ++i) {
            if (i >= n) break;
            float v[VEC];
            unpack(u[i], v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              s[j] += v[j];
              q[j] = fmaf(v[j], v[j], q[j]);
            }
          }
        });
      }
      seg = end;
    }
  }
  block_partials(g, c, chunks, s, q, part);
}

// Stage 3 of the forward: y = max(a z + b, 0), rounded once.
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const __nv_bfloat16* __restrict__ z, long long n_rows, int c,
                 long long per_chunk, int tc, const float* __restrict__ saved,
                 __nv_bfloat16* __restrict__ y) {
  const Geo g = geo(tc, n_rows, per_chunk);
  if (g.ch >= c) return;
  float a[VEC], b[VEC];
  load_row(saved + A * c, g.ch, a);
  load_row(saved + B * c, g.ch, b);
  walk(g.lo, g.hi, g.ty, g.tr, [&](const long long* rows, int n) {
    uint4 u[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i)
      if (i < n) u[i] = load16(z + rows[i] * c + g.ch);
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      if (i >= n) break;
      float v[VEC];
      unpack(u[i], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = fmaf(a[j], v[j], b[j]);
        v[j] = t < 0.f ? 0.f : t;  // a NaN stays NaN, as in clamp_min
      }
      *reinterpret_cast<uint4*>(y + rows[i] * c + g.ch) = pack(v);
    }
  });
}

// Stage 1 of the backward: partials of G1 = sum gp z and G2 = sum gp over
// every row (masked items too: their y still depends on gamma and beta).
__global__ void __launch_bounds__(THREADS)
    bwd_stats_kernel(const __nv_bfloat16* __restrict__ gy, const __nv_bfloat16* __restrict__ z,
                     long long n_rows, int c, long long per_chunk, int tc, int chunks,
                     const float* __restrict__ saved, float* __restrict__ part) {
  const Geo g = geo(tc, n_rows, per_chunk);
  float s1[VEC] = {}, s2[VEC] = {};
  if (g.ch < c) {
    float a[VEC], b[VEC];
    load_row(saved + A * c, g.ch, a);
    load_row(saved + B * c, g.ch, b);
    walk(g.lo, g.hi, g.ty, g.tr, [&](const long long* rows, int n) {
      uint4 ug[UNROLL], uz[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i)
        if (i < n) {
          ug[i] = load16(gy + rows[i] * c + g.ch);
          uz[i] = load16(z + rows[i] * c + g.ch);
        }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        if (i >= n) break;
        float gv[VEC], zv[VEC];
        unpack(ug[i], gv);
        unpack(uz[i], zv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float gp = gv[j] * tie(fmaf(a[j], zv[j], b[j]));
          s1[j] = fmaf(gp, zv[j], s1[j]);
          s2[j] += gp;
        }
      }
    });
  }
  block_partials(g, c, chunks, s1, s2, part);
}

// Stage 3 of the backward: dz = gp a + m (ds + 2 dsq z), m = 0 on a masked
// item and 1 elsewhere, rounded once.
__global__ void __launch_bounds__(THREADS)
    dz_kernel(const __nv_bfloat16* __restrict__ gy, const __nv_bfloat16* __restrict__ z,
              const uint8_t* __restrict__ mask, long long n_rows, int c, long long hw,
              long long per_chunk, int tc, const float* __restrict__ saved,
              const float* __restrict__ coef, __nv_bfloat16* __restrict__ dz) {
  const Geo g = geo(tc, n_rows, per_chunk);
  if (g.ch >= c) return;
  float a[VEC], b[VEC], ca[VEC], cs[VEC], cq[VEC];
  load_row(saved + A * c, g.ch, a);
  load_row(saved + B * c, g.ch, b);
  load_row(coef + CA * c, g.ch, ca);
  load_row(coef + CS * c, g.ch, cs);
  load_row(coef + CQ * c, g.ch, cq);
  long long seg = g.lo;
  while (seg < g.hi) {
    const long long item = seg / hw;
    const long long end = (item + 1) * hw < g.hi ? (item + 1) * hw : g.hi;
    const bool stat = mask == nullptr || mask[item];
    walk(seg, end, g.ty, g.tr, [&](const long long* rows, int n) {
      uint4 ug[UNROLL], uz[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i)
        if (i < n) {
          ug[i] = load16(gy + rows[i] * c + g.ch);
          uz[i] = load16(z + rows[i] * c + g.ch);
        }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        if (i >= n) break;
        float gv[VEC], zv[VEC];
        unpack(ug[i], gv);
        unpack(uz[i], zv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float gp = gv[j] * tie(fmaf(a[j], zv[j], b[j]));
          const float st = stat ? fmaf(cq[j], zv[j], cs[j]) : 0.f;
          gv[j] = fmaf(gp, ca[j], st);
        }
        *reinterpret_cast<uint4*>(dz + rows[i] * c + g.ch) = pack(gv);
      }
    });
    seg = end;
  }
}

// The chunks' partials of two sums for channel ch, in a fixed order: warp w
// takes chunks w, w + 32, ...; warp 0 then adds the 32 warps' sums in order.
// Returns true in the thread (warp 0) that holds the channel's sums.
__device__ __forceinline__ bool chunk_sums(const float* __restrict__ part, int chunks, int c,
                                           float& s, float& q) {
  __shared__ float ws[2][32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + lane;
  s = 0.f;
  q = 0.f;
  if (ch < c)
    for (int k = warp; k < chunks; k += 32) {
      s += part[(long long)k * c + ch];
      q += part[((long long)chunks + k) * c + ch];
    }
  ws[0][warp][lane] = s;
  ws[1][warp][lane] = q;
  __syncthreads();
  if (warp != 0 || ch >= c) return false;
  s = 0.f;
  q = 0.f;
  for (int w = 0; w < 32; ++w) {
    s += ws[0][w][lane];
    q += ws[1][w][lane];
  }
  return true;
}

// The chunks' sums alone ([2][c]: s and sq, or G1 and G2), for a process
// group to add up over its ranks before stage 2: the same order as stage 2's,
// so that a rank's sums are bit for bit those stage 2 would take.
__global__ void __launch_bounds__(FIN_THREADS)
    sums_kernel(const float* __restrict__ part, int chunks, int c, float* __restrict__ out) {
  float s, q;
  if (!chunk_sums(part, chunks, c, s, q)) return;
  const int ch = blockIdx.x * 32 + (threadIdx.x & 31);
  out[ch] = s;
  out[c + ch] = q;
}

// Stage 2 of the forward, in the plain version's order of operations (each
// product, sum and quotient rounded on its own, as PyTorch's operators do).
__global__ void __launch_bounds__(FIN_THREADS)
    fwd_finalize_kernel(const float* __restrict__ part, int chunks, int c,
                        const float* __restrict__ n_dev, const uint8_t* __restrict__ mask,
                        int items, long long hw, float n_host, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ run_mean,
                        const float* __restrict__ run_var, float mom, float one_minus_mom,
                        float eps, float* __restrict__ new_mean, float* __restrict__ new_var,
                        float* __restrict__ saved) {
  float s, sq;
  if (!chunk_sums(part, chunks, c, s, sq)) return;
  const int ch = blockIdx.x * 32 + (threadIdx.x & 31);
  float n = n_host;
  if (n_dev != nullptr) {
    n = n_dev[0];
  } else if (mask != nullptr) {
    float count = 0.f;
    for (int i = 0; i < items; ++i) count += mask[i] ? 1.f : 0.f;
    n = __fmul_rn(count, (float)hw);
  }
  n = fmaxf(n, 1.f);
  const float mean = __fdiv_rn(s, n);
  const float var_raw = __fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean));
  const float var = fmaxf(var_raw, 0.f);
  const float unbias = __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.f), 1.f));
  new_mean[ch] = __fadd_rn(__fmul_rn(mom, run_mean[ch]), __fmul_rn(one_minus_mom, mean));
  new_var[ch] = __fadd_rn(__fmul_rn(mom, run_var[ch]),
                          __fmul_rn(__fmul_rn(one_minus_mom, var), unbias));
  const float inv = rsqrtf(__fadd_rn(var, eps));
  const float a = __fmul_rn(gamma[ch], inv);
  saved[A * c + ch] = a;
  saved[B * c + ch] = __fsub_rn(beta[ch], __fmul_rn(mean, a));
  saved[MEAN * c + ch] = mean;
  saved[INV * c + ch] = inv;
  saved[VAR_RAW * c + ch] = var_raw;
  saved[N * c + ch] = n;
  saved[UNBIAS * c + ch] = unbias;
}

// Stage 2 of the backward. part holds this rank's G1 and G2; glob, where
// not null, the group's sums of G1, G2, ct_mean and ct_var ([4][c]), which
// the variance's and the mean's cotangents take in their place. ct_mean and
// ct_var may be null (no cotangent: zero), and then so are d_run_*.
__global__ void __launch_bounds__(FIN_THREADS)
    bwd_finalize_kernel(const float* __restrict__ part, int chunks, int c,
                        const float* __restrict__ glob, const float* __restrict__ ct_mean,
                        const float* __restrict__ ct_var, const float* __restrict__ saved,
                        const float* __restrict__ gamma, float mom, float one_minus_mom,
                        float* __restrict__ dgamma, float* __restrict__ dbeta,
                        float* __restrict__ d_run_mean, float* __restrict__ d_run_var,
                        float* __restrict__ coef) {
  float g1, g2;
  if (!chunk_sums(part, chunks, c, g1, g2)) return;
  const int ch = blockIdx.x * 32 + (threadIdx.x & 31);
  const float mean = saved[MEAN * c + ch], inv = saved[INV * c + ch];
  const float a = saved[A * c + ch], n = saved[N * c + ch];
  float ctm = ct_mean != nullptr ? ct_mean[ch] : 0.f;
  float ctv = ct_var != nullptr ? ct_var[ch] : 0.f;
  float da = __fsub_rn(g1, __fmul_rn(mean, g2));
  dgamma[ch] = __fmul_rn(da, inv);
  dbeta[ch] = g2;
  if (d_run_mean != nullptr) d_run_mean[ch] = __fmul_rn(mom, ctm);
  if (d_run_var != nullptr) d_run_var[ch] = __fmul_rn(mom, ctv);
  if (glob != nullptr) {
    g1 = glob[ch];
    g2 = glob[c + ch];
    ctm = glob[2 * c + ch];
    ctv = glob[3 * c + ch];
    da = __fsub_rn(g1, __fmul_rn(mean, g2));
  }
  const float inv3 = __fmul_rn(__fmul_rn(inv, inv), inv);
  float dvar = __fmul_rn(__fmul_rn(-0.5f, inv3), __fmul_rn(gamma[ch], da));
  dvar = __fmul_rn(
      __fadd_rn(dvar, __fmul_rn(__fmul_rn(one_minus_mom, saved[UNBIAS * c + ch]), ctv)),
      tie(saved[VAR_RAW * c + ch]));
  const float dmean = __fsub_rn(__fadd_rn(__fmul_rn(-a, g2), __fmul_rn(one_minus_mom, ctm)),
                                __fmul_rn(__fmul_rn(2.f, mean), dvar));
  coef[CA * c + ch] = a;
  coef[CS * c + ch] = __fdiv_rn(dmean, n);
  coef[CQ * c + ch] = __fmul_rn(2.f, __fdiv_rn(dvar, n));
}

struct Launch {
  dim3 grid;
  int tc;
  long long per_chunk;
};

// The passes' grid for n_rows x c split into `chunks` row chunks, or a grid
// of 0 blocks if the arguments do not fit the kernels.
Launch plan(long long n_rows, int c, int chunks) {
  Launch l{dim3(0), 0, 0};
  if (n_rows < 1 || c < VEC || c % VEC || chunks < 1) return l;
  l.tc = lanes_of(c);
  const int width = l.tc * VEC, tr = THREADS / l.tc;
  const long long per = (n_rows + chunks - 1) / chunks;
  l.per_chunk = (per + tr - 1) / tr * tr;
  l.grid = dim3(chunks, (c + width - 1) / width);
  return l;
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Forward stage 1. z: (n_rows, c) bf16, contiguous, 16-byte aligned, c a
// multiple of 8; mask: (n_rows / hw) uint8 or null; part: [2][chunks][c] f32
// (ops/kernels/bn_relu.py `plan` gives chunks). Returns the launch's error.
extern "C" int bn_relu_stats_bf16(const void* z, const void* mask, long long n_rows, int c,
                                  long long hw, int chunks, void* part, void* stream) {
  const Launch l = plan(n_rows, c, chunks);
  if (l.grid.x == 0 || hw < 1 || !aligned(z)) return (int)cudaErrorInvalidValue;
  stats_kernel<<<l.grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)z, (const uint8_t*)mask, n_rows, c, hw, l.per_chunk, l.tc, chunks,
      (float*)part);
  return (int)cudaGetLastError();
}

// Forward stage 2. part: [2][chunks][c] f32 (s, sq); n from n_dev (one f32
// on the card) if not null, else counted from mask (items uint8, each item
// hw rows) if not null, else n_host. gamma, beta, run_mean, run_var: c f32.
// Writes new_mean, new_var (c f32) and saved ([7][c] f32: a, b, mean,
// 1 / sqrt(var + eps), the unclamped variance, n, the unbiasing factor).
extern "C" int bn_relu_fwd_finalize_f32(const void* part, int chunks, int c, const void* n_dev,
                                        const void* mask, int items, long long hw, float n_host,
                                        const void* gamma, const void* beta,
                                        const void* run_mean, const void* run_var, float mom,
                                        float one_minus_mom, float eps, void* new_mean,
                                        void* new_var, void* saved, void* stream) {
  if (chunks < 1 || c < 1) return (int)cudaErrorInvalidValue;
  fwd_finalize_kernel<<<(c + 31) / 32, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, chunks, c, (const float*)n_dev, (const uint8_t*)mask, items, hw,
      n_host, (const float*)gamma, (const float*)beta, (const float*)run_mean,
      (const float*)run_var, mom, one_minus_mom, eps, (float*)new_mean, (float*)new_var,
      (float*)saved);
  return (int)cudaGetLastError();
}

// The sums of part ([2][chunks][c] f32) over its chunks -> out ([2][c] f32),
// in stage 2's order; with a process group, between stages 1 and 2.
extern "C" int bn_relu_sums_f32(const void* part, int chunks, int c, void* out, void* stream) {
  if (chunks < 1 || c < 1) return (int)cudaErrorInvalidValue;
  sums_kernel<<<(c + 31) / 32, FIN_THREADS, 0, (cudaStream_t)stream>>>((const float*)part,
                                                                      chunks, c, (float*)out);
  return (int)cudaGetLastError();
}

// Forward stage 3: y (n_rows, c) bf16 from z and saved's a and b.
extern "C" int bn_relu_apply_bf16(const void* z, long long n_rows, int c, int chunks,
                                  const void* saved, void* y, void* stream) {
  const Launch l = plan(n_rows, c, chunks);
  if (l.grid.x == 0 || !aligned(z) || !aligned(y)) return (int)cudaErrorInvalidValue;
  apply_kernel<<<l.grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)z, n_rows, c, l.per_chunk, l.tc, (const float*)saved,
      (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}

// Backward stage 1: part [2][chunks][c] f32 (G1, G2) from gy and z
// ((n_rows, c) bf16) and saved's a and b.
extern "C" int bn_relu_bwd_stats_bf16(const void* gy, const void* z, long long n_rows, int c,
                                      int chunks, const void* saved, void* part, void* stream) {
  const Launch l = plan(n_rows, c, chunks);
  if (l.grid.x == 0 || !aligned(gy) || !aligned(z)) return (int)cudaErrorInvalidValue;
  bwd_stats_kernel<<<l.grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gy, (const __nv_bfloat16*)z, n_rows, c, l.per_chunk, l.tc, chunks,
      (const float*)saved, (float*)part);
  return (int)cudaGetLastError();
}

// Backward stage 2. part: [2][chunks][c] f32 (this rank's G1, G2); glob:
// [4][c] f32 (the group's G1, G2, ct_mean, ct_var) or null; ct_mean, ct_var:
// c f32 or null (then d_run_mean and d_run_var may be null). Writes dgamma,
// dbeta, d_run_mean, d_run_var (c f32) and coef ([3][c] f32: a, ds, 2 dsq).
extern "C" int bn_relu_bwd_finalize_f32(const void* part, int chunks, int c, const void* glob,
                                        const void* ct_mean, const void* ct_var,
                                        const void* saved, const void* gamma, float mom,
                                        float one_minus_mom, void* dgamma, void* dbeta,
                                        void* d_run_mean, void* d_run_var, void* coef,
                                        void* stream) {
  if (chunks < 1 || c < 1) return (int)cudaErrorInvalidValue;
  bwd_finalize_kernel<<<(c + 31) / 32, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, chunks, c, (const float*)glob, (const float*)ct_mean,
      (const float*)ct_var, (const float*)saved, (const float*)gamma, mom, one_minus_mom,
      (float*)dgamma, (float*)dbeta, (float*)d_run_mean, (float*)d_run_var, (float*)coef);
  return (int)cudaGetLastError();
}

// Backward stage 3: dz (n_rows, c) bf16 from gy, z, saved's a and b and
// coef; mask ((n_rows / hw) uint8 or null) zeroes the statistics term of a
// masked item's rows.
extern "C" int bn_relu_dz_bf16(const void* gy, const void* z, const void* mask,
                               long long n_rows, int c, long long hw, int chunks,
                               const void* saved, const void* coef, void* dz, void* stream) {
  const Launch l = plan(n_rows, c, chunks);
  if (l.grid.x == 0 || hw < 1 || !aligned(gy) || !aligned(z) || !aligned(dz))
    return (int)cudaErrorInvalidValue;
  dz_kernel<<<l.grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gy, (const __nv_bfloat16*)z, (const uint8_t*)mask, n_rows, c, hw,
      l.per_chunk, l.tc, (const float*)saved, (const float*)coef, (__nv_bfloat16*)dz);
  return (int)cudaGetLastError();
}
