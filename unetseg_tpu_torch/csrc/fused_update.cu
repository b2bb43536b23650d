// fused_update: the train step's optimizer update and gradient norm in one
// pass over every parameter element, and the EMA of the parameters and the
// BatchNorm statistics in one pass over each shadow.
//
// Replaces no TPU kernel: the JAX package's update is optax under jit
// (unetseg_tpu/train/state.py), which XLA fuses into a few loops. The port's
// plain update (ops/kernels/update.py `update_plain`, `ema_plain`,
// `global_norm_plain`) issues some 300 operator calls a step over the 82
// leaves of the default net; this kernel takes their place on the card.
//
// Parameters, moments and shadows live in flat f32 buffers whose leaves
// start at multiples of 128 elements (ops/kernels/update.py FlatLayout).
// Gradients, and the new values an EMA follows, stay separate tensors: the
// wrapper hands their pointers over in a table passed by value (`Leaves`,
// under 4 KB of kernel parameters), so nothing gathers them first. Each
// block takes CHUNK elements of one leaf, found by a binary search of the
// table's block starts; a leaf whose pointer and offset allow it moves as
// float4, the rest one float at a time.
//
// Arithmetic: optax's, in optax's order, exactly as the plain `_foreach`
// path computes it (each product, sum, quotient and root rounded on its
// own: __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so that no FMA
// contraction moves a bit):
//   sgd    trace' = g + trace * momentum;  p' = p + trace' * step
//   adam   mu' = g * (1 - b1) + mu * b1;  nu' = (g * g) * (1 - b2) + nu * b2
//          u = (mu' * ic1) / (sqrt(nu' * ic2) + eps)
//          [adamw: u = u + p * weight_decay];  p' = p + u * step
//   ema    e' = e + (new - e) * (1 - d)
// with step = -lr(count) and ic1 = 1 / (1 - b1^(count+1)) in f32, ic2
// likewise (PyTorch's `_foreach_div` by a scalar multiplies by the f32
// reciprocal on the card), all computed on the host. The same pass sums
// g * g (each square rounded to f32, as the plain norm squares in f32) in
// f64 per thread, then per block; one more block sums the block partials in
// a fixed order and writes the global norm as a device scalar. No result
// goes back to the host.
//
// Bound: memory. At the default net's 31,042,434 parameters the Adam pass
// reads p, g, mu, nu and writes p, mu, nu (7 x 124 MB = 869 MB) and the EMA
// pass reads the shadow and the new p and writes the shadow (373 MB):
// 1.24 GB, 0.37 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 128;  // a launch's table: 3.6 KB of parameters
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 4 * 4;  // elements a block: 4 float4 a thread
constexpr int FINISH_THREADS = 1024;
enum Kind { SGD = 0, ADAM = 1, ADAMW = 2 };

struct Leaves {
  const float* src[MAX_LEAVES];  // the gradient (or the EMA's new value)
  long long off[MAX_LEAVES];     // element offset into the flat buffers
  long long n[MAX_LEAVES];       // elements
  int block0[MAX_LEAVES + 1];    // first block of each leaf in this launch
  int count;
};

struct Scalars {
  float step, momentum, omb1, b1, omb2, b2, ic1, ic2, eps, wd;
};

__device__ __forceinline__ int leaf_of(const Leaves& L, int b) {
  // the last leaf whose first block is at or before b
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.block0[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <int KIND>
__device__ __forceinline__ float step_one(float& p, float g, float& m1,
                                          float& m2, const Scalars& s) {
  const float gg = __fmul_rn(g, g);
  if (KIND == SGD) {
    m1 = __fadd_rn(g, __fmul_rn(m1, s.momentum));
    p = __fadd_rn(p, __fmul_rn(m1, s.step));
  } else {
    m1 = __fadd_rn(__fmul_rn(g, s.omb1), __fmul_rn(m1, s.b1));
    m2 = __fadd_rn(__fmul_rn(gg, s.omb2), __fmul_rn(m2, s.b2));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(m2, s.ic2)), s.eps);
    float u = __fdiv_rn(__fmul_rn(m1, s.ic1), den);
    if (KIND == ADAMW) u = __fadd_rn(u, __fmul_rn(p, s.wd));
    p = __fadd_rn(p, __fmul_rn(u, s.step));
  }
  return gg;
}

template <int N>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[N / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < N / 32) v = part[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // in thread 0
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    update_kernel(const __grid_constant__ Leaves L, const Scalars s,
                  const float* __restrict__ p, const float* __restrict__ m1,
                  const float* __restrict__ m2, float* __restrict__ p_out,
                  float* __restrict__ m1_out, float* __restrict__ m2_out,
                  double* __restrict__ partials) {
  const int leaf = leaf_of(L, blockIdx.x);
  const long long n = L.n[leaf], off = L.off[leaf];
  const long long start = (long long)(blockIdx.x - L.block0[leaf]) * CHUNK;
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  const float* __restrict__ g = L.src[leaf];
  double acc = 0.0;
  long long tail = start;
  if ((off & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    tail = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < tail; i += 4 * THREADS) {
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      float4 pv = *reinterpret_cast<const float4*>(p + off + i);
      float4 av = *reinterpret_cast<const float4*>(m1 + off + i);
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (KIND != SGD) bv = *reinterpret_cast<const float4*>(m2 + off + i);
      acc += step_one<KIND>(pv.x, gv.x, av.x, bv.x, s);
      acc += step_one<KIND>(pv.y, gv.y, av.y, bv.y, s);
      acc += step_one<KIND>(pv.z, gv.z, av.z, bv.z, s);
      acc += step_one<KIND>(pv.w, gv.w, av.w, bv.w, s);
      *reinterpret_cast<float4*>(p_out + off + i) = pv;
      *reinterpret_cast<float4*>(m1_out + off + i) = av;
      if (KIND != SGD) *reinterpret_cast<float4*>(m2_out + off + i) = bv;
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += THREADS) {
    float pv = p[off + i], av = m1[off + i], bv = 0.f;
    if (KIND != SGD) bv = m2[off + i];
    acc += step_one<KIND>(pv, g[i], av, bv, s);
    p_out[off + i] = pv;
    m1_out[off + i] = av;
    if (KIND != SGD) m2_out[off + i] = bv;
  }
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(FINISH_THREADS)
    norm_kernel(const double* __restrict__ partials, int n,
                float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) acc += partials[i];
  acc = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) out[0] = (float)sqrt(acc);
}

__device__ __forceinline__ float ema_one(float e, float v, float omd) {
  return __fadd_rn(e, __fmul_rn(__fsub_rn(v, e), omd));
}

__global__ void __launch_bounds__(THREADS)
    ema_kernel(const __grid_constant__ Leaves L, float omd,
               const float* __restrict__ e, float* __restrict__ e_out) {
  const int leaf = leaf_of(L, blockIdx.x);
  const long long n = L.n[leaf], off = L.off[leaf];
  const long long start = (long long)(blockIdx.x - L.block0[leaf]) * CHUNK;
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  const float* __restrict__ v = L.src[leaf];
  long long tail = start;
  if ((off & 3) == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0) {
    tail = start + ((end - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < tail; i += 4 * THREADS) {
      const float4 vv = *reinterpret_cast<const float4*>(v + i);
      const float4 ev = *reinterpret_cast<const float4*>(e + off + i);
      *reinterpret_cast<float4*>(e_out + off + i) =
          make_float4(ema_one(ev.x, vv.x, omd), ema_one(ev.y, vv.y, omd),
                      ema_one(ev.z, vv.z, omd), ema_one(ev.w, vv.w, omd));
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += THREADS)
    e_out[off + i] = ema_one(e[off + i], v[i], omd);
}

long long blocks_of(long long n) { return (n + CHUNK - 1) / CHUNK; }

// Cut the leaves into launches of at most MAX_LEAVES (empty leaves
// skipped) and call launch(table, grid, first block) for each. Returns the
// blocks launched in all, or -1 if the work does not fit an int grid.
template <typename F>
long long for_each_launch(int n_leaves, const long long* src,
                          const long long* off, const long long* numel,
                          F launch) {
  Leaves L;
  L.count = 0;
  long long first = 0, blocks = 0;
  for (int i = 0; i <= n_leaves; ++i) {
    const bool flush = i == n_leaves || (L.count == MAX_LEAVES && numel[i] > 0);
    if (flush && L.count > 0) {
      L.block0[L.count] = (int)blocks;
      if (!launch(L, (int)blocks, first)) return -1;
      first += blocks;
      blocks = 0;
      L.count = 0;
    }
    if (i == n_leaves || numel[i] <= 0) continue;
    if (blocks + blocks_of(numel[i]) > 0x7fffffffLL) return -1;
    L.src[L.count] = reinterpret_cast<const float*>(src[i]);
    L.off[L.count] = off[i];
    L.n[L.count] = numel[i];
    L.block0[L.count] = (int)blocks;
    blocks += blocks_of(numel[i]);
    ++L.count;
  }
  return first;
}

}  // namespace

// The optimizer step over n_leaves leaves. src / off / numel are host
// arrays: each leaf's gradient pointer (contiguous f32), its element offset
// into the flat buffers and its element count. p, m1 (trace or mu) and m2
// (nu; null for sgd) are the flat inputs, p_out, m1_out and m2_out the new
// flat buffers. scalars (host, 10 floats): step, momentum, 1 - b1, b1,
// 1 - b2, b2, 1 / c1, 1 / c2, eps, weight decay. kind: 0 sgd, 1 adam,
// 2 adamw. partials: n_blocks f64 of scratch (the leaves' ceil(numel /
// 4096) summed); norm_out: one f32, the gradient's global norm. Returns the
// launches' CUDA error, or cudaErrorInvalidValue if n_blocks or kind does
// not match.
extern "C" int fused_update_f32(int kind, int n_leaves, const long long* src,
                                const long long* off, const long long* numel,
                                const void* p, const void* m1, const void* m2,
                                void* p_out, void* m1_out, void* m2_out,
                                const float* scalars, void* partials,
                                int n_blocks, void* norm_out, void* stream) {
  if (kind < SGD || kind > ADAMW) return (int)cudaErrorInvalidValue;
  long long total = 0;
  for (int i = 0; i < n_leaves; ++i)
    if (numel[i] > 0) total += blocks_of(numel[i]);
  if (total != n_blocks) return (int)cudaErrorInvalidValue;
  const Scalars s = {scalars[0], scalars[1], scalars[2], scalars[3],
                     scalars[4], scalars[5], scalars[6], scalars[7],
                     scalars[8], scalars[9]};
  cudaStream_t st = (cudaStream_t)stream;
  const float* pi = (const float*)p;
  const float* ai = (const float*)m1;
  const float* bi = (const float*)m2;
  float* po = (float*)p_out;
  float* ao = (float*)m1_out;
  float* bo = (float*)m2_out;
  double* part = (double*)partials;
  cudaError_t err = cudaSuccess;
  const long long done = for_each_launch(
      n_leaves, src, off, numel,
      [&](const Leaves& L, int grid, long long first) {
        double* pt = part + first;
        if (kind == SGD)
          update_kernel<SGD><<<grid, THREADS, 0, st>>>(L, s, pi, ai, bi, po,
                                                       ao, bo, pt);
        else if (kind == ADAM)
          update_kernel<ADAM><<<grid, THREADS, 0, st>>>(L, s, pi, ai, bi, po,
                                                        ao, bo, pt);
        else
          update_kernel<ADAMW><<<grid, THREADS, 0, st>>>(L, s, pi, ai, bi, po,
                                                         ao, bo, pt);
        err = cudaGetLastError();
        return err == cudaSuccess;
      });
  if (done < 0) return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  norm_kernel<<<1, FINISH_THREADS, 0, st>>>(part, n_blocks, (float*)norm_out);
  return (int)cudaGetLastError();
}

// The EMA step of one shadow: e_out = e + (new - e) * omd over n_leaves
// leaves; src / off / numel as above, src pointing at each leaf's new value
// (contiguous f32), e and e_out flat buffers. Returns the launches' CUDA
// error.
extern "C" int fused_ema_f32(int n_leaves, const long long* src,
                             const long long* off, const long long* numel,
                             const void* e, void* e_out, float omd,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* ei = (const float*)e;
  float* eo = (float*)e_out;
  cudaError_t err = cudaSuccess;
  const long long done = for_each_launch(
      n_leaves, src, off, numel, [&](const Leaves& L, int grid, long long) {
        ema_kernel<<<grid, THREADS, 0, st>>>(L, omd, ei, eo);
        err = cudaGetLastError();
        return err == cudaSuccess;
      });
  if (done < 0) return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  return (int)cudaSuccess;
}
