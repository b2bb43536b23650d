// minplus: batched (min, +) matrix product, the exact EDT's two phases.
//
//   out[z, i, j] = min(1e12, min_k a[z, i, k] + b[z, k, j])
//
// Replaces the TPU kernel unetseg_tpu/ops/pallas/minplus.py:minplus (and
// with it the XLA product ops/edt.py:_min_plus that weight_map_device runs
// twice per instance). The accumulator starts at 1e12, as _minplus_kernel's
// does. Each operand has its own batch stride; 0 shares it across the batch,
// so one launch covers every instance of a frame in each EDT phase (phase 1:
// the (H, H) row distances shared, the column costs per instance; phase 2:
// G per instance, the (W, W) column distances shared).
//
// Exactness: every candidate is one f32 add (__fadd_rn, never contracted)
// and min is exact, so the result does not depend on the order of k and is
// bit-identical to the plain version and to the JAX package's products.
//
// Bound: one add and one min per candidate, B*M*N*K of them (2 * 32 * 512^3
// ~ 8.6e9 per 512^2 frame of 32 instances), on the FP32 pipes; the operands
// are a few MB. The schedule is SGEMM's register blocking under the other
// semiring: a block of 256 threads owns a 128x128 output tile and streams K
// through shared memory in chunks of 8; each thread keeps an 8x8 accumulator
// (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3, 64..67}, so the float4
// reads of a quarter warp hit distinct banks). Ragged edges are masked in
// the kernel: a load outside the operand reads 1e12 (its candidates are
// >= 1e12 and never beat the accumulator's start), a store outside the
// output is skipped; nothing is padded in memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
constexpr float BIG = 1e12f;

__global__ void __launch_bounds__(THREADS)
    minplus_kernel(const float* __restrict__ a, long long a_bs,
                   const float* __restrict__ b, long long b_bs,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A transposed: As[k][i]
  __shared__ __align__(16) float Bs[BK][BN];
  const int z = blockIdx.z;
  a += z * a_bs;
  b += z * b_bs;
  out += (size_t)z * M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = BIG;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK, kk = e % BK;  // 8 threads read 8 k of one row
      const int gm = m0 + row, gk = k0 + kk;
      As[kk][row] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : BIG;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / BN, col = e % BN;  // consecutive threads, consecutive columns
      const int gk = k0 + kk, gn = n0 + col;
      Bs[kk][col] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : BIG;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fminf(acc[i][j], __fadd_rn(ra[i], rb[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// a (batch, M, K) with batch stride a_bs elements (0: one shared (M, K)),
// b (batch, K, N) with stride b_bs, both f32 row-major -> out (batch, M, N)
// f32, contiguous. Returns the launch's CUDA error.
extern "C" int minplus_f32(const void* a, long long a_bs, const void* b,
                           long long b_bs, void* out, int batch, int M, int K,
                           int N, void* stream) {
  if (batch == 0 || M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  minplus_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, a_bs, (const float*)b, b_bs, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}
