// Hopper building blocks shared by the TMA/wgmma kernels
// (conv3x3_wgrad.cu, conv_fwd_wgmma.cu, tconv2x2_bias.cu and the stem of
// conv3x3_bias_relu.cu): mbarriers, TMA tensor copies into and out of
// shared memory, the tensor-map encoders, wgmma shared-memory descriptors,
// the m64n64k16 / m64n128k16 products and the register fence around
// asynchronous wgmma groups.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int SMEM_PER_BLOCK = 232448;  // the most dynamic shared memory a block can use
constexpr int SLICE = 64;               // channels per TMA box: one 128-byte row a pixel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A tile copy's first element along the innermost dimension must sit on
// a 16-byte boundary (an H100 raises an illegal instruction otherwise).
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store of a 4-D box from shared memory (128-byte aligned) into the
// map's tensor at (c0, c1, c2, c3); the parts of the box outside the
// tensor are not written. Joins the thread's open bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Closes the thread's open bulk group (the TMA stores issued since the last).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// tma_store_4d and bulk_commit where p holds, as predicated instructions:
// no branch, so no divergent path between a wgmma and its wait.
__device__ __forceinline__ void tma_store_4d_if(bool p, const CUtensorMap* map, uint32_t src,
                                                int c0, int c1, int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"((int)p)
      : "memory");
}

__device__ __forceinline__ void bulk_commit_if(bool p) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.commit_group;\n}\n" ::"r"(
                   (int)p)
               : "memory");
}

// Waits until at most N of the thread's bulk groups have not finished
// reading their shared memory (their sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of the thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads
// of the same memory by the TMA unit (the async proxy).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// im2col copy of a 4-D NHWC map: the map's pixelsPerColumn pixels from
// (w, h, n) on through its bounding box, each shifted by (off_w, off_h).
__device__ __forceinline__ void tma_load_im2col_4d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c, int w, int h, int n,
                                                   uint16_t off_w, uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(off_w), "h"(off_h)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: between 64-element blocks along N or M; ignored
// K-major), stride byte offset (between groups of 8 rows), all in 16-byte
// units. The base offset stays 0: the swizzle pattern starts on a 1 KB
// boundary (the TMA destination), and the start address may lie on any
// 128-byte row after it (on an H100 wgmma swizzles on the address bits as
// TMA wrote them).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), both K-major in shared
// memory (imm-trans-a = imm-trans-b = 0).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), both K-major in shared
// memory (imm-trans-a = imm-trans-b = 0).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) wgmma_n128(d, da, db);
  else wgmma_n64(d, da, db);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cuTensorMapEncodeTiled, resolved through the runtime so that the library
// links against no driver library.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeIm2col)p;
  }
  return fn;
}

// An im2col map of a bf16 NHWC tensor (B, H, W, C) for a valid 3x3 conv
// with (Ho, Wo) outputs, output pixel (y, x) reading the tensor at (y +
// off_y + ky, x + off_x + kx): a copy brings `pixels` consecutive output
// pixels (across rows and images) x 64 channels, the copy's coordinates
// the first pixel's (x + off_x, y + off_y) and its offsets the tap's (kx,
// ky); 128-byte swizzle, zeros outside the tensor. The bounding box spans
// [off, off + Wo) x [off, off + Ho): corners (off_x, off_y) and (off_x +
// Wo - W, off_y + Ho - H), which a 4-D map takes in [-128, 127] (the
// forward: (0, 0) and (-2, -2); the input gradient: (-2, -2) and (0, 0)).
// Returns 0 or -(the CUresult).
inline int nhwc_im2col_map(CUtensorMap* map, const void* p, int B, int H, int W, int C,
                           int pixels, int off_y, int off_x, int Ho, int Wo) {
  EncodeIm2col enc = encode_im2col();
  if (enc == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const int lower[2] = {off_x, off_y}, upper[2] = {off_x + Wo - W, off_y + Ho - H};  // (w, h)
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                         strides, lower, upper, SLICE, (cuuint32_t)pixels, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// A bf16 tensor map of `rank` dims (innermost first, byte strides of dims
// 1.. in `strides`), 128-byte swizzle unless `swizzle` says otherwise,
// zeros outside. Returns 0 or -(the CUresult).
inline int bf16_map(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// A 4-D map of a bf16 NHWC tensor (B, H, W, C) with boxes of 64 channels x
// box_w x box_h pixels of one image, 128-byte swizzle unless `swizzle`
// says otherwise. Returns 0 or -(the CUresult).
inline int nhwc_map(CUtensorMap* map, const void* p, int B, int H, int W, int C, int box_w,
                    int box_h, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SLICE, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  return bf16_map(map, p, 4, dims, strides, box, swizzle);
}

}  // namespace hopper
