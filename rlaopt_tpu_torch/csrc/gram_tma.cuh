// Shared pieces of the warp-specialised kernels for Hopper (sm_90a): K2b's
// gram_tier_symmetric (gram_tier_sym.cu), K1b's row kernel gram_tier_rows
// (gram_tier_rows.cu) and K1's wide kernel gram_wide_ws (gram_wide_ws.cu).
// The mbarriers of a TMA ring, the TMA copies, the wgmma operand descriptor
// and the asynchronous products from shared memory, and the tensor-map
// encoder (cuTensorMapEncodeTiled) reached through the runtime (no link to
// libcuda).
//
// Each includes this header, which includes gram_tier.cuh; everything here
// has internal linkage.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (no driver call is linked)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

#include "gram_tier.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// This thread's arrival, and bytes more to land before the phase completes.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box of the tensor map at (x, y) (1-D: x) into shared memory,
// its bytes counted on bar.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map, int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// True in one lane of the (converged) warp.
__device__ __forceinline__ bool elect_one() {
  uint32_t one;
  asm volatile("{\n.reg .pred p;\nelect.sync _|p, 0xffffffff;\nselp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(one));
  return one != 0;
}

// The 128 threads of warpgroup w (named barrier 1 + w).
__device__ __forceinline__ void group_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// A K-major wgmma operand of BF-feature rows swizzled over the row (BF =
// 64: 128 bytes, layout 1; 32: 64 bytes, layout 2), 8-row groups 8 rows
// apart; a k-step of 16 features moves the start 32 bytes on.
template <int BF>
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem) {
  constexpr uint64_t layout = BF == 64 ? 1 : 2, sbo = 8 * BF * 2;
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | (1ull << 16) | ((sbo >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Every committed group of this warpgroup but the newest N has completed.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulator of an
// asynchronous product across the point where this stands.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// acc (+)= A . B on the tensor cores for the warpgroup: A 64 x 16 and B 16 x 64
// bf16, both K-major in shared memory through their descriptors;
// accumulate false overwrites acc.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda); null where the driver has none.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  return encode;
}

// A tensor map of a row-major (rows, cols) bf16 array (row stride cols,
// times 2 a multiple of 16 bytes), boxes of box_cols x box_rows swizzled over
// the box's row (128 bytes: 64 columns; 64 bytes: 32), zeros past the ends.
inline bool bf16_tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                            int box_cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t tile[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, tile, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of a row-major (rows, cols) float32 array (row stride cols,
// times 4 a multiple of 16 bytes), boxes of box_cols x box_rows, zeros past
// the ends; unswizzled, or with swizzle128 swizzled over the box's row of
// 128 bytes (box_cols 32) as the tensor cores read a K-major tf32 operand.
inline bool f32_tensor_map_2d(CUtensorMap* map, const void* base, int rows, int cols,
                              int box_cols, int box_rows, bool swizzle128 = false) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t tile[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                strides, tile, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of `len` floats, boxes of `box`, zeros past the end.
inline bool f32_tensor_map(CUtensorMap* map, const void* base, size_t len, int box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[1] = {1};
  const cuuint64_t dims[1] = {(cuuint64_t)len};
  const cuuint64_t strides[1] = {(cuuint64_t)len * 4};
  const cuuint32_t tile[1] = {(cuuint32_t)box};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
                strides, tile, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
