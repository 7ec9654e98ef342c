// Shared pieces of the bf16 tier kernels: the strip of gram_tier.cu (K1b,
// K4b and K2b past two columns) and K2b's warp-specialised kernel in
// gram_tier_sym.cu, and K1b's in gram_tier_rows.cu: the 16- and 4-byte
// cp.async stages, ldmatrix, the bf16 mma, the SFU exponential and the
// tier's kernel value from its cross term.
//
// Both include this header, which includes gram_common.cuh; everything
// here has internal linkage.

#pragma once

#include "gram_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 matrices from shared memory in the mma fragment layout:
// lanes 8q .. 8q + 7 give the row addresses of matrix q, and r[q] holds
// row lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1 of it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The kernel value of the tier from its cross term; for RBF hx and hy come
// times log2 e.
template <int KIND>
__device__ __forceinline__ float sym_value(float cross, float hx, float hy) {
  if constexpr (KIND == RBF) {
    return ex2(fmaf(cross, kLog2e, -(hx + hy)));
  } else {
    const float d2 = fmaxf(hx + hy - 2.0f * cross, 0.0f);
    const float r = sqrtf(d2);
    if constexpr (KIND == MATERN12) {
      return ex2(-kLog2e * r);
    } else if constexpr (KIND == MATERN32) {
      const float s3 = 1.7320508075688772f;
      return (1.0f + s3 * r) * ex2((-s3 * kLog2e) * r);
    } else {
      const float s5 = 2.23606797749979f;
      return (1.0f + s5 * r + (5.0f / 3.0f) * d2) * ex2((-s5 * kLog2e) * r);
    }
  }
}

}  // namespace
