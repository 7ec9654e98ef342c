// Shared pieces of the fused Gram-matrix kernels (gram_tier.cu, gram_comp.cu,
// through gram_tier.cuh gram_tier_sym.cu, gram_tier_rows.cu and
// gram_wide_ws.cu, and through gram_tile.cuh gram.cu, gram_wide.cu,
// gram_wide_ws.cu and gram_pair.cu): the constants, the
// family codes, the operands of a tier launch, the float64 value of a
// distance and the fixed-order sum of a split product's partials.
//
// K1, K2, K3, K4, K5 and K6 run on the register tile of gram_tile.cuh
// (its forward, triangle and pair forms: gram.cu, gram_pair.cu), K1 and K3
// past 16 columns on gram_wide_ws.cu (the warpgroup form) and gram_wide.cu
// (mma.sync); K1b (past a
// padded depth of 128 or 16 columns), K2b (past two columns) and K4b on the
// strip of gram_tier.cu, K1b and K2b below those on the warp-specialised
// kernels of gram_tier_rows.cu and gram_tier_sym.cu; K1c, K3c, K7 and K8 on
// the float64 tile of gram_comp.cu, in its triangle, forward and pair forms.
//
// Each translation unit includes this header and instantiates what it
// launches; everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // gram_tier.cu: points of a tile
constexpr int kDepth = 16;  // depth of one bf16 tensor-core step

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, LAPLACE = 4 };

// The operands of a tier launch (gram_tier.cu): the bf16 parts X1h/X1l (n,
// dp) and X2h/X2l (m, dp), d = dp the padded depth, lo parts null on the
// one-pass tier, and the norm vectors hx (n), hy (m) of
// _norms_and_operands. V (m, k) and out (n, k) float. The triangle passes
// X2 = X1, m = n.
// part and m_split: K1b's forward strip's runs of the m axis
// (gram_tier.cu); part holds (gridDim.y, n, k) float partials.
// V1 (n, k) and out2 (m, k): K4b's second product K^T V1.
// Vh, Vl (m, kp): V's bf16 parts for K1b past 16 columns, kp a multiple of
// 16 at or above k.
struct GramArgs {
  const __nv_bfloat16* X1h;
  const __nv_bfloat16* X1l;
  const __nv_bfloat16* X2h;
  const __nv_bfloat16* X2l;
  const float* hx;
  const float* hy;
  const void* V;
  void* out;
  const void* V1;
  void* out2;
  const __nv_bfloat16* Vh;
  const __nv_bfloat16* Vl;
  float* part;
  int n, m, d, k, kp;
  int m_split;
  double c;
};

// Kernel value from the squared distance (the L1 distance for Laplace), in
// double (the float64 tile of gram_comp.cu).
template <int KIND>
__device__ __forceinline__ double finish_accurate(double d2) {
  if constexpr (KIND == RBF) {
    return exp(-0.5 * d2);
  } else if constexpr (KIND == LAPLACE) {
    return exp(-d2);
  } else {
    const double r = sqrt(d2);
    if constexpr (KIND == MATERN12) {
      return exp(-r);
    } else if constexpr (KIND == MATERN32) {
      const double s3 = 1.7320508075688772;
      return (1.0 + s3 * r) * exp(-s3 * r);
    } else {
      const double s5 = 2.23606797749979;
      return (1.0 + s5 * r + (5.0 / 3.0) * d2) * exp(-s5 * r);
    }
  }
}

// out[i] = c * (part[0][i] + part[1][i] + ...), in that order: the splits'
// partials summed in a fixed order, so the result does not change from run
// to run.
__global__ void __launch_bounds__(kThreads)
    sum_splits(const float* __restrict__ part, float* __restrict__ out,
               int splits, size_t count, double c) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < count;
       i += (size_t)gridDim.x * kThreads) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * count + i];
    out[i] = (float)(s * c);
  }
}

}  // namespace
