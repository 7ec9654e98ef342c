// The float64 Gram product of two data sets, for Hopper (sm_90a).
//
//   K8 gram_matmat_f64  replaces rlaopt_tpu/ops/kernel_value64.py ::
//                       kernel_matmat_value64 (rectangular form)
//
// It computes out = c * k(X1, X2) @ V for all five families (rbf, laplace,
// matern12/32/52) from unscaled float32 points, the inverse lengthscale in
// float64 (scalar or ARD, d values), V and out in float64. The TPU has no
// float64, so the JAX package reaches ~3e-9 kernel values through two-float
// arithmetic (ops/twofloat.py); the H100 has FP64 units, so this kernel is
// K1c's tile (gram_common.cuh, kernel_tile<KIND>) carried to float64
// end to end: the difference of two float inputs is exact in double, and
// the scaling, the distance (squared, or L1 for Laplace), the value, V, the
// contraction and the accumulator are double. Its error against the float64
// product is the float64 round-off of the sums, ~1e-15 relative. One data
// set (K7, the certified sweep) takes the float64 triangle of gram_comp.cu.
//
// What bounds it on the H100: the FP64 instruction rate. Every kernel value
// costs about 3d FP64 instructions for the distance (a subtraction, the
// scaling, an FMA per feature), a software exp (~20 FP64 instructions; no
// fast FP64 exp exists) and 2 FMAs per right-hand side, at half the FP32
// rate.
//
// Design: the narrow kernel of K1 and K1c (64-row tiles, all column tiles
// walked in the block, k <= 16 columns in registers, 16 columns per
// blockIdx.y past that).

#include "gram_common.cuh"

namespace {

int f64_matmat_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: launch_narrow_by_k<RBF, F64>(a, s); break;
    case MATERN12: launch_narrow_by_k<MATERN12, F64>(a, s); break;
    case MATERN32: launch_narrow_by_k<MATERN32, F64>(a, s); break;
    case MATERN52: launch_narrow_by_k<MATERN52, F64>(a, s); break;
    case LAPLACE: launch_narrow_by_k<LAPLACE, F64>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns a CUDA error code (0 on success).
// X1 (n, d), X2 (m, d) float32 unscaled; inv_ls (d) float64; V (m, k) and
// out (n, k) float64; all contiguous on one device. Kind 4 is Laplace.

// K8: out = c * k(X1, X2) @ V in float64.
extern "C" int rl_gram_matmat_f64(int kind, const void* X1, const void* X2,
                                  const void* inv_ls, const void* V, void* out,
                                  int n, int m, int d, int k, double c,
                                  void* stream) {
  const GramArgs a = points_args(X1, X2, inv_ls, V, out, nullptr, n, m, d, k, c);
  return f64_matmat_by_kind(kind, a, static_cast<cudaStream_t>(stream));
}
