// Float64 Gram products for certified residuals, for Hopper (sm_90a).
//
//   K8 gram_matmat_f64            replaces rlaopt_tpu/ops/kernel_value64.py ::
//                                 kernel_matmat_value64 (rectangular form)
//   K7 gram_matvec_symmetric_f64  replaces kernel_value64.py ::
//                                 _value64_symmetric (pair-chunk form)
//
// Both compute out = c * k(X1, X2) @ V for all five families (rbf, laplace,
// matern12/32/52) from unscaled float32 points, the inverse lengthscale in
// float64 (scalar or ARD, d values), V and out in float64. The TPU has no
// float64, so the JAX package reaches ~3e-9 kernel values through two-float
// arithmetic (ops/twofloat.py); the H100 has FP64 units, so these kernels
// are K1c's tile (gram_common.cuh, kernel_tile<KIND, true>) carried to
// float64 end to end: the difference of two float inputs is exact in double,
// and the scaling, the distance (squared, or L1 for Laplace), the value, V,
// the contraction and the accumulator are double. Their error against the
// float64 product is the float64 round-off of the sums, ~1e-15 relative.
//
// What bounds them on the H100: the FP64 instruction rate. Every kernel
// value costs about 3d FP64 instructions for the distance (a subtraction, the
// scaling, an FMA per feature), a software exp (~20 FP64 instructions; no
// fast FP64 exp exists) and 2 FMAs per right-hand side, at half the FP32
// rate. K1c, the same tile
// with a float contraction, takes 100.4 ms at n = m = 100,000, d = 28, k = 1
// (PERF.md); that is the expected scale of K8.
//
// Design: K8 is the narrow kernel of K1 and K1c (64-row tiles, all column
// tiles walked in the block, k <= 16 columns in registers, 16 columns per
// blockIdx.y past that). K7 is the triangle schedule of K2 (each unordered
// tile pair evaluated once, serving both triangles), with the mirror sums
// and the row sums added by float64 atomicAdd (native since sm_60) into an
// output zeroed in the same call; the order of those additions changes from
// run to run, at ~1e-16 relative. The double K tile (33 KB) and two double V
// tiles fit the 48 KB of static shared memory at 8 columns, so K7 takes 8
// right-hand-side columns per blockIdx.z.

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

int f64_symmetric_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: launch_symmetric<RBF, F64, 8>(a, s); break;
    case MATERN12: launch_symmetric<MATERN12, F64, 8>(a, s); break;
    case MATERN32: launch_symmetric<MATERN32, F64, 8>(a, s); break;
    case MATERN52: launch_symmetric<MATERN52, F64, 8>(a, s); break;
    case LAPLACE: launch_symmetric<LAPLACE, F64, 8>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

GramArgs f64_args(const void* X1, const void* X2, const void* inv_ls,
                  const void* V, void* out, int n, int m, int d, int k,
                  double c) {
  GramArgs a{};
  a.X1 = static_cast<const float*>(X1);
  a.X2 = static_cast<const float*>(X2);
  a.inv_ls = static_cast<const double*>(inv_ls);
  a.V = V;
  a.out = out;
  a.n = n;
  a.m = m;
  a.d = d;
  a.k = k;
  a.c = c;
  return a;
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
  const GramArgs a = f64_args(X1, X2, inv_ls, V, out, n, m, d, k, c);
  return f64_matmat_by_kind(kind, a, static_cast<cudaStream_t>(stream));
}

// K7: the triangle form for one data set, V (n, k); out is zeroed here
// first.
extern "C" int rl_gram_matvec_symmetric_f64(int kind, const void* X,
                                            const void* inv_ls, const void* V,
                                            void* out, int n, int d, int k,
                                            double c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(double) * (size_t)n * k, s);
  if (err != cudaSuccess) return (int)err;
  const GramArgs a = f64_args(X, X, inv_ls, V, out, n, n, d, k, c);
  return f64_symmetric_by_kind(kind, a, s);
}
