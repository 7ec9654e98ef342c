// Fused Laplace Gram-matrix products, for Hopper (sm_90a).
//
// out = c * exp(-sum_f |x_f - y_f|) @ V, K never reaching device memory:
//
//   K3  laplace_matmat            replaces rlaopt_tpu/ops/kernel_pallas.py ::
//                                 _laplace_matmat (plain)
//   K3c laplace_matmat (COMP)     replaces _laplace_matmat(compensated=True)
//   K5  laplace_matvec_symmetric  replaces kernel_pallas.py ::
//                                 _laplace_matvec_symmetric
//
// They are K1, K1c and K2 (gram.cu) on the Laplace tile: the tile generator
// of gram_common.cuh (kernel_tile<LAPLACE, ...>) sums |x - y| where the
// squared-distance family sums (x - y)^2, and finish<LAPLACE> takes exp(-l1).
// K3 and K5 take points pre-scaled by the lengthscale in float32 (the
// wrapper divides, as the JAX package does before its pallas_call); K3c
// takes them unscaled with the inverse lengthscale, and takes the division,
// |x - y|, the sum, exp, c and the tile's partial in float64, TwoSum-adding
// the partials across column tiles into a float (hi, lo) pair: the float64
// product of the float32 points, as K1c is for the squared-distance family.
//
// What bounds them on the H100: the FP32 instruction rate (FP64 for K3c),
// not bytes. Each kernel value costs 2d instructions for its distance (a
// subtraction and an add of the absolute value, the same count as RBF's
// subtraction and FMA), one expf and 2 FMAs per right-hand side; the points
// (n*d floats) are re-read from L2. No tensor cores: an L1 distance has no
// product form.
//
// Design: K3 has K1's schedule (64-row tile per block, all column tiles
// walked in the block; k <= 16 columns in registers, 64-column chunks on
// blockIdx.y past that, the Nystrom sketch at k = 500). At a block-oracle
// shape (10,000 rows of 1,000,000) the row tiles alone give 157 blocks on
// 132 SMs, so the wrapper may cut the m axis into runs on blockIdx.z and
// sum_splits adds the runs' partials in a fixed order. K3c has K1c's and K5
// has K2's (each unordered tile pair evaluated once, the mirror added by
// atomicAdd into an output zeroed in the same call, k <= 16, no n cap).
//
// Not carried over from the TPU kernels: the 64-feature grid axis of
// _laplace_feature_block (the staging loop walks d 16 features at a time),
// the VMEM mirror windows and the MXU mirror contraction of the triangle.

#include "gram_common.cuh"

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns cudaGetLastError() (0 on success).
// Shapes: X1 (n, d), X2 (m, d), V (m, k), out and out_lo (n, k), all
// contiguous float32 on one device; n, m, d, k >= 1.

// K3: out = c * k(X1, X2) @ V, X1 and X2 pre-scaled by the lengthscale.
// splits > 1 (k <= 16): the m axis in that many runs on blockIdx.z, their
// partials in part (splits * n * k floats), summed in a second launch.
extern "C" int rl_laplace_matmat(const void* X1, const void* X2, const void* V,
                                 void* out, void* part, int n, int m, int d,
                                 int k, int splits, double c, void* stream) {
  GramArgs a = points_args(X1, X2, nullptr, V, out, nullptr, n, m, d, k, c);
  a.part = static_cast<float*>(part);
  launch_matmat<LAPLACE, false>(a, static_cast<cudaStream_t>(stream), splits);
  return (int)cudaGetLastError();
}

// K3c: the same product as out + out_lo (out_lo added last), from unscaled
// X1 and X2 and the inverse lengthscale inv_ls (d doubles).
extern "C" int rl_laplace_matmat_comp(const void* X1, const void* X2,
                                      const void* V, const void* inv_ls,
                                      void* out, void* out_lo, int n, int m,
                                      int d, int k, double c, void* stream) {
  const GramArgs a = points_args(X1, X2, inv_ls, V, out, out_lo, n, m, d, k, c);
  launch_matmat<LAPLACE, true>(a, static_cast<cudaStream_t>(stream), 1);
  return (int)cudaGetLastError();
}

// K5: X (n, d) pre-scaled, V (n, k) with k <= 16, out (n, k); out is zeroed
// here first.
extern "C" int rl_laplace_matvec_symmetric(const void* X, const void* V,
                                           void* out, int n, int d, int k,
                                           double c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return (int)err;
  const GramArgs a = points_args(X, X, nullptr, V, out, nullptr, n, n, d, k, c);
  launch_symmetric<LAPLACE, EXACT, 16>(a, s);
  return (int)cudaGetLastError();
}
