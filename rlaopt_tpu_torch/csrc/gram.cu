// Fused Gram-matrix products for kernel ridge regression, for Hopper (sm_90a).
//
// out = c * k(X1, X2) @ V without K ever reaching device memory, for the
// squared-distance families: rbf, matern12, matern32, matern52 (Laplace has
// its own entry points, in gram_laplace.cu). Float32.
//
//   K1  tile_forward<KIND>      replaces rlaopt_tpu/ops/kernel_pallas.py ::
//       (k <= 16; past 16         kernel_matmat_pallas, exact tier
//       gram_wide.cu)
//   K2  tile_triangle<KIND>     replaces kernel_pallas.py ::
//                               kernel_matvec_symmetric, exact tier
//
// What bounds K1 and K2 on the H100: not bytes. X is n*d floats (11 MB at
// the HIGGS-100k shape) and is re-read from L2, while every kernel value
// costs d FSUB + FFMA pairs for its squared distance on the FP32 cores
// (the same two issue slots a feature as K3's L1 pair), one exponential on
// the SFU (Matern adds a square root there), and 2 FMAs per right-hand side
// (4 in the triangle's off-diagonal tiles). At d = 28 the distance is the
// largest share.
//
// Design: both run on the register tile of gram_tile.cuh, the tile first
// built for K3 and then put in triangle form for K5: 128 x 128 points a
// block, an 8 x 8 register tile a thread, the points handed over scaled,
// transposed and padded (kernel_cuda.tile_operand, the Laplace kernels'
// layout: zero padding adds 0 to a squared distance as to an L1 one), 32
// features a chunk by cp.async, the contraction by a shuffle reduce-scatter
// in registers; K1 in runs of the m axis summed in a fixed order (the same
// bits twice), K2 in triangle form (each pair of tiles once, the mirror
// added by float atomics). The epilogue is the family's function of the
// distance (tile_value: __expf, the square root on the SFU).
//
// The compensated tier (K1c, every form) and K8 run on the float64 tile of
// gram_comp.cu.
//
// None of the TPU's VMEM tile budget, 128-lane padding or concat6 operand fold
// carries over: the tiles here are sized to shared memory and registers.

#include "gram_tile.cuh"

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns cudaGetLastError() (0 on success).

// K1 at k <= 16 (tile_forward<KIND>): out = c * k(X1, X2) @ V from XT1
// (dpad, npad) and XT2 (dpad, mpad) floats, the points divided by the
// lengthscale, transposed, zero past d, n and m, dpad a multiple of 32,
// npad and mpad of 128; V (m, k), out (n, k) float32. splits > 1: the m
// axis in that many runs (fewer if m has fewer tiles), their partials in
// part (splits * n * k floats), summed in a fixed order by a second launch.
extern "C" int rl_gram_matmat_narrow(int kind, const void* XT1, const void* XT2,
                                     const void* V, void* out, void* part, int n, int m,
                                     int npad, int mpad, int d, int dpad, int k, int splits,
                                     double c, void* stream) {
  if (k < 1 || k > 16 || !tile_operand_ok(n, npad, d, dpad) || !tile_operand_ok(m, mpad, d, dpad))
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT1);
  const float* B = static_cast<const float*>(XT2);
  const float* Vf = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return (int)tile_forward_by_k<RBF>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
    case MATERN12:
      return (int)tile_forward_by_k<MATERN12>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
    case MATERN32:
      return (int)tile_forward_by_k<MATERN32>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
    case MATERN52:
      return (int)tile_forward_by_k<MATERN52>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 (tile_triangle<KIND>): out = c * k(X, X) @ V from XT (dpad, npad)
// floats, the tile's operand as above; V (n, k) with k <= 16, out (n, k)
// float32, zeroed here first.
extern "C" int rl_gram_matvec_symmetric(int kind, const void* XT, const void* V, void* out,
                                        int n, int npad, int d, int dpad, int k, double c,
                                        void* stream) {
  if (k < 1 || k > 16 || !tile_operand_ok(n, npad, d, dpad)) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT);
  const float* Vf = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return (int)tile_triangle_by_k<RBF>(A, Vf, o, n, npad, d, k, c, s);
    case MATERN12: return (int)tile_triangle_by_k<MATERN12>(A, Vf, o, n, npad, d, k, c, s);
    case MATERN32: return (int)tile_triangle_by_k<MATERN32>(A, Vf, o, n, npad, d, k, c, s);
    case MATERN52: return (int)tile_triangle_by_k<MATERN52>(A, Vf, o, n, npad, d, k, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
