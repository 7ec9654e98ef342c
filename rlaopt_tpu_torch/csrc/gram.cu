// Fused Gram-matrix products for kernel ridge regression, for Hopper (sm_90a).
//
// Three kernels compute out = c * k(X1, X2) @ V without K ever reaching device
// memory. K1 and K2 take inputs pre-scaled by the lengthscale (the Python
// wrapper divides, as rlaopt_tpu/ops/kernel_pallas.py does before its
// pallas_call); K1c takes them unscaled, with the inverse lengthscale.
// Families: rbf, matern12, matern32, matern52 (the squared-distance family;
// Laplace has its own entry points, in gram_laplace.cu). Float32 only, exact
// tier. The tile generators,
// the narrow contraction and the triangle schedule are shared with the bf16
// tiers (gram_tier.cu) and the float64 kernels (gram_f64.cu) through
// gram_common.cuh.
//
//   K1  gram_matmat            replaces rlaopt_tpu/ops/kernel_pallas.py ::
//                              kernel_matmat_pallas, exact tier
//   K1c gram_matmat (COMP)     replaces kernel_matmat_pallas(compensated=True)
//   K2  gram_matvec_symmetric  replaces kernel_pallas.py ::
//                              kernel_matvec_symmetric, exact tier
//
// What bounds them on the H100: not bytes. X is n*d floats (11 MB at the
// HIGGS-100k shape) and is re-read from L2, while every kernel value costs
// about 3d fp32 operations for its squared distance, one expf, and 2 FMAs per
// right-hand side. At d = 28 the distance FMAs on the CUDA cores are the
// largest share; expf (no fast math: the exact tier promises ~1e-7) is next.
// No tensor cores: TF32 keeps ~3 digits, and the distances must be exact fp32.
//
// Design: a block of 256 threads owns a 64-row tile of X1 and walks all
// 64-column tiles of X2. For each column tile it (1) stages 16 features of
// both tiles at a time in shared memory and accumulates the squared distance
// directly as sum (x - y)^2 with fmaf, each thread holding a 4x4 register
// micro-tile (8 shared loads per 32 flops); the direct form has no
// cancellation and costs the same as the norm expansion at small d; (2)
// applies the family epilogue (copied from _finish_sqdist), zeroing entries
// past the ragged edges in n and m, into a 64x65 shared tile that reuses the
// staging buffers; (3) contracts that tile with the matching 64 rows of V in
// fp32 registers. Ragged d is handled by the staging loop.
//
// The compensated tier (K1c) TwoSum-adds each column tile's partial into a
// per-output (hi, lo) pair (_twosum_accumulate in kernel_pallas.py). Inside a
// tile it works in fp64, on the H100's FP64 units (half the FP32 rate): the
// difference of two float inputs is exact in double, and the lengthscale
// division, the squared distance, the family epilogue, the kernel value, the
// constant c and the tile's partial carry no float rounding; the partial is
// split into a float pair before the TwoSum. So K1c is the float64 product of
// the float32 points, which is a different contract from the TPU kernel's
// (float32 values of points pre-scaled in float32, TwoSum across tiles only).
// Why: that contract sits 3.0e-7 of max|ref| from the float64 product at
// n = 100,000, d = 28 on an H100, over the 2e-7 bound; and K1c computes the
// true residual, where at the last logging boundary of the slice the iterate
// sits at the floor of the f32 operator that K1 and K2 apply: a residual
// with float32 kernel values there differed from a float64 residual of the
// same iterate by 0.3-1.2% on an H100, over the 1% bound. With float64 tiles
// the error is ~1e-12 and the gap ~2e-4; the cost is about 2.2x K1's time at
// k = 1.
//
// Right-hand sides: for k <= 16 one block holds all k columns (KC = 1, 2, 4,
// 8 or 16, the rest masked); four threads share an output row and split the
// 64 columns of the tile, and warp shuffles sum them. For k > 16 (the
// Nystrom sketch, k = 500) each block owns 64 columns of V (blockIdx.y) and
// each thread a 4x4 micro-tile of the output. The cost: the K tile is
// recomputed once per 64-column chunk, ceil(k/64) times (8 at k = 500), which
// is about as much work again as the k-column contraction itself. K1c's
// double K tile (33 KB) leaves no room for the wide V tile, so K1c with
// k > 16 takes 16-column chunks on blockIdx.y instead.
//
// None of the TPU's VMEM tile budget, 128-lane padding or concat6 operand fold
// carries over: the tiles here are sized to shared memory and registers.

#include "gram_common.cuh"

namespace {

template <bool COMPENSATED>
int matmat_by_kind(int kind, const GramArgs& a, cudaStream_t s, int splits) {
  switch (kind) {
    case RBF: launch_matmat<RBF, COMPENSATED>(a, s, splits); break;
    case MATERN12: launch_matmat<MATERN12, COMPENSATED>(a, s, splits); break;
    case MATERN32: launch_matmat<MATERN32, COMPENSATED>(a, s, splits); break;
    case MATERN52: launch_matmat<MATERN52, COMPENSATED>(a, s, splits); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns cudaGetLastError() (0 on success).
// Shapes: X1 (n, d), X2 (m, d), V (m, k), out and out_lo (n, k), all
// contiguous float32 on one device; n, m, d, k >= 1.

// K1: out = c * k(X1, X2) @ V, X1 and X2 pre-scaled by the lengthscale.
// splits > 1 (k <= 16): the m axis in that many runs on blockIdx.z, their
// partials in part (splits * n * k floats), summed in a second launch.
extern "C" int rl_gram_matmat(int kind, const void* X1, const void* X2,
                              const void* V, void* out, void* part, int n,
                              int m, int d, int k, int splits, double c,
                              void* stream) {
  GramArgs a = points_args(X1, X2, nullptr, V, out, nullptr, n, m, d, k, c);
  a.part = static_cast<float*>(part);
  return matmat_by_kind<false>(kind, a, static_cast<cudaStream_t>(stream), splits);
}

// K1c: the same product as out + out_lo (out_lo added last), from unscaled
// X1 and X2 and the inverse lengthscale inv_ls (d doubles).
extern "C" int rl_gram_matmat_comp(int kind, const void* X1, const void* X2,
                                   const void* V, const void* inv_ls,
                                   void* out, void* out_lo, int n, int m,
                                   int d, int k, double c, void* stream) {
  const GramArgs a = points_args(X1, X2, inv_ls, V, out, out_lo, n, m, d, k, c);
  return matmat_by_kind<true>(kind, a, static_cast<cudaStream_t>(stream), 1);
}

// K2: X (n, d), V (n, k) with k <= 16, out (n, k); out is zeroed here first.
extern "C" int rl_gram_matvec_symmetric(int kind, const void* X, const void* V,
                                        void* out, int n, int d, int k, double c,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return (int)err;
  const GramArgs a = points_args(X, X, nullptr, V, out, nullptr, n, n, d, k, c);
  switch (kind) {
    case RBF: launch_symmetric<RBF, EXACT, 16>(a, s); break;
    case MATERN12: launch_symmetric<MATERN12, EXACT, 16>(a, s); break;
    case MATERN32: launch_symmetric<MATERN32, EXACT, 16>(a, s); break;
    case MATERN52: launch_symmetric<MATERN52, EXACT, 16>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
