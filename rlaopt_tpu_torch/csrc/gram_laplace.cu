// Fused Laplace Gram-matrix products, for Hopper (sm_90a).
//
// out = c * exp(-sum_f |x_f - y_f|) @ V, K never reaching device memory:
//
//   K3  tile_forward<LAPLACE>     replaces rlaopt_tpu/ops/kernel_pallas.py ::
//       (k <= 16; past 16         _laplace_matmat (plain)
//       gram_wide.cu's 3xTF32
//       kernel)
//   K5  tile_triangle<LAPLACE>    replaces kernel_pallas.py ::
//                                 _laplace_matvec_symmetric
//
// What bounds them on the H100: the FP32 instruction rate, not bytes. An
// L1 pair and feature costs two FADDs, d = x - y and acc += |d| with the
// absolute value an operand modifier: unlike RBF's FMA they do
// not fuse, so the FP32 pipes (128 lanes a clock per SM, one warp
// instruction a clock per sub-partition) deliver half the data sheet's
// 67 TFLOP/s (which counts an FMA as two) for this function, and every
// other instruction in the loop takes a FADD's slot. Per kernel value
// besides: one exp and 2k FMAs of contraction. An L1 distance has no
// product form, so it stays on the FP32 pipes; past 16 columns the
// contraction goes to the TF32 tensor cores (gram_wide.cu).
//
// K3 for k <= 16 and K5 run on the register tile of gram_tile.cuh (K3's
// tile and its triangle form, since generalised to every family: K1
// and K2 run on it too): 128 x 128 points a block, an 8 x 8 register tile
// a thread, cp.async staging of 32-feature chunks, the shuffle
// reduce-scatter, the m axis in runs summed by sum_splits (forward form),
// the triangle's mirror through shared memory with one atomicAdd a column.
// K3 past 16 columns is gram_wide.cu's gram_wide_tf32<LAPLACE, NF>, K1's
// 3xTF32 kernel with the L1 step (rl_gram_matmat_wide, LAPLACE's code);
// the pair of two point sets (K6) is the tile's pair form in gram_pair.cu.
// K3c (every form) is K1c's float64 tile with the L1 step (gram_comp.cu).
//
// Not carried over from the TPU kernels: the 64-feature grid axis of
// _laplace_feature_block (the staging loops walk d 16 or 32 features at a time),
// the VMEM mirror windows and the MXU mirror contraction of the triangle.

#include "gram_tile.cuh"

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns cudaGetLastError() (0 on success).

// K5 (tile_triangle<LAPLACE>): out = c * k(X, X) @ V from XT (dpad, npad)
// floats, the points divided by the lengthscale, transposed, zero past d
// and n, dpad a multiple of 32 and npad of 128 (the tile's operand); V (n,
// k) with k <= 16, out (n, k) float32, zeroed here first.
extern "C" int rl_laplace_matvec_symmetric(const void* XT, const void* V, void* out, int n,
                                           int npad, int d, int dpad, int k, double c,
                                           void* stream) {
  if (k < 1 || k > 16 || !tile_operand_ok(n, npad, d, dpad)) return (int)cudaErrorInvalidValue;
  return (int)tile_triangle_by_k<LAPLACE>(static_cast<const float*>(XT),
                                          static_cast<const float*>(V), static_cast<float*>(out),
                                          n, npad, d, k, c, static_cast<cudaStream_t>(stream));
}

// K3 at k <= 16 (tile_forward<LAPLACE>): out = c * k(X1, X2) @ V from XT1
// (dpad, npad) and XT2 (dpad, mpad) floats, the points divided by the
// lengthscale, transposed, zero past d, n and m, dpad a multiple of 32,
// npad and mpad of 128; V (m, k), out (n, k) float32. splits > 1: the m
// axis in that many runs (fewer if m has fewer tiles), their partials in
// part (splits * n * k floats), summed in a fixed order by a second launch.
extern "C" int rl_laplace_matmat_narrow(const void* XT1, const void* XT2, const void* V,
                                        void* out, void* part, int n, int m, int npad,
                                        int mpad, int d, int dpad, int k, int splits,
                                        double c, void* stream) {
  if (k < 1 || k > 16 || !tile_operand_ok(n, npad, d, dpad) || !tile_operand_ok(m, mpad, d, dpad))
    return (int)cudaErrorInvalidValue;
  return (int)tile_forward_by_k<LAPLACE>(
      static_cast<const float*>(XT1), static_cast<const float*>(XT2),
      static_cast<const float*>(V), static_cast<float*>(out), static_cast<float*>(part), n, m,
      npad, mpad, d, k, splits, c, static_cast<cudaStream_t>(stream));
}
