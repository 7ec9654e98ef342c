// Fused two-output Gram products of two point sets, for Hopper (sm_90a).
//
// (out1, out2) = (c * K @ V2, c * K^T @ V1) with K = k(X1, X2), each kernel
// value evaluated once and contracted both ways, K never reaching device
// memory:
//
//   K4  gram_pair     replaces rlaopt_tpu/ops/kernel_pallas.py ::
//                     kernel_pair_matmat (_body_pair), exact tier
//   K6  laplace_pair  replaces kernel_pallas.py :: _laplace_pair_matmat
//                     (_body_pair_laplace)
//
// The bf16 tiers of kernel_pair_matmat (K4b) are the pair form of the tier
// strip, in gram_tier.cu.
//
// The pair kernel serves one off-diagonal block of a symmetric Gram matrix
// split into shards: block K_pq of shards p and q gives K_pq V_q to shard p
// and K_pq^T V_p to shard q (the symmetric half-ring of
// rlaopt_tpu_torch/kernels/sharded.py). On the TPU it was also the building
// block of kernel_matmat_symmetric_banded, which the VMEM mirror window
// forced; the triangle kernels here write their mirror to device memory and
// have no n cap, so that banded schedule is not ported.
//
// What bounds them on the H100: what bounds K2, whose tile code they are
// (gram_common.cuh: gram_matvec_symmetric with PAIR). Per kernel value:
// ~3d float32 instructions of squared distance (2d of L1 distance for
// Laplace), one expf, and 2 FMAs per right-hand side for each of the two
// products. Bytes are O((n1 + n2)(d + k)), re-read from L2: not the limit.
//
// Design: K2's schedule over the full nt1 x nt2 rectangle of 64 x 64 tiles,
// with no diagonal: block (I, s) holds row tile I of X1 and walks the 16
// column tiles J = 16s .. 16s + 15 of X2; for each it makes the K tile in
// shared memory (kernel_tile), contracts it with V2_J into registers for
// out1[I], and its transpose with V1_I into out2[J] at once by atomicAdd.
// out1[I] is added once per block by atomicAdd. Both outputs are zeroed in
// the same call; k <= 16 (gridDim.z past 16 columns is not taken: the caller
// routes k > 16 to two general calls, as kernel_dispatch.py does).
//
// Ragged edges: entries of the K tile past n1 or n2 are zero, and no output
// row past n1 or n2 is written, so zero-padded shards of a mesh only need
// their padded OPERAND rows to be zero: a padded point's kernel values with
// real points are not zero (k(x, 0) > 0), so the padded rows of out1 and
// out2 hold values, and the caller slices them away.
//
// Not carried over: the TPU body's software-pipelined epilogue (tile j-1's
// exp under tile j's MXU pass), the resident VMEM mirror window and its
// transposed (k_pad, T) layout, the MXU "highest" mirror contraction of the
// exact tier (here float32 FMAs), and _laplace_pair_matmat's 64-feature
// grid axis (the staging loop walks d 16 features at a time).

#include "gram_common.cuh"

namespace {

cudaError_t zero_outputs(void* out1, void* out2, size_t n1, size_t n2, int k,
                         cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(out1, 0, sizeof(float) * n1 * k, s);
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(out2, 0, sizeof(float) * n2 * k, s);
}

int pair_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: launch_symmetric<RBF, true>(a, s); break;
    case MATERN12: launch_symmetric<MATERN12, true>(a, s); break;
    case MATERN32: launch_symmetric<MATERN32, true>(a, s); break;
    case MATERN52: launch_symmetric<MATERN52, true>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns a CUDA error code (0 on success).
// Shapes: X1 (n1, d), X2 (n2, d), V2 (n2, k), V1 (n1, k), out1 (n1, k),
// out2 (n2, k) with 1 <= k <= 16, all contiguous float32 on one device;
// out1 and out2 are zeroed here first.

// K4: (out1, out2) = (c * k(X1, X2) @ V2, c * k(X1, X2)^T @ V1), X1 and X2
// pre-scaled by the lengthscale; the squared-distance families.
extern "C" int rl_gram_pair(int kind, const void* X1, const void* X2,
                            const void* V2, const void* V1, void* out1,
                            void* out2, int n1, int n2, int d, int k,
                            double c, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = zero_outputs(out1, out2, n1, n2, k, s);
  if (err != cudaSuccess) return (int)err;
  GramArgs a = points_args(X1, X2, nullptr, V2, out1, nullptr, n1, n2, d, k, c);
  a.V1 = V1;
  a.out2 = out2;
  return pair_by_kind(kind, a, s);
}

// K6: the Laplace pair, c * exp(-|x - y|_1) with X1 and X2 pre-scaled by the
// lengthscale.
extern "C" int rl_laplace_pair(const void* X1, const void* X2, const void* V2,
                               const void* V1, void* out1, void* out2, int n1,
                               int n2, int d, int k, double c, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = zero_outputs(out1, out2, n1, n2, k, s);
  if (err != cudaSuccess) return (int)err;
  GramArgs a = points_args(X1, X2, nullptr, V2, out1, nullptr, n1, n2, d, k, c);
  a.V1 = V1;
  a.out2 = out2;
  launch_symmetric<LAPLACE, true>(a, s);
  return (int)cudaGetLastError();
}
