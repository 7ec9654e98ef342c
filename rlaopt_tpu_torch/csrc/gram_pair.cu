// Fused two-output Gram products of two point sets, for Hopper (sm_90a):
// the pair form of the register tile (gram_tile.cuh), every family.
//
// (out1, out2) = (c * K @ V2, c * K^T @ V1) with K = k(X1, X2), each kernel
// value evaluated once and contracted both ways, K never reaching device
// memory:
//
//   K4  tile_pair<KIND != LAPLACE>  replaces rlaopt_tpu/ops/kernel_pallas.py
//       (kernel_cuda.gram_pair)     :: kernel_pair_matmat (_body_pair),
//                                   exact tier
//   K6  tile_pair<LAPLACE>          replaces kernel_pallas.py:2063, the
//       (kernel_cuda.gram_pair)     Laplace pair (_body_pair_laplace)
//
// The bf16 tiers of kernel_pair_matmat (K4b) are the pair form of the tier
// strip, in gram_tier.cu.
//
// The pair kernel serves one off-diagonal block of a symmetric Gram matrix
// split into shards: block K_pq of shards p and q gives K_pq V_q to shard p
// and K_pq^T V_p to shard q (the symmetric half-ring of
// rlaopt_tpu_torch/kernels/sharded.py), on the register tile's operand of
// each shard, which the operator keeps. On the TPU it was also the
// building block of kernel_matmat_symmetric_banded, which the VMEM mirror
// window forced; the triangle kernels here write their mirror to device
// memory and have no n cap, so that banded schedule is not ported.
//
// What bounds it on the H100: the FP32 instruction rate, as every form of
// the tile. Per kernel value: two issue slots a feature of distance (an L1
// pair's two FADDs, a squared pair's FSUB and FFMA), the epilogue on the
// SFU, and 2 FMAs a right-hand side for each of the two products. Bytes
// are O((n1 + n2)(d + k)), re-read from L2: not the limit.
//
// Design (gram_tile.cuh, L_PAIR): the triangle's mirror without the
// triangle. Block (I, s) holds row tile I of X1 (128 points) and walks the
// column tiles [s run, (s + 1) run) of X2, the runs those of the forward
// form (kernel_cuda.tile_splits: E2's 12,500-point shards, 98 x 98 tiles,
// take 10 runs, 980 blocks on the H100's 264 slots), over the whole
// nt1 x nt2 rectangle; each tile's values are contracted with V2_J into
// the lanes' row sums (out1 rows of tile I, added once a block by
// atomicAdd) and, from V1_I staged once a block, into column sums (out2
// rows of tile J, one atomicAdd a column a tile). Both outputs are zeroed
// in the same call; the atomics make the last bits change from run to
// run. k <= 16: the caller routes k > 16 to two general calls, as
// kernel_dispatch.py does.
//
// Ragged edges: the operands are zero past n1 and n2, but a padded
// point's kernel values are not (k(x, 0) > 0). V1 and V2 are staged as
// zero past n1 and n2, and no output row past them is written, so the
// padding adds nothing. The two operands share dpad (one d).
//
// Not carried over: the TPU body's software-pipelined epilogue (tile j-1's
// exp under tile j's MXU pass), the resident VMEM mirror window and its
// transposed (k_pad, T) layout, the MXU "highest" mirror contraction of the
// exact tier (here float32 FMAs), and the Laplace pair's 64-feature
// grid axis (the staging loop walks d 32 features at a time).

#include "gram_tile.cuh"

// Plain C interface, loaded with ctypes; launches on `stream`, does not
// synchronize, and returns a CUDA error code (0 on success).
// (out1, out2) = (c * k(X1, X2) @ V2, c * k(X1, X2)^T @ V1) for the family
// `kind` from XT1 (dpad, n1pad) and XT2 (dpad, n2pad) floats, the points
// divided by the lengthscale, transposed, zero past d, n1 and n2 (the
// tile's operands, kernel_cuda.tile_operand), dpad a multiple of 32, n1pad
// and n2pad of 128; V2 (n2, k), V1 (n1, k), out1 (n1, k), out2 (n2, k)
// float32, 1 <= k <= 16; out1 and out2 are zeroed here first. run: column
// tiles of 128 points a block.
extern "C" int rl_tile_pair(int kind, const void* XT1, const void* XT2, const void* V2,
                            const void* V1, void* out1, void* out2, int n1, int n2, int n1pad,
                            int n2pad, int d, int dpad, int k, int run, double c, void* stream) {
  if (k < 1 || k > 16 || run < 1 || !tile_operand_ok(n1, n1pad, d, dpad) ||
      !tile_operand_ok(n2, n2pad, d, dpad))
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT1);
  const float* B = static_cast<const float*>(XT2);
  const float* W2 = static_cast<const float*>(V2);
  const float* W1 = static_cast<const float*>(V1);
  float* o1 = static_cast<float*>(out1);
  float* o2 = static_cast<float*>(out2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF:
      return (int)tile_pair_by_k<RBF>(A, B, W2, W1, o1, o2, n1, n2, n1pad, n2pad, d, k, run, c, s);
    case MATERN12:
      return (int)tile_pair_by_k<MATERN12>(A, B, W2, W1, o1, o2, n1, n2, n1pad, n2pad, d, k, run,
                                           c, s);
    case MATERN32:
      return (int)tile_pair_by_k<MATERN32>(A, B, W2, W1, o1, o2, n1, n2, n1pad, n2pad, d, k, run,
                                           c, s);
    case MATERN52:
      return (int)tile_pair_by_k<MATERN52>(A, B, W2, W1, o1, o2, n1, n2, n1pad, n2pad, d, k, run,
                                           c, s);
    case LAPLACE:
      return (int)tile_pair_by_k<LAPLACE>(A, B, W2, W1, o1, o2, n1, n2, n1pad, n2pad, d, k, run,
                                          c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
