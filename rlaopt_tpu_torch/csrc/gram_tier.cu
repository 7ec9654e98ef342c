// The bf16 accuracy tiers of the fused Gram products, for Hopper (sm_90a).
//
//   K1b gram_matmat_tier<PASSES>            replaces rlaopt_tpu/ops/
//       kernel_pallas.py :: kernel_matmat_pallas with compute_dtype="bf16x3"
//       (PASSES = 3: _cross_split, _body_split) or "bfloat16" (PASSES = 1:
//       _cross_bf16, _body_bf16), and _acc_update's tier-matched "split" and
//       "fast" contractions for k > 16
//   K2b gram_matvec_symmetric_tier<PASSES>  replaces kernel_pallas.py ::
//       kernel_matvec_symmetric with the same tiers (_sym_epilogue,
//       _sym_tier_params, _sym_mirror_mode)
//
// Operands: the bf16 parts of the points pre-scaled by the lengthscale (hi,
// and lo for bf16x3), split once per operator in PyTorch and padded in depth
// to a multiple of 16 with zeros, and the norm vectors hx, hy of
// _norms_and_operands (ops/kernel_tiers.py).
//
// What bounds them on the H100: the cross term x.y of every kernel value is
// 3 (or 1) bf16 products of depth dp = 32 at d = 28, a few percent of the
// tensor cores' rate; what is left on the CUDA cores is the epilogue (two
// subtractions and expf per value) and, for k <= 16, the float32 contraction
// (2 FMAs per value and column, 4 with the triangle's mirror). So the tiers
// are bound by the CUDA-core instruction rate at k <= 16, like K1 and K2,
// but without the ~3d-instruction direct distance that dominates those. At k = 500 (the
// Nystrom sketch) the contraction is the work: 3 bf16 passes of depth 64 per
// tile and 128 columns on the tensor cores, fed from shared memory.
//
// Design. The K tile (64 x 64, tier_tile in gram_common.cuh): the parts of
// both point tiles are staged 16 features at a time; each of 8 warps runs
// wmma 16x16x16 (bf16 in, float accumulate) on a 16-row strip and two
// 16-column fragments, hi.hi + hi.lo + lo.hi (the lo.lo term is dropped, as
// in the JAX kernel); the fragments go to shared memory, where the epilogue
// finishes the values in float32 in place. For k <= 16 the narrow
// contraction and the triangle schedule are K1's and K2's, float32 on the
// CUDA cores; K2b's mirror rows take the tier-matched contraction at k >= 3
// (tier_mul), as _sym_mirror_mode does. For k > 16 (gram_matmat_tier_wide)
// a block owns 64 rows and 128 right-hand-side columns: per column tile it
// splits the K tile and the matching 64 x 128 slice of V into bf16 parts in
// shared memory and contracts them, hi.hi + hi.lo + lo.hi (or hi.hi), in
// wmma fragments whose partials are added to float sums tile by tile, so the
// contraction runs on the tensor cores at the tier's accuracy; the K tile is
// recomputed once per 128 columns (4 times at k = 500).
//
// Not carried over: the concat fold of the TPU kernel (one MXU pass of depth
// 3d on [xh|xh|xl].[yh;yl;yh]), a trade of the TPU's 128-lane padding; the
// same three product terms are computed here as separate tensor-core steps.
// wgmma, TMA and warp specialisation are later work.

#include "gram_common.cuh"

namespace {

constexpr int kTierWide = 128;          // right-hand-side columns per block
constexpr int kKLd = kTile + 8;         // row stride of the K tile's parts
constexpr int kVLd = kTierWide + 8;     // row stride of V's parts
constexpr int kOutLd = kTierWide + 4;   // row stride of the output staging

struct __align__(128) WideSmem {
  TierSmem tile;
  uint16_t kh[kTile][kKLd], kl[kTile][kKLd];
  union {
    struct {
      uint16_t vh[kTile][kVLd], vl[kTile][kVLd];
    } v;
    float o[kTile][kOutLd];
  };
};

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// K1b for k > 16: block (bx, by) owns rows 64*bx.. and right-hand-side
// columns 128*by..; warp w owns the output fragments of rows 16*(w%4).. and
// columns 64*(w/4) + 16j, j < 4.
template <int KIND, int PASSES>
__global__ void __launch_bounds__(kThreads) gram_matmat_tier_wide(const GramArgs a) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WideSmem& sm = *reinterpret_cast<WideSmem*>(smem_raw);
  const float* __restrict__ V = static_cast<const float*>(a.V);
  const int row0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTierWide;
  const int t = threadIdx.x, warp = t / 32;
  const int fr = warp % 4, fc = (warp / 4) * 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int col0 = 0; col0 < a.m; col0 += kTile) {
    for (int e = t; e < kTile * kTierWide; e += kThreads) {
      const int j = e / kTierWide, c = e % kTierWide;
      const int gj = col0 + j, gc = c0 + c;
      const float v = (gj < a.m && gc < a.k) ? V[(size_t)gj * a.k + gc] : 0.0f;
      const uint16_t h = bf16_bits(v);
      sm.v.vh[j][c] = h;
      if constexpr (PASSES == 3) sm.v.vl[j][c] = bf16_bits(v - bf16_value(h));
    }
    tier_tile<KIND, PASSES>(a.X1h, a.X1l, a.hx, a.X2h, a.X2l, a.hy, a.n, a.m,
                            a.d, row0, col0, sm.tile);
    for (int e = t; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const float kv = sm.tile.k[r][c];
      const uint16_t h = bf16_bits(kv);
      sm.kh[r][c] = h;
      if constexpr (PASSES == 3) sm.kl[r][c] = bf16_bits(kv - bf16_value(h));
    }
    __syncthreads();
    // This tile's 64-deep partial in fresh fragments, added to the running
    // sums by float adds: the tensor cores' own accumulation is not IEEE
    // float, and carried over all m / 64 tiles its error grew to 7.6e-5 of
    // max|ref| at m = 20,000 on an H100, where the plain version of the
    // tier sits at 5.8e-6 from the float64 product.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(part[j], 0.0f);
#pragma unroll
    for (int ks = 0; ks < kTile / kDepth; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> k_hi, k_lo;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> v_hi, v_lo;
      wmma::load_matrix_sync(
          k_hi, reinterpret_cast<const __nv_bfloat16*>(&sm.kh[fr * 16][ks * kDepth]), kKLd);
      if constexpr (PASSES == 3) {
        wmma::load_matrix_sync(
            k_lo, reinterpret_cast<const __nv_bfloat16*>(&sm.kl[fr * 16][ks * kDepth]),
            kKLd);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(
            v_hi,
            reinterpret_cast<const __nv_bfloat16*>(&sm.v.vh[ks * kDepth][(fc + j) * 16]),
            kVLd);
        wmma::mma_sync(part[j], k_hi, v_hi, part[j]);
        if constexpr (PASSES == 3) {
          wmma::load_matrix_sync(
              v_lo,
              reinterpret_cast<const __nv_bfloat16*>(&sm.v.vl[ks * kDepth][(fc + j) * 16]),
              kVLd);
          wmma::mma_sync(part[j], k_hi, v_lo, part[j]);
          wmma::mma_sync(part[j], k_lo, v_hi, part[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] += part[j].x[i];
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(&sm.o[fr * 16][(fc + j) * 16], acc[j], kOutLd,
                            wmma::mem_row_major);
  }
  __syncthreads();
  float* __restrict__ out = static_cast<float*>(a.out);
  for (int e = t; e < kTile * kTierWide; e += kThreads) {
    const int r = e / kTierWide, c = e % kTierWide;
    const int gr = row0 + r, gc = c0 + c;
    if (gr < a.n && gc < a.k) out[(size_t)gr * a.k + gc] = (float)(sm.o[r][c] * a.c);
  }
}

template <int KIND, int PASSES>
int launch_tier_matmat(const GramArgs& a, cudaStream_t s) {
  constexpr int MODE = PASSES == 3 ? TIER3 : TIER1;
  if (a.k <= 16) {
    launch_narrow_by_k<KIND, MODE>(a, s);
    return (int)cudaGetLastError();
  }
  const int bytes = (int)sizeof(WideSmem);
  cudaError_t err = cudaFuncSetAttribute(gram_matmat_tier_wide<KIND, PASSES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kTile - 1) / kTile, (a.k + kTierWide - 1) / kTierWide);
  gram_matmat_tier_wide<KIND, PASSES><<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int PASSES>
int tier_matmat_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_tier_matmat<RBF, PASSES>(a, s);
    case MATERN12: return launch_tier_matmat<MATERN12, PASSES>(a, s);
    case MATERN32: return launch_tier_matmat<MATERN32, PASSES>(a, s);
    case MATERN52: return launch_tier_matmat<MATERN52, PASSES>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int tier_symmetric_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: launch_symmetric<RBF, MODE, 16>(a, s); break;
    case MATERN12: launch_symmetric<MATERN12, MODE, 16>(a, s); break;
    case MATERN32: launch_symmetric<MATERN32, MODE, 16>(a, s); break;
    case MATERN52: launch_symmetric<MATERN52, MODE, 16>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

GramArgs tier_args(const void* X1h, const void* X1l, const void* hx,
                   const void* X2h, const void* X2l, const void* hy,
                   const void* V, void* out, int n, int m, int dp, int k,
                   double c) {
  GramArgs a{};
  a.X1h = static_cast<const __nv_bfloat16*>(X1h);
  a.X1l = static_cast<const __nv_bfloat16*>(X1l);
  a.hx = static_cast<const float*>(hx);
  a.X2h = static_cast<const __nv_bfloat16*>(X2h);
  a.X2l = static_cast<const __nv_bfloat16*>(X2l);
  a.hy = static_cast<const float*>(hy);
  a.V = V;
  a.out = out;
  a.n = n;
  a.m = m;
  a.d = dp;
  a.k = k;
  a.c = c;
  return a;
}

}  // namespace

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns a CUDA error code (0 on success).
// Parts: X1h, X1l (n, dp) and X2h, X2l (m, dp) bf16 with dp a multiple of
// 16 (the lo parts are unused and may be null when passes == 1); hx (n),
// hy (m), V (m, k), out (n, k) float32; all contiguous on one device.

// K1b: out = c * k(X1, X2) @ V on the tier of `passes` (3 or 1).
extern "C" int rl_gram_matmat_tier(int kind, int passes, const void* X1h,
                                   const void* X1l, const void* hx,
                                   const void* X2h, const void* X2l,
                                   const void* hy, const void* V, void* out,
                                   int n, int m, int dp, int k, double c,
                                   void* stream) {
  if (dp % kDepth != 0) return (int)cudaErrorInvalidValue;
  const GramArgs a = tier_args(X1h, X1l, hx, X2h, X2l, hy, V, out, n, m, dp, k, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3) return tier_matmat_by_kind<3>(kind, a, s);
  if (passes == 1) return tier_matmat_by_kind<1>(kind, a, s);
  return (int)cudaErrorInvalidValue;
}

// K2b: the triangle form for one data set, V (n, k) with k <= 16; out is
// zeroed here first.
extern "C" int rl_gram_matvec_symmetric_tier(int kind, int passes,
                                             const void* Xh, const void* Xl,
                                             const void* hx, const void* V,
                                             void* out, int n, int dp, int k,
                                             double c, void* stream) {
  if (dp % kDepth != 0 || k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return (int)err;
  const GramArgs a = tier_args(Xh, Xl, hx, Xh, Xl, hx, V, out, n, n, dp, k, c);
  if (passes == 3) return tier_symmetric_by_kind<TIER3>(kind, a, s);
  if (passes == 1) return tier_symmetric_by_kind<TIER1>(kind, a, s);
  return (int)cudaErrorInvalidValue;
}
