// Shared pieces of the fused Gram-matrix kernels (gram.cu, gram_laplace.cu,
// gram_tier.cu, gram_f64.cu): the tile generators, the narrow (k <= 16) and
// wide contractions and the triangle schedule, each templated on the kernel
// family and on a MODE:
//
//   EXACT  K1, K2, K3, K5  f32 points pre-scaled by the lengthscale, f32 values
//   COMP   K1c, K3c  unscaled f32 points, float64 inside a tile, f32 (hi, lo)
//   F64    K7, K8    K1c's tile, carried to float64 end to end (V and out too)
//   TIER1  K1b, K2b  bf16 parts, one tensor-core pass (bfloat16 tier)
//   TIER3  K1b, K2b  bf16 hi/lo parts, three tensor-core passes (bf16x3)
//
// Each translation unit includes this header and instantiates what it
// launches; everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows of X1 per block; columns of X2 per step
constexpr int kFeat = 16;   // features staged in shared memory per pass
constexpr int kWide = 64;   // right-hand-side columns per block when k > 16
constexpr int kStrip = 16;  // column tiles per block in the triangle kernel
constexpr int kDepth = 16;  // depth of one bf16 tensor-core step
constexpr int kPartLd = kDepth + 8;  // row stride of a staged bf16 part
constexpr int kTierLd = kTile + 4;   // row stride of a tier K tile (floats)

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, LAPLACE = 4 };
enum Mode { EXACT = 0, COMP = 1, F64 = 2, TIER1 = 3, TIER3 = 4 };

__host__ __device__ constexpr bool is_tier(int mode) { return mode == TIER1 || mode == TIER3; }

// The operands of one launch. Points: X1 (n, d), X2 (m, d) float32,
// pre-scaled for EXACT, unscaled with inv_ls (d doubles) for COMP and F64.
// Tiers: the bf16 parts X1h/X1l (n, dp) and X2h/X2l (m, dp), d = dp the
// padded depth, lo parts null on TIER1, and the norm vectors hx (n), hy (m)
// of _norms_and_operands. V (m, k) and out (n, k) are float, or double for
// F64; out_lo is K1c's lo part. The triangle kernels pass X2 = X1, m = n.
// part and m_split: the narrow kernel's column splits (see
// launch_narrow_by_k); part holds (gridDim.z, n, k) float partials.
struct GramArgs {
  const float* X1;
  const float* X2;
  const double* inv_ls;
  const __nv_bfloat16* X1h;
  const __nv_bfloat16* X1l;
  const __nv_bfloat16* X2h;
  const __nv_bfloat16* X2l;
  const float* hx;
  const float* hy;
  const void* V;
  void* out;
  void* out_lo;
  float* part;
  int n, m, d, k;
  int m_split;
  double c;
};

// The staging buffers of the distance pass and the finished K tile are never
// live at once, so they share memory.
template <typename T>
union TileSmem {
  struct {
    float x[kFeat][kTile + 1];
    float y[kFeat][kTile + 1];
  } in;
  T k[kTile][kTile + 1];
};

// The tiers' tile: bf16 parts staged kDepth features at a time (raw bits),
// then the cross term and the kernel values in place as floats.
struct __align__(128) TierSmem {
  union {
    struct {
      uint16_t ah[kTile][kPartLd], al[kTile][kPartLd];
      uint16_t bh[kTile][kPartLd], bl[kTile][kPartLd];
    } in;
    float k[kTile][kTierLd];
  };
  float hx[kTile], hy[kTile];
};

template <int MODE> struct ModeTraits {
  using Val = float;  // kernel values and the contraction
  using VT = float;   // V and out
  using Acc = float;  // accumulator across column tiles
  using Smem = TileSmem<float>;
};
template <> struct ModeTraits<COMP> {
  using Val = double;
  using VT = float;
  using Acc = float;
  using Smem = TileSmem<double>;
};
template <> struct ModeTraits<F64> {
  using Val = double;
  using VT = double;
  using Acc = double;
  using Smem = TileSmem<double>;
};
template <> struct ModeTraits<TIER1> {
  using Val = float;
  using VT = float;
  using Acc = float;
  using Smem = TierSmem;
};
template <> struct ModeTraits<TIER3> : ModeTraits<TIER1> {};

// Kernel value from the squared distance (the L1 distance for Laplace).
template <int KIND>
__device__ __forceinline__ float finish(float d2) {
  if constexpr (KIND == RBF) {
    return expf(-0.5f * d2);
  } else if constexpr (KIND == LAPLACE) {
    return expf(-d2);
  } else {
    const float r = sqrtf(d2);
    if constexpr (KIND == MATERN12) {
      return expf(-r);
    } else if constexpr (KIND == MATERN32) {
      const float s3 = 1.7320508075688772f;
      return (1.0f + s3 * r) * expf(-s3 * r);
    } else {
      const float s5 = 2.23606797749979f;
      return (1.0f + s5 * r + (5.0f / 3.0f) * d2) * expf(-s5 * r);
    }
  }
}

// The same epilogue in double, for COMP and F64.
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

// Kernel value from the tier's cross term x.y and the norm vectors
// (_finish_dot): RBF exp(cross - hx - hy) with hx = |x|^2/2; the Matern
// family from max(hx + hy - 2 cross, 0) with hx = |x|^2, the 2 being the
// JAX package's X-operand scale, applied here to the cross term (exact).
template <int KIND>
__device__ __forceinline__ float finish_dot(float cross, float hx, float hy) {
  if constexpr (KIND == RBF) {
    return expf(cross - hx - hy);
  } else {
    return finish<KIND>(fmaxf(hx + hy - 2.0f * cross, 0.0f));
  }
}

// a * b + c, fused, in the type of the operands.
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// hi + lo += p, the rounding error carried in lo (Knuth TwoSum, as
// _twosum_accumulate in kernel_pallas.py). __fadd_rn is never contracted into
// an FMA, which would break the error term.
__device__ __forceinline__ void acc_two_sum(float& hi, float& lo, float p) {
  const float s = __fadd_rn(hi, p);
  const float z = __fadd_rn(s, -hi);
  const float e = __fadd_rn(__fadd_rn(hi, -__fadd_rn(s, -z)), __fadd_rn(p, -z));
  hi = s;
  lo = __fadd_rn(lo, e);
}

// K tile: sm.k[r][c] = k(A[row0 + r], B[col0 + c]), zero past n_a or n_b.
// Ends with a barrier, so the caller may read sm.k (and anything it staged
// before the call) at once. ACCURATE (COMP and F64) takes unscaled inputs,
// and the differences, their scaling by inv_ls (d doubles), the distance and
// the value in double; otherwise inv_ls is unused. Laplace sums |x - y|.
template <int KIND, bool ACCURATE>
__device__ __forceinline__ void kernel_tile(
    const float* __restrict__ A, const float* __restrict__ B,
    const double* __restrict__ inv_ls, int n_a, int n_b, int d, int row0,
    int col0, TileSmem<typename ModeTraits<ACCURATE ? COMP : EXACT>::Val>& sm) {
  using Val = typename ModeTraits<ACCURATE ? COMP : EXACT>::Val;
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  Val acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int f0 = 0; f0 < d; f0 += kFeat) {
    const int nf = min(kFeat, d - f0);
    for (int e = t; e < kTile * kFeat; e += kThreads) {
      const int r = e / kFeat, f = e % kFeat;
      const int ga = row0 + r, gb = col0 + r;
      sm.in.x[f][r] = (f < nf && ga < n_a) ? A[(size_t)ga * d + f0 + f] : 0.0f;
      sm.in.y[f][r] = (f < nf && gb < n_b) ? B[(size_t)gb * d + f0 + f] : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.in.x[f][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.in.y[f][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (ACCURATE) {
            const double diff = ((double)a[i] - (double)b[j]) * inv_ls[f0 + f];
            if constexpr (KIND == LAPLACE) {
              acc[i][j] += fabs(diff);
            } else {
              acc[i][j] = fma(diff, diff, acc[i][j]);
            }
          } else {
            const float diff = a[i] - b[j];
            if constexpr (KIND == LAPLACE) {
              acc[i][j] += fabsf(diff);
            } else {
              acc[i][j] = fmaf(diff, diff, acc[i][j]);
            }
          }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i, c = tx + 16 * j;
      const bool inside = (row0 + r < n_a) && (col0 + c < n_b);
      Val v = 0;
      if (inside) {
        if constexpr (ACCURATE) {
          v = finish_accurate<KIND>(acc[i][j]);
        } else {
          v = finish<KIND>(acc[i][j]);
        }
      }
      sm.k[r][c] = v;
    }
  __syncthreads();
}

// Stage rows [row0, row0 + 64) of the (n_p, dp) bf16 part P into dst, the
// kDepth features from f0 on, zero past n_p. Two 16-byte loads per row.
__device__ __forceinline__ void stage_part(const __nv_bfloat16* __restrict__ P,
                                           int n_p, int dp, int row0, int f0,
                                           int e, uint16_t (*dst)[kPartLd]) {
  const int r = e / 2, half = e % 2;
  const int g = row0 + r;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (g < n_p) {
    v = *reinterpret_cast<const uint4*>(P + (size_t)g * dp + f0 + half * 8);
  }
  *reinterpret_cast<uint4*>(&dst[r][half * 8]) = v;
}

// Tier K tile: sm.k[r][c] = finish_dot(cross(A_r, B_c)), zero past n_a or
// n_b, with the cross term on the tensor cores (bf16 in, f32 accumulate):
// hi.hi (+ hi.lo + lo.hi when PASSES == 3) over the padded depth. Each of
// the 8 warps owns a 16-row strip and two 16-column fragments of the 64x64
// tile. Ends with a barrier.
template <int KIND, int PASSES>
__device__ __forceinline__ void tier_tile(
    const __nv_bfloat16* __restrict__ Ah, const __nv_bfloat16* __restrict__ Al,
    const float* __restrict__ hx, const __nv_bfloat16* __restrict__ Bh,
    const __nv_bfloat16* __restrict__ Bl, const float* __restrict__ hy,
    int n_a, int n_b, int dp, int row0, int col0, TierSmem& sm) {
  using namespace nvcuda;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int fr = warp / 2, fc = (warp % 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  if (t < kTile) {
    sm.hx[t] = (row0 + t < n_a) ? hx[row0 + t] : 0.0f;
  } else if (t < 2 * kTile) {
    sm.hy[t - kTile] = (col0 + t - kTile < n_b) ? hy[col0 + t - kTile] : 0.0f;
  }
  for (int f0 = 0; f0 < dp; f0 += kDepth) {
    // 128 16-byte loads per part: threads 0..127 the hi parts, 128..255 lo
    if (t < 2 * kTile) {
      stage_part(Ah, n_a, dp, row0, f0, t, sm.in.ah);
      stage_part(Bh, n_b, dp, col0, f0, t, sm.in.bh);
    } else if (PASSES == 3) {
      stage_part(Al, n_a, dp, row0, f0, t - 2 * kTile, sm.in.al);
      stage_part(Bl, n_b, dp, col0, f0, t - 2 * kTile, sm.in.bl);
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a_hi, a_lo;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b_hi, b_lo;
    wmma::load_matrix_sync(
        a_hi, reinterpret_cast<const __nv_bfloat16*>(&sm.in.ah[fr * 16][0]), kPartLd);
    if constexpr (PASSES == 3) {
      wmma::load_matrix_sync(
          a_lo, reinterpret_cast<const __nv_bfloat16*>(&sm.in.al[fr * 16][0]), kPartLd);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // B^T as a column-major matrix_b: element (f, c) = B[c][f]
      wmma::load_matrix_sync(
          b_hi, reinterpret_cast<const __nv_bfloat16*>(&sm.in.bh[(fc + j) * 16][0]),
          kPartLd);
      wmma::mma_sync(acc[j], a_hi, b_hi, acc[j]);
      if constexpr (PASSES == 3) {
        wmma::load_matrix_sync(
            b_lo, reinterpret_cast<const __nv_bfloat16*>(&sm.in.bl[(fc + j) * 16][0]),
            kPartLd);
        wmma::mma_sync(acc[j], a_hi, b_lo, acc[j]);
        wmma::mma_sync(acc[j], a_lo, b_hi, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(&sm.k[fr * 16][(fc + j) * 16], acc[j], kTierLd,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = t; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const bool inside = (row0 + r < n_a) && (col0 + c < n_b);
    sm.k[r][c] = inside ? finish_dot<KIND>(sm.k[r][c], sm.hx[r], sm.hy[c]) : 0.0f;
  }
  __syncthreads();
}

// The K tile of a launch, by MODE: rows from X1, columns from X2.
template <int KIND, int MODE>
__device__ __forceinline__ void make_tile(const GramArgs& a, int row0, int col0,
                                          typename ModeTraits<MODE>::Smem& sm) {
  if constexpr (is_tier(MODE)) {
    tier_tile<KIND, MODE == TIER3 ? 3 : 1>(a.X1h, a.X1l, a.hx, a.X2h, a.X2l, a.hy,
                                         a.n, a.m, a.d, row0, col0, sm);
  } else {
    kernel_tile<KIND, MODE != EXACT>(a.X1, a.X2, a.inv_ls, a.n, a.m, a.d, row0,
                                     col0, sm);
  }
}

// Stage rows [row0, row0 + 64) and columns [c0, c0 + KC) of V (n_v, k) into
// vs, zero past the edges.
template <typename T, int KC>
__device__ __forceinline__ void stage_v(const T* __restrict__ V, int n_v, int k,
                                        int row0, int c0, T (*vs)[KC]) {
  for (int e = threadIdx.x; e < kTile * KC; e += kThreads) {
    const int j = e / KC, c = e % KC;
    const int gj = row0 + j, gc = c0 + c;
    vs[j][c] = (gj < n_v && gc < k) ? V[(size_t)gj * k + gc] : T(0);
  }
}

// Sum a per-thread vector over the 4 adjacent lanes that share an output row.
template <typename T, int KC>
__device__ __forceinline__ void reduce_quad(T (&v)[KC]) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    v[c] += __shfl_xor_sync(0xffffffffu, v[c], 1);
    v[c] += __shfl_xor_sync(0xffffffffu, v[c], 2);
  }
}

// a * b by the tier's mirror contraction at k >= 3 (_sym_mirror_mode):
// "split" (PASSES 3: hi.hi + hi.lo + lo.hi of both operands' bf16 parts) or
// "fast" (PASSES 1: one product of bf16 values); each product of bf16 values
// is exact in float.
template <int PASSES>
__device__ __forceinline__ float tier_mul(float a, float b) {
  const float ah = __bfloat162float(__float2bfloat16_rn(a));
  const float bh = __bfloat162float(__float2bfloat16_rn(b));
  if constexpr (PASSES == 1) {
    return ah * bh;
  } else {
    const float al = __bfloat162float(__float2bfloat16_rn(a - ah));
    const float bl = __bfloat162float(__float2bfloat16_rn(b - bh));
    return fmaf(ah, bh, fmaf(ah, bl, al * bh));
  }
}

// K1 / K1c / K1b / K3 / K8 for KC <= 16 right-hand-side columns, those from
// KC * blockIdx.y on. Thread t owns output row t/4 and the columns
// j = 16*(t%4) .. +15 of each tile. With COMP the tile partial is completed
// across the quad and scaled by c in double, then split into a float pair and
// TwoSum-added. F64 contracts and accumulates in double. Block z walks the
// columns [z * m_split, (z + 1) * m_split); with more than one split (EXACT
// only) it writes its unscaled float partial to part[z] for sum_splits.
template <int KIND, int KC, int MODE>
__global__ void __launch_bounds__(kThreads) gram_matmat_narrow(const GramArgs a) {
  using Tr = ModeTraits<MODE>;
  using Val = typename Tr::Val;
  using VT = typename Tr::VT;
  using Acc = typename Tr::Acc;
  __shared__ typename Tr::Smem sm;
  __shared__ VT vs[kTile][KC];
  const VT* __restrict__ V = static_cast<const VT*>(a.V);
  const int row0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * KC;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  const int col_begin = blockIdx.z * a.m_split;
  const int col_end = min(a.m, col_begin + a.m_split);
  Acc acc[KC];
  float lo[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    acc[i] = 0;
    lo[i] = 0.0f;
  }

  for (int col0 = col_begin; col0 < col_end; col0 += kTile) {
    stage_v<VT, KC>(V, a.m, a.k, col0, c0, vs);
    make_tile<KIND, MODE>(a, row0, col0, sm);
    Val p[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i) p[i] = 0;
#pragma unroll 4
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int j = q * (kTile / 4) + jj;
      const Val kv = sm.k[r][j];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        p[i] = madd(kv, (Val)vs[j][i], p[i]);
      }
    }
    if constexpr (MODE == COMP) {
      reduce_quad<double, KC>(p);
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const double ps = p[i] * a.c;
        const float ph = (float)ps;
        acc_two_sum(acc[i], lo[i], ph);
        lo[i] = __fadd_rn(lo[i], (float)(ps - (double)ph));
      }
    } else {
#pragma unroll
      for (int i = 0; i < KC; ++i) acc[i] += p[i];
    }
    __syncthreads();
  }
  if constexpr (MODE != COMP) reduce_quad<Acc, KC>(acc);
  const int gr = row0 + r;
  if (q == 0 && gr < a.n) {
    VT* __restrict__ out = static_cast<VT*>(a.out);
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int gc = c0 + i;
      if (gc < a.k) {
        if constexpr (MODE == COMP) {
          out[(size_t)gr * a.k + gc] = acc[i];
          static_cast<float*>(a.out_lo)[(size_t)gr * a.k + gc] = lo[i];
        } else if constexpr (MODE == EXACT) {
          if (gridDim.z > 1) {
            a.part[((size_t)blockIdx.z * a.n + gr) * a.k + gc] = acc[i];
          } else {
            out[(size_t)gr * a.k + gc] = (VT)(acc[i] * a.c);
          }
        } else {
          out[(size_t)gr * a.k + gc] = (VT)(acc[i] * a.c);
        }
      }
    }
  }
}

// K2 / K2b / K7: the triangle kernel. Block (I, s, z) takes row tile I, the
// column tiles J = I + 16s .. I + 16s + 15 (J < nt) and the right-hand-side
// columns from KC * z on. Each tile K_IJ is evaluated once: K_IJ V_J
// accumulates in registers for out[I]; for J != I, K_IJ^T V_I goes to out[J]
// at once. Cross-block sums use atomicAdd (float, or double for F64) into an
// output zeroed before the launch, so the order of the additions, and with
// it the last bits of the result, changes from run to run (about one
// rounding per addition). The tiers' mirror takes the tier-matched
// contraction at k >= 3 (KC >= 4), as _sym_mirror_mode.
template <int KIND, int KC, int MODE>
__global__ void __launch_bounds__(kThreads)
    gram_matvec_symmetric(const GramArgs a, int nt) {
  using Tr = ModeTraits<MODE>;
  using Val = typename Tr::Val;
  using VT = typename Tr::VT;
  constexpr bool kTierMirror = is_tier(MODE) && KC >= 4;
  const int I = blockIdx.x;
  const int J0 = I + blockIdx.y * kStrip;
  if (J0 >= nt) return;
  const int J1 = min(J0 + kStrip, nt);
  const int c0 = blockIdx.z * KC;
  __shared__ typename Tr::Smem sm;
  __shared__ VT vj[kTile][KC];
  __shared__ VT vi[kTile][KC];
  const VT* __restrict__ V = static_cast<const VT*>(a.V);
  VT* __restrict__ out = static_cast<VT*>(a.out);
  const VT c = (VT)a.c;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  Val acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = 0;
  stage_v<VT, KC>(V, a.n, a.k, I * kTile, c0, vi);

  for (int J = J0; J < J1; ++J) {
    stage_v<VT, KC>(V, a.n, a.k, J * kTile, c0, vj);
    make_tile<KIND, MODE>(a, I * kTile, J * kTile, sm);
#pragma unroll 4
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int j = q * (kTile / 4) + jj;
      const Val kv = sm.k[r][j];
#pragma unroll
      for (int i = 0; i < KC; ++i) acc[i] = madd(kv, vj[j][i], acc[i]);
    }
    if (J != I) {
      // mirror: thread t owns column t/4 of the tile, rows 16*(t%4) .. +15
      Val mir[KC];
#pragma unroll
      for (int i = 0; i < KC; ++i) mir[i] = 0;
#pragma unroll 4
      for (int rr = 0; rr < kTile / 4; ++rr) {
        const int ri = q * (kTile / 4) + rr;
        const Val kv = sm.k[ri][r];
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if constexpr (kTierMirror) {
            mir[i] += tier_mul<MODE == TIER3 ? 3 : 1>(kv, vi[ri][i]);
          } else {
            mir[i] = madd(kv, vi[ri][i], mir[i]);
          }
        }
      }
      reduce_quad<Val, KC>(mir);
      const int gj = J * kTile + r;
      if (q == 0 && gj < a.n) {
#pragma unroll
        for (int i = 0; i < KC; ++i)
          if (c0 + i < a.k) atomicAdd(&out[(size_t)gj * a.k + c0 + i], mir[i] * c);
      }
    }
    __syncthreads();
  }
  reduce_quad<Val, KC>(acc);
  const int gr = I * kTile + r;
  if (q == 0 && gr < a.n) {
#pragma unroll
    for (int i = 0; i < KC; ++i)
      if (c0 + i < a.k) atomicAdd(&out[(size_t)gr * a.k + c0 + i], acc[i] * c);
  }
}

template <int KIND, int KC, int MODE>
void launch_narrow(dim3 grid, const GramArgs& a, cudaStream_t s) {
  gram_matmat_narrow<KIND, KC, MODE><<<grid, kThreads, 0, s>>>(a);
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

// The narrow kernel at the smallest KC that holds k <= 16 columns, or 16
// columns per blockIdx.y past that (COMP, F64). splits > 1 (EXACT, k <= 16,
// a.part holding splits * n * k floats) cuts the m axis into that many runs
// of whole column tiles on blockIdx.z, for grid fill when n is small (a
// 10,000-row block oracle is 157 row tiles on 132 SMs), and sums the
// partials with sum_splits.
template <int KIND, int MODE>
void launch_narrow_by_k(const GramArgs& args, cudaStream_t s, int splits = 1) {
  GramArgs a = args;
  const int tiles = (a.m + kTile - 1) / kTile;
  if (MODE != EXACT || splits < 1 || a.part == nullptr) splits = 1;
  if (splits > tiles) splits = tiles;
  a.m_split = ((tiles + splits - 1) / splits) * kTile;
  splits = (a.m + a.m_split - 1) / a.m_split;
  const unsigned rows = (a.n + kTile - 1) / kTile;
  const unsigned z = splits;
  if (a.k > 8) {
    launch_narrow<KIND, 16, MODE>(dim3(rows, (a.k + 15) / 16, z), a, s);
  } else if (a.k > 4) {
    launch_narrow<KIND, 8, MODE>(dim3(rows, 1, z), a, s);
  } else if (a.k > 2) {
    launch_narrow<KIND, 4, MODE>(dim3(rows, 1, z), a, s);
  } else if (a.k > 1) {
    launch_narrow<KIND, 2, MODE>(dim3(rows, 1, z), a, s);
  } else {
    launch_narrow<KIND, 1, MODE>(dim3(rows, 1, z), a, s);
  }
  if (splits > 1) {
    const size_t count = (size_t)a.n * a.k;
    size_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    sum_splits<<<(unsigned)blocks, kThreads, 0, s>>>(a.part, static_cast<float*>(a.out),
                                           splits, count, a.c);
  }
}

// K1 and K3 for k > 16: block (bx, by) owns rows 64*bx.. and right-hand-side
// columns 64*by..; thread (ty, tx) owns rows 4*ty.. and columns 4*tx.. .
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    gram_matmat_wide(const float* __restrict__ X1, const float* __restrict__ X2,
                     const float* __restrict__ V, float* __restrict__ out, int n,
                     int m, int d, int k, double c) {
  __shared__ TileSmem<float> sm;
  __shared__ __align__(16) float vs[kTile][kWide];
  const int row0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kWide;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int col0 = 0; col0 < m; col0 += kTile) {
    stage_v<float, kWide>(V, m, k, col0, c0, vs);
    kernel_tile<KIND, false>(X1, X2, nullptr, n, m, d, row0, col0, sm);
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.k[ty * 4 + i][j];
      const float4 b4 = *reinterpret_cast<const float4*>(&vs[j][tx * 4]);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jc = 0; jc < 4; ++jc) p[i][jc] = fmaf(a[i], b[jc], p[i][jc]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += p[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + tx * 4 + j;
      if (gc < k) out[(size_t)gr * k + gc] = (float)(acc[i][j] * c);
    }
  }
}

// K1 / K3 (wide past 16 columns, narrow with column splits up to 16) and
// K1c (narrow, 16 columns per blockIdx.y past 16).
template <int KIND, bool COMPENSATED>
void launch_matmat(const GramArgs& a, cudaStream_t s, int splits) {
  if (!COMPENSATED && a.k > 16) {
    const dim3 grid((a.n + kTile - 1) / kTile, (a.k + kWide - 1) / kWide);
    gram_matmat_wide<KIND><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a.X1), static_cast<const float*>(a.X2),
        static_cast<const float*>(a.V), static_cast<float*>(a.out), a.n, a.m,
        a.d, a.k, a.c);
  } else {
    launch_narrow_by_k<KIND, COMPENSATED ? COMP : EXACT>(a, s, COMPENSATED ? 1 : splits);
  }
}

// The operands of a launch on points (K1, K1c, K3, K3c, K2, K5, K7, K8).
GramArgs points_args(const void* X1, const void* X2, const void* inv_ls,
                     const void* V, void* out, void* out_lo, int n, int m,
                     int d, int k, double c) {
  GramArgs a{};
  a.X1 = static_cast<const float*>(X1);
  a.X2 = static_cast<const float*>(X2);
  a.inv_ls = static_cast<const double*>(inv_ls);
  a.V = V;
  a.out = out;
  a.out_lo = out_lo;
  a.n = n;
  a.m = m;
  a.d = d;
  a.k = k;
  a.c = c;
  return a;
}

// The triangle kernel at the smallest KC that holds k <= MAX_KC columns, or
// MAX_KC columns per blockIdx.z past that.
template <int KIND, int MODE, int MAX_KC>
void launch_symmetric(const GramArgs& a, cudaStream_t s) {
  const int nt = (a.n + kTile - 1) / kTile;
  const dim3 block(kThreads);
  const auto grid = [&](int kc) {
    return dim3(nt, (nt + kStrip - 1) / kStrip, (a.k + kc - 1) / kc);
  };
  if (a.k > 8 && MAX_KC >= 16) {
    gram_matvec_symmetric<KIND, (MAX_KC >= 16 ? 16 : MAX_KC), MODE>
        <<<grid(16), block, 0, s>>>(a, nt);
  } else if (a.k > 4) {
    gram_matvec_symmetric<KIND, 8, MODE><<<grid(8), block, 0, s>>>(a, nt);
  } else if (a.k > 2) {
    gram_matvec_symmetric<KIND, 4, MODE><<<grid(4), block, 0, s>>>(a, nt);
  } else if (a.k > 1) {
    gram_matvec_symmetric<KIND, 2, MODE><<<grid(2), block, 0, s>>>(a, nt);
  } else {
    gram_matvec_symmetric<KIND, 1, MODE><<<grid(1), block, 0, s>>>(a, nt);
  }
}

}  // namespace
