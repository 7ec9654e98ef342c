// Shared pieces of the fused Gram-matrix kernels (gram.cu, gram_laplace.cu,
// gram_tier.cu, gram_f64.cu, gram_comp.cu, and through gram_tile.cuh
// gram_wide.cu and gram_pair.cu): the operands of a launch, the float64
// tile generator and the narrow contraction of the general compensated and
// float64 kernels, templated on the kernel family and on a MODE:
//
//   COMP   K1c, K3c  unscaled f32 points, float64 inside a tile, f32 (hi, lo)
//   F64    K8        K1c's tile, carried to float64 end to end (V and out too)
//
// K1, K2, K3, K4, K5 and K6 run on the register tile of gram_tile.cuh
// (its forward, triangle and pair forms: gram.cu, gram_laplace.cu,
// gram_pair.cu), K1 and K3 past 16 columns on gram_wide.cu; K1b, K2b, K4b
// (gram_tier.cu), the triangle K1c and K7 (gram_comp.cu) have kernels of
// their own; they take the operands and sum_splits from here.
//
// Each translation unit includes this header and instantiates what it
// launches; everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows of X1 per block; columns of X2 per step
constexpr int kFeat = 16;   // features staged in shared memory per pass
constexpr int kDepth = 16;  // depth of one bf16 tensor-core step

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, LAPLACE = 4 };
enum Mode { COMP = 1, F64 = 2 };

// The operands of one launch. Points: X1 (n, d), X2 (m, d) float32,
// unscaled with inv_ls (d doubles) for COMP and F64.
// Tiers (gram_tier.cu): the bf16 parts X1h/X1l (n, dp) and X2h/X2l (m,
// dp), d = dp the padded depth, lo parts null on the one-pass tier, and the
// norm vectors hx (n), hy (m) of _norms_and_operands. V (m, k) and out (n,
// k) are float, or double for F64; out_lo is K1c's lo part. The triangle
// kernels pass X2 = X1, m = n.
// part and m_split: K1b's forward strip's runs of the m axis
// (gram_tier.cu); part holds (gridDim.y, n, k) float partials.
// V1 (n, k) and out2 (m, k): K4b's second product K^T V1.
// Vh, Vl (m, kp): V's bf16 parts for K1b past 16 columns, kp a multiple of
// 16 at or above k.
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
  const void* V1;
  void* out2;
  const __nv_bfloat16* Vh;
  const __nv_bfloat16* Vl;
  float* part;
  int n, m, d, k, kp;
  int m_split;
  double c;
};

// The staging buffers of the distance pass and the finished K tile (float64
// values) are never live at once, so they share memory.
union TileSmem {
  struct {
    float x[kFeat][kTile + 1];
    float y[kFeat][kTile + 1];
  } in;
  double k[kTile][kTile + 1];
};

template <int MODE> struct ModeTraits;
template <> struct ModeTraits<COMP> {
  using VT = float;   // V and out
  using Acc = float;  // accumulator across column tiles (hi, with lo beside it)
};
template <> struct ModeTraits<F64> {
  using VT = double;
  using Acc = double;
};

// Kernel value from the squared distance (the L1 distance for Laplace), in
// double, for COMP and F64.
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
// before the call) at once. Takes unscaled inputs, and the differences,
// their scaling by inv_ls (d doubles), the distance and the value in
// double. Laplace sums |x - y|.
template <int KIND>
__device__ __forceinline__ void kernel_tile(
    const float* __restrict__ A, const float* __restrict__ B,
    const double* __restrict__ inv_ls, int n_a, int n_b, int d, int row0,
    int col0, TileSmem& sm) {
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  double acc[4][4];
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
          const double diff = ((double)a[i] - (double)b[j]) * inv_ls[f0 + f];
          if constexpr (KIND == LAPLACE) {
            acc[i][j] += fabs(diff);
          } else {
            acc[i][j] = fma(diff, diff, acc[i][j]);
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
      sm.k[r][c] = inside ? finish_accurate<KIND>(acc[i][j]) : 0.0;
    }
  __syncthreads();
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

// K1c / K3c / K8 for KC <= 16 right-hand-side columns, those from
// KC * blockIdx.y on. Thread t owns output row t/4 and the columns
// j = 16*(t%4) .. +15 of each tile. With COMP the tile partial is completed
// across the quad and scaled by c in double, then split into a float pair and
// TwoSum-added. F64 contracts and accumulates in double.
template <int KIND, int KC, int MODE>
__global__ void __launch_bounds__(kThreads) gram_matmat_narrow(const GramArgs a) {
  using VT = typename ModeTraits<MODE>::VT;
  using Acc = typename ModeTraits<MODE>::Acc;
  __shared__ TileSmem sm;
  __shared__ VT vs[kTile][KC];
  const VT* __restrict__ V = static_cast<const VT*>(a.V);
  const int row0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * KC;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  Acc acc[KC];
  float lo[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    acc[i] = 0;
    lo[i] = 0.0f;
  }

  for (int col0 = 0; col0 < a.m; col0 += kTile) {
    stage_v<VT, KC>(V, a.m, a.k, col0, c0, vs);
    kernel_tile<KIND>(a.X1, a.X2, a.inv_ls, a.n, a.m, a.d, row0, col0, sm);
    double p[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i) p[i] = 0;
#pragma unroll 4
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int j = q * (kTile / 4) + jj;
      const double kv = sm.k[r][j];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        p[i] = fma(kv, (double)vs[j][i], p[i]);
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
        } else {
          out[(size_t)gr * a.k + gc] = (VT)(acc[i] * a.c);
        }
      }
    }
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

// The narrow kernel (COMP, F64) at the smallest KC that holds k <= 16
// columns, or 16 columns per blockIdx.y past that.
template <int KIND, int MODE>
void launch_narrow_by_k(const GramArgs& a, cudaStream_t s) {
  const unsigned rows = (a.n + kTile - 1) / kTile;
  if (a.k > 8) {
    launch_narrow<KIND, 16, MODE>(dim3(rows, (a.k + 15) / 16), a, s);
  } else if (a.k > 4) {
    launch_narrow<KIND, 8, MODE>(dim3(rows), a, s);
  } else if (a.k > 2) {
    launch_narrow<KIND, 4, MODE>(dim3(rows), a, s);
  } else if (a.k > 1) {
    launch_narrow<KIND, 2, MODE>(dim3(rows), a, s);
  } else {
    launch_narrow<KIND, 1, MODE>(dim3(rows), a, s);
  }
}

// The operands of a launch on points (K1c, K3c, K8).
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

}  // namespace
