// Fused Gram-matrix products for kernel ridge regression, for Hopper (sm_90a).
//
// Three kernels compute out = c * k(X1, X2) @ V without K ever reaching device
// memory. K1 and K2 take inputs pre-scaled by the lengthscale (the Python
// wrapper divides, as rlaopt_tpu/ops/kernel_pallas.py does before its
// pallas_call); K1c takes them unscaled, with the inverse lengthscale.
// Families: rbf, matern12, matern32, matern52 (the squared-distance family;
// Laplace is not ported yet). Float32 only, exact tier.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // rows of X1 per block; columns of X2 per step
constexpr int kFeat = 16;   // features staged in shared memory per pass
constexpr int kWide = 64;   // right-hand-side columns per block when k > 16
constexpr int kStrip = 16;  // column tiles per block in the triangle kernel

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

// Kernel values are float in K1 and K2, double in K1c.
template <bool ACCURATE> struct ValType { using type = float; };
template <> struct ValType<true> { using type = double; };

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

template <int KIND>
__device__ __forceinline__ float finish(float d2) {
  if constexpr (KIND == RBF) {
    return expf(-0.5f * d2);
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

// The same epilogue in double, for the compensated tier.
template <int KIND>
__device__ __forceinline__ double finish_accurate(double d2) {
  if constexpr (KIND == RBF) {
    return exp(-0.5 * d2);
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
// before the call) at once. ACCURATE (the compensated tier) takes unscaled
// inputs, and the differences, their scaling by inv_ls (d doubles), the
// squared distance and the value in double; otherwise inv_ls is unused.
template <int KIND, bool ACCURATE>
__device__ __forceinline__ void kernel_tile(
    const float* __restrict__ A, const float* __restrict__ B,
    const double* __restrict__ inv_ls, int n_a, int n_b, int d, int row0,
    int col0, TileSmem<typename ValType<ACCURATE>::type>& sm) {
  using Val = typename ValType<ACCURATE>::type;
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
            acc[i][j] = fma(diff, diff, acc[i][j]);
          } else {
            const float diff = a[i] - b[j];
            acc[i][j] = fmaf(diff, diff, acc[i][j]);
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

// Stage rows [row0, row0 + 64) and columns [c0, c0 + KC) of V (n_v, k) into
// vs, zero past the edges.
template <int KC>
__device__ __forceinline__ void stage_v(const float* __restrict__ V, int n_v,
                                        int k, int row0, int c0,
                                        float (*vs)[KC]) {
  for (int e = threadIdx.x; e < kTile * KC; e += kThreads) {
    const int j = e / KC, c = e % KC;
    const int gj = row0 + j, gc = c0 + c;
    vs[j][c] = (gj < n_v && gc < k) ? V[(size_t)gj * k + gc] : 0.0f;
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

// K1 / K1c for KC <= 16 right-hand-side columns, those from KC * blockIdx.y
// on. Thread t owns output row t/4 and the columns j = 16*(t%4) .. +15 of
// each tile. With COMP the tile partial is completed across the quad and
// scaled by c in double, then split into a float pair and TwoSum-added.
template <int KIND, int KC, bool COMP>
__global__ void __launch_bounds__(kThreads)
    gram_matmat_narrow(const float* __restrict__ X1, const float* __restrict__ X2,
                       const float* __restrict__ V,
                       const double* __restrict__ inv_ls,
                       float* __restrict__ out, float* __restrict__ out_lo,
                       int n, int m, int d, int k, double c) {
  using Val = typename ValType<COMP>::type;
  __shared__ TileSmem<Val> sm;
  __shared__ float vs[kTile][KC];
  const int row0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * KC;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  float acc[KC], lo[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = lo[i] = 0.0f;

  for (int col0 = 0; col0 < m; col0 += kTile) {
    stage_v<KC>(V, m, k, col0, c0, vs);
    kernel_tile<KIND, COMP>(X1, X2, inv_ls, n, m, d, row0, col0, sm);
    Val p[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i) p[i] = 0;
#pragma unroll 4
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int j = q * (kTile / 4) + jj;
      const Val kv = sm.k[r][j];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if constexpr (COMP) {
          p[i] = fma(kv, (double)vs[j][i], p[i]);
        } else {
          p[i] = fmaf(kv, vs[j][i], p[i]);
        }
      }
    }
    if constexpr (COMP) {
      reduce_quad<double, KC>(p);
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const double ps = p[i] * c;
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
  if constexpr (!COMP) reduce_quad<float, KC>(acc);
  const int gr = row0 + r;
  if (q == 0 && gr < n) {
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int gc = c0 + i;
      if (gc < k) {
        if constexpr (COMP) {
          out[(size_t)gr * k + gc] = acc[i];
          out_lo[(size_t)gr * k + gc] = lo[i];
        } else {
          out[(size_t)gr * k + gc] = (float)(acc[i] * c);
        }
      }
    }
  }
}

// K1 for k > 16: block (bx, by) owns rows 64*bx.. and right-hand-side
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
    stage_v<kWide>(V, m, k, col0, c0, vs);
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

// K2: the triangle kernel. Block (I, s) takes row tile I and the column tiles
// J = I + 16s .. I + 16s + 15 (J < nt). Each tile K_IJ is evaluated once:
// K_IJ V_J accumulates in registers for out[I]; for J != I, K_IJ^T V_I goes to
// out[J] at once. Cross-block sums use fp32 atomicAdd into an output zeroed
// before the launch, so the order of the additions, and with it the last bits
// of the result, changes from run to run (about one rounding per addition,
// ~1e-7 relative). No cap on n or k <= 16 beyond the grid's.
template <int KIND, int KC>
__global__ void __launch_bounds__(kThreads)
    gram_matvec_symmetric(const float* __restrict__ X,
                          const float* __restrict__ V, float* __restrict__ out,
                          int n, int d, int k, float c, int nt) {
  const int I = blockIdx.x;
  const int J0 = I + blockIdx.y * kStrip;
  if (J0 >= nt) return;
  const int J1 = min(J0 + kStrip, nt);
  __shared__ TileSmem<float> sm;
  __shared__ float vj[kTile][KC];
  __shared__ float vi[kTile][KC];
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  float acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = 0.0f;
  stage_v<KC>(V, n, k, I * kTile, 0, vi);

  for (int J = J0; J < J1; ++J) {
    stage_v<KC>(V, n, k, J * kTile, 0, vj);
    kernel_tile<KIND, false>(X, X, nullptr, n, n, d, I * kTile, J * kTile, sm);
#pragma unroll 4
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int j = q * (kTile / 4) + jj;
      const float kv = sm.k[r][j];
#pragma unroll
      for (int i = 0; i < KC; ++i) acc[i] = fmaf(kv, vj[j][i], acc[i]);
    }
    if (J != I) {
      // mirror: thread t owns column t/4 of the tile, rows 16*(t%4) .. +15
      float mir[KC];
#pragma unroll
      for (int i = 0; i < KC; ++i) mir[i] = 0.0f;
#pragma unroll 4
      for (int rr = 0; rr < kTile / 4; ++rr) {
        const int ri = q * (kTile / 4) + rr;
        const float kv = sm.k[ri][r];
#pragma unroll
        for (int i = 0; i < KC; ++i) mir[i] = fmaf(kv, vi[ri][i], mir[i]);
      }
      reduce_quad<float, KC>(mir);
      const int gj = J * kTile + r;
      if (q == 0 && gj < n) {
#pragma unroll
        for (int i = 0; i < KC; ++i)
          if (i < k) atomicAdd(&out[(size_t)gj * k + i], mir[i] * c);
      }
    }
    __syncthreads();
  }
  reduce_quad<float, KC>(acc);
  const int gr = I * kTile + r;
  if (q == 0 && gr < n) {
#pragma unroll
    for (int i = 0; i < KC; ++i)
      if (i < k) atomicAdd(&out[(size_t)gr * k + i], acc[i] * c);
  }
}

// The operands of one K1 or K1c call (inv_ls and out_lo are null for K1).
struct MatmatArgs {
  const float* X1;
  const float* X2;
  const float* V;
  const double* inv_ls;
  float* out;
  float* out_lo;
  int n, m, d, k;
  double c;
};

template <int KIND, int KC, bool COMP>
void launch_narrow(dim3 grid, const MatmatArgs& a, cudaStream_t s) {
  gram_matmat_narrow<KIND, KC, COMP><<<grid, kThreads, 0, s>>>(
      a.X1, a.X2, a.V, a.inv_ls, a.out, a.out_lo, a.n, a.m, a.d, a.k, a.c);
}

template <int KIND, bool COMP>
void launch_matmat(const MatmatArgs& a, cudaStream_t s) {
  const unsigned rows = (a.n + kTile - 1) / kTile;
  if (a.k > 16) {
    if constexpr (COMP) {
      launch_narrow<KIND, 16, true>(dim3(rows, (a.k + 15) / 16), a, s);
    } else {
      const dim3 grid(rows, (a.k + kWide - 1) / kWide);
      gram_matmat_wide<KIND><<<grid, kThreads, 0, s>>>(
          a.X1, a.X2, a.V, a.out, a.n, a.m, a.d, a.k, a.c);
    }
  } else if (a.k > 8) {
    launch_narrow<KIND, 16, COMP>(dim3(rows), a, s);
  } else if (a.k > 4) {
    launch_narrow<KIND, 8, COMP>(dim3(rows), a, s);
  } else if (a.k > 2) {
    launch_narrow<KIND, 4, COMP>(dim3(rows), a, s);
  } else if (a.k > 1) {
    launch_narrow<KIND, 2, COMP>(dim3(rows), a, s);
  } else {
    launch_narrow<KIND, 1, COMP>(dim3(rows), a, s);
  }
}

template <int KIND>
void launch_symmetric(const float* X, const float* V, float* out, int n, int d,
                      int k, float c, cudaStream_t s) {
  const int nt = (n + kTile - 1) / kTile;
  const dim3 grid(nt, (nt + kStrip - 1) / kStrip);
  const dim3 block(kThreads);
  if (k > 8) {
    gram_matvec_symmetric<KIND, 16><<<grid, block, 0, s>>>(X, V, out, n, d, k, c, nt);
  } else if (k > 4) {
    gram_matvec_symmetric<KIND, 8><<<grid, block, 0, s>>>(X, V, out, n, d, k, c, nt);
  } else if (k > 2) {
    gram_matvec_symmetric<KIND, 4><<<grid, block, 0, s>>>(X, V, out, n, d, k, c, nt);
  } else if (k > 1) {
    gram_matvec_symmetric<KIND, 2><<<grid, block, 0, s>>>(X, V, out, n, d, k, c, nt);
  } else {
    gram_matvec_symmetric<KIND, 1><<<grid, block, 0, s>>>(X, V, out, n, d, k, c, nt);
  }
}

template <bool COMP>
int matmat_by_kind(int kind, const MatmatArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: launch_matmat<RBF, COMP>(a, s); break;
    case MATERN12: launch_matmat<MATERN12, COMP>(a, s); break;
    case MATERN32: launch_matmat<MATERN32, COMP>(a, s); break;
    case MATERN52: launch_matmat<MATERN52, COMP>(a, s); break;
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
extern "C" int rl_gram_matmat(int kind, const void* X1, const void* X2,
                              const void* V, void* out, int n, int m, int d,
                              int k, double c, void* stream) {
  const MatmatArgs a{static_cast<const float*>(X1),
                     static_cast<const float*>(X2),
                     static_cast<const float*>(V),
                     nullptr,
                     static_cast<float*>(out),
                     nullptr,
                     n, m, d, k, c};
  return matmat_by_kind<false>(kind, a, static_cast<cudaStream_t>(stream));
}

// K1c: the same product as out + out_lo (out_lo added last), from unscaled
// X1 and X2 and the inverse lengthscale inv_ls (d doubles).
extern "C" int rl_gram_matmat_comp(int kind, const void* X1, const void* X2,
                                   const void* V, const void* inv_ls,
                                   void* out, void* out_lo, int n, int m,
                                   int d, int k, double c, void* stream) {
  const MatmatArgs a{static_cast<const float*>(X1),
                     static_cast<const float*>(X2),
                     static_cast<const float*>(V),
                     static_cast<const double*>(inv_ls),
                     static_cast<float*>(out),
                     static_cast<float*>(out_lo),
                     n, m, d, k, c};
  return matmat_by_kind<true>(kind, a, static_cast<cudaStream_t>(stream));
}

// X (n, d), V (n, k) with k <= 16, out (n, k); out is zeroed here first.
extern "C" int rl_gram_matvec_symmetric(int kind, const void* X, const void* V,
                                        void* out, int n, int d, int k, double c,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const float* v = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  const float cf = (float)c;
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return (int)err;
  switch (kind) {
    case RBF: launch_symmetric<RBF>(x, v, o, n, d, k, cf, s); break;
    case MATERN12: launch_symmetric<MATERN12>(x, v, o, n, d, k, cf, s); break;
    case MATERN32: launch_symmetric<MATERN32>(x, v, o, n, d, k, cf, s); break;
    case MATERN52: launch_symmetric<MATERN52>(x, v, o, n, d, k, cf, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
