// The Gram product for one data set on a triangle of float64 tiles, for
// Hopper (sm_90a).
//
//   K1c gram_comp_symmetric<KIND, KC, float>  replaces rlaopt_tpu/ops/
//       kernel_pallas.py :: kernel_matmat_pallas(compensated=True) when X2
//       is X1 (the true residual of a solve, the refinement's updates)
//   K3c gram_comp_symmetric<LAPLACE, KC, float>  replaces kernel_pallas.py
//       :: _laplace_matmat(compensated=True) when X2 is X1 (path A's final
//       residual, path B's boundaries)
//   K7 gram_comp_symmetric<KIND, KC, double>  replaces rlaopt_tpu/ops/
//       kernel_value64.py :: _value64_symmetric (the certified float64
//       sweep of refinement and of config 6's check)
//
// It computes c * k(X, X) @ V with the values formed in float64 from the
// float32 points: K1c and K3c take V in float32 and give a float32 pair
// (hi, lo), lo added last, the contract of the general K1c (gram.cu) and K3c
// (gram_laplace.cu); K7 takes V in float64 and gives float64, the contract
// of K8 (gram_f64.cu). The TPU has no float64, so the JAX package reaches
// ~3e-9 kernel values through two-float arithmetic (ops/twofloat.py); the
// H100 has FP64 units, and the error here is the float64 round-off of the
// sums. Every family: the squared-distance ones sum (x - y)^2 (a
// subtraction and an FMA a feature), Laplace sums |x - y| (a subtraction
// and an add of the absolute value, the same count).
//
// What bounds it on the H100: the FP64 instruction rate (64 a clock per SM,
// 34 TFLOP/s on the data sheet). Per kernel value: two float64 operations
// per feature, the family's epilogue in float64 (a software exp, ~20
// instructions), and 4k FMAs of contraction (each value serves both
// triangles). The general K1c evaluates every value twice (the full n x m
// square) and spends, per pair and feature, two conversions of the staged
// floats to double and a multiplication by the inverse lengthscale on top:
// 101.4 ms at n = 100,000, d = 28, k = 1, 25% of its bound. K7's first
// version was the shared triangle template in float64 (gram_common.cuh,
// kernel_tile<KIND>): a 4 x 4 register tile, those conversions and
// that multiplication per pair and feature, 8 right-hand sides a slice, and
// float64 V and sums throughout: 59.4 / 261.5 ms at n = 100,000, d = 28,
// k = 1 / 10, where this triangle took 41.1 / 133.7 ms as K1c.
//
// Design:
//   * the points are scaled by the lengthscale in float64 once per call by
//     the wrapper and handed over transposed, (dpad, npad) doubles, zero
//     padded to whole chunks of 16 features and tiles of 128 points; a pair
//     and feature then costs one subtraction and one FMA;
//   * the triangle: block (I, s, z) owns row tile I (128 points) and the
//     column tiles J = I + 16s .. I + 16s + 15 (J < nt); each tile pair is
//     evaluated once, contracted forward (K_IJ V_J into rows I) and, off the
//     diagonal, mirrored (K_IJ^T V_I into rows J); the diagonal tile is
//     contracted forward alone, so each value is counted once. KC right-hand
//     sides (1, 2 or 4) per launch slice z; more columns take more slices,
//     each evaluating its tiles again;
//   * register tile: a thread holds 8 x 8 values (rows 2 rg + {0, 1} + 32 i,
//     columns 16 w + 8 cg + j of its warp w, lane 2 rg + cg), 128 double
//     operations per 16 staged doubles read from shared memory (the 4 x 4
//     tile of the shared template: 32 per 8);
//   * the features reach shared memory by cp.async, 16 at a time, one chunk
//     ahead (two buffers), read as double2;
//   * the mirror's column sums stay within a warp (its 16 columns hold all
//     128 rows): a shuffle reduce-scatter over the 16 row groups, one
//     float64 atomicAdd per column and right-hand side a tile; the forward
//     row sums are reduced over the column pair of a lane (one shuffle) and
//     carried in registers over the strip, one float64 atomicAdd per row
//     and right-hand side a block;
//   * the sums go to a float64 (n, k) array zeroed first (K1c's scratch,
//     K7's output); a second pass scales by c and, for K1c, splits each sum
//     s into hi = (float)s, lo = (float)(s - hi). The float64 atomics make
//     the last bits of s change from run to run (about 1e-16 relative), far
//     under the 1e-10 the card checks hold;
//   * V's type (float for K1c, double for K7) is a template parameter: its
//     column tiles are staged in that type (8 KB more shared memory in
//     float64), and V_J and V_I are read from shared memory where they are
//     used, so that float64 V adds no live registers.
// Registers: 128 for the values, pinned by __launch_bounds__ (256 threads,
// one block an SM); the kernel reaches the 255 a thread may hold and spills
// a few hundred bytes (the build's -Xptxas -v log, chip_smoke.py's
// registers line): a smaller register tile is the next step.

#include "gram_common.cuh"

namespace {

constexpr int kCTile = 128;   // points per tile
constexpr int kCFeat = 16;    // features per staged chunk
constexpr int kCStrip = 16;   // column tiles a block walks
constexpr int kCThreads = 256;

template <typename VT>
struct __align__(16) CompSmem {
  double x[2][kCFeat][kCTile];  // the row tile's chunk, two buffers
  double y[2][kCFeat][kCTile];  // the column tile's chunk
  VT vj[2][4][kCTile];          // V of the column tile (two tiles), KC <= 4
  double vi[4][kCTile];         // V of the row tile
};

__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// One element of V (4 or 8 bytes), zero-filled when not valid.
template <typename VT>
__device__ __forceinline__ void cp_async_ca(VT* dst, const VT* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"((int)sizeof(VT)), "r"(valid ? (int)sizeof(VT) : 0));
}

// XT (dpad, npad) doubles: the scaled points, transposed. V (n, k) of type
// VT, acc (n, k) double, zeroed. c0: the slice's first right-hand side.
template <int KIND, int KC, typename VT>
__global__ void __launch_bounds__(kCThreads, 1)
    gram_comp_symmetric(const double* __restrict__ XT, const VT* __restrict__ V,
                        double* __restrict__ acc, int n, int npad, int dpad, int k,
                        int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CompSmem<VT>& sm = *reinterpret_cast<CompSmem<VT>*>(smem_raw);
  const int I = blockIdx.x;
  const int J0 = I + blockIdx.y * kCStrip;
  if (J0 >= nt) return;
  const int J1 = min(J0 + kCStrip, nt);
  const int c0 = blockIdx.z * KC;
  const int kc = min(KC, k - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane >> 1, cg = lane & 1;
  const int row0 = I * kCTile;
  const int chunks = dpad / kCFeat;
  // the thread's rows (2 rg + 32 (i / 2) + i % 2) and columns (16 warp +
  // 8 cg + j) within a tile
  const int rbase = 2 * rg, cbase = 16 * warp + 8 * cg;

  for (int e = tid; e < KC * kCTile; e += kCThreads) {
    const int c = e / kCTile, r = e % kCTile;
    sm.vi[c][r] = (row0 + r < n && c < kc) ? (double)V[(size_t)(row0 + r) * k + c0 + c] : 0.0;
  }

  const int steps = (J1 - J0) * chunks;
  // step st: tile J0 + st / chunks, features 16 (st % chunks) ..; buffer st % 2
  const auto load_step = [&](int st) {
    const int J = J0 + st / chunks, ch = st % chunks, buf = st & 1;
    const double* xs = XT + (size_t)ch * kCFeat * npad;
    // 16 features x 128 points of each side: 1,024 pieces of 16 bytes each
    for (int e = tid; e < kCFeat * kCTile / 2; e += kCThreads) {
      const int f = e / (kCTile / 2), q = 2 * (e % (kCTile / 2));
      cp_async16_cg(&sm.x[buf][f][q], xs + (size_t)f * npad + row0 + q);
      cp_async16_cg(&sm.y[buf][f][q], xs + (size_t)f * npad + J * kCTile + q);
    }
    if (ch == 0) {
      const int col0 = J * kCTile, vb = (J - J0) & 1;
      for (int e = tid; e < KC * kCTile; e += kCThreads) {
        const int c = e / kCTile, j = e % kCTile;
        const bool valid = col0 + j < n && c < kc;
        cp_async_ca(&sm.vj[vb][c][j], valid ? V + (size_t)(col0 + j) * k + c0 + c : V,
                    valid);
      }
    }
    asm volatile("cp.async.commit_group;\n");
  };

  double fwd[4][KC];  // forward row sums: rows i = 4 cg .. 4 cg + 3
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) fwd[i][c] = 0.0;
  double K[8][8];

  load_step(0);
  for (int st = 0; st < steps; ++st) {
    asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();
    if (st + 1 < steps) load_step(st + 1);
    const int J = J0 + st / chunks, ch = st % chunks, buf = st & 1;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) K[i][j] = 0.0;
    }
#pragma unroll 2
    for (int f = 0; f < kCFeat; ++f) {
      double a[8], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 x2 = *reinterpret_cast<const double2*>(&sm.x[buf][f][rbase + 32 * i]);
        a[2 * i] = x2.x;
        a[2 * i + 1] = x2.y;
        const double2 y2 = *reinterpret_cast<const double2*>(&sm.y[buf][f][cbase + 2 * i]);
        b[2 * i] = y2.x;
        b[2 * i + 1] = y2.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const double diff = a[i] - b[j];
          if constexpr (KIND == LAPLACE) {
            K[i][j] += fabs(diff);
          } else {
            K[i][j] = fma(diff, diff, K[i][j]);
          }
        }
    }
    if (ch != chunks - 1) continue;

    // epilogue: the values, zero past n
    const int col0 = J * kCTile, vb = (J - J0) & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool row_in = row0 + rbase + 32 * (i / 2) + (i & 1) < n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool inside = row_in && col0 + cbase + j < n;
        K[i][j] = inside ? finish_accurate<KIND>(K[i][j]) : 0.0;
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c >= kc) break;
      // forward: this thread's 8 rows over its 8 columns, then the lane
      // pair (cg 0, 1) reduce-scattered: cg keeps rows 4 cg .. 4 cg + 3
      double p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[i] = 0.0;
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i] = fma(K[i][j], (double)sm.vj[vb][c][cbase + j], p[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double send = cg ? p[i] : p[i + 4];
        const double keep = cg ? p[i + 4] : p[i];
        fwd[i][c] += keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      if (J == I) continue;
      // mirror: this thread's 8 columns over its 8 rows, reduce-scattered
      // over the 16 row groups (lane bits 4, 3, 2), then summed over bit 1
      double q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        q[j] = 0.0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          q[j] = fma(K[i][j], sm.vi[c][rbase + 32 * (i / 2) + (i & 1)], q[j]);
      }
#pragma unroll
      for (int step = 0; step < 3; ++step) {
        const int width = 4 >> step;
        const bool up = lane & (16 >> step);
#pragma unroll
        for (int j = 0; j < width; ++j) {
          const double send = up ? q[j] : q[j + width];
          const double keep = up ? q[j + width] : q[j];
          q[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16 >> step);
        }
      }
      q[0] += __shfl_xor_sync(0xffffffffu, q[0], 2);
      // column 4 (bit 4) + 2 (bit 3) + (bit 2) of the thread's 8
      const int j = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
      const int gc = col0 + cbase + j;
      if ((lane & 2) == 0 && gc < n) atomicAdd(&acc[(size_t)gc * k + c0 + c], q[0]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ii = 4 * cg + i;
    const int gr = row0 + rbase + 32 * (ii / 2) + (ii & 1);
    if (gr >= n) continue;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < kc) atomicAdd(&acc[(size_t)gr * k + c0 + c], fwd[i][c]);
  }
}

// The finishing pass over each float64 sum s: K1c's hi = (float)(c s), lo
// = (float)(c s - hi) (VT float), or K7's c s in place (VT double; hi and
// lo unused).
template <typename VT>
__global__ void __launch_bounds__(kThreads)
    gram_comp_finish(double* acc, float* hi, float* lo, size_t count, double c) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < count;
       i += (size_t)gridDim.x * kThreads) {
    const double s = acc[i] * c;
    if constexpr (sizeof(VT) == sizeof(double)) {
      acc[i] = s;
    } else {
      const float h = (float)s;
      hi[i] = h;
      lo[i] = (float)(s - (double)h);
    }
  }
}

template <int KIND, int KC, typename VT>
cudaError_t launch_comp_kc(const double* XT, const VT* V, double* acc, int n, int npad,
                           int dpad, int k, cudaStream_t s) {
  const int bytes = (int)sizeof(CompSmem<VT>);
  const cudaError_t err = cudaFuncSetAttribute(
      gram_comp_symmetric<KIND, KC, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nt = (n + kCTile - 1) / kCTile;
  const dim3 grid(nt, (nt + kCStrip - 1) / kCStrip, (k + KC - 1) / KC);
  gram_comp_symmetric<KIND, KC, VT><<<grid, kCThreads, bytes, s>>>(XT, V, acc, n, npad, dpad,
                                                                   k, nt);
  return cudaGetLastError();
}

// KC = 1, 2 or 4 right-hand sides a slice: the smallest that holds k, 4
// past that.
template <int KIND, typename VT>
cudaError_t launch_comp(const double* XT, const VT* V, double* acc, int n, int npad,
                        int dpad, int k, cudaStream_t s) {
  if (k > 2) return launch_comp_kc<KIND, 4>(XT, V, acc, n, npad, dpad, k, s);
  if (k > 1) return launch_comp_kc<KIND, 2>(XT, V, acc, n, npad, dpad, k, s);
  return launch_comp_kc<KIND, 1>(XT, V, acc, n, npad, dpad, k, s);
}

// Zero acc, sum every family's triangle into it, then the finishing pass.
template <typename VT>
int comp_symmetric(int kind, const void* XT, const void* V, double* acc, void* out,
                   void* out_lo, int n, int npad, int dpad, int k, double c,
                   cudaStream_t s) {
  if (n < 1 || k < 1 || dpad % kCFeat || npad % kCTile || npad < n)
    return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)n * k;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double) * count, s);
  if (err != cudaSuccess) return (int)err;
  const double* X = static_cast<const double*>(XT);
  const VT* Vt = static_cast<const VT*>(V);
  switch (kind) {
    case RBF: err = launch_comp<RBF>(X, Vt, acc, n, npad, dpad, k, s); break;
    case MATERN12: err = launch_comp<MATERN12>(X, Vt, acc, n, npad, dpad, k, s); break;
    case MATERN32: err = launch_comp<MATERN32>(X, Vt, acc, n, npad, dpad, k, s); break;
    case MATERN52: err = launch_comp<MATERN52>(X, Vt, acc, n, npad, dpad, k, s); break;
    case LAPLACE: err = launch_comp<LAPLACE>(X, Vt, acc, n, npad, dpad, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  size_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  gram_comp_finish<VT><<<(unsigned)blocks, kThreads, 0, s>>>(
      acc, static_cast<float*>(out), static_cast<float*>(out_lo), count, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes; launches on `stream`, does not
// synchronize, returns a CUDA error code (0 on success).

// K1c and K3c, triangle form: out + out_lo = c * k(X, X) @ V, kind the
// family code (LAPLACE 4). XT (dpad, npad)
// float64: the points divided by the lengthscale, transposed, zero past n
// and d, dpad a multiple of 16 and npad of 128; V (n, k) float32; acc (n,
// k) float64 scratch, zeroed here; out, out_lo (n, k) float32.
extern "C" int rl_gram_matvec_symmetric_comp(int kind, const void* XT, const void* V,
                                             void* acc, void* out, void* out_lo, int n,
                                             int npad, int dpad, int k, double c,
                                             void* stream) {
  return comp_symmetric<float>(kind, XT, V, static_cast<double*>(acc), out, out_lo, n, npad,
                               dpad, k, c, static_cast<cudaStream_t>(stream));
}

// K7: out = c * k(X, X) @ V in float64, the same operand XT; V and out (n,
// k) float64, out zeroed here.
extern "C" int rl_gram_matvec_symmetric_f64(int kind, const void* XT, const void* V,
                                            void* out, int n, int npad, int dpad, int k,
                                            double c, void* stream) {
  return comp_symmetric<double>(kind, XT, V, static_cast<double*>(out), nullptr, nullptr, n,
                                npad, dpad, k, c, static_cast<cudaStream_t>(stream));
}
