// The Gram product on float64 tiles, in three forms, for Hopper (sm_90a).
//
//   triangle  gram_comp_symmetric<KIND, KC, VT>: one data set, each pair of
//             tiles once, contracted both ways
//     K1c (VT float)  replaces rlaopt_tpu/ops/kernel_pallas.py ::
//         kernel_matmat_pallas(compensated=True) when X2 is X1 (the true
//         residual of a solve, the refinement's updates)
//     K3c (LAPLACE)   replaces kernel_pallas.py :: _laplace_matmat(
//         compensated=True) when X2 is X1 (path A's final residual, path
//         B's boundaries)
//     K7 (VT double)  replaces rlaopt_tpu/ops/kernel_value64.py ::
//         _value64_symmetric (the certified float64 sweep)
//   forward   gram_comp_forward<KIND, 16, VT>: two data sets, the whole
//             rectangle contracted forward
//     K1c, K3c (VT float) replace the same two TPU kernels for two data
//         sets (the sharded replicated slabs and general ring, the
//         oracles' submatrices)
//     K8 (VT double)  replaces kernel_value64.py :: kernel_matmat_value64
//         (rectangular form; config 6's sampled certificate)
//   pair      gram_comp_pair<KIND, KC, VT>: two shards of one data set, each
//             value once for c K(X1, X2) V2 and c K(X1, X2)^T V1 (the
//             certified routes of the sharded half-ring; the JAX package
//             sweeps every ordered shard pair there)
//
// It computes c * k(X1, X2) @ V with the values formed in float64 from the
// float32 points: with float32 V (K1c, K3c) the forward and triangle forms
// give a float32 pair (hi, lo), lo added last, and the pair gives its
// float64 sums; with float64 V (K7, K8) every form gives float64. The TPU
// has no float64, so the JAX package reaches ~3e-9 kernel values through
// two-float arithmetic (ops/twofloat.py); the H100 has FP64 units, and the
// error here is the float64 round-off of the sums. Every family: the
// squared-distance ones sum (x - y)^2 (a subtraction and an FMA a
// feature), Laplace sums |x - y| (a subtraction and an add of the absolute
// value, the same count). The expansion |x|^2 + |y|^2 - 2 x.y is not used:
// it loses ~1e-8 on Matern-1/2's diagonal.
//
// What bounds it on the H100: the FP64 instruction rate (64 a clock per SM,
// 34 TFLOP/s on the data sheet). Per kernel value: two float64 operations
// per feature, the family's epilogue in float64 (a software exp, ~20
// instructions), and 2k FMAs of contraction a direction (4k where the
// value serves both: the triangle off its diagonal, the pair). The general
// K1c, K3c and K8 first ran on a narrow template (64-point tiles, a 4 x 4
// register tile, two conversions of staged floats to double and a
// multiplication by the inverse lengthscale per pair and feature, the
// values through a 33 KB shared-memory tile): 101.5, 101.5 and 105.5 ms
// at n = m = 100,000, d = 28, k = 1, where this forward form takes 62.4,
// 64.4 and 62.4 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// Design, common to the forms:
//   * the points are scaled by the lengthscale in float64 once per call by
//     the wrapper and handed over transposed, (dpad, npad) doubles, zero
//     padded to whole chunks of 16 features and tiles of 128 points
//     (kernel_cuda.comp_operand, one for each point set); a pair and
//     feature then costs one subtraction and one FMA;
//   * register tile: a thread holds 8 x 8 values (side A's points 2 rg +
//     {0, 1} + 32 i, side B's 16 w + 8 cg + j, of its warp w, lane 2 rg +
//     cg), 128 double operations per 16 staged doubles read from shared
//     memory;
//   * the features reach shared memory by cp.async, 16 at a time, one chunk
//     ahead (two buffers), read as double2; V of the walking tiles is
//     staged by cp.async in its own type, zero past the points (a padded
//     point's values are not zero), and V_J is read from shared memory where
//     it is used;
//   * a column sum of the register tile (its 16 columns of a warp hold all
//     128 rows) is a shuffle reduce-scatter over the 16 row groups; a row
//     sum is reduced over the column pair of a lane (one shuffle), carried
//     in registers over the strip and added across the 8 warps by float64
//     atomics;
//   * padded points' values are computed like any other: their V is staged
//     zero and their sums are not written.
// The forms differ in which side a block keeps and in the contractions:
//   * triangle: block (I, s, z) keeps row tile I (side A) and walks the
//     column tiles J = I + 16 s .. (side B); row sums K_IJ V_J and, off the
//     diagonal, column sums K_IJ^T V_I, both into a float64 (n, k) array by
//     atomics; KC right-hand sides (1, 2 or 4) a slice z, more columns more
//     slices, each evaluating its tiles again;
//   * pair: the triangle over the whole n1 x n2 rectangle (X1 on side A,
//     X2 on side B; the column tiles of X2 in runs of `run`), row sums of
//     V2 into out1 and column sums of V1 into out2, no diagonal;
//   * forward: block (I, s, z) keeps X1's tile I on side B and walks X2's
//     tiles of run s on side A: the column sums K_JI^T V2_J, one value each
//     per lane and right-hand side, kept in shared memory (no registers
//     grow with k) for up to 16 right-hand sides a slice (each value
//     evaluated once up to k = 16, as the narrow template did; past that
//     16 a slice); no atomics: each run writes its partial, and the
//     finishing pass adds the runs in a fixed order, so the forward form
//     gives the same bits on every call. The runs of the X2 axis fill the
//     card where X1 has few tiles (E2's 12,500-point shards: 98 tiles;
//     config 6's 8,192-row certificate: 64).
// A finishing pass scales the float64 sums by c and, for float V outside
// the pair, splits each sum s into hi = (float)s, lo = (float)(s - hi).
// The triangle's and the pair's float64 atomics make the last bits of s
// change from run to run (about 1e-16 relative), far under the 1e-10 the
// card checks hold.
// Registers: 128 for the values, __launch_bounds__ (256 threads, one block
// an SM); the triangle and the pair reach the 255 a thread may hold and
// spill a few hundred bytes, the forward form carries no row sums (the
// build's -Xptxas -v log, chip_smoke.py's registers line).

#include "gram_common.cuh"

namespace {

constexpr int kCTile = 128;     // points per tile
constexpr int kCFeat = 16;      // features per staged chunk
constexpr int kCStrip = 16;     // column tiles a triangle block walks
constexpr int kCThreads = 256;
constexpr int kCForwardK = 16;  // right-hand sides a forward slice

enum Form { TRIANGLE = 0, FORWARD = 1, PAIR = 2 };

// The operands of a launch. Side A's points are the rows of the register
// tile, side B's its columns, each (dpad, npad) doubles (comp_operand).
// VA (nA, k) and VB (nB, k): V of each side's points, of type VT. outA
// (nA, k) and outB (nB, k) float64: the sums into each side's points,
// zeroed (triangle: one array, pair: out1 and out2); the forward form
// writes its runs' partials (gridDim.y, nB, k) to outB. ntA, ntB: the
// tiles of each side; run: the walking side's tiles a block.
struct CompArgs {
  const double* XA;
  const double* XB;
  const void* VA;
  const void* VB;
  double* outA;
  double* outB;
  int nA, nB, npadA, npadB, dpad, k, ntA, ntB, run;
};

template <typename VT, int KC>
struct __align__(16) CompSmem {
  double x[2][kCFeat][kCTile];  // side A's chunk, two buffers
  double y[2][kCFeat][kCTile];  // side B's chunk
  VT vw[2][KC][kCTile];         // V of the walking tile (two tiles)
  double vf[KC][kCTile];        // V of the kept tile; the forward form's sums
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

// The column (16 warp + 8 cg + this) whose sum a lane ends with in
// column_sum: 4 (lane bit 4) + 2 (bit 3) + (bit 2).
__device__ __forceinline__ int column_of(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// The thread's 8 columns of K against v over its 8 rows (v[r] for side A's
// point r of the tile), reduce-scattered over the 16 row groups (lane bits
// 4, 3, 2), then summed over bit 1: the warp's column sum of column_of(lane),
// held by the lanes with bit 1 clear and their neighbours.
template <typename T>
__device__ __forceinline__ double column_sum(const double (&K)[8][8], const T* v, int rbase,
                                             int lane) {
  double q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    q[j] = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      q[j] = fma(K[i][j], (double)v[rbase + 32 * (i / 2) + (i & 1)], q[j]);
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
  return q[0] + __shfl_xor_sync(0xffffffffu, q[0], 2);
}

template <int KIND, int KC, typename VT, int FORM>
__device__ __forceinline__ void comp_tile(const CompArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CompSmem<VT, KC>& sm = *reinterpret_cast<CompSmem<VT, KC>*>(smem_raw);
  // I: the kept tile (side A's, or side B's in the forward form); J walks
  const int I = blockIdx.x;
  const int nt = FORM == FORWARD ? a.ntA : a.ntB;
  const int J0 = (FORM == TRIANGLE ? I : 0) + blockIdx.y * a.run;
  if (J0 >= nt) return;
  const int J1 = min(J0 + a.run, nt);
  const int k = a.k;
  const int c0 = blockIdx.z * KC;
  const int kc = min(KC, k - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane >> 1, cg = lane & 1;
  const int chunks = a.dpad / kCFeat;
  // the thread's points of side A (2 rg + 32 (i / 2) + i % 2) and of side
  // B (16 warp + 8 cg + j) within a tile; the column whose sum it ends with
  const int rbase = 2 * rg, cbase = 16 * warp + 8 * cg;
  const int mine = cbase + column_of(lane);
  const bool owner = (lane & 2) == 0;
  const VT* __restrict__ Vw = static_cast<const VT*>(FORM == FORWARD ? a.VA : a.VB);
  const int nw = FORM == FORWARD ? a.nA : a.nB;

  if constexpr (FORM == FORWARD) {
    if (owner) {
#pragma unroll
      for (int c = 0; c < KC; ++c) sm.vf[c][mine] = 0.0;
    }
  } else {
    const VT* __restrict__ VA = static_cast<const VT*>(a.VA);
    const int row0 = I * kCTile;
    for (int e = tid; e < KC * kCTile; e += kCThreads) {
      const int c = e / kCTile, r = e % kCTile;
      sm.vf[c][r] =
          (row0 + r < a.nA && c < kc) ? (double)VA[(size_t)(row0 + r) * k + c0 + c] : 0.0;
    }
  }

  const int steps = (J1 - J0) * chunks;
  // step st: tile J0 + st / chunks, features 16 (st % chunks) ..; buffer st % 2
  const auto load_step = [&](int st) {
    const int J = J0 + st / chunks, ch = st % chunks, buf = st & 1;
    const int ta = FORM == FORWARD ? J : I, tb = FORM == FORWARD ? I : J;
    const double* xa = a.XA + (size_t)ch * kCFeat * a.npadA + ta * kCTile;
    const double* xb = a.XB + (size_t)ch * kCFeat * a.npadB + tb * kCTile;
    // 16 features x 128 points of each side: 1,024 pieces of 16 bytes each
    for (int e = tid; e < kCFeat * kCTile / 2; e += kCThreads) {
      const int f = e / (kCTile / 2), q = 2 * (e % (kCTile / 2));
      cp_async16_cg(&sm.x[buf][f][q], xa + (size_t)f * a.npadA + q);
      cp_async16_cg(&sm.y[buf][f][q], xb + (size_t)f * a.npadB + q);
    }
    if (ch == 0) {
      const int col0 = J * kCTile, vb = (J - J0) & 1;
      for (int e = tid; e < kc * kCTile; e += kCThreads) {
        const int c = e / kCTile, j = e % kCTile;
        const bool valid = col0 + j < nw;
        cp_async_ca(&sm.vw[vb][c][j], valid ? Vw + (size_t)(col0 + j) * k + c0 + c : Vw, valid);
      }
    }
    asm volatile("cp.async.commit_group;\n");
  };

  double fwd[4][KC];  // row sums (triangle, pair): rows i = 4 cg .. 4 cg + 3
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
      double x[8], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 x2 = *reinterpret_cast<const double2*>(&sm.x[buf][f][rbase + 32 * i]);
        x[2 * i] = x2.x;
        x[2 * i + 1] = x2.y;
        const double2 y2 = *reinterpret_cast<const double2*>(&sm.y[buf][f][cbase + 2 * i]);
        y[2 * i] = y2.x;
        y[2 * i + 1] = y2.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const double diff = x[i] - y[j];
          if constexpr (KIND == LAPLACE) {
            K[i][j] += fabs(diff);
          } else {
            K[i][j] = fma(diff, diff, K[i][j]);
          }
        }
    }
    if (ch != chunks - 1) continue;

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) K[i][j] = finish_accurate<KIND>(K[i][j]);
    const int vb = (J - J0) & 1;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c >= kc) break;
      if constexpr (FORM == FORWARD) {
        const double s = column_sum(K, sm.vw[vb][c], rbase, lane);
        if (owner) sm.vf[c][mine] += s;
      } else {
        // row sums: this thread's 8 rows over its 8 columns, then the lane
        // pair (cg 0, 1) reduce-scattered: cg keeps rows 4 cg .. 4 cg + 3
        double p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          p[i] = 0.0;
#pragma unroll
          for (int j = 0; j < 8; ++j) p[i] = fma(K[i][j], (double)sm.vw[vb][c][cbase + j], p[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double send = cg ? p[i] : p[i + 4];
          const double keep = cg ? p[i + 4] : p[i];
          fwd[i][c] += keep + __shfl_xor_sync(0xffffffffu, send, 1);
        }
        if (FORM == TRIANGLE && J == I) continue;
        const double s = column_sum(K, sm.vf[c], rbase, lane);
        const int gc = J * kCTile + mine;
        if (owner && gc < a.nB) atomicAdd(&a.outB[(size_t)gc * k + c0 + c], s);
      }
    }
  }
  if constexpr (FORM == FORWARD) {
    const int gc = I * kCTile + mine;
    if (owner && gc < a.nB) {
      double* part = a.outB + (size_t)blockIdx.y * a.nB * k;
      for (int c = 0; c < kc; ++c) part[(size_t)gc * k + c0 + c] = sm.vf[c][mine];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ii = 4 * cg + i;
      const int gr = I * kCTile + rbase + 32 * (ii / 2) + (ii & 1);
      if (gr >= a.nA) continue;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc) atomicAdd(&a.outA[(size_t)gr * k + c0 + c], fwd[i][c]);
    }
  }
}

template <int KIND, int KC, typename VT>
__global__ void __launch_bounds__(kCThreads, 1) gram_comp_symmetric(const CompArgs a) {
  comp_tile<KIND, KC, VT, TRIANGLE>(a);
}

template <int KIND, int KC, typename VT>
__global__ void __launch_bounds__(kCThreads, 1) gram_comp_forward(const CompArgs a) {
  comp_tile<KIND, KC, VT, FORWARD>(a);
}

template <int KIND, int KC, typename VT>
__global__ void __launch_bounds__(kCThreads, 1) gram_comp_pair(const CompArgs a) {
  comp_tile<KIND, KC, VT, PAIR>(a);
}

// The finishing pass over each float64 sum, the runs' partials added in
// order: s = c (part[0][i] + part[1][i] + ...); the pair and float64 V
// write s to out (double, in place where part is out), float V elsewhere
// hi = (float)s to out and lo = (float)(s - hi) to lo. The template
// arguments name the wrapper in a profile.
template <typename VT, int FORM>
__global__ void __launch_bounds__(kThreads)
    gram_comp_finish(const double* part, int splits, size_t count, double c, void* out,
                     float* lo) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < count;
       i += (size_t)gridDim.x * kThreads) {
    double s = 0.0;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * count + i];
    s *= c;
    if constexpr (FORM == PAIR || sizeof(VT) == sizeof(double)) {
      static_cast<double*>(out)[i] = s;
    } else {
      const float h = (float)s;
      static_cast<float*>(out)[i] = h;
      lo[i] = (float)(s - (double)h);
    }
  }
}

template <typename VT, int FORM>
cudaError_t finish(const double* part, int splits, size_t count, double c, void* out, float* lo,
                   cudaStream_t s) {
  size_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  gram_comp_finish<VT, FORM><<<(unsigned)blocks, kThreads, 0, s>>>(part, splits, count, c, out,
                                                                   lo);
  return cudaGetLastError();
}

template <int KIND, int KC, typename VT, int FORM>
cudaError_t launch_form(const CompArgs& a, cudaStream_t s) {
  void (*kernel)(const CompArgs);
  if constexpr (FORM == TRIANGLE) {
    kernel = gram_comp_symmetric<KIND, KC, VT>;
  } else if constexpr (FORM == FORWARD) {
    kernel = gram_comp_forward<KIND, KC, VT>;
  } else {
    kernel = gram_comp_pair<KIND, KC, VT>;
  }
  const int bytes = (int)sizeof(CompSmem<VT, KC>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int kept = FORM == FORWARD ? a.ntB : a.ntA, walked = FORM == FORWARD ? a.ntA : a.ntB;
  const dim3 grid(kept, (walked + a.run - 1) / a.run, (a.k + KC - 1) / KC);
  kernel<<<grid, kCThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// Right-hand sides a slice: the forward form 16 (its sums in shared
// memory); the triangle and the pair 1, 2 or 4 (their row sums in
// registers), the smallest that holds k, 4 past that.
template <int KIND, typename VT, int FORM>
cudaError_t launch_by_k(const CompArgs& a, cudaStream_t s) {
  if constexpr (FORM == FORWARD) {
    return launch_form<KIND, kCForwardK, VT, FORM>(a, s);
  } else {
    if (a.k > 2) return launch_form<KIND, 4, VT, FORM>(a, s);
    if (a.k > 1) return launch_form<KIND, 2, VT, FORM>(a, s);
    return launch_form<KIND, 1, VT, FORM>(a, s);
  }
}

template <typename VT, int FORM>
cudaError_t launch_kind(int kind, const CompArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_by_k<RBF, VT, FORM>(a, s);
    case MATERN12: return launch_by_k<MATERN12, VT, FORM>(a, s);
    case MATERN32: return launch_by_k<MATERN32, VT, FORM>(a, s);
    case MATERN52: return launch_by_k<MATERN52, VT, FORM>(a, s);
    case LAPLACE: return launch_by_k<LAPLACE, VT, FORM>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

bool operand_ok(int n, int npad, int dpad) {
  return n >= 1 && npad >= n && npad % kCTile == 0 && dpad > 0 && dpad % kCFeat == 0;
}

int tiles(int n) { return (n + kCTile - 1) / kCTile; }

// Zero acc, sum every family's triangle into it, then the finishing pass.
template <typename VT>
int comp_symmetric(int kind, const void* XT, const void* V, double* acc, void* out,
                   void* out_lo, int n, int npad, int dpad, int k, double c, cudaStream_t s) {
  if (k < 1 || !operand_ok(n, npad, dpad)) return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)n * k;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double) * count, s);
  if (err != cudaSuccess) return (int)err;
  const double* X = static_cast<const double*>(XT);
  const CompArgs a{X, X, V, V, acc, acc, n, n, npad, npad, dpad, k, tiles(n), tiles(n), kCStrip};
  err = launch_kind<VT, TRIANGLE>(kind, a, s);
  if (err != cudaSuccess) return (int)err;
  void* dst = sizeof(VT) == sizeof(double) ? static_cast<void*>(acc) : out;
  return (int)finish<VT, TRIANGLE>(acc, 1, count, c, dst, static_cast<float*>(out_lo), s);
}

// The forward form: X1's tiles kept, X2's walked in runs of `run` tiles,
// each run's partial into part, then the finishing pass.
template <typename VT>
int comp_forward(int kind, const void* XT1, const void* XT2, const void* V, double* part,
                 void* out, void* out_lo, int n, int m, int npad, int mpad, int dpad, int k,
                 int run, double c, cudaStream_t s) {
  if (k < 1 || run < 1 || !operand_ok(n, npad, dpad) || !operand_ok(m, mpad, dpad))
    return (int)cudaErrorInvalidValue;
  const CompArgs a{static_cast<const double*>(XT2), static_cast<const double*>(XT1), V,
                   nullptr, nullptr, part, m, n, mpad, npad, dpad, k, tiles(m), tiles(n), run};
  const cudaError_t err = launch_kind<VT, FORWARD>(kind, a, s);
  if (err != cudaSuccess) return (int)err;
  const int splits = (tiles(m) + run - 1) / run;
  return (int)finish<VT, FORWARD>(part, splits, (size_t)n * k, c, out,
                                  static_cast<float*>(out_lo), s);
}

// The pair form into out (n1 + n2, k) float64: out1 its first n1 rows,
// out2 the rest; zeroed, summed, scaled in place.
template <typename VT>
int comp_pair(int kind, const void* XT1, const void* XT2, const void* V2, const void* V1,
              double* out, int n1, int n2, int npad1, int npad2, int dpad, int k, int run,
              double c, cudaStream_t s) {
  if (k < 1 || run < 1 || !operand_ok(n1, npad1, dpad) || !operand_ok(n2, npad2, dpad))
    return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)(n1 + n2) * k;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(double) * count, s);
  if (err != cudaSuccess) return (int)err;
  const CompArgs a{static_cast<const double*>(XT1), static_cast<const double*>(XT2), V1, V2,
                   out, out + (size_t)n1 * k, n1, n2, npad1, npad2, dpad, k, tiles(n1),
                   tiles(n2), run};
  err = launch_kind<VT, PAIR>(kind, a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)finish<VT, PAIR>(out, 1, count, c, out, nullptr, s);
}

}  // namespace

// Plain C interface, loaded with ctypes; launches on `stream`, does not
// synchronize, returns a CUDA error code (0 on success). Every entry takes
// the family code (LAPLACE 4) and the points as kernel_cuda.comp_operand
// gives them: XT (dpad, npad) float64, the points divided by the
// lengthscale, transposed, zero past n and d, dpad a multiple of 16 and
// npad of 128 (XT1 and XT2 of X1 and X2 alike).

// K1c and K3c, triangle form: out + out_lo = c * k(X, X) @ V. V (n, k)
// float32; acc (n, k) float64 scratch, zeroed here; out, out_lo (n, k)
// float32.
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

// K1c and K3c, forward form: out + out_lo = c * k(X1, X2) @ V from XT1
// (dpad, npad) and XT2 (dpad, mpad); V (m, k) float32; out, out_lo (n, k)
// float32. X2's tiles in runs of `run`, ceil(ceil(m / 128) / run) of them,
// whose float64 partials go to part (runs, n, k).
extern "C" int rl_gram_matmat_comp(int kind, const void* XT1, const void* XT2, const void* V,
                                   void* part, void* out, void* out_lo, int n, int m, int npad,
                                   int mpad, int dpad, int k, int run, double c, void* stream) {
  return comp_forward<float>(kind, XT1, XT2, V, static_cast<double*>(part), out, out_lo, n, m,
                             npad, mpad, dpad, k, run, c, static_cast<cudaStream_t>(stream));
}

// K8, forward form: out = c * k(X1, X2) @ V in float64; V (m, k) and out
// (n, k) float64; part as for rl_gram_matmat_comp.
extern "C" int rl_gram_matmat_f64(int kind, const void* XT1, const void* XT2, const void* V,
                                  void* part, void* out, int n, int m, int npad, int mpad,
                                  int dpad, int k, int run, double c, void* stream) {
  return comp_forward<double>(kind, XT1, XT2, V, static_cast<double*>(part), out, nullptr, n, m,
                              npad, mpad, dpad, k, run, c, static_cast<cudaStream_t>(stream));
}

// The pair form with float32 V (K1c's and K3c's): out (n1 + n2, k) float64
// holds c * k(X1, X2) @ V2 in its first n1 rows and c * k(X1, X2)^T @ V1
// in the next n2; V2 (n2, k), V1 (n1, k) float32; X2's tiles in runs of
// `run` a block.
extern "C" int rl_gram_pair_comp(int kind, const void* XT1, const void* XT2, const void* V2,
                                 const void* V1, void* out, int n1, int n2, int npad1,
                                 int npad2, int dpad, int k, int run, double c, void* stream) {
  return comp_pair<float>(kind, XT1, XT2, V2, V1, static_cast<double*>(out), n1, n2, npad1,
                          npad2, dpad, k, run, c, static_cast<cudaStream_t>(stream));
}

// The pair form with float64 V (K8's): as rl_gram_pair_comp, V2 and V1
// float64.
extern "C" int rl_gram_pair_f64(int kind, const void* XT1, const void* XT2, const void* V2,
                                const void* V1, void* out, int n1, int n2, int npad1, int npad2,
                                int dpad, int k, int run, double c, void* stream) {
  return comp_pair<double>(kind, XT1, XT2, V2, V1, static_cast<double*>(out), n1, n2, npad1,
                           npad2, dpad, k, run, c, static_cast<cudaStream_t>(stream));
}
