// Fused Laplace Gram-matrix products, for Hopper (sm_90a).
//
// out = c * exp(-sum_f |x_f - y_f|) @ V, K never reaching device memory:
//
//   K3  laplace_forward           replaces rlaopt_tpu/ops/kernel_pallas.py ::
//       (k <= 16; past 16 the     _laplace_matmat (plain)
//       shared wide kernel)
//   K3c laplace_matmat (COMP)     replaces _laplace_matmat(compensated=True)
//                                 for two data sets; one data set takes the
//                                 triangle of gram_comp.cu
//   K5  laplace_triangle          replaces kernel_pallas.py ::
//       (K3's tile, triangle form) _laplace_matvec_symmetric
//
// What bounds them on the H100: the FP32 instruction rate (FP64 for K3c),
// not bytes. An L1 pair and feature costs two FADDs, d = x - y and acc +=
// |d| with the absolute value an operand modifier: unlike RBF's FMA they do
// not fuse, so the FP32 pipes (128 lanes a clock per SM, one warp
// instruction a clock per sub-partition) deliver half the data sheet's
// 67 TFLOP/s (which counts an FMA as two) for this function, and every
// other instruction in the loop takes a FADD's slot. Per kernel value
// besides: one exp and 2k FMAs of contraction. No tensor cores: an L1
// distance has no product form.
//
// K3 for k <= 16 (laplace_forward<KC>), a tile of its own:
//   * a block owns a row tile of 128 points of X1 and walks a run of column
//     tiles of 128 points of X2; 256 threads, an 8 x 8 float32 register tile
//     a thread (rows 16 w + 8 (lane >> 4) + i of warp w, columns
//     4 (lane & 15) + j and 64 + 4 (lane & 15) + j): 16 floats read as four
//     float4 from shared memory for 128 FADDs (the shared template's 4 x 4
//     tile read 8 floats for 32);
//   * the wrapper hands the points scaled and transposed, (dpad, npad)
//     floats zero past d and n, so that 32 features of 128 points are 32
//     rows of 512 bytes; they reach shared memory by cp.async in chunks of
//     32 features, one chunk ahead (two buffers, one barrier a chunk), as
//     does each column tile's V (transposed to KC x 128, read as float4) on
//     its first chunk; a last chunk of fewer than 32 features runs only
//     those (d = 50: 32 + 18). Of chunks of 16, 24 and 32 features, two
//     and three buffers and several unroll depths, timed at the row
//     oracle, this one (32, two, the loop unrolled 8 deep) was the fastest;
//   * the values' epilogue (__expf, an FMUL and the SFU's ex2) and the
//     contraction stay in registers: per right-hand side a thread contracts
//     its 8 rows over its 8 columns, and the 16 lanes that share the rows
//     reduce-scatter them by shuffles (three halving steps and one sum), so
//     a lane carries one row's sum a right-hand side across the run; no K
//     tile goes through shared memory, and the padding needs no masks (its
//     points are zero, its V rows zero-filled);
//   * the m axis in runs (kernel_cuda.laplace_splits: SAP's row oracle,
//     79 row tiles, takes 13), each run's partial written to part[z] and
//     summed by sum_splits in a fixed order: no float atomics, the same bits
//     on every run;
//   * __launch_bounds__(256, 2): two blocks an SM, 128 registers a thread
//     (the build's -Xptxas -v log, chip_smoke.py's registers line).
// K3 past 16 columns keeps the wide kernel of gram_common.cuh
// (gram_matmat_wide<LAPLACE>, 64-column chunks on blockIdx.y); the narrow
// branch of rl_laplace_matmat (gram_matmat_narrow<LAPLACE, KC, EXACT>, the
// 64-point template with column splits) is no longer called by the wrapper
// for k <= 16 and stays as the schedule chip_smoke.py times the new tile
// against.
//
// K5 (laplace_triangle<KC>) is the triangle form of K3's tile, on the same
// operand (the wrapper's laplace_operand, or the one an operator keeps):
//   * block (I, s) owns row tile I and walks the column tiles J = I + 8 s
//     .. I + 8 s + 7 (J < nt), so each unordered pair of 128-point tiles is
//     evaluated once, and the triangle's blocks carry 8 tiles each but at
//     its edge (blocks past the edge leave at once);
//   * the forward contraction K_IJ V_J on the register tile and the
//     shuffle reduce-scatter, as in K3, the lane's row sums carried across
//     the run and added once by atomicAdd;
//   * for J > I the mirror K_IJ^T V_I: V_I (the row tile's right-hand
//     sides, transposed) is read into shared memory once a block; per
//     right-hand side a thread sums its 8 rows for each of its 8 columns,
//     the two lanes that share those columns (rows 8 apart) reduce-scatter
//     them by shuffles, 4 columns each, the 8 warps' sums go through shared
//     memory (4 right-hand sides at a time) and are added in warp order,
//     and one atomicAdd a column goes into the output, zeroed in the same
//     call. The diagonal tile contracts forward only;
//   * the float atomics make the last bits change from run to run.
// The kernel it replaced ran on the shared triangle template
// (gram_matvec_symmetric<LAPLACE>: 64-point tiles through shared memory,
// each thread one output row of a 4 x 4 slice, both contractions reading
// the K tile back from shared memory k times over), 23.7 / 97.3 ms at
// 100k^2, d = 28, k = 1 / 10 (NVIDIA H100 80GB HBM3, 700 W), where K3's
// tile took 24.8 / 31.7 ms for the whole square.
// K3c has K1c's general schedule, from unscaled points with the inverse
// lengthscale in float64 (the float64 product of the float32 points,
// TwoSum-added into a float (hi, lo) pair across column tiles).
//
// Not carried over from the TPU kernels: the 64-feature grid axis of
// _laplace_feature_block (the staging loops walk d 16 or 32 features at a time),
// the VMEM mirror windows and the MXU mirror contraction of the triangle.

#include "gram_common.cuh"

namespace {

constexpr int kLTile = 128;  // points per tile (rows of X1, columns of X2)
constexpr int kLFeat = 32;   // features per staged chunk
constexpr int kLStages = 2;  // chunk buffers: one load in flight
constexpr int kLThreads = 256;

constexpr int kLWarps = kLThreads / 32;
constexpr int kLRun = 8;     // column tiles a triangle block walks

// The tile's forms: K3 (forward) and K5 (triangle); the pair form (K6) is
// to take the next value.
enum LaplaceForm { L_FORWARD = 0, L_TRIANGLE = 1 };

template <int KC>
struct __align__(16) LaplaceSmem {
  float x[kLStages][kLFeat][kLTile];  // the row tile's chunk
  float y[kLStages][kLFeat][kLTile];  // the column tile's chunk
  float v[kLStages][KC][kLTile];      // V of the column tile, transposed
};

// The triangle's mirror, after LaplaceSmem in shared memory.
template <int KC>
struct __align__(16) LaplaceMirror {
  static constexpr int kGroup = KC < 4 ? KC : 4;  // right-hand sides a pass
  float vi[KC][kLTile];                 // V of the row tile, transposed
  float sums[kLWarps][kGroup][kLTile];  // each warp's column sums of a pass
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// One feature of the thread's 8 x 8 tile: D[i][j] += |x[rbase + i] -
// y[col j]|, two FADDs a pair (the absolute value an operand modifier).
__device__ __forceinline__ void l1_feature(float (&D)[8][8], const float* x, const float* y,
                                           int rbase, int cbase) {
  float a[8], b[8];
  load4(x + rbase, a);
  load4(x + rbase + 4, a + 4);
  load4(y + cbase, b);
  load4(y + 64 + cbase, b + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) D[i][j] += fabsf(a[i] - b[j]);
}

// K3 and K5, k <= 16. XT1 (dpad, npad), XT2 (dpad, mpad) floats: the scaled
// points, transposed, zero padded; V (m, k).
// L_FORWARD (K3): block (I, 0, z): row tile I, column tiles [z run, (z + 1)
// run). One run: out = c * sums; more: part[z] = sums, for sum_splits.
// L_TRIANGLE (K5): X2 = X1, block (I, s): row tile I, column tiles [I + s
// run, I + (s + 1) run), every sum added to out (zeroed) by atomicAdd.
template <int KC, int FORM>
__device__ __forceinline__ void laplace_tile(const float* __restrict__ XT1,
                                             const float* __restrict__ XT2,
                                             const float* __restrict__ V,
                                             float* __restrict__ out, float* __restrict__ part,
                                             int n, int m, int npad, int mpad, int d, int k,
                                             int run, double c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LaplaceSmem<KC>& sm = *reinterpret_cast<LaplaceSmem<KC>*>(smem_raw);
  LaplaceMirror<KC>& mi =
      *reinterpret_cast<LaplaceMirror<KC>*>(smem_raw + sizeof(LaplaceSmem<KC>));
  const int mt = (m + kLTile - 1) / kLTile;
  int J0, J1;
  if constexpr (FORM == L_TRIANGLE) {
    J0 = blockIdx.x + blockIdx.y * run;
    if (J0 >= mt) return;  // past the triangle's edge: the whole block
    J1 = min(J0 + run, mt);
  } else {
    J0 = blockIdx.z * run;
    J1 = min(J0 + run, mt);
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * kLTile;
  const int rbase = 16 * warp + 8 * (lane >> 4), cbase = 4 * (lane & 15);
  const int chunks = (d + kLFeat - 1) / kLFeat;
  const int kc = min(k, KC);
  const float cf = (float)c;
  if constexpr (FORM == L_TRIANGLE) {
    // V of the row tile, for every mirror of the run (visible after the
    // first step's barrier)
    for (int e = tid; e < KC * kLTile; e += kLThreads) {
      const int cc = e / kLTile, j = e % kLTile;
      mi.vi[cc][j] = cc < kc && row0 + j < n ? V[(size_t)(row0 + j) * k + cc] : 0.0f;
    }
  }

  const int steps = (J1 - J0) * chunks;
  // Loads run kLStages - 1 steps ahead of the compute: step st (column
  // tile J0 + st / chunks, features 32 (st % chunks) ..) lands in buffer
  // st % kLStages, and a column tile's V on its first chunk in
  // v[(J - J0) % kLStages]. The load position is tracked as (lJ, lch), the
  // compute one as (ch, buf, vb): no division in the loop.
  int lst = 0, lJ = J0, lch = 0, lbuf = 0, lvb = 0;
  const auto load_next = [&]() {
    if (lst < steps) {
      const float* xs = XT1 + (size_t)lch * kLFeat * npad + row0;
      const float* ys = XT2 + (size_t)lch * kLFeat * mpad + (size_t)lJ * kLTile;
      // 32 features x 128 points of each side: 1,024 pieces of 16 bytes each
      for (int e = tid; e < kLFeat * kLTile / 4; e += kLThreads) {
        const int f = e / (kLTile / 4), q = 4 * (e % (kLTile / 4));
        cp_async16(&sm.x[lbuf][f][q], xs + (size_t)f * npad + q);
        cp_async16(&sm.y[lbuf][f][q], ys + (size_t)f * mpad + q);
      }
      if (lch == 0) {
        const int col0 = lJ * kLTile;
        for (int e = tid; e < kLTile * KC; e += kLThreads) {
          const int cc = e / kLTile, j = e % kLTile;
          const bool valid = col0 + j < m && cc < kc;
          cp_async4(&sm.v[lvb][cc][j], valid ? V + (size_t)(col0 + j) * k + cc : V, valid);
        }
      }
      ++lst;
      lbuf = lbuf == kLStages - 1 ? 0 : lbuf + 1;
      if (++lch == chunks) {
        lch = 0;
        ++lJ;
        lvb = lvb == kLStages - 1 ? 0 : lvb + 1;
      }
    }
    asm volatile("cp.async.commit_group;\n");  // empty past the last step
  };

  float acc[KC];  // the lane's row (ri below), each right-hand side
#pragma unroll
  for (int cc = 0; cc < KC; ++cc) acc[cc] = 0.0f;
  float D[8][8];
  // the lane's row of the 8 after the reduce-scatter over lane bits 3, 2, 1
  const int ri = ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);

  for (int s = 0; s < kLStages - 1; ++s) load_next();
  int ch = 0, buf = 0, vb = 0, cj = J0;
  for (int st = 0; st < steps; ++st) {
    // step st's group is complete when at most kLStages - 2 (the later
    // ones) are pending; after the barrier every thread is done with step
    // st - 1, whose buffer step st + kLStages - 1 then takes
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLStages - 2));
    __syncthreads();
    load_next();
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) D[i][j] = 0.0f;
    }
    const int nf = min(kLFeat, d - ch * kLFeat);
    if (nf == kLFeat) {
#pragma unroll 8
      for (int f = 0; f < kLFeat; ++f) l1_feature(D, sm.x[buf][f], sm.y[buf][f], rbase, cbase);
    } else {
#pragma unroll 4
      for (int f = 0; f < nf; ++f) l1_feature(D, sm.x[buf][f], sm.y[buf][f], rbase, cbase);
    }
    buf = buf == kLStages - 1 ? 0 : buf + 1;
    if (++ch != chunks) continue;
    ch = 0;

    // epilogue: the values, then each right-hand side contracted
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) D[i][j] = __expf(-D[i][j]);
#pragma unroll
    for (int cc = 0; cc < KC; ++cc) {
      if (cc >= kc) break;
      float w[8], p[8];
      load4(&sm.v[vb][cc][cbase], w);
      load4(&sm.v[vb][cc][64 + cbase], w + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i] = fmaf(D[i][j], w[j], p[i]);
      }
      // reduce-scatter over the 16 lanes of the rows (lane bits 3, 2, 1),
      // then the sum over bit 0
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int width = 4 >> s;
        const bool up = lane & (8 >> s);
#pragma unroll
        for (int i = 0; i < width; ++i) {
          const float send = up ? p[i] : p[i + width];
          const float keep = up ? p[i + width] : p[i];
          p[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8 >> s);
        }
      }
      acc[cc] += p[0] + __shfl_xor_sync(0xffffffffu, p[0], 1);
    }
    if constexpr (FORM == L_TRIANGLE) {
      // the mirror K_IJ^T V_I into the rows of tile J, above the diagonal
      if (cj > (int)blockIdx.x) {
        constexpr int G = LaplaceMirror<KC>::kGroup;
        const bool up = lane & 16;
        const int cpos = (up ? 64 : 0) + cbase;  // the 4 columns this lane sums
        const int col0 = cj * kLTile;
#pragma unroll
        for (int g0 = 0; g0 < KC; g0 += G) {
          if (g0 >= kc) break;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g0 + g >= kc) break;
            float w[8], t[8];
            load4(&mi.vi[g0 + g][rbase], w);
            load4(&mi.vi[g0 + g][rbase + 4], w + 4);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              t[j] = 0.0f;
#pragma unroll
              for (int i = 0; i < 8; ++i) t[j] = fmaf(D[i][j], w[i], t[j]);
            }
            // lanes l and l ^ 16 (rows 8 apart) share the columns: each
            // keeps 4 of the 8 sums, its partner's added
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float send = up ? t[j] : t[j + 4];
              const float keep = up ? t[j + 4] : t[j];
              t[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
            }
            *reinterpret_cast<float4*>(&mi.sums[warp][g][cpos]) =
                make_float4(t[0], t[1], t[2], t[3]);
          }
          __syncthreads();
          // the warps' column sums in warp order, one atomicAdd a column
          for (int e = tid; e < G * kLTile; e += kLThreads) {
            const int g = e / kLTile, j = e % kLTile;
            if (g0 + g < kc && col0 + j < n) {
              float sum = mi.sums[0][g][j];
#pragma unroll
              for (int w = 1; w < kLWarps; ++w) sum += mi.sums[w][g][j];
              atomicAdd(&out[(size_t)(col0 + j) * k + g0 + g], sum * cf);
            }
          }
          __syncthreads();
        }
      }
      ++cj;
    }
    vb = vb == kLStages - 1 ? 0 : vb + 1;
  }
  const int gr = row0 + rbase + ri;
  if ((lane & 1) || gr >= n) return;
  if constexpr (FORM == L_TRIANGLE) {
#pragma unroll
    for (int cc = 0; cc < KC; ++cc)
      if (cc < kc) atomicAdd(&out[(size_t)gr * k + cc], acc[cc] * cf);
  } else if (gridDim.z > 1) {
    float* dst = part + ((size_t)blockIdx.z * n + gr) * k;
#pragma unroll
    for (int cc = 0; cc < KC; ++cc)
      if (cc < kc) dst[cc] = acc[cc];
  } else {
#pragma unroll
    for (int cc = 0; cc < KC; ++cc)
      if (cc < kc) out[(size_t)gr * k + cc] = (float)(acc[cc] * c);
  }
}

template <int KC>
__global__ void __launch_bounds__(kLThreads, 2)
    laplace_forward(const float* __restrict__ XT1, const float* __restrict__ XT2,
                    const float* __restrict__ V, float* __restrict__ out,
                    float* __restrict__ part, int n, int m, int npad, int mpad, int d,
                    int k, int run, double c) {
  laplace_tile<KC, L_FORWARD>(XT1, XT2, V, out, part, n, m, npad, mpad, d, k, run, c);
}

template <int KC>
__global__ void __launch_bounds__(kLThreads, 2)
    laplace_triangle(const float* __restrict__ XT, const float* __restrict__ V,
                     float* __restrict__ out, int n, int npad, int d, int k, int run,
                     double c) {
  laplace_tile<KC, L_TRIANGLE>(XT, XT, V, out, nullptr, n, n, npad, npad, d, k, run, c);
}

// K5: out zeroed, then the triangle's blocks (I, s), s < ceil(nt / run).
template <int KC>
cudaError_t launch_triangle(const float* XT, const float* V, float* out, int n, int npad,
                            int d, int k, double c, cudaStream_t s) {
  const int bytes = (int)(sizeof(LaplaceSmem<KC>) + sizeof(LaplaceMirror<KC>));
  cudaError_t err = cudaFuncSetAttribute(
      laplace_triangle<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nt = (n + kLTile - 1) / kLTile;
  const int strips = (nt + kLRun - 1) / kLRun;
  if (strips > 65535) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return err;
  laplace_triangle<KC><<<dim3(nt, strips), kLThreads, bytes, s>>>(XT, V, out, n, npad, d, k,
                                                                  kLRun, c);
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_forward(const float* XT1, const float* XT2, const float* V, float* out,
                           float* part, int n, int m, int npad, int mpad, int d, int k,
                           int splits, double c, cudaStream_t s) {
  const int bytes = (int)sizeof(LaplaceSmem<KC>);
  cudaError_t err = cudaFuncSetAttribute(
      laplace_forward<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int mt = (m + kLTile - 1) / kLTile;
  if (part == nullptr || splits < 1) splits = 1;
  if (splits > mt) splits = mt;
  const int run = (mt + splits - 1) / splits;
  splits = (mt + run - 1) / run;
  const dim3 grid((n + kLTile - 1) / kLTile, 1, splits);
  laplace_forward<KC><<<grid, kLThreads, bytes, s>>>(XT1, XT2, V, out, part, n, m, npad, mpad,
                                                     d, k, run, c);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)n * k;
  size_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, kThreads, 0, s>>>(part, out, splits, count, c);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every call launches on `stream`,
// does not synchronize, and returns cudaGetLastError() (0 on success).
// Shapes: X1 (n, d), X2 (m, d), V (m, k), out and out_lo (n, k), all
// contiguous float32 on one device; n, m, d, k >= 1.

// K3 past 16 columns (the wide kernel): out = c * k(X1, X2) @ V, X1 and X2
// pre-scaled by the lengthscale. At k <= 16 this entry runs the shared
// narrow template (the schedule laplace_forward replaced), splits > 1
// cutting the m axis into that many runs on blockIdx.z, their partials in
// part (splits * n * k floats), summed in a second launch.
extern "C" int rl_laplace_matmat(const void* X1, const void* X2, const void* V,
                                 void* out, void* part, int n, int m, int d,
                                 int k, int splits, double c, void* stream) {
  GramArgs a = points_args(X1, X2, nullptr, V, out, nullptr, n, m, d, k, c);
  a.part = static_cast<float*>(part);
  launch_matmat<LAPLACE, false>(a, static_cast<cudaStream_t>(stream), splits);
  return (int)cudaGetLastError();
}

// K3c: the same product as out + out_lo (out_lo added last), from unscaled
// X1 and X2 and the inverse lengthscale inv_ls (d doubles).
extern "C" int rl_laplace_matmat_comp(const void* X1, const void* X2,
                                      const void* V, const void* inv_ls,
                                      void* out, void* out_lo, int n, int m,
                                      int d, int k, double c, void* stream) {
  const GramArgs a = points_args(X1, X2, inv_ls, V, out, out_lo, n, m, d, k, c);
  launch_matmat<LAPLACE, true>(a, static_cast<cudaStream_t>(stream), 1);
  return (int)cudaGetLastError();
}

// K5 (laplace_triangle): out = c * k(X, X) @ V from XT (dpad, npad) floats,
// the points divided by the lengthscale, transposed, zero past d and n, dpad
// a multiple of 32 and npad of 128 (K3's operand); V (n, k) with k <= 16,
// out (n, k) float32, zeroed here first.
extern "C" int rl_laplace_matvec_symmetric(const void* XT, const void* V, void* out, int n,
                                           int npad, int d, int dpad, int k, double c,
                                           void* stream) {
  if (n < 1 || d < 1 || k < 1 || k > 16 || dpad % kLFeat || dpad < d || npad % kLTile ||
      npad < n)
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT);
  const float* Vf = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k > 8) {
    err = launch_triangle<16>(A, Vf, o, n, npad, d, k, c, s);
  } else if (k > 4) {
    err = launch_triangle<8>(A, Vf, o, n, npad, d, k, c, s);
  } else if (k > 2) {
    err = launch_triangle<4>(A, Vf, o, n, npad, d, k, c, s);
  } else if (k > 1) {
    err = launch_triangle<2>(A, Vf, o, n, npad, d, k, c, s);
  } else {
    err = launch_triangle<1>(A, Vf, o, n, npad, d, k, c, s);
  }
  return (int)err;
}

// K3 at k <= 16 (laplace_forward): out = c * k(X1, X2) @ V from XT1 (dpad,
// npad) and XT2 (dpad, mpad) floats, the points divided by the lengthscale,
// transposed, zero past d, n and m, dpad a multiple of 32, npad and mpad of
// 128; V (m, k), out (n, k) float32. splits > 1: the m axis in that many
// runs (fewer if m has fewer tiles), their partials in part (splits * n * k
// floats), summed in a fixed order by a second launch.
extern "C" int rl_laplace_matmat_narrow(const void* XT1, const void* XT2, const void* V,
                                        void* out, void* part, int n, int m, int npad,
                                        int mpad, int d, int dpad, int k, int splits,
                                        double c, void* stream) {
  if (n < 1 || m < 1 || d < 1 || k < 1 || k > 16 || dpad % kLFeat || dpad < d ||
      npad % kLTile || npad < n || mpad % kLTile || mpad < m)
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT1);
  const float* B = static_cast<const float*>(XT2);
  const float* Vf = static_cast<const float*>(V);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k > 8) {
    err = launch_forward<16>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
  } else if (k > 4) {
    err = launch_forward<8>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
  } else if (k > 2) {
    err = launch_forward<4>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
  } else if (k > 1) {
    err = launch_forward<2>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
  } else {
    err = launch_forward<1>(A, B, Vf, o, p, n, m, npad, mpad, d, k, splits, c, s);
  }
  return (int)err;
}
