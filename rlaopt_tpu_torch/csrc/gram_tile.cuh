// The register tile of the float32 Gram products for k <= 16, for Hopper
// (sm_90a), in every family: K3's tile, generalised over the kernel
// family. gram.cu instantiates it for every family's forward and triangle
// forms (K1, K2; K3, K5 for Laplace), gram_pair.cu every family's pair (K4,
// K6); the three forms:
//
//   tile_forward<KIND, KC>   c * k(X1, X2) @ V for two point sets (K1, K3)
//   tile_triangle<KIND, KC>  c * k(X, X) @ V, each pair of tiles once (K2, K5)
//   tile_pair<KIND, KC>      (c * k(X1, X2) @ V2, c * k(X1, X2)^T @ V1), each
//                            value once, contracted both ways (K4, K6)
//
// What bounds them on the H100: the FP32 instruction rate, not bytes. Per
// feature and pair of points the distance takes two instructions: an L1
// pair d = x - y and acc += |d| (two FADDs, the absolute value an operand
// modifier), a squared pair d = x - y and acc = fma(d, d, acc) (FSUB and
// FFMA). The data sheet's 67 TFLOP/s counts an FMA as two, so the squared
// pair's three counted operations take the same two issue slots as the L1
// pair's two. Per kernel value besides: the epilogue (one exp on the SFU,
// and for Matern a square root there too) and 2k FMAs of contraction
// (4k in the triangle's off-diagonal tiles and in every tile of the pair).
//
// Design:
//   * a block owns a row tile of 128 points of X1 and walks a run of column
//     tiles of 128 points of X2; 256 threads, an 8 x 8 float32 register tile
//     a thread (rows 16 w + 8 (lane >> 4) + i of warp w, columns
//     4 (lane & 15) + j and 64 + 4 (lane & 15) + j): 16 floats read as four
//     float4 from shared memory for 64 pairs;
//   * the wrapper hands the points scaled and transposed, (dpad, npad)
//     floats zero past d and n (kernel_cuda.tile_operand), so that 32
//     features of 128 points are 32 rows of 512 bytes; they reach shared
//     memory by cp.async in chunks of 32 features, one chunk ahead (two
//     buffers, one barrier a chunk), as does each column tile's V
//     (transposed to KC x 128, read as float4) on its first chunk; a last
//     chunk of fewer than 32 features runs only those (d = 50: 32 + 18). Of
//     chunks of 16, 24 and 32 features, two and three buffers and several
//     unroll depths, timed on Laplace at SAP's row oracle, this one (32,
//     two, the loop unrolled 8 deep) was the fastest;
//   * the values' epilogue (tile_value: the family's function of the
//     distance, __expf and sqrt.approx on the SFU) and the contraction stay
//     in registers: per right-hand side a thread contracts its 8 rows over
//     its 8 columns, and the 16 lanes that share the rows reduce-scatter
//     them by shuffles (three halving steps and one sum), so a lane carries
//     one row's sum a right-hand side across the run; no K tile goes
//     through shared memory, and the padding needs no masks: a padded
//     column's value meets a zero row of V, a padded row's a zero row of
//     V1 in the mirror, and no padded row of either output is written;
//   * forward (K1, K3): the m axis in runs (kernel_cuda.tile_splits: SAP's
//     row oracle, 79 row tiles, takes 13), each run's partial written to
//     part[z] and summed by sum_splits in a fixed order: no float atomics,
//     the same bits on every run;
//   * triangle (K2, K5): block (I, s) owns row tile I and walks the column
//     tiles J = I + 8 s .. I + 8 s + 7 (J < nt), so each unordered pair of
//     128-point tiles is evaluated once; the forward contraction K_IJ V_J
//     as above, its row sums added once by atomicAdd; for J > I the mirror
//     K_IJ^T V_I: V_I (transposed) is read into shared memory once a block;
//     per right-hand side a thread sums its 8 rows for each of its 8
//     columns, the two lanes that share those columns (rows 8 apart)
//     reduce-scatter them by shuffles, 4 columns each, the 8 warps' sums go
//     through shared memory (4 right-hand sides at a time) and are added in
//     warp order, and one atomicAdd a column goes into the output, zeroed in
//     the same call. The diagonal tile contracts forward only. The float
//     atomics make the last bits change from run to run;
//   * pair (K4, K6): the triangle's mirror without the triangle. Block
//     (I, s) owns row tile I of X1 and the column tiles [s run, (s + 1)
//     run) of X2 (kernel_cuda.tile_splits runs), the whole nt1 x nt2
//     rectangle, no tile skipped; the forward sums go to out1 (rows of X1)
//     and every tile's mirror, from V1 of the row tile, to out2 (rows of
//     X2), both by atomicAdd into outputs zeroed in the same call;
//   * __launch_bounds__(256, 2): two blocks an SM, 128 registers a thread
//     (the build's -Xptxas -v log, chip_smoke.py's registers line).
//
// The exponential: __expf is ex2.approx of the product x log2 e rounded to
// float, so its relative error grows with |x|, about |x| 2^-24 besides
// ex2's own 2 ulps; its absolute error, |x| e^-|x| 2^-24 at most, peaks
// under 2.2e-8 at |x| = 1. Against max|ref| of a product (a sum of values
// up to 1 times V) that is far inside the exact tier's 2e-5. Measured on an
// H100 at the HIGGS shape with RBF's and Matern-5/2's largest arguments,
// K1's and K2's largest error was 0.9-1.5e-6 of max|ref| with __expf and
// with expf alike, and expf cost 4-6% more time; chip_smoke.py holds every
// family to 2e-5 against float64.

#pragma once

#include "gram_common.cuh"

namespace {

constexpr int kLTile = 128;  // points per tile (rows of X1, columns of X2)
constexpr int kLFeat = 32;   // features per staged chunk
constexpr int kLStages = 2;  // chunk buffers: one load in flight
constexpr int kLThreads = 256;

constexpr int kLWarps = kLThreads / 32;
constexpr int kLRun = 8;     // column tiles a triangle block walks

// The tile's forms: forward (K1, K3), triangle (K2, K5) and pair (K4, K6).
enum TileForm { L_FORWARD = 0, L_TRIANGLE = 1, L_PAIR = 2 };

template <int KC>
struct __align__(16) TileSmem128 {
  float x[kLStages][kLFeat][kLTile];  // the row tile's chunk
  float y[kLStages][kLFeat][kLTile];  // the column tile's chunk
  float v[kLStages][KC][kLTile];      // V of the column tile, transposed
};

// The mirror of the triangle and the pair, after TileSmem128 in shared
// memory.
template <int KC>
struct __align__(16) TileMirror {
  static constexpr int kGroup = KC < 4 ? KC : 4;  // right-hand sides a pass
  float vi[KC][kLTile];                 // V (V1 of the pair) of the row tile, transposed
  float sums[kLWarps][kGroup][kLTile];  // each warp's column sums of a pass
};

__device__ __forceinline__ void tile_cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void tile_cp_async4(void* dst, const void* src, bool valid) {
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

// One feature's step of a pair's distance: |x - y| added (Laplace, two
// FADDs), or (x - y)^2 by FSUB and FFMA (the squared-distance families).
template <int KIND>
__device__ __forceinline__ float dist_step(float acc, float x, float y) {
  if constexpr (KIND == LAPLACE) {
    return acc + fabsf(x - y);
  } else {
    const float d = x - y;
    return fmaf(d, d, acc);
  }
}

// The square root on the SFU (MUFU.SQRT, relative error about 2^-23).
__device__ __forceinline__ float sqrt_sfu(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The kernel value from the tile's distance: Laplace e^-L1, RBF
// e^(-d2 / 2), the Matern forms of gram_common.cuh's finish with the
// square root and the exponential on the SFU.
template <int KIND>
__device__ __forceinline__ float tile_value(float d2) {
  if constexpr (KIND == LAPLACE) {
    return __expf(-d2);
  } else if constexpr (KIND == RBF) {
    return __expf(-0.5f * d2);
  } else {
    const float r = sqrt_sfu(d2);
    if constexpr (KIND == MATERN12) {
      return __expf(-r);
    } else if constexpr (KIND == MATERN32) {
      const float s3 = 1.7320508075688772f;
      return (1.0f + s3 * r) * __expf(-s3 * r);
    } else {
      const float s5 = 2.23606797749979f;
      return (1.0f + s5 * r + (5.0f / 3.0f) * d2) * __expf(-s5 * r);
    }
  }
}

// One feature of the thread's 8 x 8 tile: D[i][j] = dist_step(D[i][j],
// x[rbase + i], y[col j]).
template <int KIND>
__device__ __forceinline__ void tile_feature(float (&D)[8][8], const float* x, const float* y,
                                             int rbase, int cbase) {
  float a[8], b[8];
  load4(x + rbase, a);
  load4(x + rbase + 4, a + 4);
  load4(y + cbase, b);
  load4(y + 64 + cbase, b + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) D[i][j] = dist_step<KIND>(D[i][j], a[i], b[j]);
}

// The three forms, k <= 16. XT1 (dpad, npad), XT2 (dpad, mpad) floats: the
// scaled points, transposed, zero padded; V (m, k).
// L_FORWARD: block (I, 0, z): row tile I, column tiles [z run, (z + 1)
// run). One run: out = c * sums; more: part[z] = sums, for sum_splits.
// L_TRIANGLE: X2 = X1, V1 = V, out2 = out, block (I, s): row tile I,
// column tiles [I + s run, I + (s + 1) run), every sum added to out
// (zeroed) by atomicAdd.
// L_PAIR: block (I, s): row tile I, column tiles [s run, (s + 1) run);
// the forward sums added to out (n, k), the mirror from V1 (n, k) to out2
// (m, k), both zeroed, by atomicAdd. (V1 and out2 are not __restrict__:
// the triangle passes V and out for them.)
template <int KIND, int KC, int FORM>
__device__ __forceinline__ void gram_tile(const float* __restrict__ XT1,
                                          const float* __restrict__ XT2,
                                          const float* __restrict__ V,
                                          const float* V1, float* __restrict__ out,
                                          float* out2,
                                          float* __restrict__ part, int n, int m, int npad,
                                          int mpad, int d, int k, int run, double c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem128<KC>& sm = *reinterpret_cast<TileSmem128<KC>*>(smem_raw);
  TileMirror<KC>& mi =
      *reinterpret_cast<TileMirror<KC>*>(smem_raw + sizeof(TileSmem128<KC>));
  const int mt = (m + kLTile - 1) / kLTile;
  int J0, J1;
  if constexpr (FORM != L_FORWARD) {
    J0 = (FORM == L_TRIANGLE ? blockIdx.x : 0) + blockIdx.y * run;
    if (J0 >= mt) return;  // past the triangle's (the rectangle's) edge: the whole block
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
  if constexpr (FORM != L_FORWARD) {
    // V1 of the row tile (V in the triangle), for every mirror of the run
    // (visible after the first step's barrier); zero past n
    for (int e = tid; e < KC * kLTile; e += kLThreads) {
      const int cc = e / kLTile, j = e % kLTile;
      mi.vi[cc][j] = cc < kc && row0 + j < n ? V1[(size_t)(row0 + j) * k + cc] : 0.0f;
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
        tile_cp_async16(&sm.x[lbuf][f][q], xs + (size_t)f * npad + q);
        tile_cp_async16(&sm.y[lbuf][f][q], ys + (size_t)f * mpad + q);
      }
      if (lch == 0) {
        const int col0 = lJ * kLTile;
        for (int e = tid; e < kLTile * KC; e += kLThreads) {
          const int cc = e / kLTile, j = e % kLTile;
          const bool valid = col0 + j < m && cc < kc;
          tile_cp_async4(&sm.v[lvb][cc][j], valid ? V + (size_t)(col0 + j) * k + cc : V, valid);
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
      for (int f = 0; f < kLFeat; ++f)
        tile_feature<KIND>(D, sm.x[buf][f], sm.y[buf][f], rbase, cbase);
    } else {
#pragma unroll 4
      for (int f = 0; f < nf; ++f)
        tile_feature<KIND>(D, sm.x[buf][f], sm.y[buf][f], rbase, cbase);
    }
    buf = buf == kLStages - 1 ? 0 : buf + 1;
    if (++ch != chunks) continue;
    ch = 0;

    // epilogue: the values, then each right-hand side contracted
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) D[i][j] = tile_value<KIND>(D[i][j]);
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
    if constexpr (FORM != L_FORWARD) {
      // the mirror K_IJ^T V_I into the rows of tile J: above the triangle's
      // diagonal, every tile of the pair
      if (FORM == L_PAIR || cj > (int)blockIdx.x) {
        constexpr int G = TileMirror<KC>::kGroup;
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
            if (g0 + g < kc && col0 + j < m) {
              float sum = mi.sums[0][g][j];
#pragma unroll
              for (int w = 1; w < kLWarps; ++w) sum += mi.sums[w][g][j];
              atomicAdd(&out2[(size_t)(col0 + j) * k + g0 + g], sum * cf);
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
  if constexpr (FORM != L_FORWARD) {
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

template <int KIND, int KC>
__global__ void __launch_bounds__(kLThreads, 2)
    tile_forward(const float* __restrict__ XT1, const float* __restrict__ XT2,
                 const float* __restrict__ V, float* __restrict__ out,
                 float* __restrict__ part, int n, int m, int npad, int mpad, int d, int k,
                 int run, double c) {
  gram_tile<KIND, KC, L_FORWARD>(XT1, XT2, V, nullptr, out, nullptr, part, n, m, npad, mpad, d,
                                 k, run, c);
}

template <int KIND, int KC>
__global__ void __launch_bounds__(kLThreads, 2)
    tile_triangle(const float* __restrict__ XT, const float* __restrict__ V,
                  float* __restrict__ out, int n, int npad, int d, int k, int run, double c) {
  gram_tile<KIND, KC, L_TRIANGLE>(XT, XT, V, V, out, out, nullptr, n, n, npad, npad, d, k, run,
                                  c);
}

template <int KIND, int KC>
__global__ void __launch_bounds__(kLThreads, 2)
    tile_pair(const float* __restrict__ XT1, const float* __restrict__ XT2,
              const float* __restrict__ V2, const float* __restrict__ V1,
              float* __restrict__ out1, float* __restrict__ out2, int n1, int n2, int n1pad,
              int n2pad, int d, int k, int run, double c) {
  gram_tile<KIND, KC, L_PAIR>(XT1, XT2, V2, V1, out1, out2, nullptr, n1, n2, n1pad, n2pad, d, k,
                              run, c);
}

// The triangle form: out zeroed, then the blocks (I, s), s < ceil(nt / run).
template <int KIND, int KC>
cudaError_t launch_tile_triangle(const float* XT, const float* V, float* out, int n, int npad,
                                 int d, int k, double c, cudaStream_t s) {
  const int bytes = (int)(sizeof(TileSmem128<KC>) + sizeof(TileMirror<KC>));
  cudaError_t err = cudaFuncSetAttribute(
      tile_triangle<KIND, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nt = (n + kLTile - 1) / kLTile;
  const int strips = (nt + kLRun - 1) / kLRun;
  if (strips > 65535) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return err;
  tile_triangle<KIND, KC><<<dim3(nt, strips), kLThreads, bytes, s>>>(XT, V, out, n, npad, d, k,
                                                                     kLRun, c);
  return cudaGetLastError();
}

// The pair form: out1 and out2 zeroed, then the blocks (I, s), each on
// `run` column tiles of X2.
template <int KIND, int KC>
cudaError_t launch_tile_pair(const float* XT1, const float* XT2, const float* V2,
                             const float* V1, float* out1, float* out2, int n1, int n2,
                             int n1pad, int n2pad, int d, int k, int run, double c,
                             cudaStream_t s) {
  const int bytes = (int)(sizeof(TileSmem128<KC>) + sizeof(TileMirror<KC>));
  cudaError_t err = cudaFuncSetAttribute(
      tile_pair<KIND, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nt2 = (n2 + kLTile - 1) / kLTile;
  const int strips = (nt2 + run - 1) / run;
  if (strips > 65535) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(out1, 0, sizeof(float) * (size_t)n1 * k, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(out2, 0, sizeof(float) * (size_t)n2 * k, s);
  if (err != cudaSuccess) return err;
  tile_pair<KIND, KC><<<dim3((n1 + kLTile - 1) / kLTile, strips), kLThreads, bytes, s>>>(
      XT1, XT2, V2, V1, out1, out2, n1, n2, n1pad, n2pad, d, k, run, c);
  return cudaGetLastError();
}

// The forward form in `splits` runs of the m axis (fewer if m has fewer
// tiles), their partials summed by sum_splits in a fixed order.
template <int KIND, int KC>
cudaError_t launch_tile_forward(const float* XT1, const float* XT2, const float* V, float* out,
                                float* part, int n, int m, int npad, int mpad, int d, int k,
                                int splits, double c, cudaStream_t s) {
  const int bytes = (int)sizeof(TileSmem128<KC>);
  cudaError_t err = cudaFuncSetAttribute(
      tile_forward<KIND, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int mt = (m + kLTile - 1) / kLTile;
  if (part == nullptr || splits < 1) splits = 1;
  if (splits > mt) splits = mt;
  const int run = (mt + splits - 1) / splits;
  splits = (mt + run - 1) / run;
  const dim3 grid((n + kLTile - 1) / kLTile, 1, splits);
  tile_forward<KIND, KC><<<grid, kLThreads, bytes, s>>>(XT1, XT2, V, out, part, n, m, npad,
                                                        mpad, d, k, run, c);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)n * k;
  size_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, kThreads, 0, s>>>(part, out, splits, count, c);
  return cudaGetLastError();
}

// The operand checks of the tile's C entries: the layout of
// kernel_cuda.tile_operand (dpad a multiple of 32 at or above d, npad of
// 128 at or above n).
inline bool tile_operand_ok(int n, int npad, int d, int dpad) {
  return n >= 1 && d >= 1 && dpad % kLFeat == 0 && dpad >= d && npad % kLTile == 0 &&
         npad >= n;
}

// The C entries' bodies at the smallest KC that holds k <= 16 columns.
template <int KIND>
cudaError_t tile_forward_by_k(const float* XT1, const float* XT2, const float* V, float* out,
                              float* part, int n, int m, int npad, int mpad, int d, int k,
                              int splits, double c, cudaStream_t s) {
  if (k > 8)
    return launch_tile_forward<KIND, 16>(XT1, XT2, V, out, part, n, m, npad, mpad, d, k,
                                         splits, c, s);
  if (k > 4)
    return launch_tile_forward<KIND, 8>(XT1, XT2, V, out, part, n, m, npad, mpad, d, k,
                                        splits, c, s);
  if (k > 2)
    return launch_tile_forward<KIND, 4>(XT1, XT2, V, out, part, n, m, npad, mpad, d, k,
                                        splits, c, s);
  if (k > 1)
    return launch_tile_forward<KIND, 2>(XT1, XT2, V, out, part, n, m, npad, mpad, d, k,
                                        splits, c, s);
  return launch_tile_forward<KIND, 1>(XT1, XT2, V, out, part, n, m, npad, mpad, d, k, splits,
                                      c, s);
}

template <int KIND>
cudaError_t tile_pair_by_k(const float* XT1, const float* XT2, const float* V2, const float* V1,
                           float* out1, float* out2, int n1, int n2, int n1pad, int n2pad, int d,
                           int k, int run, double c, cudaStream_t s) {
  if (k > 8)
    return launch_tile_pair<KIND, 16>(XT1, XT2, V2, V1, out1, out2, n1, n2, n1pad, n2pad, d, k,
                                      run, c, s);
  if (k > 4)
    return launch_tile_pair<KIND, 8>(XT1, XT2, V2, V1, out1, out2, n1, n2, n1pad, n2pad, d, k,
                                     run, c, s);
  if (k > 2)
    return launch_tile_pair<KIND, 4>(XT1, XT2, V2, V1, out1, out2, n1, n2, n1pad, n2pad, d, k,
                                     run, c, s);
  if (k > 1)
    return launch_tile_pair<KIND, 2>(XT1, XT2, V2, V1, out1, out2, n1, n2, n1pad, n2pad, d, k,
                                     run, c, s);
  return launch_tile_pair<KIND, 1>(XT1, XT2, V2, V1, out1, out2, n1, n2, n1pad, n2pad, d, k, run,
                                   c, s);
}

template <int KIND>
cudaError_t tile_triangle_by_k(const float* XT, const float* V, float* out, int n, int npad,
                               int d, int k, double c, cudaStream_t s) {
  if (k > 8) return launch_tile_triangle<KIND, 16>(XT, V, out, n, npad, d, k, c, s);
  if (k > 4) return launch_tile_triangle<KIND, 8>(XT, V, out, n, npad, d, k, c, s);
  if (k > 2) return launch_tile_triangle<KIND, 4>(XT, V, out, n, npad, d, k, c, s);
  if (k > 1) return launch_tile_triangle<KIND, 2>(XT, V, out, n, npad, d, k, c, s);
  return launch_tile_triangle<KIND, 1>(XT, V, out, n, npad, d, k, c, s);
}

}  // namespace
