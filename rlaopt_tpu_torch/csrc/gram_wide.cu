// K1 and K3 past 16 columns, for Hopper (sm_90a): out = c * k(X1, X2) @ V
// for every family, the contraction on the tensor cores in 3xTF32.
//
//   K1  gram_wide_tf32<KIND, NF>  replaces rlaopt_tpu/ops/kernel_pallas.py ::
//       (KIND != LAPLACE,         kernel_matmat_pallas, exact tier, past 16
//       k > 16)                   columns: its six-term bf16 fold of the
//                                 distance on the MXU and its contraction at
//                                 Precision.HIGHEST (the Nystrom sketch at
//                                 k = 500, config 5's at k = 200)
//   K3  gram_wide_tf32<LAPLACE,   replaces kernel_pallas.py:592, the Laplace matmat,
//       NF> (k > 16)              past 16 columns: the L1 distance on the
//                                 VPU, the contraction at "highest" (path
//                                 B's sketch at k = 500, E3's sketches)
//
// What bounds it on the H100: at k = 500 the contraction, 2k operations a
// kernel value (1,000 of every value's ~1,056-1,084 at d = 28); on the FP32
// cores that alone is ~150 ms at 100k^2. Here it runs on the TF32 tensor
// cores in three passes, hi.hi + hi.lo + lo.hi, each value and each V entry
// split into TF32 parts (hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi)):
// the error of a product is ~2^-21 of it, float32-class (the TPU's
// "highest" contract), where one TF32 pass keeps ~3 digits. Three passes of
// 2k at the data sheet's dense 495 TFLOP/s are ~61 ms at 100k^2, k = 500;
// the distances on the FP32 cores ~12.5 ms a pass over the values (a
// squared pair's FSUB and FFMA and an L1 pair's two FADDs take the same
// two issue slots a feature) and the exponential ~2.4 ms on the SFU.
//
// Design (the values never leave registers between the distance and the
// tensor cores):
//   * block (I, y) owns 128 rows of X1 and the 8 NF output columns from
//     8 NF y (NF = 16: 128 columns; 8: 64), and walks the column tiles of 64
//     points of X2; 256 threads, warp w the 32 rows 32 (w & 3) .. and the
//     32 tile columns 32 (w >> 2) ..;
//   * the thread map is chosen so that a lane's distance tile is its mma A
//     fragments: lane (g = lane / 4, t = lane % 4) owns the 4 physical rows
//     4 g .. 4 g + 3 of its warp's 32 and the 8 physical columns 8 t ..
//     8 t + 7 of its 32, which are rows 16 a + g + 8 h (physical 4 g + 2 a
//     + h) of the m16 tiles a = 0, 1 and contraction indices 8 s + t + 4 u
//     (physical 8 t + 2 s + u) of the k8 steps s = 0 .. 3. The rows and the
//     contraction index are permuted, not the arithmetic: the output rows
//     are written back through the same map, and V's rows are staged in the
//     same order. Per feature a lane reads three float4 (4 x values, 8 y)
//     for 32 pairs (FSUB + FFMA, or Laplace's two FADDs: gram_tile.cuh's
//     dist_step);
//   * the points come as the register tile's operand (kernel_cuda.
//     tile_operand: scaled, transposed, zero padded), staged by cp.async in
//     chunks of 32 features, one chunk ahead, as in gram_tile.cuh; with one
//     chunk (d <= 32) the row tile's stays in shared memory from the first
//     step;
//   * V's TF32 parts are split once per call by the wrapper
//     (kernel_cuda.wide_rhs: pairs of V rows, (hi0, hi1, lo0, lo1) a 16-byte
//     piece for each output column), staged with the tile's first chunk by
//     cp.async (two buffers), each piece a lane's B fragments (b0, b1) of
//     both parts, read as one float4; the pieces of a row of 32 pairs sit
//     4 s + t apart, 36 a row, so that a quarter warp's 8 reads hit 8
//     distinct 16-byte bank groups;
//   * after the distance, the epilogue (gram_tile.cuh's tile_value) and the
//     split into hi and lo in registers, then per group of G n-tiles (2 at
//     NF = 16, 4 at NF = 8) a fresh set of accumulators takes the tile's 4
//     k-steps x 3 passes, the passes in turn over the 2 G accumulators (the
//     small terms first), and is added to float running sums: the tensor
//     cores' own accumulation is not IEEE float, and carried over every tile
//     its error grows (K1b's wide kernel lost 7.6e-5 of max|ref| so);
//   * the two warps that share rows (their halves of the tile's columns)
//     add their running sums through shared memory once, at the end;
//   * registers: the 8 NF running sums, the 64 parts of the 32 values;
//     256 threads, one block an SM (__launch_bounds__); the build's
//     -Xptxas -v log reports them (chip_smoke.py's registers line).
// A value is evaluated once per 8 NF output columns: 4 times at k = 500
// with NF = 16. Timed on an H100 at 700 W (tools/before_after.py): up to
// kp = 64, NF = 8 (245-249 registers, no spills) took 14-17% less time
// than NF = 16 (255 registers, 116 bytes spilled) at k = 17, 32, 64; at
// k = 200 and 500 it took more, each value evaluated twice as often.

#include "gram_tile.cuh"

namespace {

constexpr int kWRows = 128;            // rows of X1 a block: 4 warp rows of 32
constexpr int kWCols = 64;             // points of X2 a column tile: 2 warp columns of 32
constexpr int kWFeat = 32;             // features a staged chunk
constexpr int kWPairs = kWCols / 2;    // pairs of V rows a tile
constexpr int kWVld = kWPairs + 4;     // 16-byte pieces a V row in shared memory
constexpr int kWThreads = 256;

template <int NF>
struct __align__(16) WideSmem {
  float x[2][kWFeat][kWRows];   // the row tile's chunk
  float y[2][kWFeat][kWCols];   // the column tile's chunk
  float4 v[2][8 * NF][kWVld];   // V's parts of the column tile, by output column
};

__device__ __forceinline__ void wide_cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16 x 8, TF32, row) * B (8 x 8, TF32, col), float32 accumulate.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// XT1 (dpad, npad), XT2 (dpad, mpad): the tile's operands; VP (mpad / 2,
// kp) pieces of 4 floats: V's TF32 parts (kernel_cuda.wide_rhs), zero past
// m and k; out (n, k).
// G: n-tiles a group of fresh accumulators takes (2 G independent mma
// chains a warp): 2 at NF = 16, 4 at NF = 8, as registers allow.
template <int KIND, int NF, int G = NF == 16 ? 2 : 4>
__global__ void __launch_bounds__(kWThreads, 1)
    gram_wide_tf32(const float* __restrict__ XT1, const float* __restrict__ XT2,
                   const float4* __restrict__ VP, float* __restrict__ out, int n, int m,
                   int npad, int mpad, int d, int k, int kp, double c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideSmem<NF>& sm = *reinterpret_cast<WideSmem<NF>*>(smem_raw);
  constexpr int BN = 8 * NF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp & 3, wc = warp >> 2;
  const int row0 = blockIdx.x * kWRows;
  const int c0 = blockIdx.y * BN;
  const int xo = 32 * wr + 4 * g;  // the lane's 4 rows of the tile
  const int yo = 32 * wc + 8 * t;  // and its 8 columns
  const int mt = (m + kWCols - 1) / kWCols;
  const int chunks = (d + kWFeat - 1) / kWFeat;
  const int steps = mt * chunks;
  // n-tiles of this block's columns that hold any of V's kp columns
  const int tiles = min(NF, (kp - c0 + 7) / 8);

  int lst = 0, lJ = 0, lch = 0, lbuf = 0, lvb = 0;
  const auto load_next = [&]() {
    if (lst < steps) {
      const float* xs = XT1 + (size_t)lch * kWFeat * npad + row0;
      const float* ys = XT2 + (size_t)lch * kWFeat * mpad + (size_t)lJ * kWCols;
      // one chunk of features: the row tile's stays in buffer 0 from the first step
      for (int e = tid; e < kWFeat * kWRows / 4 && (chunks > 1 || lst == 0); e += kWThreads) {
        const int f = e / (kWRows / 4), q = 4 * (e % (kWRows / 4));
        wide_cp_async16(&sm.x[lbuf][f][q], xs + (size_t)f * npad + q, true);
      }
      for (int e = tid; e < kWFeat * kWCols / 4; e += kWThreads) {
        const int f = e / (kWCols / 4), q = 4 * (e % (kWCols / 4));
        wide_cp_async16(&sm.y[lbuf][f][q], ys + (size_t)f * mpad + q, true);
      }
      if (lch == 0) {
        // pair pl = 16 wc + 4 t + s of the tile goes to piece 16 wc + 4 s + t
        const float4* vs = VP + (size_t)lJ * kWPairs * kp + c0;
        for (int e = tid; e < kWPairs * BN; e += kWThreads) {
          const int col = e % BN, pl = e / BN;
          const int q = (pl & ~15) | ((pl & 3) << 2) | ((pl >> 2) & 3);
          const bool valid = c0 + col < kp;
          wide_cp_async16(&sm.v[lvb][col][q], valid ? vs + (size_t)pl * kp + col : VP, valid);
        }
      }
      ++lst;
      lbuf ^= 1;
      if (++lch == chunks) {
        lch = 0;
        ++lJ;
        lvb ^= 1;
      }
    }
    asm volatile("cp.async.commit_group;\n");  // empty past the last step
  };

  float acc[2][NF][4];  // running sums: m16 tile a, n-tile f, fragment entry
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][f][r] = 0.0f;
  float D[4][8];

  load_next();
  int ch = 0, buf = 0, vb = 0;
  for (int st = 0; st < steps; ++st) {
    asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();
    load_next();
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) D[i][j] = 0.0f;
    }
    const int nf = min(kWFeat, d - ch * kWFeat);
    const int xb = chunks > 1 ? buf : 0;
#pragma unroll 8
    for (int f = 0; f < nf; ++f) {
      float xa[4], yb[8];
      load4(&sm.x[xb][f][xo], xa);
      load4(&sm.y[buf][f][yo], yb);
      load4(&sm.y[buf][f][yo + 4], yb + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) D[i][j] = dist_step<KIND>(D[i][j], xa[i], yb[j]);
    }
    buf ^= 1;
    if (++ch != chunks) continue;
    ch = 0;

    // the values and their TF32 parts: kh[i][j], kl[i][j] of physical row
    // 4 g + i, column 8 t + j
    uint32_t kh[4][8], kl[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = tile_value<KIND>(D[i][j]);
        kh[i][j] = tf32_rna(v);
        kl[i][j] = tf32_rna(v - __uint_as_float(kh[i][j]));
      }
    // A of m16 tile a, k-step s: a0 (row g, k t) = (2a, 2s), a1 (row g + 8)
    // = (2a + 1, 2s), a2 (k t + 4) = (2a, 2s + 1), a3 = (2a + 1, 2s + 1)
    const float4* vrow = &sm.v[vb][g][16 * wc + t];
#pragma unroll
    for (int f0 = 0; f0 < NF; f0 += G) {
      if (f0 >= tiles) break;
      float P[2][G][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int f = 0; f < G; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) P[a][f][r] = 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int f = 0; f < G; ++f) {
          const float4 q = vrow[(size_t)8 * (f0 + f) * kWVld + 4 * s];
          bh[f][0] = __float_as_uint(q.x);
          bh[f][1] = __float_as_uint(q.y);
          bl[f][0] = __float_as_uint(q.z);
          bl[f][1] = __float_as_uint(q.w);
        }
        // the passes in turn over the 2 G accumulators: hi.lo, lo.hi, hi.hi
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const uint32_t(&A)[4][8] = pass == 1 ? kl : kh;
#pragma unroll
            for (int f = 0; f < G; ++f) {
              const uint32_t(&B)[G][2] = pass == 0 ? bl : bh;
              mma_tf32(P[a][f], A[2 * a][2 * s], A[2 * a + 1][2 * s], A[2 * a][2 * s + 1],
                       A[2 * a + 1][2 * s + 1], B[f][0], B[f][1]);
            }
          }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int f = 0; f < G; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[a][f0 + f][r] += P[a][f][r];
    }
    vb ^= 1;
  }

  // the two warps of a row strip add their sums: warp column 1 through
  // shared memory (every load is done; the trailing groups are empty)
  asm volatile("cp.async.wait_group 0;\n");
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw) + (size_t)wr * (8 * NF) * 32 + lane;
  if (wc == 1) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) red[(size_t)((a * NF + f) * 4 + r) * 32] = acc[a][f][r];
  }
  __syncthreads();
  if (wc == 1) return;
  // fragment entry r of (a, f): row 16 a + g + 8 (r >> 1), physical
  // 4 g + 2 a + (r >> 1); column 8 f + 2 t + (r & 1)
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gr = row0 + xo + 2 * a + (r >> 1);
        const int gc = c0 + 8 * f + 2 * t + (r & 1);
        const float sum = acc[a][f][r] + red[(size_t)((a * NF + f) * 4 + r) * 32];
        if (gr < n && gc < k) out[(size_t)gr * k + gc] = (float)(sum * c);
      }
}

template <int KIND, int NF>
cudaError_t launch_wide_tf32(const float* XT1, const float* XT2, const float4* VP, float* out,
                             int n, int m, int npad, int mpad, int d, int k, int kp, double c,
                             cudaStream_t s) {
  static_assert(sizeof(WideSmem<NF>) >= sizeof(float) * 4 * (8 * NF) * 32,
                "the row strips' sums fit in the stage buffers");
  const int bytes = (int)sizeof(WideSmem<NF>);
  cudaError_t err = cudaFuncSetAttribute(gram_wide_tf32<KIND, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kWRows - 1) / kWRows, (kp + 8 * NF - 1) / (8 * NF));
  gram_wide_tf32<KIND, NF><<<grid, kWThreads, bytes, s>>>(XT1, XT2, VP, out, n, m, npad, mpad,
                                                          d, k, kp, c);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t wide_by_nf(int nf, const float* XT1, const float* XT2, const float4* VP, float* out,
                       int n, int m, int npad, int mpad, int d, int k, int kp, double c,
                       cudaStream_t s) {
  if (nf == 16)
    return launch_wide_tf32<KIND, 16>(XT1, XT2, VP, out, n, m, npad, mpad, d, k, kp, c, s);
  return launch_wide_tf32<KIND, 8>(XT1, XT2, VP, out, n, m, npad, mpad, d, k, kp, c, s);
}

}  // namespace

// K1 and K3 past 16 columns: out (n, k) = c * k(X1, X2) @ V for the family
// `kind` (every one, Laplace included) from the tile's operands XT1 (dpad,
// npad), XT2 (dpad, mpad) (as rl_gram_matmat_narrow) and VP, V's TF32
// parts as (mpad / 2, kp) pieces of 4 floats (kernel_cuda.wide_rhs), kp a
// multiple of 8 at or above k; nf: 8 or 16 n-tiles of 8 output columns a
// block. Zero padding adds nothing to a squared or an L1 distance. Plain C
// interface, as gram.cu's.
extern "C" int rl_gram_matmat_wide(int kind, const void* XT1, const void* XT2, const void* VP,
                                   void* out, int n, int m, int npad, int mpad, int d, int dpad,
                                   int k, int kp, int nf, double c, void* stream) {
  if (k < 1 || kp < k || kp % 8 || (nf != 8 && nf != 16) || !tile_operand_ok(n, npad, d, dpad) ||
      !tile_operand_ok(m, mpad, d, dpad))
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT1);
  const float* B = static_cast<const float*>(XT2);
  const float4* P = static_cast<const float4*>(VP);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return (int)wide_by_nf<RBF>(nf, A, B, P, o, n, m, npad, mpad, d, k, kp, c, s);
    case MATERN12: return (int)wide_by_nf<MATERN12>(nf, A, B, P, o, n, m, npad, mpad, d, k, kp, c, s);
    case MATERN32: return (int)wide_by_nf<MATERN32>(nf, A, B, P, o, n, m, npad, mpad, d, k, kp, c, s);
    case MATERN52: return (int)wide_by_nf<MATERN52>(nf, A, B, P, o, n, m, npad, mpad, d, k, kp, c, s);
    case LAPLACE: return (int)wide_by_nf<LAPLACE>(nf, A, B, P, o, n, m, npad, mpad, d, k, kp, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
