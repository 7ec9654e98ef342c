// The bf16 accuracy tiers of the fused Gram products, for Hopper (sm_90a).
//
//   K1b gram_matmat_tier<PASSES>            replaces rlaopt_tpu/ops/
//       kernel_pallas.py :: kernel_matmat_pallas with compute_dtype="bf16x3"
//       (PASSES = 3: _cross_split, _body_split) or "bfloat16" (PASSES = 1:
//       _cross_bf16, _body_bf16), and _acc_update's tier-matched "split" and
//       "fast" contractions for k > 16
//   K2b gram_tier_symmetric<KIND, PASSES, KC>  replaces kernel_pallas.py ::
//       kernel_matvec_symmetric with the same tiers (_sym_epilogue,
//       _sym_tier_params, _sym_mirror_mode)
//
// Operands: the bf16 parts of the points pre-scaled by the lengthscale (hi,
// and lo for bf16x3), split once per operator in PyTorch and padded in depth
// to a multiple of 16 with zeros, and the norm vectors hx, hy of
// _norms_and_operands (ops/kernel_tiers.py).
//
// What bounds them on the H100: the cross term x.y of every kernel value is
// 3 (or 1) bf16 products of depth dp = 32 at d = 28 on the tensor cores, and
// the exponential (one SFU operation a value, 16 a clock per SM; Matern adds
// a square root) is of the same order; the rest on the CUDA cores is a few
// float32 operations of epilogue per value and, for k <= 16, the float32
// contraction (2 FMAs per value and column, 4 with the triangle's mirror).
// At k = 500 (the Nystrom sketch) the contraction is the work: 3 bf16 passes
// of depth 64 per tile and 128 columns on the tensor cores, fed from shared
// memory.
//
// Design of K1b. The K tile (64 x 64, tier_tile in gram_common.cuh): the
// parts of both point tiles are staged 16 features at a time; each of 8
// warps runs wmma 16x16x16 (bf16 in, float accumulate) on a 16-row strip and
// two 16-column fragments, hi.hi + hi.lo + lo.hi (the lo.lo term is dropped,
// as in the JAX kernel); the fragments go to shared memory, where the
// epilogue finishes the values in float32 in place. For k <= 16 the narrow
// contraction is K1's, float32 on the CUDA cores. For k > 16
// (gram_matmat_tier_wide) a block owns 64 rows and 128 right-hand-side
// columns: per column tile it splits the K tile and the matching 64 x 128
// slice of V into bf16 parts in shared memory and contracts them, hi.hi +
// hi.lo + lo.hi (or hi.hi), in wmma fragments whose partials are added to
// float sums tile by tile, so the contraction runs on the tensor cores at
// the tier's accuracy; the K tile is recomputed once per 128 columns (4
// times at k = 500). K2b has a kernel of its own (gram_tier_symmetric,
// below: mma.sync into registers, the epilogue and both contractions on the
// fragments); K4b (gram_pair.cu) keeps the shared triangle template.
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

// ---------------------------------------------------------------------------
// K2b: the triangle matvec on the tensor cores, finished in registers.
//
// What bounds it on the H100: per kernel value, 3 (or 1) bf16 products of
// depth dp on the tensor cores (0.85 ms of work at n = 100,000, d = 28 on
// the 989 TFLOP/s data-sheet rate) and one exponential on the SFU, which
// issues 16 a clock per SM: 5.0e9 values at 132 x 16 x 1.98 GHz take
// ~1.2 ms, the floor. The first version (the shared triangle template with
// tier_tile) ran at 6% of it: per 64 x 64 tile it staged both point tiles
// 16 features at a time, stored the wmma accumulators to shared memory, ran
// the epilogue there, read the tile again for the row contraction and by
// columns for the mirror (the four threads of a quad 16 rows of 68 floats
// apart: one bank by the address arithmetic, not confirmed by a profiler),
// six barriers and two shared-memory round trips for 4,096 values, about
// one value per SM per clock.
//
// Design. Block (I, s) owns row tiles 2I and 2I + 1 (128 rows; warp w its
// rows 16w..16w+15) and walks the column tiles J = 2I + 16s .. 2I + 16s +
// 15 (J < nt): each column tile's parts are loaded once for 128 rows (its
// traffic from L2 is half that of a 64-row block), and a warp takes no
// part below the diagonal (J < its row tile) and the forward contraction
// alone on it:
//   * cross term: mma.sync m16n8k16 (bf16 in, float32 accumulate) into
//     registers, hi.hi + hi.lo + lo.hi (bf16x3) or hi.hi (bfloat16), the
//     passes interleaved over 8 accumulators; each warp holds its 16 x 64
//     strip of the tile as 8 fragments of 16 x 8, a thread 2 rows x 2
//     columns of each. The accumulators never go to shared memory;
//   * epilogue in registers on the fragment layout: RBF as
//     ex2(cross log2 e - (hx + hy) log2 e) (the norms taken times log2 e),
//     the Matern forms from max(hx + hy - 2 cross, 0) with their ex2;
//     entries past n are zero;
//   * row contraction K_IJ V_J from the same registers, into 2 x KC float
//     sums a thread carried over the strip and added across the quad by
//     shuffles once at the end (one atomicAdd per output row and block);
//   * mirror K_IJ^T V_I (J above the warp's row tile) from the same
//     registers. At k >= 3 the tier-matched contraction (hi.hi + hi.lo +
//     lo.hi of the values' and V_I's bf16 parts, or hi.hi on the one-pass
//     tier, as _sym_mirror_mode) runs on the tensor cores: each pair of
//     accumulator fragments is rounded to bf16 parts and transposed in
//     registers (movmatrix) into the A operand of K^T V_I, V_I's parts
//     being a B operand held for the whole strip. At k <= 2 it is float32
//     on the CUDA cores: each thread's
//     2-row partial of its 16 columns, reduced over the fragment's 8 row
//     groups by a shuffle reduce-scatter (8 + 4 + 2 shuffles, each lane
//     left with 2 column sums). Either way the warps' column sums are
//     added once per tile in shared memory in a fixed order, and one
//     atomicAdd goes out per column;
//   * loads: the column tiles' bf16 parts, norms and V rows go to shared
//     memory by cp.async, two tiles ahead of the one being finished (three
//     stage buffers); the row tiles' parts stay resident (or, past 64
//     features, both sides are staged in chunks of at most 64). Part rows
//     are padded to 8 bf16 more than the chunk, so ldmatrix reads hit 32
//     distinct banks;
//   * registers pinned by __launch_bounds__ (256 threads, 2 blocks an SM:
//     at most 128), reported by the build's -Xptxas -v log.
// What stays: each off-diagonal value is evaluated once and contracted both
// ways; padded rows stay zero and are not written; the outputs are zeroed
// before the launch; the float atomics make the last bits run-dependent.

constexpr int kSymRowTiles = 2;                 // 64-row tiles a block owns
constexpr int kSymRows = kSymRowTiles * kTile;  // 128 rows
constexpr int kSymStrips = kSymRows / 16;       // warps: 16 rows each
constexpr int kSymThreads = 32 * kSymStrips;    // 256
constexpr int kSymStrip = 16;                   // column tiles a block walks
constexpr int kSymStages = 3;  // column-tile loads in flight: 2 ahead
constexpr int kMirLd = kTile + 4;  // row stride of the mirror sums (floats)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one launch, by the padded depth dp and KC: byte offsets.
struct SymLayout {
  int dc;         // features per staged chunk (a multiple of 16 dividing dp)
  int ld;         // row stride of a staged part, bf16 elements
  int chunks;     // dp / dc
  int part;       // bytes of one staged part of a column tile (64 rows)
  int j_off;      // the column tile's parts (hi, then lo) of stage buffer
                  // b at j_off + b * 2 part
  int i_off;      // the row tiles' parts (128 rows, hi then lo): resident
  int i_step;     // (i_step = 0) or, staged in chunks, stage buffer b at
                  // i_off + b * i_step
  int hy_off;     // float [kSymStages][64]: the column tiles' norms
  int vj_off;     // float [kSymStages][KC][64]: V of the column tiles,
                  // transposed
  int vi_off;     // float [2][KC][128]: V of the row tiles (bf16 hi, lo
                  // parts for the tier mirror, else the values)
  int mir_off;    // float [kSymStrips][KC][kMirLd]: the warps' mirror
                  // column sums
  int bytes;
};

__host__ __device__ inline SymLayout sym_layout(int dp, int kc) {
  SymLayout L{};
  L.dc = dp % 64 == 0 ? 64 : dp % 48 == 0 ? 48 : dp % 32 == 0 ? 32 : 16;
  L.ld = L.dc + 8;
  L.chunks = dp / L.dc;
  L.part = kTile * L.ld * 2;
  int at = 0;
  L.j_off = at; at += kSymStages * 2 * L.part;
  L.i_off = at; at += 2 * kSymRowTiles * L.part;
  L.i_step = L.chunks > 1 ? 2 * kSymRowTiles * L.part : 0;
  at += (kSymStages - 1) * L.i_step;
  L.hy_off = at; at += kSymStages * kTile * 4;
  L.vj_off = at; at += kSymStages * kc * kTile * 4;
  L.vi_off = at; at += 2 * kc * kSymRows * 4;
  L.mir_off = at; at += kSymStrips * kc * kMirLd * 4;
  L.bytes = at;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// All but the newest kSymStages - 2 groups of cp.async have landed.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSymStages - 2));
}

// The 8 x 8 bf16 matrix held one 32-bit register a lane (row lane / 4,
// columns 2 (lane % 4) and + 1), transposed across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Two bf16 values in one register, a in the low half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 matrices from shared memory in the mma fragment layout:
// lanes 8q .. 8q + 7 give the row addresses of matrix q, and r[q] holds
// row lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1 of it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col), bf16.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The kernel value of the tier from its cross term; for RBF hx and hy come
// times log2 e.
template <int KIND>
__device__ __forceinline__ float sym_value(float cross, float hx, float hy) {
  if constexpr (KIND == RBF) {
    return ex2(fmaf(cross, kLog2e, -(hx + hy)));
  } else {
    const float d2 = fmaxf(hx + hy - 2.0f * cross, 0.0f);
    const float r = sqrtf(d2);
    if constexpr (KIND == MATERN12) {
      return ex2(-kLog2e * r);
    } else if constexpr (KIND == MATERN32) {
      const float s3 = 1.7320508075688772f;
      return (1.0f + s3 * r) * ex2((-s3 * kLog2e) * r);
    } else {
      const float s5 = 2.23606797749979f;
      return (1.0f + s5 * r + (5.0f / 3.0f) * d2) * ex2((-s5 * kLog2e) * r);
    }
  }
}

// Rows [row0, row0 + rows) of the (n, dp) bf16 part P, features f0 .. f0
// + dc, into dst (row stride ld) by 16-byte cp.async; zero past n. Thread
// t takes the 16-byte pieces t, t + kSymThreads, ..., walked without a
// division.
__device__ __forceinline__ void stage_chunk(const __nv_bfloat16* __restrict__ P, int n,
                                            int dp, int row0, int rows, int f0, int dc,
                                            int ld, uint16_t* dst) {
  const int per_row = dc / 8;
  const int dr = kSymThreads / per_row, dq = kSymThreads % per_row;
  int r = threadIdx.x / per_row, q = threadIdx.x % per_row;
  for (; r < rows; r += dr, q += dq) {
    if (q >= per_row) {
      q -= per_row;
      ++r;
      if (r >= rows) break;
    }
    const bool valid = row0 + r < n;
    const __nv_bfloat16* src = valid ? P + (size_t)(row0 + r) * dp + f0 + q * 8 : P;
    cp_async16(dst + r * ld + q * 8, src, valid);
  }
}

template <int KIND, int PASSES, int KC>
__global__ void __launch_bounds__(kSymThreads, 2)
    gram_tier_symmetric(const GramArgs a, int nt) {
  constexpr bool kTierMirror = KC >= 4;  // k >= 3, as _sym_mirror_mode
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  extern __shared__ __align__(16) unsigned char smem[];
  // row tiles I0 and I0 + 1; column tiles J0 .. J1 - 1
  const int I0 = kSymRowTiles * blockIdx.x;
  const int J0 = I0 + blockIdx.y * kSymStrip;
  if (J0 >= nt) return;
  const int J1 = min(J0 + kSymStrip, nt);
  const SymLayout L = sym_layout(a.d, KC);
  const int n = a.n, k = a.k, dp = a.d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Iw = I0 + warp / 4;  // the warp's row tile; its rows 16 warp..
  const float* __restrict__ V = static_cast<const float*>(a.V);
  float* __restrict__ out = static_cast<float*>(a.out);
  float* hy_s = reinterpret_cast<float*>(smem + L.hy_off);
  float* vj_s = reinterpret_cast<float*>(smem + L.vj_off);
  float* vi_s = reinterpret_cast<float*>(smem + L.vi_off);
  float* mir_s = reinterpret_cast<float*>(smem + L.mir_off);
  const int row0 = I0 * kTile;

  // The row tiles: the warp's norms in registers, V_I in shared memory.
  float hx_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 16 * warp + g + 8 * h;
    hx_r[h] = gr < n ? a.hx[gr] * kScale : 0.0f;
  }
  for (int e = tid; e < KC * kSymRows; e += kSymThreads) {
    const int c = e / kSymRows, r = e % kSymRows;
    const float v = (row0 + r < n && c < k) ? V[(size_t)(row0 + r) * k + c] : 0.0f;
    if constexpr (kTierMirror) {
      const float vh = bf16_value(bf16_bits(v));
      vi_s[e] = vh;
      vi_s[KC * kSymRows + e] = PASSES == 3 ? bf16_value(bf16_bits(v - vh)) : 0.0f;
    } else {
      vi_s[e] = v;
    }
  }

  const int steps = (J1 - J0) * L.chunks;
  // Stage step st into buffer st % kSymStages: the column tile's chunk of
  // parts (and the row tiles' when they are staged in chunks), with its
  // norms and V rows at its first chunk.
  const auto issue = [&](int st) {
    const int J = J0 + st / L.chunks, ch = st % L.chunks, buf = st % kSymStages;
    const int f0 = ch * L.dc;
    uint16_t* jp = reinterpret_cast<uint16_t*>(smem + L.j_off + buf * 2 * L.part);
    stage_chunk(a.X2h, n, dp, J * kTile, kTile, f0, L.dc, L.ld, jp);
    if constexpr (PASSES == 3) {
      stage_chunk(a.X2l, n, dp, J * kTile, kTile, f0, L.dc, L.ld, jp + L.part / 2);
    }
    if (L.chunks > 1 || st == 0) {
      uint16_t* ip = reinterpret_cast<uint16_t*>(smem + L.i_off + buf * L.i_step);
      stage_chunk(a.X1h, n, dp, row0, kSymRows, f0, L.dc, L.ld, ip);
      if constexpr (PASSES == 3) {
        stage_chunk(a.X1l, n, dp, row0, kSymRows, f0, L.dc, L.ld,
                    ip + kSymRowTiles * L.part / 2);
      }
    }
    if (ch == 0) {
      const int jb = (J - J0) % kSymStages;
      const int col0 = J * kTile;
      for (int e = tid; e < kTile; e += kSymThreads) {
        const bool valid = col0 + e < n;
        cp_async4(hy_s + jb * kTile + e, valid ? a.hy + col0 + e : a.hy, valid);
      }
      for (int e = tid; e < KC * kTile; e += kSymThreads) {
        const int c = e / kTile, j = e % kTile;
        const bool valid = col0 + j < n && c < k;
        cp_async4(vj_s + (jb * KC + c) * kTile + j,
                  valid ? V + (size_t)(col0 + j) * k + c : V, valid);
      }
    }
    cp_async_commit();
  };

  float acc[2][KC];  // row contraction: rows g and g + 8 of the warp
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[h][c] = 0.0f;
  float C[8][4];

  // the tier mirror's B operand: V_I's bf16 parts in the mma fragment
  // layout (rows 16 warp + 2t, + 1 and, for b1, 8 more; column 8 nb + g)
  constexpr int kNb = KC >= 8 ? KC / 8 : 1;
  uint32_t vb[kNb][2][2];
  if constexpr (kTierMirror) {
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * nb + g, r = 16 * warp + 8 * h + 2 * t;
          const float* src = vi_s + (part * KC + c) * kSymRows + r;
          vb[nb][part][h] = c < KC ? pack_bf16(__float2bfloat16_rn(src[0]),
                                               __float2bfloat16_rn(src[1]))
                                   : 0u;
        }
  }

  issue(0);
  if (steps > 1) {
    issue(1);
  } else {
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    // step st has landed for every thread, and every thread is done with
    // step st - 1, whose buffers the next issue overwrites
    cp_async_wait_stage();
    __syncthreads();
    if (st + 2 < steps) {
      issue(st + 2);
    } else {
      cp_async_commit();
    }
    const int J = J0 + st / L.chunks, ch = st % L.chunks, buf = st % kSymStages;
    // the warp's part of this column tile: none below the diagonal (J <
    // Iw: its mirror image is taken from tile (J, Iw)), the forward
    // contraction alone on it (J == Iw), both above (J > Iw)
    const bool active = J >= Iw;
    if (active) {
      if (ch == 0) {
#pragma unroll
        for (int f = 0; f < 8; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i) C[f][i] = 0.0f;
      }
      const uint16_t* ih =
          reinterpret_cast<const uint16_t*>(smem + L.i_off + buf * L.i_step);
      const uint16_t* jh = reinterpret_cast<const uint16_t*>(smem + L.j_off + buf * 2 * L.part);
      const int ihalf = kSymRowTiles * L.part / 2;  // lo parts, bf16 elements
      const int jhalf = L.part / 2;
      // ldmatrix rows: A (the warp's 16 rows) as a0..a3, B (column
      // fragments f and f + 1) as their b0, b1
      const int q = lane / 8, rr = lane % 8;
      const uint16_t* pa = ih + (16 * warp + rr + 8 * (q & 1)) * L.ld + 8 * (q >> 1);
      const uint16_t* pb = jh + (rr + 8 * (q >> 1)) * L.ld + 8 * (q & 1);
      for (int ks = 0; ks < L.dc; ks += 16) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, pa + ks);
        if constexpr (PASSES == 3) ldsm_x4(al, pa + ihalf + ks);
        // the 8 column fragments' B parts, then each pass over the 8
        // independent accumulators, so that back-to-back mma do not wait on
        // each other
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int f = 0; f < 8; f += 2) {
          uint32_t r4[4];
          ldsm_x4(r4, pb + 8 * f * L.ld + ks);
          bh[f][0] = r4[0]; bh[f][1] = r4[1]; bh[f + 1][0] = r4[2]; bh[f + 1][1] = r4[3];
          if constexpr (PASSES == 3) {
            ldsm_x4(r4, pb + jhalf + 8 * f * L.ld + ks);
            bl[f][0] = r4[0]; bl[f][1] = r4[1]; bl[f + 1][0] = r4[2]; bl[f + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int f = 0; f < 8; ++f) mma_bf16(C[f], ah, bh[f][0], bh[f][1]);
        if constexpr (PASSES == 3) {
#pragma unroll
          for (int f = 0; f < 8; ++f) mma_bf16(C[f], ah, bl[f][0], bl[f][1]);
#pragma unroll
          for (int f = 0; f < 8; ++f) mma_bf16(C[f], al, bh[f][0], bh[f][1]);
        }
      }
    }
    if (ch != L.chunks - 1) continue;

    const int jb = (J - J0) % kSymStages;
    const int col0 = J * kTile;
    if (active) {
      // epilogue and row contraction, on the fragments
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int col = 8 * f + 2 * t;
        const float2 hy2 = *reinterpret_cast<const float2*>(hy_s + jb * kTile + col);
        const float hy[2] = {hy2.x * kScale, hy2.y * kScale};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1, cc = i & 1;
          const bool inside = row0 + 16 * warp + g + 8 * h < n && col0 + col + cc < n;
          C[f][i] = inside ? sym_value<KIND>(C[f][i], hx_r[h], hy[cc]) : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c >= k) break;
          const float2 v = *reinterpret_cast<const float2*>(vj_s + (jb * KC + c) * kTile + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[h][c] = fmaf(C[f][2 * h], v.x, acc[h][c]);
            acc[h][c] = fmaf(C[f][2 * h + 1], v.y, acc[h][c]);
          }
        }
      }
    }
    // the mirror runs where some row tile lies above J's diagonal
    if (J <= I0) continue;
    if (J > Iw) {
      // column sums of K_IJ^T V_I over the warp's 16 rows, into
      // mir_s[warp][c][column]
      if constexpr (kTierMirror) {
        // on the tensor cores: each pair of column fragments, transposed in
        // registers (movmatrix), is the A operand (16 columns x 16 rows) of
        // K^T V_I; hi.hi + hi.lo + lo.hi of the values' and V_I's bf16
        // parts (hi.hi alone on the one-pass tier), as _sym_mirror_mode's
        // "split" and "fast"
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          uint32_t kh[4], kl[4];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            // a0..a3: fragment 2pr (q4 even) or 2pr + 1 (odd), rows g (q4 <
            // 2) or g + 8, transposed
            const int f = 2 * pr + (q4 & 1), h = q4 >> 1;
            const __nv_bfloat16 h0 = __float2bfloat16_rn(C[f][2 * h]);
            const __nv_bfloat16 h1 = __float2bfloat16_rn(C[f][2 * h + 1]);
            kh[q4] = transpose8x8(pack_bf16(h0, h1));
            if constexpr (PASSES == 3) {
              kl[q4] = transpose8x8(pack_bf16(
                  __float2bfloat16_rn(C[f][2 * h] - __bfloat162float(h0)),
                  __float2bfloat16_rn(C[f][2 * h + 1] - __bfloat162float(h1))));
            }
          }
#pragma unroll
          for (int nb = 0; nb < kNb; ++nb) {
            float D[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(D, kh, vb[nb][0][0], vb[nb][0][1]);
            if constexpr (PASSES == 3) {
              mma_bf16(D, kh, vb[nb][1][0], vb[nb][1][1]);
              mma_bf16(D, kl, vb[nb][0][0], vb[nb][0][1]);
            }
            // D: columns 16 pr + g (+ 8), right-hand sides 8 nb + 2t (+ 1)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 8 * nb + 2 * t + (i & 1), col = 16 * pr + g + 8 * (i >> 1);
              if (c < KC) mir_s[(warp * KC + c) * kMirLd + col] = D[i];
            }
          }
        }
      } else {
        // float32 on the CUDA cores: each thread's 2-row partial of its 16
        // columns, reduced over the fragment's 8 row groups by a shuffle
        // reduce-scatter (lane bits 4, 3, 2: each lane keeps the half its
        // bit selects and adds its partner's), 2 column sums a lane
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c >= k) break;
          const int r = 16 * warp + g;
          const float v0 = vi_s[c * kSymRows + r], v1 = vi_s[c * kSymRows + r + 8];
          float m[16];
#pragma unroll
          for (int f = 0; f < 8; ++f)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) m[2 * f + cc] = fmaf(C[f][cc], v0, C[f][2 + cc] * v1);
#pragma unroll
          for (int step = 0; step < 3; ++step) {
            const int width = 8 >> step;  // values kept after this step
            const bool up = lane & (16 >> step);
#pragma unroll
            for (int i = 0; i < width; ++i) {
              const float send = up ? m[i] : m[i + width];
              const float keep = up ? m[i + width] : m[i];
              m[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16 >> step);
            }
          }
          // lane (g, t) holds columns 8g + 2t and 8g + 2t + 1
          *reinterpret_cast<float2*>(mir_s + (warp * KC + c) * kMirLd + 8 * g + 2 * t) =
              make_float2(m[0], m[1]);
        }
      }
    }
    __syncthreads();
    // the column sums of the warps above the diagonal (both row tiles', or
    // at J = I0 + 1 the first's), in warp order
    const int above = J > I0 + 1 ? kSymStrips : kSymStrips / kSymRowTiles;
    for (int e = tid; e < KC * kTile; e += kSymThreads) {
      const int c = e / kTile, j = e % kTile;
      float s = mir_s[c * kMirLd + j];
      for (int w = 1; w < above; ++w) s += mir_s[(w * KC + c) * kMirLd + j];
      if (col0 + j < n && c < k) atomicAdd(&out[(size_t)(col0 + j) * k + c], s * (float)a.c);
    }
  }

  // the strip's row sums: across the quad, then one atomicAdd per row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 16 * warp + g + 8 * h;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float v = acc[h][c];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0 && gr < n && c < k) atomicAdd(&out[(size_t)gr * k + c], v * (float)a.c);
    }
  }
}

template <int KIND, int PASSES, int KC>
int launch_tier_symmetric_kc(const GramArgs& a, cudaStream_t s) {
  const SymLayout L = sym_layout(a.d, KC);
  cudaError_t err = cudaFuncSetAttribute(gram_tier_symmetric<KIND, PASSES, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (a.n + kTile - 1) / kTile;
  const dim3 grid((nt + kSymRowTiles - 1) / kSymRowTiles, (nt + kSymStrip - 1) / kSymStrip);
  gram_tier_symmetric<KIND, PASSES, KC><<<grid, kSymThreads, L.bytes, s>>>(a, nt);
  return (int)cudaGetLastError();
}

// K2b at the smallest KC that holds k <= 16 columns.
template <int KIND, int PASSES>
int launch_tier_symmetric(const GramArgs& a, cudaStream_t s) {
  if (a.k > 8) return launch_tier_symmetric_kc<KIND, PASSES, 16>(a, s);
  if (a.k > 4) return launch_tier_symmetric_kc<KIND, PASSES, 8>(a, s);
  if (a.k > 2) return launch_tier_symmetric_kc<KIND, PASSES, 4>(a, s);
  if (a.k > 1) return launch_tier_symmetric_kc<KIND, PASSES, 2>(a, s);
  return launch_tier_symmetric_kc<KIND, PASSES, 1>(a, s);
}

template <int PASSES>
int tier_symmetric_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_tier_symmetric<RBF, PASSES>(a, s);
    case MATERN12: return launch_tier_symmetric<MATERN12, PASSES>(a, s);
    case MATERN32: return launch_tier_symmetric<MATERN32, PASSES>(a, s);
    case MATERN52: return launch_tier_symmetric<MATERN52, PASSES>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (passes == 3) return tier_symmetric_by_kind<3>(kind, a, s);
  if (passes == 1) return tier_symmetric_by_kind<1>(kind, a, s);
  return (int)cudaErrorInvalidValue;
}
