// The bf16 accuracy tiers of the fused Gram products, for Hopper (sm_90a).
//
//   K1b gram_tier_forward<KIND, PASSES, KC> (k <= 16) and
//       gram_tier_wide<KIND, PASSES, NF> (k > 16)  replace rlaopt_tpu/ops/
//       kernel_pallas.py :: kernel_matmat_pallas with compute_dtype="bf16x3"
//       (PASSES = 3: _cross_split, _body_split) or "bfloat16" (PASSES = 1:
//       _cross_bf16, _body_bf16), and _acc_update's tier-matched "split" and
//       "fast" contractions for k > 16
//   K2b gram_tier_symmetric<KIND, PASSES, KC>  replaces kernel_pallas.py ::
//       kernel_matvec_symmetric with the same tiers (_sym_epilogue,
//       _sym_tier_params, _sym_mirror_mode)
//   K4b gram_tier_pair<KIND, PASSES, KC>  replaces kernel_pallas.py ::
//       kernel_pair_matmat with the same tiers: (out1, out2) = (c K @ V2,
//       c K^T @ V1) with K = k(X1, X2) evaluated once, the off-diagonal
//       block of the sharded half-ring (rlaopt_tpu_torch/kernels/sharded.py)
//
// Operands: the bf16 parts of the points pre-scaled by the lengthscale (hi,
// and lo for bf16x3), split once per operator in PyTorch and padded in depth
// to a multiple of 16 with zeros, and the norm vectors hx, hy of
// _norms_and_operands (ops/kernel_tiers.py). Past k = 16, K1b also takes V's
// bf16 parts, split once per call by the wrapper and padded to kp columns,
// a multiple of 16 (kernel_tiers.split_rhs).
//
// What bounds them on the H100: the cross term x.y of every kernel value is
// 3 (or 1) bf16 products of depth dp = 32 at d = 28 on the tensor cores, and
// the exponential (one SFU operation a value, 16 a clock per SM; Matern adds
// a square root) is of the same order; the rest on the CUDA cores is a few
// float32 operations of epilogue per value and, for k <= 16, the float32
// contraction (2 FMAs per value and column, 4 with the triangle's mirror).
// At k = 500 (the Nystrom sketch) the contraction is the work: 3 bf16 passes
// of depth 64 per tile and column on the tensor cores, 18x the cross term at
// d = 28.
//
// K1b, K2b and K4b share one strip body (tier_strip, below): a block owns
// 128 rows, 8 warps of 16, and walks 64-column tiles; the cross term goes
// through mma.sync into registers, the epilogue and the row contraction run
// on the fragments, and the column tiles are staged by cp.async two ahead.
// K1b's forward form walks a run of the m axis: with few row
// blocks (SAP's 10,000-row oracle is 79 of them on 132 SMs) the wrapper cuts
// the m axis into runs on blockIdx.y (kernel_cuda.tier_splits), each block
// writes its partial rows, and sum_splits adds them in a fixed order.
// K1b's wide form (gram_tier_wide) is described above it.
//
// Not carried over: the concat fold of the TPU kernel (one MXU pass of depth
// 3d on [xh|xh|xl].[yh;yl;yh]), a trade of the TPU's 128-lane padding; the
// same three product terms are computed here as separate tensor-core steps.
// wgmma, TMA and warp specialisation are later work.

#include "gram_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The strip body: K2b (the triangle), K1b's forward form and K4b's pair
// form.
//
// What bounds K2b on the H100: per kernel value, 3 (or 1) bf16 products of
// depth dp on the tensor cores (0.85 ms of work at n = 100,000, d = 28 on
// the 989 TFLOP/s data-sheet rate) and one exponential on the SFU, which
// returns 16 a clock per SM: 5.0e9 values at 132 x 16 x 1.98 GHz take
// ~1.2 ms, the floor. The first version (the shared triangle template with
// a tier tile built in shared memory) ran at 6% of it: per 64 x 64 tile it
// staged both point tiles 16 features at a time, stored the tensor-core
// accumulators to shared memory, ran
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
//
// K1b's forward form is the same body without the triangle and the mirror:
// block (I, z) owns row tiles 2I and 2I + 1 of X1 and walks the column
// tiles of X2 in its run z (all of them with one run), every warp active on
// every tile; its rows are written once, scaled (one run) or as the run's
// unscaled partial into part[z], with no atomics.
//
// K4b's pair form is the triangle's body on two point sets, with neither
// the triangle nor the diagonal: block (I, s) owns row tiles 2I and 2I + 1
// of X1 and walks the column tiles J = 16s .. 16s + 15 of X2, every warp
// active on every tile. The forward product K_IJ V2_J goes to out1's rows
// (one atomicAdd per row and block: several strips add to a row); the
// mirror K_IJ^T V1_I, V1_I staged from V1 where the triangle stages it from
// V, goes to out2's rows of tile J, the 8 warps' column sums added in warp
// order, one atomicAdd per column a tile. Entries past n1 or n2 are zero and
// no output row past them is written; a padded shard's points are zero only
// in the operands (k(x, 0) > 0), so the caller slices the padded rows away.
// The first version (the shared triangle template in its pair form, the
// same tier tile in shared memory) evaluated 2.6e11 values a second at E4's
// shards, where K2b's strip evaluates 6.6e11.

// The strip body's three forms.
enum StripForm { FORWARD = 0, TRIANGLE = 1, PAIR = 2 };

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
                  // parts for the tier mirror, else the values); triangle
  int mir_off;    // float [kSymStrips][KC][kMirLd]: the warps' mirror
                  // column sums; triangle
  int bytes;
};

// max_dc: the largest chunk (64 for the strip body; the wide kernel, whose
// V stages take most of the shared memory, takes 32).
__host__ __device__ inline SymLayout sym_layout(int dp, int kc, bool mirror,
                                                int max_dc = 64) {
  SymLayout L{};
  L.dc = dp % 64 == 0 && max_dc >= 64 ? 64
         : dp % 48 == 0 && max_dc >= 48 ? 48
         : dp % 32 == 0 ? 32 : 16;
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
  L.vi_off = at; at += mirror ? 2 * kc * kSymRows * 4 : 0;
  L.mir_off = at; at += mirror ? kSymStrips * kc * kMirLd * 4 : 0;
  L.bytes = at;
  return L;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
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

// The same, each matrix transposed: r[q] holds elements (2 (lane % 4),
// lane / 4) and (2 (lane % 4) + 1, lane / 4) of matrix q, the B operand of
// an mma from a row-major (k, n) tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// C[f] += one staged chunk of the cross term of the warp's 16 rows (parts
// at ih, lo parts ihalf elements on) with the column tile's 8 fragments of
// 8 columns (parts at jh, lo parts jhalf on): the 8 column fragments' B
// parts first, then each pass over the 8 independent accumulators, so that
// back-to-back mma do not wait on each other.
template <int PASSES>
__device__ __forceinline__ void cross_chunk(float (&C)[8][4], const uint16_t* ih, int ihalf,
                                            const uint16_t* jh, int jhalf, int ld, int dc,
                                            int warp, int lane) {
  // ldmatrix rows: A (the warp's 16 rows) as a0..a3, B (column fragments
  // f and f + 1) as their b0, b1
  const int q = lane / 8, rr = lane % 8;
  const uint16_t* pa = ih + (16 * warp + rr + 8 * (q & 1)) * ld + 8 * (q >> 1);
  const uint16_t* pb = jh + (rr + 8 * (q >> 1)) * ld + 8 * (q & 1);
  for (int ks = 0; ks < dc; ks += 16) {
    uint32_t ah[4], al[4];
    ldsm_x4(ah, pa + ks);
    if constexpr (PASSES == 3) ldsm_x4(al, pa + ihalf + ks);
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int f = 0; f < 8; f += 2) {
      uint32_t r4[4];
      ldsm_x4(r4, pb + 8 * f * ld + ks);
      bh[f][0] = r4[0]; bh[f][1] = r4[1]; bh[f + 1][0] = r4[2]; bh[f + 1][1] = r4[3];
      if constexpr (PASSES == 3) {
        ldsm_x4(r4, pb + jhalf + 8 * f * ld + ks);
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

// TRIANGLE: K2b, block (I, s) as described above, nt = ceil(n / 64), X2 =
// X1. FORWARD (K1b, k <= 16): block (I, z), nt = ceil(m / 64) column tiles
// of X2, the run z of a.m_split / 64 of them. PAIR (K4b): block (I, s), nt
// = ceil(m / 64) column tiles of X2, V2 = a.V, V1 = a.V1, out1 = a.out,
// out2 = a.out2.
template <int KIND, int PASSES, int KC, int FORM>
__device__ __forceinline__ void tier_strip(const GramArgs& a, int nt) {
  constexpr bool kMirror = FORM != FORWARD;
  constexpr bool kTierMirror = kMirror && KC >= 4;  // k >= 3, as _sym_mirror_mode
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  extern __shared__ __align__(16) unsigned char smem[];
  // row tiles I0 and I0 + 1; column tiles J0 .. J1 - 1
  const int I0 = kSymRowTiles * blockIdx.x;
  int J0, J1;
  if constexpr (FORM == TRIANGLE) {
    J0 = I0 + blockIdx.y * kSymStrip;
    if (J0 >= nt) return;
    J1 = min(J0 + kSymStrip, nt);
  } else if constexpr (FORM == PAIR) {
    J0 = blockIdx.y * kSymStrip;  // < nt by the grid
    J1 = min(J0 + kSymStrip, nt);
  } else {
    const int run = a.m_split / kTile;
    J0 = blockIdx.y * run;
    J1 = min(J0 + run, nt);
  }
  const SymLayout L = sym_layout(a.d, KC, kMirror);
  const int n = a.n, m = a.m, k = a.k, dp = a.d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Iw = I0 + warp / 4;  // the warp's row tile; its rows 16 warp..
  // forward: V_J from V (V2 for the pair) into out; mirror: V_I from V (V1
  // for the pair) into the rows of tile J of out (out2 for the pair)
  const float* __restrict__ V = static_cast<const float*>(a.V);
  const float* __restrict__ Vi = static_cast<const float*>(FORM == PAIR ? a.V1 : a.V);
  float* out = static_cast<float*>(a.out);  // the triangle's two are one array
  float* mirror_out = static_cast<float*>(FORM == PAIR ? a.out2 : a.out);
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
  if constexpr (kMirror) {
    for (int e = tid; e < KC * kSymRows; e += kSymThreads) {
      const int c = e / kSymRows, r = e % kSymRows;
      const float v = (row0 + r < n && c < k) ? Vi[(size_t)(row0 + r) * k + c] : 0.0f;
      if constexpr (kTierMirror) {
        const float vh = bf16_value(bf16_bits(v));
        vi_s[e] = vh;
        vi_s[KC * kSymRows + e] = PASSES == 3 ? bf16_value(bf16_bits(v - vh)) : 0.0f;
      } else {
        vi_s[e] = v;
      }
    }
  }

  const int steps = (J1 - J0) * L.chunks;
  // Stage step st into buffer st % kSymStages: the column tile's chunk of
  // parts (and the row tiles' when they are staged in chunks), with its
  // norms and V rows at its first chunk.
  const auto load_step = [&](int st) {
    const int J = J0 + st / L.chunks, ch = st % L.chunks, buf = st % kSymStages;
    const int f0 = ch * L.dc;
    uint16_t* jp = reinterpret_cast<uint16_t*>(smem + L.j_off + buf * 2 * L.part);
    stage_chunk(a.X2h, m, dp, J * kTile, kTile, f0, L.dc, L.ld, jp);
    if constexpr (PASSES == 3) {
      stage_chunk(a.X2l, m, dp, J * kTile, kTile, f0, L.dc, L.ld, jp + L.part / 2);
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
        const bool valid = col0 + e < m;
        cp_async4(hy_s + jb * kTile + e, valid ? a.hy + col0 + e : a.hy, valid);
      }
      for (int e = tid; e < KC * kTile; e += kSymThreads) {
        const int c = e / kTile, j = e % kTile;
        const bool valid = col0 + j < m && c < k;
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

  load_step(0);
  if (steps > 1) {
    load_step(1);
  } else {
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    // step st has landed for every thread, and every thread is done with
    // step st - 1, whose buffers the next load overwrites
    cp_async_wait_stage();
    __syncthreads();
    if (st + 2 < steps) {
      load_step(st + 2);
    } else {
      cp_async_commit();
    }
    const int J = J0 + st / L.chunks, ch = st % L.chunks, buf = st % kSymStages;
    // the warp's part of this column tile (triangle): none below the
    // diagonal (J < Iw: its mirror image is taken from tile (J, Iw)), the
    // forward contraction alone on it (J == Iw), both above (J > Iw); the
    // other forms have no diagonal
    const bool active = FORM != TRIANGLE || J >= Iw;
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
      cross_chunk<PASSES>(C, ih, kSymRowTiles * L.part / 2, jh, L.part / 2, L.ld, L.dc,
                          warp, lane);
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
          const bool inside = row0 + 16 * warp + g + 8 * h < n && col0 + col + cc < m;
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
    if constexpr (kMirror) {
      // the mirror runs where some row tile lies above J's diagonal (the
      // pair's every tile)
      if (FORM == TRIANGLE && J <= I0) continue;
      if (FORM == PAIR || J > Iw) {
        // column sums of K_IJ^T V_I over the warp's 16 rows, into
        // mir_s[warp][c][column]
        if constexpr (kTierMirror) {
          // on the tensor cores: each pair of column fragments, transposed
          // in registers (movmatrix), is the A operand (16 columns x 16
          // rows) of K^T V_I; hi.hi + hi.lo + lo.hi of the values' and
          // V_I's bf16 parts (hi.hi alone on the one-pass tier), as
          // _sym_mirror_mode's "split" and "fast"
#pragma unroll
          for (int pr = 0; pr < 4; ++pr) {
            uint32_t kh[4], kl[4];
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) {
              // a0..a3: fragment 2pr (q4 even) or 2pr + 1 (odd), rows g
              // (q4 < 2) or g + 8, transposed
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
          // float32 on the CUDA cores: each thread's 2-row partial of its
          // 16 columns, reduced over the fragment's 8 row groups by a
          // shuffle reduce-scatter (lane bits 4, 3, 2: each lane keeps the
          // half its bit selects and adds its partner's), 2 column sums a
          // lane
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (c >= k) break;
            const int r = 16 * warp + g;
            const float v0 = vi_s[c * kSymRows + r], v1 = vi_s[c * kSymRows + r + 8];
            float mm[16];
#pragma unroll
            for (int f = 0; f < 8; ++f)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc)
                mm[2 * f + cc] = fmaf(C[f][cc], v0, C[f][2 + cc] * v1);
#pragma unroll
            for (int step = 0; step < 3; ++step) {
              const int width = 8 >> step;  // values kept after this step
              const bool up = lane & (16 >> step);
#pragma unroll
              for (int i = 0; i < width; ++i) {
                const float send = up ? mm[i] : mm[i + width];
                const float keep = up ? mm[i + width] : mm[i];
                mm[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16 >> step);
              }
            }
            // lane (g, t) holds columns 8g + 2t and 8g + 2t + 1
            *reinterpret_cast<float2*>(mir_s + (warp * KC + c) * kMirLd + 8 * g + 2 * t) =
                make_float2(mm[0], mm[1]);
          }
        }
      }
      __syncthreads();
      // the column sums of the warps above the diagonal (both row tiles',
      // or at J = I0 + 1 the first's; the pair's 8), in warp order
      const int above =
          FORM == PAIR || J > I0 + 1 ? kSymStrips : kSymStrips / kSymRowTiles;
      for (int e = tid; e < KC * kTile; e += kSymThreads) {
        const int c = e / kTile, j = e % kTile;
        float s = mir_s[c * kMirLd + j];
        for (int w = 1; w < above; ++w) s += mir_s[(w * KC + c) * kMirLd + j];
        if (col0 + j < m && c < k) {
          atomicAdd(&mirror_out[(size_t)(col0 + j) * k + c], s * (float)a.c);
        }
      }
    }
  }

  // the strip's row sums: across the quad, then one atomicAdd per row
  // (triangle, pair), or one store per row: scaled, or the run's partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 16 * warp + g + 8 * h;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float v = acc[h][c];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0 && gr < n && c < k) {
        if constexpr (kMirror) {
          atomicAdd(&out[(size_t)gr * k + c], v * (float)a.c);
        } else if (gridDim.y > 1) {
          a.part[((size_t)blockIdx.y * n + gr) * k + c] = v;
        } else {
          out[(size_t)gr * k + c] = (float)(v * a.c);
        }
      }
    }
  }
}

template <int KIND, int PASSES, int KC>
__global__ void __launch_bounds__(kSymThreads, 2)
    gram_tier_symmetric(const GramArgs a, int nt) {
  tier_strip<KIND, PASSES, KC, TRIANGLE>(a, nt);
}

template <int KIND, int PASSES, int KC>
__global__ void __launch_bounds__(kSymThreads, 2)
    gram_tier_forward(const GramArgs a, int nt) {
  tier_strip<KIND, PASSES, KC, FORWARD>(a, nt);
}

template <int KIND, int PASSES, int KC>
__global__ void __launch_bounds__(kSymThreads, 2)
    gram_tier_pair(const GramArgs a, int nt) {
  tier_strip<KIND, PASSES, KC, PAIR>(a, nt);
}

// ---------------------------------------------------------------------------
// K1b past 16 columns: gram_tier_wide, the contraction on the tensor cores.
//
// What bounds it: at k = 500 the tier-matched contraction, 3 bf16 passes
// of 2 k operations per kernel value on the tensor cores: 30.3 ms of the
// 989 TFLOP/s data-sheet rate at n = m = 100,000, 18x the cross term at
// d = 28.
// The first version built each 64 x 64 K tile through shared memory
// (tensor-core fragments stored, the epilogue there), split it and the
// matching 64 x 128 slice of V into bf16 parts in shared memory per tile
// (V's split redone by every row block: 15,625 times at n = 1M), and
// contracted with tensor-core operands loaded from shared memory: every
// product passed through shared memory twice, 7.1% of the bound.
//
// Design. Block (I, y) owns rows 128 I .. (8 warps of 16, the strip body's
// warps) and the 8 NF right-hand-side columns from 8 NF y of kp (NF = 16:
// 128 columns, or 8 for kp <= 64), and walks every 64-column tile of X2:
//   * the K tile's 16 x 64 strip of a warp is the strip body's: cross term
//     by mma.sync into 8 fragments, epilogue on them;
//   * the finished values stay in registers: a warp's m16n8 accumulator
//     fragments 2s and 2s + 1 are exactly the A operand (m16k16) of the
//     contraction's k-slice s, so each value is split into its bf16 hi and
//     lo there (the same roundings as _body_split's) and contracted against
//     V's rows of the tile, without a pass through shared memory;
//   * V's bf16 parts, split once per call by the wrapper, are staged with
//     the tile's point parts by cp.async two tiles ahead (three buffers of
//     64 x 8 NF per part), read by ldmatrix.trans as the B operand;
//   * each tile's 64-deep partial goes into fresh fragments (four column
//     fragments at a time) that are added to float running sums: the
//     tensor cores' own accumulation is not IEEE float, and carried over
//     all m / 64 tiles its error grew to 7.6e-5 of max|ref| at m = 20,000
//     on an H100, where the plain version of the tier sits at 5.8e-6 from
//     the float64 product;
//   * registers: the 4 NF running sums, the 32 of the values' parts and
//     the cross term; 256 threads, one block an SM (__launch_bounds__);
//     the build's -Xptxas -v log reports them (chip_smoke.py's registers
//     line).
// The K tile is evaluated once per 8 NF columns (4 times at k = 500, about
// a fifth of the tensor-core work there).

// The wide kernel's shared memory: the strip body's stages for the points
// (chunks of at most 32 features), then [kSymStages][2][64][wide_vld(NF)]
// bf16 for V's parts, in the place of the float V stages (vj_off). The V
// strides are compile-time constants, so ldmatrix takes them as immediates.
__host__ __device__ constexpr int wide_vld(int nf) { return 8 * nf + 8; }
__host__ __device__ constexpr int wide_vpart(int nf) { return kTile * wide_vld(nf) * 2; }

__host__ __device__ inline SymLayout wide_points(int dp) { return sym_layout(dp, 1, false, 32); }

__host__ __device__ inline int wide_bytes(int dp, int nf) {
  return wide_points(dp).vj_off + kSymStages * 2 * wide_vpart(nf);
}

template <int KIND, int PASSES, int NF>
__global__ void __launch_bounds__(kSymThreads, 1)
    gram_tier_wide(const GramArgs a, int nt) {
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  constexpr int BN = 8 * NF;
  constexpr int kVld = wide_vld(NF), kVpart = wide_vpart(NF);
  extern __shared__ __align__(16) unsigned char smem[];
  const SymLayout L = wide_points(a.d);
  unsigned char* const vsm = smem + L.vj_off;
  const int n = a.n, m = a.m, k = a.k, kp = a.kp, dp = a.d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kSymRows;
  const int c0 = blockIdx.y * BN;
  float* hy_s = reinterpret_cast<float*>(smem + L.hy_off);

  float hx_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 16 * warp + g + 8 * h;
    hx_r[h] = gr < n ? a.hx[gr] * kScale : 0.0f;
  }

  const int steps = nt * L.chunks;
  const auto load_step = [&](int st) {
    const int J = st / L.chunks, ch = st % L.chunks, buf = st % kSymStages;
    const int f0 = ch * L.dc;
    uint16_t* jp = reinterpret_cast<uint16_t*>(smem + L.j_off + buf * 2 * L.part);
    stage_chunk(a.X2h, m, dp, J * kTile, kTile, f0, L.dc, L.ld, jp);
    if constexpr (PASSES == 3) {
      stage_chunk(a.X2l, m, dp, J * kTile, kTile, f0, L.dc, L.ld, jp + L.part / 2);
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
      const int jb = J % kSymStages;
      const int col0 = J * kTile;
      for (int e = tid; e < kTile; e += kSymThreads) {
        const bool valid = col0 + e < m;
        cp_async4(hy_s + jb * kTile + e, valid ? a.hy + col0 + e : a.hy, valid);
      }
      // V's rows of the tile, columns c0 .. c0 + BN: NF 16-byte pieces a row
      uint16_t* vp = reinterpret_cast<uint16_t*>(vsm + jb * 2 * kVpart);
      for (int e = tid; e < kTile * NF; e += kSymThreads) {
        const int r = e / NF, q = e % NF;
        const bool valid = col0 + r < m && c0 + 8 * q < kp;
        const size_t at = (size_t)(col0 + r) * kp + c0 + 8 * q;
        cp_async16(vp + r * kVld + 8 * q, valid ? a.Vh + at : a.Vh, valid);
        if constexpr (PASSES == 3) {
          cp_async16(vp + kVpart / 2 + r * kVld + 8 * q, valid ? a.Vl + at : a.Vl, valid);
        }
      }
    }
    cp_async_commit();
  };

  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.0f;
  float C[8][4];

  load_step(0);
  if (steps > 1) {
    load_step(1);
  } else {
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait_stage();
    __syncthreads();
    if (st + 2 < steps) {
      load_step(st + 2);
    } else {
      cp_async_commit();
    }
    const int J = st / L.chunks, ch = st % L.chunks, buf = st % kSymStages;
    if (ch == 0) {
#pragma unroll
      for (int f = 0; f < 8; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) C[f][i] = 0.0f;
    }
    const uint16_t* ih = reinterpret_cast<const uint16_t*>(smem + L.i_off + buf * L.i_step);
    const uint16_t* jh = reinterpret_cast<const uint16_t*>(smem + L.j_off + buf * 2 * L.part);
    cross_chunk<PASSES>(C, ih, kSymRowTiles * L.part / 2, jh, L.part / 2, L.ld, L.dc,
                        warp, lane);
    if (ch != L.chunks - 1) continue;

    const int jb = J % kSymStages;
    const int col0 = J * kTile;
    // epilogue on the fragments, then each value's bf16 parts as the A
    // operand of k-slice s: a0 = (row g, k 2t..), a1 = (row g + 8, k 2t..),
    // a2 and a3 the same 8 columns on (fragments 2s and 2s + 1)
    uint32_t kh[4][4], kl[4][4];
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int col = 8 * f + 2 * t;
      const float2 hy2 = *reinterpret_cast<const float2*>(hy_s + jb * kTile + col);
      const float hy[2] = {hy2.x * kScale, hy2.y * kScale};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const bool inside = row0 + 16 * warp + g + 8 * h < n && col0 + col + cc < m;
          v[cc] = inside ? sym_value<KIND>(C[f][2 * h + cc], hx_r[h], hy[cc]) : 0.0f;
        }
        const __nv_bfloat16 h0 = __float2bfloat16_rn(v[0]), h1 = __float2bfloat16_rn(v[1]);
        kh[f / 2][2 * (f & 1) + h] = pack_bf16(h0, h1);
        if constexpr (PASSES == 3) {
          kl[f / 2][2 * (f & 1) + h] =
              pack_bf16(__float2bfloat16_rn(v[0] - __bfloat162float(h0)),
                        __float2bfloat16_rn(v[1] - __bfloat162float(h1)));
        }
      }
    }
    // the contraction: ldmatrix.trans rows of V's tile, matrix q = k rows
    // 8 (q & 1).., columns 8 (q >> 1).. of a pair of column fragments
    const uint16_t* vh = reinterpret_cast<const uint16_t*>(vsm + jb * 2 * kVpart);
    const int q = lane / 8, rr = lane % 8;
    const uint16_t* pv = vh + (rr + 8 * (q & 1)) * kVld + 8 * (q >> 1);
#pragma unroll
    for (int f0 = 0; f0 < NF; f0 += 4) {
      float D[4][4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) D[f][i] = 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int fp = 0; fp < 2; ++fp) {
          uint32_t r4[4];
          const uint16_t* p = pv + 16 * s * kVld + 8 * (f0 + 2 * fp);
          ldsm_x4_trans(r4, p);
          bh[2 * fp][0] = r4[0]; bh[2 * fp][1] = r4[1];
          bh[2 * fp + 1][0] = r4[2]; bh[2 * fp + 1][1] = r4[3];
          if constexpr (PASSES == 3) {
            ldsm_x4_trans(r4, p + kVpart / 2);
            bl[2 * fp][0] = r4[0]; bl[2 * fp][1] = r4[1];
            bl[2 * fp + 1][0] = r4[2]; bl[2 * fp + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) mma_bf16(D[f], kh[s], bh[f][0], bh[f][1]);
        if constexpr (PASSES == 3) {
#pragma unroll
          for (int f = 0; f < 4; ++f) mma_bf16(D[f], kh[s], bl[f][0], bl[f][1]);
#pragma unroll
          for (int f = 0; f < 4; ++f) mma_bf16(D[f], kl[s], bh[f][0], bh[f][1]);
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f0 + f][i] += D[f][i];
    }
  }

  // acc[f]: rows g (i < 2) and g + 8, columns c0 + 8 f + 2 t (+ 1)
  float* __restrict__ out = static_cast<float*>(a.out);
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + 16 * warp + g + 8 * (i >> 1);
      const int gc = c0 + 8 * f + 2 * t + (i & 1);
      if (gr < n && gc < k) out[(size_t)gr * k + gc] = (float)(acc[f][i] * a.c);
    }
}

template <int KIND, int PASSES, int KC>
int launch_tier_forward_kc(const GramArgs& args, int splits, cudaStream_t s) {
  GramArgs a = args;
  const SymLayout L = sym_layout(a.d, KC, false);
  cudaError_t err = cudaFuncSetAttribute(gram_tier_forward<KIND, PASSES, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.m + kTile - 1) / kTile;
  if (splits < 1 || a.part == nullptr) splits = 1;
  if (splits > tiles) splits = tiles;
  const int run = (tiles + splits - 1) / splits;
  splits = (tiles + run - 1) / run;
  a.m_split = run * kTile;
  const dim3 grid((a.n + kSymRows - 1) / kSymRows, splits);
  gram_tier_forward<KIND, PASSES, KC><<<grid, kSymThreads, L.bytes, s>>>(a, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)a.n * a.k;
  size_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, kThreads, 0, s>>>(a.part, static_cast<float*>(a.out),
                                                   splits, count, a.c);
  return (int)cudaGetLastError();
}

template <int KIND, int PASSES, int NF>
int launch_tier_wide_nf(const GramArgs& a, cudaStream_t s) {
  const int bytes = wide_bytes(a.d, NF);
  cudaError_t err = cudaFuncSetAttribute(gram_tier_wide<KIND, PASSES, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kSymRows - 1) / kSymRows, (a.kp + 8 * NF - 1) / (8 * NF));
  gram_tier_wide<KIND, PASSES, NF><<<grid, kSymThreads, bytes, s>>>(
      a, (a.m + kTile - 1) / kTile);
  return (int)cudaGetLastError();
}

// K1b: the forward strip at the smallest KC that holds k <= 16 columns, the
// wide kernel past that (64 columns a block up to kp = 64, 128 beyond).
template <int KIND, int PASSES>
int launch_tier_matmat(const GramArgs& a, int splits, cudaStream_t s) {
  if (a.k > 16) {
    if (a.Vh == nullptr || (PASSES == 3 && a.Vl == nullptr) || a.kp < a.k || a.kp % 16)
      return (int)cudaErrorInvalidValue;
    if (a.kp <= 64) return launch_tier_wide_nf<KIND, PASSES, 8>(a, s);
    return launch_tier_wide_nf<KIND, PASSES, 16>(a, s);
  }
  if (a.k > 8) return launch_tier_forward_kc<KIND, PASSES, 16>(a, splits, s);
  if (a.k > 4) return launch_tier_forward_kc<KIND, PASSES, 8>(a, splits, s);
  if (a.k > 2) return launch_tier_forward_kc<KIND, PASSES, 4>(a, splits, s);
  if (a.k > 1) return launch_tier_forward_kc<KIND, PASSES, 2>(a, splits, s);
  return launch_tier_forward_kc<KIND, PASSES, 1>(a, splits, s);
}

template <int PASSES>
int tier_matmat_by_kind(int kind, const GramArgs& a, int splits, cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_tier_matmat<RBF, PASSES>(a, splits, s);
    case MATERN12: return launch_tier_matmat<MATERN12, PASSES>(a, splits, s);
    case MATERN32: return launch_tier_matmat<MATERN32, PASSES>(a, splits, s);
    case MATERN52: return launch_tier_matmat<MATERN52, PASSES>(a, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2b (triangle) or K4b (pair): row tiles of X1 two a block, strips of 16
// column tiles of X2 (the triangle's from the block's own row tile on).
template <int KIND, int PASSES, int KC, bool PAIR>
int launch_tier_mirror_kc(const GramArgs& a, cudaStream_t s) {
  const SymLayout L = sym_layout(a.d, KC, true);
  void (*kernel)(const GramArgs, int) =
      PAIR ? gram_tier_pair<KIND, PASSES, KC> : gram_tier_symmetric<KIND, PASSES, KC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt1 = (a.n + kTile - 1) / kTile, nt2 = (a.m + kTile - 1) / kTile;
  const dim3 grid((nt1 + kSymRowTiles - 1) / kSymRowTiles, (nt2 + kSymStrip - 1) / kSymStrip);
  kernel<<<grid, kSymThreads, L.bytes, s>>>(a, nt2);
  return (int)cudaGetLastError();
}

// K2b or K4b at the smallest KC that holds k <= 16 columns.
template <int KIND, int PASSES, bool PAIR>
int launch_tier_mirror(const GramArgs& a, cudaStream_t s) {
  if (a.k > 8) return launch_tier_mirror_kc<KIND, PASSES, 16, PAIR>(a, s);
  if (a.k > 4) return launch_tier_mirror_kc<KIND, PASSES, 8, PAIR>(a, s);
  if (a.k > 2) return launch_tier_mirror_kc<KIND, PASSES, 4, PAIR>(a, s);
  if (a.k > 1) return launch_tier_mirror_kc<KIND, PASSES, 2, PAIR>(a, s);
  return launch_tier_mirror_kc<KIND, PASSES, 1, PAIR>(a, s);
}

template <int PASSES, bool PAIR>
int tier_mirror_by_kind(int kind, const GramArgs& a, cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_tier_mirror<RBF, PASSES, PAIR>(a, s);
    case MATERN12: return launch_tier_mirror<MATERN12, PASSES, PAIR>(a, s);
    case MATERN32: return launch_tier_mirror<MATERN32, PASSES, PAIR>(a, s);
    case MATERN52: return launch_tier_mirror<MATERN52, PASSES, PAIR>(a, s);
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
// hy (m) the norm vectors of _norms_and_operands, V (m, k), out (n, k)
// float32; all contiguous on one device.

// K1b: out = c * k(X1, X2) @ V on the tier of `passes` (3 or 1). k <= 16:
// V is read, and splits > 1 cuts the m axis into that many runs whose
// partials go to part (splits * n * k floats) and are summed by a second
// launch. k > 16: V's bf16 parts Vh, Vl (m, kp), kp a multiple of 16 at or
// above k, zero past column k (Vl null when passes == 1), are read instead.
extern "C" int rl_gram_matmat_tier(int kind, int passes, const void* X1h,
                                   const void* X1l, const void* hx,
                                   const void* X2h, const void* X2l,
                                   const void* hy, const void* V, const void* Vh,
                                   const void* Vl, void* part, void* out, int n,
                                   int m, int dp, int k, int kp, int splits,
                                   double c, void* stream) {
  if (dp % kDepth != 0) return (int)cudaErrorInvalidValue;
  GramArgs a = tier_args(X1h, X1l, hx, X2h, X2l, hy, V, out, n, m, dp, k, c);
  a.Vh = static_cast<const __nv_bfloat16*>(Vh);
  a.Vl = static_cast<const __nv_bfloat16*>(Vl);
  a.kp = kp;
  a.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3) return tier_matmat_by_kind<3>(kind, a, splits, s);
  if (passes == 1) return tier_matmat_by_kind<1>(kind, a, splits, s);
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
  if (passes == 3) return tier_mirror_by_kind<3, false>(kind, a, s);
  if (passes == 1) return tier_mirror_by_kind<1, false>(kind, a, s);
  return (int)cudaErrorInvalidValue;
}

// K4b: (out1, out2) = (c * k(X1, X2) @ V2, c * k(X1, X2)^T @ V1) with X1's
// parts (n1, dp) and X2's (n2, dp), V2 (n2, k), V1 (n1, k), out1 (n1, k),
// out2 (n2, k), 1 <= k <= 16; both outputs are zeroed here first.
extern "C" int rl_gram_pair_tier(int kind, int passes, const void* X1h,
                                 const void* X1l, const void* hx,
                                 const void* X2h, const void* X2l,
                                 const void* hy, const void* V2, const void* V1,
                                 void* out1, void* out2, int n1, int n2, int dp,
                                 int k, double c, void* stream) {
  if (dp % kDepth != 0 || k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out1, 0, sizeof(float) * (size_t)n1 * k, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(out2, 0, sizeof(float) * (size_t)n2 * k, s);
  if (err != cudaSuccess) return (int)err;
  GramArgs a = tier_args(X1h, X1l, hx, X2h, X2l, hy, V2, out1, n1, n2, dp, k, c);
  a.V1 = V1;
  a.out2 = out2;
  if (passes == 3) return tier_mirror_by_kind<3, true>(kind, a, s);
  if (passes == 1) return tier_mirror_by_kind<1, true>(kind, a, s);
  return (int)cudaErrorInvalidValue;
}
