// K1b's forward form for Hopper (sm_90a): the bf16 tiers' general product
// c k(X1, X2) @ W at k <= 16 and a padded depth <= 128.
//
//   K1b gram_tier_rows<KIND, PASSES, BN, BF, CH, KC, SPLIT>  replaces
//       rlaopt_tpu/ops/kernel_pallas.py :: kernel_matmat_pallas with
//       compute_dtype "bf16x3" (PASSES = 3: _cross_split, _body_split) or
//       "bfloat16" (PASSES = 1: _cross_bf16, _body_bf16), and the
//       contraction its dispatch takes there (kernel_tiers.
//       forward_contraction): _acc_update's float32 "vpu" one (SPLIT = 0,
//       KC of W's columns: up to 8 columns, on the one-pass tier, and past
//       a depth of 80) or its tier-matched "split" (SPLIT = 1: hi.hi +
//       hi.lo + lo.hi of the values' and W's bf16 parts, ~2^-18 relative;
//       bf16x3 at 9 to 16 columns, as config 9's row oracle). Past a padded
//       depth of 128 the wrapper keeps the strip's forward form (gram_tier.cu
//       :: gram_tier_forward, a float32 contraction), past 16 columns the
//       wide kernel.
//
// What bounds it on the H100: the tensor cores. A kernel value takes the
// cross term, 3 (or 1) bf16 products of the padded depth dp (384 operations
// at dp = 64), and the split contraction 3 of depth 16 (96 operations: W
// padded to 16 columns); at 989 TFLOP/s the row oracle of configs 7 and 9
// (10^5 x 10^7, d = 50, k = 10) takes 485 ms (303 ms for the cross term at
// d = 50 unpadded). The float32 contraction is k FMAs a value on the CUDA
// cores (33.5 T a second: 30 ms at 10^12 values a column). The exponential
// (one SFU operation a value, 16 a clock per SM: 239 ms there) and the
// epilogue on the CUDA cores (the exponent, the bf16 split of the value:
// about six float32 operations) fit beside it when they overlap the
// products. The strip's forward form (gram_tier.cu)
// took 2,548.7 ms there on an H100 at 700 W (13.5% of the frozen 343.3 ms
// bound, which counts the contraction as float32 work): mma.sync, a float32
// contraction of ten FMAs a value on the CUDA cores, and each warp's
// products, epilogue and contraction in series.
//
// Design: the flash-attention forward shape without the running maximum
// (values are at most 1). Block (x, z) owns rows 128 x .. 128 x + 127 of X1
// and walks the key tiles of run z of X2 (BN = 128 keys up to a depth of
// 64, 64 past it), at most TIER_RUN_TILES x 64 columns a run:
//   * loads by TMA: one elected lane of a producer warpgroup fills a ring
//     of stages, a stage the key tile's bf16 parts (BF-feature chunks, 128-
//     or 64-byte rows swizzled as the tensor cores read them), its norms and
//     W's bf16 parts for the tile, transposed (16 rows of BN keys, in
//     64-key chunks of 128-byte rows; the wrapper splits W once per call,
//     kernel_tiers.split_rhs_t; or W's KC float32 columns transposed, KC
//     rows of BN keys, kernel_tiers.rhs_t), its arrival counted in bytes
//     on the stage's full mbarrier; it refills a stage once every consumer
//     warp has arrived on its empty mbarrier. The rows' parts arrive once. Keys past m, rows
//     past n and features past dp come in as zeros: a padded key's value is
//     finite and multiplies W's zero rows, so nothing is masked;
//   * two consumer warpgroups, 64 rows each. The cross term S = X1 X2^T of
//     a tile by wgmma m64nBNk16 (bf16 in, float32 accumulate), both
//     operands from shared memory: hi.hi + hi.lo + lo.hi (bf16x3) or hi.hi;
//   * epilogue on the accumulator: thread (warp q of the group, lane 4g +
//     t) holds rows 16q + g and + 8 against keys 8j + 2t and + 1; a value is
//     sym_value (for RBF one ex2 of the cross term with the norms times
//     log2 e, as K2b) and, for the split, is rounded in registers to its
//     bf16 hi and lo parts, which the accumulator's layout leaves exactly in the A-fragment
//     layout of an mma: no shuffle, no round trip through shared memory;
//   * the float32 contraction (SPLIT = 0): the tile's values made in place
//     in the accumulator, then for each of W's columns each row's products
//     over the thread's keys of the tile summed apart (two sums a row) and
//     added to the float32 sum O[row][column] once a tile; the quad's four
//     sums of a row are added by shuffles at the end of the run;
//   * the tier-matched contraction (SPLIT = 1) D = P W_tile by mma.sync
//     m16n8k16, 16 keys at a time as their values are made (two fragments
//     of 8 of W's columns), B W's parts read from the stage by ldmatrix,
//     into a fresh accumulator each tile that is added to the float32 sums O (in
//     registers for the whole run): carried across thousands of products
//     the tensor cores' own sum is not IEEE float (gram_tier.cu's wide
//     kernel). As wgmma m64n16k16 with A from registers (24 products a
//     tile, waited for before the next tile's cross term) it took 1,034 ms
//     at configs 7 and 9's row oracle, as mma.sync 967-972 (H100, 700 W);
//   * overlap: a group issues the next tile's cross term before it runs
//     this tile's epilogue and contraction, so those run while the tensor
//     cores compute it; two accumulators of BN / 2 floats, the values of a
//     step and O fit a consumer's registers: one block an SM, a producer
//     warpgroup of few registers (setmaxnreg) and the consumers the rest.
//     The other group fills the tensor cores' gaps. Three groups of 64-key
//     tiles (1,007 ms there) or of 128-key tiles (1,820 ms, spilled), and
//     two groups of 64-key tiles (1,139 ms), were slower; so was one step
//     of depth 16 for the last 16 features' three passes where at most 5
//     are real (d = 50: [xh|xh|xl].[yh|yl|yh], 10 cross-term steps a tile
//     for 12), 1,262 ms against 1,108-1,121 in the same build, whose extra
//     maps and descriptors made the kernels spill;
//   * output: each run's rows written once, scaled (one run) or as the
//     run's unscaled partial into part[z], no atomics; sum_splits adds the
//     runs' partials in a fixed order, so two calls give the same bits.
// Blocks are laid out row block first, so the blocks on the card at one
// time walk the same run's key tiles, which then come from L2.

#include "gram_tma.cuh"

namespace {

constexpr int kRwGroups = 2;                        // consumer warpgroups, 64 rows each
constexpr int kRwRows = kTile * kRwGroups;          // rows a block
constexpr int kRwThreads = 128 * (kRwGroups + 1);  // and the producer warpgroup
// Registers a thread (setmaxnreg): the producer's few, the consumers' the
// rest of the SM's 65,536, in multiples of 8.
constexpr int kRwProducerRegs = 40;
constexpr int kRwConsumerRegs = (65536 - 128 * kRwProducerRegs) / (128 * kRwGroups) / 8 * 8;
constexpr int kRwMaxStages = 6;
constexpr int kRwSmem = 227 * 1024;                 // a block's shared memory (H100)
constexpr int kRwAlign = 1024;                      // a swizzled chunk's alignment
constexpr int kRwCols = 16;                         // W's columns, padded: the split's N
constexpr int kRwKeyChunk = 64;                     // keys of a chunk of W's parts
constexpr int kRwWChunk = kRwCols * kRwKeyChunk * 2;  // its bytes

// Shared memory of a launch: byte offsets from a base aligned to kRwAlign.
struct RwLayout {
  int xchunk;  // bytes of one chunk of a key tile's part (BN points)
  int qchunk;  // of one chunk of a row tile's part (64 points)
  int w;       // W in a stage, after the key tile's [hi, lo][chunks]
  int wbytes;  // its bytes: the split's parts [hi, lo][BN / 64], or KC x BN floats
  int hy;      // the key tile's norms in a stage, after W
  int stage;   // bytes of a stage
  int stages;
  int qgroup;  // bytes of a group's rows: [hi, lo][chunks]
  int q;       // the rows' parts: [G][qgroup]
  int bars;    // uint64 full[stages], empty[stages], rows
  int bytes;   // with kRwAlign of room to align the base
};

__host__ __device__ constexpr RwLayout rw_layout(int box, int chunks, int bn, int passes,
                                                 int kc, int split) {
  const int parts = passes == 3 ? 2 : 1;
  RwLayout L{};
  L.xchunk = bn * box * 2;
  L.qchunk = kTile * box * 2;
  L.w = parts * chunks * L.xchunk;
  L.wbytes = split ? parts * (bn / kRwKeyChunk) * kRwWChunk : kc * bn * 4;
  L.hy = L.w + L.wbytes;
  L.stage = (L.hy + bn * 4 + kRwAlign - 1) / kRwAlign * kRwAlign;
  L.qgroup = parts * chunks * L.qchunk;
  const int q = kRwGroups * L.qgroup, bars = (2 * kRwMaxStages + 1) * 8;
  const int fit = (kRwSmem - kRwAlign - q - bars) / L.stage;
  L.stages = fit < kRwMaxStages ? fit : kRwMaxStages;
  L.q = L.stages * L.stage;
  L.bars = L.q + q;
  L.bytes = L.bars + bars + kRwAlign;
  return L;
}

// The operands of the accumulator of N = 64 or 128 columns, as "+f" (or, for
// a product that overwrites it, "=f") asm outputs.
#define RW_D8(C, d, i)                                                                         \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]),      \
      C(d[i + 7])
#define RW_D32(C, d) RW_D8(C, d, 0), RW_D8(C, d, 8), RW_D8(C, d, 16), RW_D8(C, d, 24)
#define RW_D64(C, d) RW_D32(C, d), RW_D8(C, d, 32), RW_D8(C, d, 40), RW_D8(C, d, 48), RW_D8(C, d, 56)
#define RW_REGS32                                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define RW_REGS64                                                                              \
  RW_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "    \
            "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, " \
            "%63"

// S (+)= A . B on the tensor cores for the warpgroup: A 64 x 16 and B 16 x BN
// bf16, both K-major in shared memory through their descriptors. FIRST:
// S is overwritten (its old values are not read).
template <int BN, bool FIRST>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  constexpr int kAcc = FIRST ? 0 : 1;
  if constexpr (BN == 128) {
    if constexpr (FIRST) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" RW_REGS64
                   "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
                   : RW_D64("=f", d)
                   : "l"(desc_a), "l"(desc_b), "r"(kAcc));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" RW_REGS64
                   "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
                   : RW_D64("+f", d)
                   : "l"(desc_a), "l"(desc_b), "r"(kAcc));
    }
  } else {
    if constexpr (FIRST) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" RW_REGS32
                   "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
                   : RW_D32("=f", d)
                   : "l"(desc_a), "l"(desc_b), "r"(kAcc));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" RW_REGS32
                   "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
                   : RW_D32("+f", d)
                   : "l"(desc_a), "l"(desc_b), "r"(kAcc));
    }
  }
}

// Issues and commits the cross term of the key tile at st against the
// group's rows at q into S.
template <int PASSES, int BN, int BF, int CH>
__device__ __forceinline__ void rw_cross(float (&S)[BN / 2], const unsigned char* q,
                                         const unsigned char* st) {
  constexpr RwLayout L = rw_layout(BF, CH, BN, PASSES, kRwCols, 1);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const uint64_t ah = wgmma_desc<BF>(q + c * L.qchunk);
    const uint64_t al = wgmma_desc<BF>(q + (CH + c) * L.qchunk);
    const uint64_t bh = wgmma_desc<BF>(st + c * L.xchunk);
    const uint64_t bl = wgmma_desc<BF>(st + (CH + c) * L.xchunk);
#pragma unroll
    for (int ks = 0; ks < BF / kDepth; ++ks) {
      if (c == 0 && ks == 0) {
        wgmma_ss<BN, true>(S, ah, bh);
      } else {
        wgmma_ss<BN, false>(S, ah + 2 * ks, bh + 2 * ks);
      }
      if constexpr (PASSES == 3) {
        wgmma_ss<BN, false>(S, ah + 2 * ks, bl + 2 * ks);
        wgmma_ss<BN, false>(S, al + 2 * ks, bh + 2 * ks);
      }
    }
  }
  wgmma_commit();
}

// B fragments of W's part for keys 16 s .. 16 s + 15 of the tile at w (its
// 64-key chunks of 16 rows of 128 bytes, swizzled): b[f][0..1] for W's
// columns 8 f .. 8 f + 7 (f < NT), by ldmatrix from the swizzled rows.
template <int NT>
__device__ __forceinline__ void rw_wfrag(uint32_t (&b)[2][2], const unsigned char* w, int s,
                                         int lane) {
  const int q = lane / 8, rr = lane % 8;
  const int row = 8 * (q >> 1) + rr, unit = (2 * (s % 4) + (q & 1)) ^ rr;
  const unsigned char* at = w + (s / 4) * kRwWChunk + row * 128 + unit * 16;
  if constexpr (NT == 2) {
    uint32_t r[4];
    ldsm_x4(r, reinterpret_cast<const uint16_t*>(at));
    b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1])
                 : "r"(smem_u32(at)));
  }
}

// The tile's epilogue and contraction, a 16-key step at a time: the values
// from S (epilogue on the accumulator), rounded to their bf16 hi and lo
// parts as split_bf16 rounds them, are the A fragment of the step (the
// accumulator's layout is the mma's A layout: no shuffle, no shared
// memory), contracted with W's parts of the step's keys (hi.hi + hi.lo +
// lo.hi, or hi.hi) into D, NT column fragments of 8.
template <int KIND, int PASSES, int BN, int NT>
__device__ __forceinline__ void rw_tile(const float (&S)[BN / 2], const unsigned char* w,
                                        const float* hy_s, const float (&hx)[2], int lane,
                                        float (&D)[2][4]) {
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  const int t = lane % 4;
#pragma unroll
  for (int s = 0; s < BN / 16; ++s) {
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * s + half;
      const float2 h2 = *reinterpret_cast<const float2*>(hy_s + 8 * j + 2 * t);
      const float hy0 = h2.x * kScale, hy1 = h2.y * kScale;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v0 = sym_value<KIND>(S[4 * j + 2 * r], hx[r], hy0);
        const float v1 = sym_value<KIND>(S[4 * j + 2 * r + 1], hx[r], hy1);
        const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
        ph[2 * half + r] = *reinterpret_cast<const uint32_t*>(&h);
        if constexpr (PASSES == 3) {
          const float2 hf = __bfloat1622float2(h);
          const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
          pl[2 * half + r] = *reinterpret_cast<const uint32_t*>(&l);
        }
      }
    }
    uint32_t wh[2][2], wl[2][2];
    rw_wfrag<NT>(wh, w, s, lane);
    if constexpr (PASSES == 3) rw_wfrag<NT>(wl, w + (BN / kRwKeyChunk) * kRwWChunk, s, lane);
#pragma unroll
    for (int f = 0; f < NT; ++f) {
      mma_bf16(D[f], ph, wh[f][0], wh[f][1]);
      if constexpr (PASSES == 3) {
        mma_bf16(D[f], ph, wl[f][0], wl[f][1]);
        mma_bf16(D[f], pl, wh[f][0], wh[f][1]);
      }
    }
  }
}

// The tile's epilogue and float32 contraction: the values made in place in
// S, then for each of W's first k columns (wt: KC rows of BN floats) each
// row's products over the thread's keys summed apart, two sums a row, and
// added to O[row][column] once a tile.
template <int KIND, int BN, int KC>
__device__ __forceinline__ void rw_tile_f32(float (&S)[BN / 2], const float* wt,
                                            const float* hy_s, const float (&hx)[2], int lane,
                                            int k, float (&O)[2][KC]) {
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 h2 = *reinterpret_cast<const float2*>(hy_s + 8 * j + 2 * t);
    const float hy0 = h2.x * kScale, hy1 = h2.y * kScale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      S[4 * j + 2 * r] = sym_value<KIND>(S[4 * j + 2 * r], hx[r], hy0);
      S[4 * j + 2 * r + 1] = sym_value<KIND>(S[4 * j + 2 * r + 1], hx[r], hy1);
    }
  }
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c >= k) break;
    const float* wc = wt + c * BN + 2 * t;
    float p[2][2] = {};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 w2 = *reinterpret_cast<const float2*>(wc + 8 * j);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        p[r][j & 1] = fmaf(S[4 * j + 2 * r], w2.x, p[r][j & 1]);
        p[r][j & 1] = fmaf(S[4 * j + 2 * r + 1], w2.y, p[r][j & 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) O[r][c] += p[r][0] + p[r][1];
  }
}

template <int KIND, int PASSES, int BN, int BF, int CH, int KC, int SPLIT>
__global__ void __launch_bounds__(kRwThreads, 1)
    gram_tier_rows(const GramArgs a, int nt, const __grid_constant__ CUtensorMap tm_xh,
                   const __grid_constant__ CUtensorMap tm_xl,
                   const __grid_constant__ CUtensorMap tm_yh,
                   const __grid_constant__ CUtensorMap tm_yl,
                   const __grid_constant__ CUtensorMap tm_hy,
                   const __grid_constant__ CUtensorMap tm_wh,
                   const __grid_constant__ CUtensorMap tm_wl) {
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  constexpr int G = kRwGroups, kParts = PASSES == 3 ? 2 : 1, NT = KC / 8;
  static_assert(!SPLIT || (PASSES == 3 && KC == kRwCols), "the split contraction: bf16x3, 16");
  constexpr RwLayout L = rw_layout(BF, CH, BN, PASSES, KC, SPLIT);
  constexpr int S = L.stages;
  static_assert(S >= 2, "a ring of at least two stages");
  const int run = a.m_split / BN;
  const int J0 = blockIdx.y * run, J1 = min(J0 + run, nt), T = J1 - J0;
  const int row0 = blockIdx.x * kRwRows;
  if (T <= 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kRwAlign - (smem_u32(smem_raw) & (kRwAlign - 1))) & (kRwAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;
  uint64_t* rows_full = empty + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * G);
    }
    mbar_init(rows_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * G) {
    // the producer: the rows' parts, then the run's key tiles into the ring,
    // from one lane of its first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRwProducerRegs));
    if (warp == 4 * G && elect_one()) {
      mbar_arrive_tx(rows_full, G * L.qgroup);
      for (int w = 0; w < G; ++w)
        for (int c = 0; c < CH; ++c) {
          unsigned char* dst = smem + L.q + w * L.qgroup + c * L.qchunk;
          tma_2d(dst, &tm_xh, c * BF, row0 + w * kTile, rows_full);
          if constexpr (PASSES == 3)
            tma_2d(dst + CH * L.qchunk, &tm_xl, c * BF, row0 + w * kTile, rows_full);
        }
      constexpr int kTx = kParts * CH * L.xchunk + L.wbytes + BN * 4;
      for (int t = 0; t < T; ++t) {
        const int s = t % S, J = J0 + t;
        if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
        unsigned char* st = smem + s * L.stage;
        mbar_arrive_tx(&full[s], kTx);
        for (int c = 0; c < CH; ++c) {
          tma_2d(st + c * L.xchunk, &tm_yh, c * BF, J * BN, &full[s]);
          if constexpr (PASSES == 3)
            tma_2d(st + (CH + c) * L.xchunk, &tm_yl, c * BF, J * BN, &full[s]);
        }
        if constexpr (SPLIT) {
          for (int h = 0; h < BN / kRwKeyChunk; ++h) {
            tma_2d(st + L.w + h * kRwWChunk, &tm_wh, J * BN + h * kRwKeyChunk, 0, &full[s]);
            tma_2d(st + L.w + (BN / kRwKeyChunk + h) * kRwWChunk, &tm_wl,
                   J * BN + h * kRwKeyChunk, 0, &full[s]);
          }
        } else {
          tma_2d(st + L.w, &tm_wh, J * BN, 0, &full[s]);
        }
        tma_1d(st + L.hy, &tm_hy, J * BN, &full[s]);
      }
    }
    return;
  }

  // Warpgroup w, its warp q4; lane (g, t) holds rows r0 = row0 + 64 w + 16 q4
  // + g and r0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRwConsumerRegs));
  const int w = warp / 4, q4 = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = row0 + w * kTile + 16 * q4 + g;
  float hx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) hx[r] = r0 + 8 * r < a.n ? a.hx[r0 + 8 * r] * kScale : 0.0f;
  const unsigned char* q = smem + L.q + w * L.qgroup;

  // split: O[f][2 r + e], row r0 + 8 r, column 8 f + 2 t + e; float32:
  // O[r][c], the thread's part of row r0 + 8 r, column c
  // (a.k is read where it is used: held in a register across the loop it
  // cost the split 4.5% at configs 7 and 9's row oracle, H100 at 700 W)
  float O[2][SPLIT ? 4 : KC] = {};
  float S0[BN / 2], S1[BN / 2];
  mbar_wait(rows_full, 0);
  mbar_wait(&full[0], 0);
  rw_cross<PASSES, BN, BF, CH>(S0, q, smem);
  fence_acc(S0);
  // Tile j, its cross term in Sc issued before: issue tile j + 1's into Sn,
  // wait for tile j's, then its values and contraction into a fresh D added
  // to O, and release its stage.
  const auto step = [&](int j, float (&Sc)[BN / 2], float (&Sn)[BN / 2]) {
    if (j + 1 < T) {
      const int s1 = (j + 1) % S;
      mbar_wait(&full[s1], ((j + 1) / S) & 1);
      rw_cross<PASSES, BN, BF, CH>(Sn, q, smem + s1 * L.stage);
      fence_acc(Sn);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(Sc);
    const unsigned char* st = smem + (j % S) * L.stage;
    const float* hy_s = reinterpret_cast<const float*>(st + L.hy);
    if constexpr (SPLIT) {
      float D[2][4] = {};
      rw_tile<KIND, PASSES, BN, NT>(Sc, st + L.w, hy_s, hx, lane, D);
#pragma unroll
      for (int f = 0; f < NT; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) O[f][i] += D[f][i];
    } else {
      rw_tile_f32<KIND, BN, KC>(Sc, reinterpret_cast<const float*>(st + L.w), hy_s, hx, lane,
                                a.k, O);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % S]);
  };
  for (int j = 0; j < T; j += 2) {
    step(j, S0, S1);
    if (j + 1 < T) step(j + 1, S1, S0);
  }

  // the run's rows, scaled (one run) or its partial
  const int n = a.n, k = a.k;
  float* out = static_cast<float*>(a.out);
  const auto put = [&](int row, int col, float v) {
    if (gridDim.y > 1) {
      a.part[((size_t)blockIdx.y * n + row) * k + col] = v;
    } else {
      out[(size_t)row * k + col] = (float)(v * a.c);
    }
  };
  if constexpr (SPLIT) {
#pragma unroll
    for (int f = 0; f < NT; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 8 * (i >> 1), col = 8 * f + 2 * t + (i & 1);
        if (row < n && col < k) put(row, col, O[f][i]);
      }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (c >= k) break;
        float v = O[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && r0 + 8 * r < n) put(r0 + 8 * r, c, v);
      }
  }
}

#undef RW_D8
#undef RW_D32
#undef RW_D64
#undef RW_REGS32
#undef RW_REGS64

// The launch's tensor maps: X1's parts (boxes of BF features x 64 rows),
// X2's (BF x BN), X2's norms (BN floats), and W: its transposed bf16 parts
// (split: 64 keys x 16 rows, 128-byte rows) or its transposed float32
// columns (BN keys x kc rows); zeros past the ends. The lo maps repeat the
// hi ones on the one-pass tier and for float32 W. False where a map cannot
// be made.
bool rw_tensor_maps(const GramArgs& a, int mpad, int bf, int bn, int kc, int split,
                    CUtensorMap (&maps)[7]) {
  const void* x1l = a.X1l != nullptr ? a.X1l : a.X1h;
  const void* x2l = a.X2l != nullptr ? a.X2l : a.X2h;
  const void* vl = a.Vl != nullptr ? a.Vl : a.Vh;
  const bool w = split ? bf16_tensor_map(&maps[5], a.Vh, kRwCols, mpad, kRwKeyChunk, kRwCols) &&
                             bf16_tensor_map(&maps[6], vl, kRwCols, mpad, kRwKeyChunk, kRwCols)
                       : f32_tensor_map_2d(&maps[5], a.Vh, kRwCols, mpad, bn, kc) &&
                             f32_tensor_map_2d(&maps[6], a.Vh, kRwCols, mpad, bn, kc);
  return w && bf16_tensor_map(&maps[0], a.X1h, a.n, a.d, bf, kTile) &&
         bf16_tensor_map(&maps[1], x1l, a.n, a.d, bf, kTile) &&
         bf16_tensor_map(&maps[2], a.X2h, a.m, a.d, bf, bn) &&
         bf16_tensor_map(&maps[3], x2l, a.m, a.d, bf, bn) &&
         f32_tensor_map(&maps[4], a.hy, (size_t)a.m, bn);
}

template <int KIND, int PASSES, int BN, int BF, int CH, int KC, int SPLIT>
int launch_tier_rows_shape(const GramArgs& args, int mpad, int splits, cudaStream_t s) {
  constexpr RwLayout L = rw_layout(BF, CH, BN, PASSES, KC, SPLIT);
  GramArgs a = args;
  CUtensorMap maps[7];
  if (!rw_tensor_maps(a, mpad, BF, BN, KC, SPLIT, maps)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gram_tier_rows<KIND, PASSES, BN, BF, CH, KC, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.m + BN - 1) / BN;
  if (splits < 1 || a.part == nullptr) splits = 1;
  if (splits > tiles) splits = tiles;
  const int run = (tiles + splits - 1) / splits;
  splits = (tiles + run - 1) / run;
  a.m_split = run * BN;
  const dim3 grid((a.n + kRwRows - 1) / kRwRows, splits);
  gram_tier_rows<KIND, PASSES, BN, BF, CH, KC, SPLIT><<<grid, kRwThreads, L.bytes, s>>>(
      a, tiles, maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6]);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)a.n * a.k;
  size_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, kThreads, 0, s>>>(a.part, static_cast<float*>(a.out), splits,
                                                   count, a.c);
  return (int)cudaGetLastError();
}

// By the depth: 128-key tiles of 32-feature chunks up to a depth of 32, of
// one 64-feature chunk up to 64; 64-key tiles of two chunks past that.
template <int KIND, int PASSES, int KC, int SPLIT>
int launch_tier_rows_k(const GramArgs& a, int mpad, int splits, cudaStream_t s) {
  if (a.d <= 32)
    return launch_tier_rows_shape<KIND, PASSES, 128, 32, 1, KC, SPLIT>(a, mpad, splits, s);
  if (a.d <= 64)
    return launch_tier_rows_shape<KIND, PASSES, 128, 64, 1, KC, SPLIT>(a, mpad, splits, s);
  return launch_tier_rows_shape<KIND, PASSES, 64, 64, 2, KC, SPLIT>(a, mpad, splits, s);
}

// The split contraction on W's 16 padded columns (bf16x3 alone); the
// float32 one on 1, 8 or 16 columns of W, the first k of them.
template <int KIND, int PASSES>
int launch_tier_rows(const GramArgs& a, int mpad, int splits, int split, cudaStream_t s) {
  if (split) {
    if constexpr (PASSES == 3) return launch_tier_rows_k<KIND, 3, kRwCols, 1>(a, mpad, splits, s);
    return (int)cudaErrorInvalidValue;
  }
  if (a.k == 1) return launch_tier_rows_k<KIND, PASSES, 1, 0>(a, mpad, splits, s);
  if (a.k <= 8) return launch_tier_rows_k<KIND, PASSES, 8, 0>(a, mpad, splits, s);
  return launch_tier_rows_k<KIND, PASSES, 16, 0>(a, mpad, splits, s);
}

template <int PASSES>
int tier_rows_by_kind(int kind, const GramArgs& a, int mpad, int splits, int split,
                      cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_tier_rows<RBF, PASSES>(a, mpad, splits, split, s);
    case MATERN12: return launch_tier_rows<MATERN12, PASSES>(a, mpad, splits, split, s);
    case MATERN32: return launch_tier_rows<MATERN32, PASSES>(a, mpad, splits, split, s);
    case MATERN52: return launch_tier_rows<MATERN52, PASSES>(a, mpad, splits, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: launches on `stream`, does not
// synchronize, returns a CUDA error code (0 on success).
// K1b at k <= 16 and dp <= 128: out = c * k(X1, X2) @ W on the tier of
// `passes` (3 or 1) from X1's parts X1h, X1l (n, dp) and X2's X2h, X2l (m,
// dp) bf16 (dp a multiple of 16; the lo parts unused and may be null when
// passes == 1), the norm vectors hx (n) and hy (m) of _norms_and_operands,
// and W transposed, zero past column m and row k (mpad a multiple of 8 at
// or above m): with split (bf16x3 alone) its bf16 parts Wh, Wl (16, mpad)
// (kernel_tiers.split_rhs_t), contracted tier-matched; else W itself in Wh,
// (16, mpad) float32 (kernel_tiers.rhs_t), Wl unused, contracted in
// float32. out (n, k) float32. splits > 1 cuts the m axis into that many runs whose
// partials go to part (splits * n * k floats) and are summed by a second
// launch. X1h, X1l, X2h, X2l, hy, Wh and Wl start 16-byte aligned.
extern "C" int rl_gram_matmat_tier_rows(int kind, int passes, const void* X1h,
                                        const void* X1l, const void* hx, const void* X2h,
                                        const void* X2l, const void* hy, const void* Wh,
                                        const void* Wl, void* part, void* out, int n, int m,
                                        int mpad, int dp, int k, int split, int splits,
                                        double c, void* stream) {
  if (dp % kDepth != 0 || dp > 128 || k < 1 || k > kRwCols || mpad < m || mpad % 8 != 0 ||
      (passes != 3 && passes != 1) || (split && passes != 3))
    return (int)cudaErrorInvalidValue;
  GramArgs a{};
  a.X1h = static_cast<const __nv_bfloat16*>(X1h);
  a.X1l = static_cast<const __nv_bfloat16*>(X1l);
  a.X2h = static_cast<const __nv_bfloat16*>(X2h);
  a.X2l = static_cast<const __nv_bfloat16*>(X2l);
  a.hx = static_cast<const float*>(hx);
  a.hy = static_cast<const float*>(hy);
  a.Vh = static_cast<const __nv_bfloat16*>(Wh);
  a.Vl = static_cast<const __nv_bfloat16*>(Wl);
  a.part = static_cast<float*>(part);
  a.out = out;
  a.n = n;
  a.m = m;
  a.d = dp;
  a.k = k;
  a.c = c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 3 ? tier_rows_by_kind<3>(kind, a, mpad, splits, split, s)
                     : tier_rows_by_kind<1>(kind, a, mpad, splits, split, s);
}
