// K2b for Hopper (sm_90a): the bf16 tiers' symmetric product c k(X, X) @ V,
// for one data set.
//
//   K2b gram_tier_symmetric<KIND, PASSES, KC> (k <= 2, padded depth <= 128)
//       replaces rlaopt_tpu/ops/kernel_pallas.py :: kernel_matvec_symmetric
//       with compute_dtype "bf16x3" (PASSES = 3) or "bfloat16" (PASSES = 1):
//       _sym_epilogue, _sym_tier_params, and _sym_mirror_mode's float32
//       mirror. Past two columns (the tier-matched mirror on the tensor
//       cores) or a padded depth of 128, rl_gram_matvec_symmetric_tier
//       hands the product to the strip's triangle form in gram_tier.cu
//       (gram_tier_triangle).
//
// What bounds it on the H100: one SFU exponential a kernel value (16 a
// clock per SM; n^2 / 2 = 5e11 values at n = 10^6 take 119.6 ms at the
// data-sheet clock), 3 (or 1) bf16 products of depth dp on the tensor cores
// (~85 ms at dp = 32 at the data-sheet rate), and on the CUDA cores a few
// float32 operations of epilogue and two FMAs of contraction a value: at
// 128 issued instructions a clock per SM against 16 exponentials, about 8
// instructions a value, the exponential included, keep the SFU the limit.
// The strip (gram_tier.cu) ran at 16% of that bound at n = 10^6 on an
// H100 at 700 W (749 ms): its 8 warps a block met at two __syncthreads a
// 64-column step, each warp's 16 rows summed their mirror by a 16-value
// shuffle reduce-scatter kept in local memory, the 8 warps' column sums
// were added by 64 of the 256 threads while the rest waited, and every
// value was masked. Timed without the exponential it took the same time,
// without the mirror 512 ms: neither the SFU nor the tensor cores set its
// pace.
//
// Design. Block (r, s) of the folded grid (ws_decode) owns the row tiles
// 2r and 2r + 1 (128 points) and walks the column tiles J = 2r + 64s .. 2r
// + 64s + 63 (J < nt). A producer warp streams the column tiles; warpgroup
// w (4 warps) evaluates each 64 x 64 block of values of column tile J
// against its row tile 2r + w:
//   * loads by TMA: one elected lane of the producer warp fills a ring of 4
//     stages, a stage the column tile's bf16 parts (64 points by chunks of
//     BF = 32 or 64 features, 64- or 128-byte rows swizzled as the tensor
//     cores read them), norms and V rows, its arrival counted in bytes on
//     the stage's full mbarrier; it refills a stage once every consumer
//     warp has arrived on its empty mbarrier. The row tiles' parts arrive
//     the same way once a strip. Rows and features past n and dp come in as
//     zeros. No __syncthreads in the steady state, and no load instruction
//     on the consumers' side but their norms and V rows;
//   * cross term by wgmma m64n64k16 (bf16 in, float32 accumulate), both
//     operands from shared memory through descriptors: A the column tile's
//     64 points, B the warpgroup's row tile; hi.hi + hi.lo + lo.hi
//     (bf16x3) or hi.hi (bfloat16), the strip's three products, issued
//     back to back in one commit group;
//   * epilogue on the accumulator: thread (warp q of the group, lane 4g +
//     t) holds the values of column points 16q + g and 16q + g + 8 against
//     row points 8j + 2t and 8j + 2t + 1 (j < 8), whose norms and V rows it
//     reads from shared memory, 16 floats by four 16-byte loads a tile; a
//     value costs its epilogue (sym_value: one ex2 for RBF), one FMA into
//     its row point's forward sum, carried in registers over the strip,
//     and one into its column point's mirror sum, and no mask: padded
//     points have zero parts, norms and V rows, so their values are finite
//     and multiply zeros;
//   * mirror: a column point's sum over the row tile is the thread's own
//     (over its 16) plus its quad's (two shuffles); the two warpgroups'
//     sums go to shared memory beside the stage, and the producer warp,
//     once it has refilled the stage, adds them in warpgroup order and
//     sends one atomicAdd per column point and tile; forward: at the
//     strip's end the row points' sums are added over the warp's 8 row
//     groups by shuffles and over the group's 4 warps in shared memory in
//     warp order, one atomicAdd per row point and strip;
//   * occupancy: at k = 1 a thread holds the 32 accumulators and 16 forward
//     sums in at most 128 registers, so two blocks (16 consumer warps) share
//     an SM and, running apart, overlap one's products on the tensor cores
//     with the other's epilogue on the SFU and the FP32 pipes; at k = 2 one
//     block an SM.
// Warpgroup w takes no part in column tiles below its row tile (their
// values are the mirror images of tiles it owns), the forward contraction
// alone on its diagonal tile, and both above.
// Timed on an H100 (PERF.md, row #2b): two warpgroups sharing
// an SM's tensor cores and SFU in lockstep finish in the sum of the two
// pipes' times rather than the larger; a double set of accumulators (tile
// u + 1's products behind tile u's epilogue) needs more registers than
// two blocks an SM leave, and an ordered turn at the tensor cores cost
// more in mbarrier hand-offs than it saved.

#include "gram_tma.cuh"

namespace {

constexpr int kWsStrip = 64;           // column tiles a block walks
constexpr int kWsStages = 4;           // column tiles in flight
constexpr int kWsMaxDepth = 128;       // padded depth the shared memory holds
constexpr int kWsMaxK = 2;             // right-hand sides: the float32 mirror
constexpr int kWsSmem = 227 * 1024;    // a block's shared memory (H100)
constexpr int kWsLd = 36;              // per-lane row of the norms and V rows (floats)
constexpr int kWsAlign = 1024;         // a swizzled chunk's alignment

constexpr int kWsGroups = 2;           // consumer warpgroups a block, a row tile each
constexpr int kWsThreads = 128 * kWsGroups + 32;  // and the producer warp
// Features of a chunk of a part: 32 (64-byte rows) up to a depth of 32,
// else 64 (128-byte rows), the row being the swizzle's span.
__host__ __device__ constexpr int ws_box(int dp) { return dp <= 32 ? 32 : 64; }

// Shared memory of one launch by the padded depth dp and KC: byte offsets
// from a base aligned to kWsAlign.
struct WsLayout {
  int chunk;   // bytes of one chunk of a part (64 points)
  int chunks;  // chunks a part
  int hy;      // the column tile's norms, in a stage (after hi, lo chunks)
  int vj;      // its V rows, in a stage
  int stage;   // bytes of one stage
  int rows;    // the row tiles' parts: [G][hi, lo][chunks]
  int mir;     // float [stages][2][G][64 KC]: the groups' mirror sums, by
               // the stage's round (even, odd)
  int hxs;     // float [G][4][kWsLd]: the row points' norms, by lane t
  int vis;     // float [G][KC][4][kWsLd]: their V rows, by lane t
  int red;     // float [G][4][64 KC]: the warps' forward sums at the strip's end
  int bars;    // uint64 full[stages], empty[stages], then the row tiles'
  int bytes;   // with kWsAlign of room to align the base
};

__host__ __device__ inline WsLayout ws_layout(int dp, int kc) {
  const int G = kWsGroups, box = ws_box(dp);
  WsLayout L{};
  L.chunk = kTile * box * 2;
  L.chunks = (dp + box - 1) / box;
  L.hy = 2 * L.chunks * L.chunk;
  L.vj = L.hy + kTile * 4;
  L.stage = (L.vj + kTile * kc * 4 + kWsAlign - 1) / kWsAlign * kWsAlign;
  const int rows = G * 2 * L.chunks * L.chunk, mir = 2 * G * kTile * kc * 4;
  int at = kWsStages * L.stage;
  L.rows = at; at += rows;
  L.mir = at; at += kWsStages * mir;
  L.hxs = at; at += G * 4 * kWsLd * 4;
  L.vis = at; at += kc * G * 4 * kWsLd * 4;
  L.red = at; at += G * 4 * kTile * kc * 4;
  L.bars = at; at += (2 * kWsStages + 1) * 8;
  L.bytes = at + kWsAlign;
  return L;
}

// Column-tile strips of row block r (its first tile 2r, nt tiles in all).
__host__ __device__ inline int ws_strips(int nt, int r) {
  return (nt - kWsGroups * r + kWsStrip - 1) / kWsStrip;
}

// The folded grid: block x takes row blocks x and R - 1 - x (R = ceil(nt /
// 2)), the strips of the first then of the second, so that every x has
// about the same work; false for a block past both.
__device__ __forceinline__ bool ws_decode(int nt, int& r, int& s) {
  const int R = (nt + kWsGroups - 1) / kWsGroups;
  const int x = blockIdx.x, x2 = R - 1 - x;
  s = blockIdx.y;
  const int s1 = ws_strips(nt, x);
  if (s < s1) {
    r = x;
    return true;
  }
  s -= s1;
  r = x2;
  return x2 > x && s < ws_strips(nt, x2);
}

// The producer warp: the row tiles, then column tiles J0 .. J1 - 1 into the
// ring (one elected lane issues the copies), and after each refill the
// mirror sums of the tile it replaced, the groups' added in order, to out.
template <int PASSES, int KC, int BF>
__device__ __forceinline__ void ws_produce(const GramArgs& a, unsigned char* smem,
                                           const WsLayout& L, int r, int J0, int J1,
                                           uint64_t* full, uint64_t* empty, uint64_t* rows_full,
                                           const CUtensorMap* tm_hi, const CUtensorMap* tm_lo,
                                           const CUtensorMap* tm_hx, const CUtensorMap* tm_v,
                                           int lane) {
  constexpr int G = kWsGroups, kParts = PASSES == 3 ? 2 : 1;
  const int n = a.n, T = J1 - J0;
  constexpr int S = kWsStages;
  const int part = L.chunks * L.chunk;
  float* out = static_cast<float*>(a.out);
  const float cs = (float)a.c;
  if (elect_one()) {
    mbar_arrive_tx(rows_full, G * kParts * part);
    for (int w = 0; w < G; ++w)
      for (int c = 0; c < L.chunks; ++c) {
        unsigned char* dst = smem + L.rows + 2 * w * part + c * L.chunk;
        tma_2d(dst, tm_hi, c * BF, (G * r + w) * kTile, rows_full);
        if constexpr (PASSES == 3) tma_2d(dst + part, tm_lo, c * BF, (G * r + w) * kTile, rows_full);
      }
  }
  __syncwarp();
  for (int t = 0; t < T + S; ++t) {
    const int s = t % S;
    if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
    if (t < T) {
      if (elect_one()) {
        const int J = J0 + t;
        unsigned char* st = smem + s * L.stage;
        mbar_arrive_tx(&full[s], kParts * part + kTile * 4 * (1 + KC));
        for (int c = 0; c < L.chunks; ++c) {
          tma_2d(st + c * L.chunk, tm_hi, c * BF, J * kTile, &full[s]);
          if constexpr (PASSES == 3) tma_2d(st + part + c * L.chunk, tm_lo, c * BF, J * kTile, &full[s]);
        }
        tma_1d(st + L.hy, tm_hx, J * kTile, &full[s]);
        tma_1d(st + L.vj, tm_v, J * kTile * KC, &full[s]);
      }
      __syncwarp();
    }
    // tile t - S, released: its mirror sums (the round's half of the stage's
    // buffer, which the next round's consumers do not write), where some
    // group took them
    const int J = J0 + t - S;
    if (t >= S && J > G * r) {
      const float* mir = reinterpret_cast<const float*>(smem + L.mir) +
                         (2 * s + (t / S - 1) % 2) * G * kTile * KC;
      for (int e = lane; e < kTile * KC; e += 32) {
        float v = mir[e];
#pragma unroll
        for (int w = 1; w < G; ++w) v += mir[w * kTile * KC + e];
        if (J * kTile + e / KC < n) atomicAdd(&out[(size_t)J * kTile * KC + e], v * cs);
      }
    }
  }
}

// The epilogue of one tile on the accumulator: both contractions, or
// (BOTH false: the diagonal tile) the forward one alone.
template <int KIND, int KC, bool BOTH>
__device__ __forceinline__ void ws_epilogue(const float (&acc)[32], const float4* hx4,
                                            const float4* vi4, float (&fwd)[8][2][KC],
                                            float hy0, float hy1, const float (&vj0)[KC],
                                            const float (&vj1)[KC], float (&mir)[2][2][KC]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float4 h4 = hx4[jj];
    const float hx[4] = {h4.x, h4.y, h4.z, h4.w};
    float vi[KC][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 v4 = vi4[c * kWsLd + jj];
      vi[c][0] = v4.x; vi[c][1] = v4.y; vi[c][2] = v4.z; vi[c][3] = v4.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 2 * jj + q / 2, e = q % 2;
      const float v0 = sym_value<KIND>(acc[4 * j + e], hx[q], hy0);
      const float v1 = sym_value<KIND>(acc[4 * j + 2 + e], hx[q], hy1);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        fwd[j][e][c] = fmaf(v1, vj1[c], fmaf(v0, vj0[c], fwd[j][e][c]));
        if constexpr (BOTH) {
          mir[0][q & 1][c] = fmaf(v0, vi[c][q], mir[0][q & 1][c]);
          mir[1][q & 1][c] = fmaf(v1, vi[c][q], mir[1][q & 1][c]);
        }
      }
    }
  }
}

template <int KIND, int PASSES, int KC, int BF, int CH>
__global__ void __launch_bounds__(kWsThreads, KC == 1 ? 2 : 1)
    gram_tier_symmetric(const GramArgs a, int nt, const __grid_constant__ CUtensorMap tm_hi,
                        const __grid_constant__ CUtensorMap tm_lo,
                        const __grid_constant__ CUtensorMap tm_hx,
                        const __grid_constant__ CUtensorMap tm_v) {
  constexpr float kScale = KIND == RBF ? kLog2e : 1.0f;
  constexpr int G = kWsGroups, S = kWsStages;
  int r, s;
  if (!ws_decode(nt, r, s)) return;
  const int J0 = G * r + s * kWsStrip, J1 = min(J0 + kWsStrip, nt);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kWsAlign - (smem_u32(smem_raw) & (kWsAlign - 1))) & (kWsAlign - 1));
  const int n = a.n, dp = a.d;
  const WsLayout L = ws_layout(dp, KC);
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
  if (warp == 4 * G) {
    ws_produce<PASSES, KC, BF>(a, smem, L, r, J0, J1, full, empty, rows_full, &tm_hi, &tm_lo,
                               &tm_hx, &tm_v, lane);
    return;
  }

  // Warpgroup w, its warp q; its row tile RT, rows row0 ..
  const int w = warp / 4, q4 = warp % 4, tid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int RT = G * r + w, row0 = RT * kTile;
  // the row points' norms and V rows by lane: point 8j + 2u + e at [u][2j + e]
  const float* __restrict__ V = static_cast<const float*>(a.V);
  float* hxs = reinterpret_cast<float*>(smem + L.hxs) + w * 4 * kWsLd;
  float* vis = reinterpret_cast<float*>(smem + L.vis) + w * KC * 4 * kWsLd;
  if (tid < kTile) {
    const int i = row0 + tid, u = (tid % 8) / 2, at = 2 * (tid / 8) + tid % 2;
    hxs[u * kWsLd + at] = i < n ? a.hx[i] * kScale : 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      vis[(c * 4 + u) * kWsLd + at] = i < n ? V[(size_t)i * KC + c] : 0.0f;
  }
  group_sync(w);
  const float4* hx4 = reinterpret_cast<const float4*>(hxs + t * kWsLd);
  const float4* vi4 = reinterpret_cast<const float4*>(vis + t * kWsLd);

  float fwd[8][2][KC];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < KC; ++c) fwd[j][e][c] = 0.0f;
  const int part = CH * L.chunk;
  const unsigned char* rows = smem + L.rows + 2 * w * part;
  const int j0 = 16 * q4 + g;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  mbar_wait(rows_full, 0);

  for (int J = J0, tt = 0; J < J1; ++J, ++tt) {
    const int st = tt % S;
    mbar_wait(&full[st], (tt / S) & 1);
    const unsigned char* sp = smem + st * L.stage;
    float mir[2][2][KC];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int c = 0; c < KC; ++c) mir[h][p][c] = 0.0f;
    if (J >= RT) {
      const float* hy_s = reinterpret_cast<const float*>(sp + L.hy);
      const float* vj_s = reinterpret_cast<const float*>(sp + L.vj);
      const float hy0 = hy_s[j0] * kScale, hy1 = hy_s[j0 + 8] * kScale;
      float vj0[KC], vj1[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        vj0[c] = vj_s[j0 * KC + c];
        vj1[c] = vj_s[(j0 + 8) * KC + c];
      }
      // the CH chunks' k-steps (the descriptors' start 32 bytes on a step),
      // the three products of a step back to back, one commit group
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint64_t ah = wgmma_desc<BF>(sp + c * L.chunk);
        const uint64_t al = wgmma_desc<BF>(sp + part + c * L.chunk);
        const uint64_t bh = wgmma_desc<BF>(rows + c * L.chunk);
        const uint64_t bl = wgmma_desc<BF>(rows + part + c * L.chunk);
#pragma unroll
        for (int ks = 0; ks < BF / kDepth; ++ks) {
          wgmma_ss64(acc, ah + 2 * ks, bh + 2 * ks, c > 0 || ks > 0);
          if constexpr (PASSES == 3) {
            wgmma_ss64(acc, ah + 2 * ks, bl + 2 * ks, 1);
            wgmma_ss64(acc, al + 2 * ks, bh + 2 * ks, 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (J > RT) {
        ws_epilogue<KIND, KC, true>(acc, hx4, vi4, fwd, hy0, hy1, vj0, vj1, mir);
      } else {
        ws_epilogue<KIND, KC, false>(acc, hx4, vi4, fwd, hy0, hy1, vj0, vj1, mir);
      }
    }
    // the group's mirror sums of column points 16 q + g (+ 8) over the quad
    // (zero where it takes none), lanes t = 0 and 1 the first and second,
    // beside the stage (the half of the stage's round); then the stage goes
    // back to the producer
    float* mir_s = reinterpret_cast<float*>(smem + L.mir) +
                   ((2 * st + (tt / S) % 2) * G + w) * kTile * KC;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float r0 = mir[0][0][c] + mir[0][1][c], r1 = mir[1][0][c] + mir[1][1][c];
      const bool odd = t & 1;
      float x = odd ? r1 : r0;
      x += __shfl_xor_sync(0xffffffffu, odd ? r0 : r1, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t < 2) mir_s[(j0 + 8 * t) * KC + c] = x;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the forward sums: over the warp's 8 row groups (lanes 4, 8, 16 apart),
  // then over the group's 4 warps in shared memory, in warp order
  float* red = reinterpret_cast<float*>(smem + L.red) + w * 4 * kTile * KC;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float v = fwd[j][e][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[(q4 * kTile + 8 * j + 2 * t + e) * KC + c] = v;
      }
  group_sync(w);
  for (int e = tid; e < kTile * KC; e += 128) {
    const float v = red[e] + red[kTile * KC + e] + red[2 * kTile * KC + e] +
                    red[3 * kTile * KC + e];
    if (row0 + e / KC < n) atomicAdd(&out[(size_t)row0 * KC + e], v * (float)a.c);
  }
}

// The launch's four tensor maps: X's parts (dp x n bf16, boxes of BF x 64,
// swizzled over the box's row), hx (n floats) and V (n k floats), boxes of
// 64 points; zeros past the ends. False where a map cannot be made.
bool ws_tensor_maps(const GramArgs& a, int box, CUtensorMap (&maps)[4]) {
  const void* parts[2] = {a.X1h, a.X1l != nullptr ? a.X1l : a.X1h};
  for (int p = 0; p < 2; ++p)
    if (!bf16_tensor_map(&maps[p], parts[p], a.n, a.d, box, kTile)) return false;
  return f32_tensor_map(&maps[2], a.hx, (size_t)a.n, kTile) &&
         f32_tensor_map(&maps[3], a.V, (size_t)a.n * a.k, kTile * a.k);
}

template <int KIND, int PASSES, int KC, int BF, int CH>
int launch_tier_symmetric_kc(const GramArgs& a, const CUtensorMap (&maps)[4], cudaStream_t s) {
  constexpr int G = kWsGroups;
  const WsLayout L = ws_layout(a.d, KC);
  if (L.bytes > kWsSmem || L.chunks != CH) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gram_tier_symmetric<KIND, PASSES, KC, BF, CH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (a.n + kTile - 1) / kTile, R = (nt + G - 1) / G, X = (R + 1) / 2;
  int strips = 0;
  for (int x = 0; x < X; ++x) {
    const int x2 = R - 1 - x;
    strips = max(strips, ws_strips(nt, x) + (x2 > x ? ws_strips(nt, x2) : 0));
  }
  gram_tier_symmetric<KIND, PASSES, KC, BF, CH><<<dim3(X, strips), kWsThreads, L.bytes, s>>>(
      a, nt, maps[0], maps[1], maps[2], maps[3]);
  return (int)cudaGetLastError();
}

// By k and the depth: chunks of 32 features up to a depth of 32, one chunk
// of 64 up to 64, two past that.
template <int KIND, int PASSES, int KC>
int launch_tier_symmetric_k(const GramArgs& a, const CUtensorMap (&maps)[4], cudaStream_t s) {
  if (a.d <= 32) return launch_tier_symmetric_kc<KIND, PASSES, KC, 32, 1>(a, maps, s);
  if (a.d <= 64) return launch_tier_symmetric_kc<KIND, PASSES, KC, 64, 1>(a, maps, s);
  return launch_tier_symmetric_kc<KIND, PASSES, KC, 64, 2>(a, maps, s);
}

template <int KIND, int PASSES>
int launch_tier_symmetric(const GramArgs& a, const CUtensorMap (&maps)[4], cudaStream_t s) {
  return a.k == 1 ? launch_tier_symmetric_k<KIND, PASSES, 1>(a, maps, s)
                  : launch_tier_symmetric_k<KIND, PASSES, 2>(a, maps, s);
}

template <int PASSES>
int tier_symmetric_by_kind(int kind, const GramArgs& a, const CUtensorMap (&maps)[4],
                           cudaStream_t s) {
  switch (kind) {
    case RBF: return launch_tier_symmetric<RBF, PASSES>(a, maps, s);
    case MATERN12: return launch_tier_symmetric<MATERN12, PASSES>(a, maps, s);
    case MATERN32: return launch_tier_symmetric<MATERN32, PASSES>(a, maps, s);
    case MATERN52: return launch_tier_symmetric<MATERN52, PASSES>(a, maps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rl_gram_tier_triangle(int kind, int passes, const void* Xh, const void* Xl,
                                     const void* hx, const void* V, void* out, int n,
                                     int dp, int k, double c, void* stream);

// Plain C interface, loaded with ctypes: launches on `stream`, does not
// synchronize, returns a CUDA error code (0 on success).
// K2b: out = c * k(X, X) @ V on the tier of `passes` (3 or 1), from X's
// parts Xh, Xl (n, dp) bf16 (dp a multiple of 16; Xl unused and may be
// null when passes == 1), the norm vector hx (n) of _norms_and_operands,
// V (n, k) and out (n, k) float32, 1 <= k <= 16; out is zeroed here first.
// k <= 2 at dp <= 128 takes gram_tier_symmetric, the rest the strip.
extern "C" int rl_gram_matvec_symmetric_tier(int kind, int passes, const void* Xh,
                                             const void* Xl, const void* hx,
                                             const void* V, void* out, int n, int dp,
                                             int k, double c, void* stream) {
  if (dp % kDepth != 0 || k < 1 || k > 16 || (passes != 3 && passes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * k, s);
  if (err != cudaSuccess) return (int)err;
  if (k > kWsMaxK || dp > kWsMaxDepth)
    return rl_gram_tier_triangle(kind, passes, Xh, Xl, hx, V, out, n, dp, k, c, stream);
  GramArgs a{};
  a.X1h = a.X2h = static_cast<const __nv_bfloat16*>(Xh);
  a.X1l = a.X2l = static_cast<const __nv_bfloat16*>(Xl);
  a.hx = a.hy = static_cast<const float*>(hx);
  a.V = V;
  a.out = out;
  a.n = a.m = n;
  a.d = dp;
  a.k = k;
  a.c = c;
  CUtensorMap maps[4];
  if (!ws_tensor_maps(a, ws_box(dp), maps)) return (int)cudaErrorInvalidValue;
  return passes == 3 ? tier_symmetric_by_kind<3>(kind, a, maps, s)
                     : tier_symmetric_by_kind<1>(kind, a, maps, s);
}
