// K1 and K3 past 16 columns for Hopper (sm_90a), the warpgroup form:
// out = c * k(X1, X2) @ V for every family, the contraction by 3xTF32 wgmma.
//
//   K1  gram_wide_ws<KIND, BN>   replaces rlaopt_tpu/ops/kernel_pallas.py ::
//       (KIND != LAPLACE,         kernel_matmat_pallas, exact tier, past 16
//       k > 16)                   columns: its six-term bf16 fold of the
//                                 distance on the MXU and its contraction at
//                                 Precision.HIGHEST (the Nystrom sketch at
//                                 k = 500, config 5's at k = 200)
//   K3  gram_wide_ws<LAPLACE, BN> replaces kernel_pallas.py :: _laplace_matmat
//       (k > 16)                  past 16 columns: the L1 distance on the
//                                 VPU, the contraction at "highest" (path
//                                 B's sketch at k = 500, E3's sketches)
//
// kernel_cuda.wide_route sends here k >= 33 at a padded depth up to 128,
// where this kernel measures faster than gram_wide.cu's gram_wide_tf32;
// that kernel keeps the rest (k = 17 .. 32, where it measured 1-3% faster,
// and deeper points).
//
// What bounds it on the H100: the contraction, three TF32 passes (hi.hi +
// hi.lo + lo.hi, each value and each V entry split as hi = cvt.rna.tf32(v),
// lo = cvt.rna.tf32(v - hi), float32 accumulation) of 2k operations a
// value: at the data sheet's dense 495 TFLOP/s 60.6 ms at 100k^2, k = 500,
// the frozen bound of sketch_roofline.solve. Beside it, on the CUDA cores,
// each evaluation of the 10^10 values: the distance (an FSUB and an FFMA a
// feature of a squared pair, two FADDs of an L1 pair), the epilogue (the
// exponential on the SFU) and the TF32 split, ~25 ms of issue slots at d =
// 28 (measured: the kernel without its products).
//
// Design:
//   * block (I, y) owns rows 128 I .. 128 I + 127 of X1 and BN output
//     columns from BN y, and walks X2 in tiles of 32 points. BN (64, 128 or
//     168; kernel_cuda.wide_ws_cols) is the narrowest that covers k in the
//     fewest groups: a value is evaluated once a group, 3 times at k = 500
//     (gram_wide.cu's kernel: 4). 384 threads: two consumer warpgroups (64
//     rows each) and a producer warpgroup (setmaxnreg: 40 registers, the
//     consumers 232; ptxas still compiles every warp for the launch bound,
//     168, so the accumulator and the running sums of 64 x 168 fill it);
//   * loads by TMA: one elected lane fills a ring of stages, a stage the
//     tile's V parts (BN rows of 32 floats each, 128-byte rows swizzled as
//     wgmma reads a K-major tf32 operand) and its points (the register
//     tile's operand, kernel_cuda.tile_operand: dpad rows of 32 floats),
//     counted in bytes on the stage's full mbarrier; it refills a stage
//     once the 8 consumer warps have arrived on its empty mbarrier. The
//     row tile's points (dpad x 128 floats) arrive once. Zero padding adds
//     nothing to a distance, padded points meet V's zero rows, and rows of V
//     past k come in as zeros: nothing is masked;
//   * values: lane (g4, t8) of warp q of group w makes rows 64 w + 16 q +
//     4 g4 + i against the tile's points 4 t8 + p (i, p < 4) from one float4
//     of x and one of y a feature (gram_tile.cuh's dist_step: direct
//     differences, never the norm expansion), then tile_value and the TF32
//     split, and stores both parts as the group's A operand in shared
//     memory (64 rows of 128 bytes, swizzled), one 16-byte chunk a row and
//     part; fence.proxy.async and a barrier of the group's 128 threads
//     make them visible to the products;
//   * products: per tile 12 wgmma m64nBNk8 .tf32, both operands from shared
//     memory, the small terms first (hi.lo, lo.hi, then hi.hi), into a
//     fresh accumulator that is added to float32 running sums when they are
//     done (every 32 points): the tensor cores' own sum is not IEEE float,
//     and carried across a walk its error grows (K1b's wide kernel lost
//     7.6e-5 of max|ref| so). Every 64 tiles (2,048 points) the running
//     sums are added to the block's entries of out (the first time written)
//     and zeroed: a float32 sum carried over the 3,125 tiles of m = 10^5
//     put the kernel's error at 1.3-1.8x gram_wide.cu's, this one at a
//     third of it (tools/wide_routes.py);
//   * overlap: a group makes tile j + 1's values while its products of tile
//     j run, then waits for them, folds, releases tile j's stage and issues
//     tile j + 1's;
//   * output: each thread's entries of out scaled by c at the end; no
//     atomics, no runs of the m axis: the same bits on every call.
// Blocks are laid out row block first, so the blocks on the card at one
// time read the same column group's V from L2. Timed on an H100 at 700 W
// (tools/wide_routes.py, 100k^2, d = 28, k = 500): with the products left
// out the kernel takes ~109 ms, with the values left out ~85 ms, without
// either ~49 ms (the ring), and whole ~185: the tensor cores and the CUDA
// cores of an SM did not overlap (every version summed the two). Tried
// and slower: A from registers (wgmma's RS form: 222-335 ms), 2 x 8 values
// a lane in place of 4 x 4 (254 against 229 ms: three loads a feature for
// 16 pairs where this takes two), a producer warp in place of the
// warpgroup (252 against 207 ms), 128 columns a block (211 ms; PERF.md
// section 6). WIDE_WS_ABLATE
// (not set by the build) leaves out the products (1) or the values (2), or
// both (3), for that diagnosis.

#include "gram_tile.cuh"
#include "gram_tma.cuh"

#ifndef WIDE_WS_ABLATE
#define WIDE_WS_ABLATE 0
#endif

namespace {

constexpr int kWsGroups = 2;                      // consumer warpgroups, 64 rows each
constexpr int kWsRows = 64 * kWsGroups;           // rows of X1 a block
constexpr int kWsPts = 32;                        // points of X2 a tile: 4 k-steps of 8
constexpr int kWsThreads = 128 * (kWsGroups + 1);  // and the producer warpgroup
// Registers a thread (setmaxnreg): the producer's few, the consumers' the
// rest of the SM's 65,536, in multiples of 8.
constexpr int kWsProducerRegs = 40;
constexpr int kWsConsumerRegs = (65536 - 128 * kWsProducerRegs) / (128 * kWsGroups) / 8 * 8;
constexpr int kWsFlush = 64;                      // tiles between flushes of the sums
constexpr int kWsMaxStages = 6;
constexpr int kWsSmem = 227 * 1024;                // a block's shared memory (H100)
constexpr int kWsAlign = 1024;                     // a swizzled part's alignment
constexpr int kWsMaxDepth = 128;                   // padded depth: the row tile in shared memory
constexpr int kWsAPart = 64 * kWsPts * 4;          // a group's part of A: 64 rows of 128 bytes

// Shared memory of a launch: byte offsets from a base aligned to kWsAlign.
struct WsLayout {
  int part;    // bytes of one of V's parts in a stage: BN rows of 128 bytes
  int y;       // the tile's points in a stage, after [hi, lo]: dpad x 32 floats
  int stage;   // bytes of a stage
  int stages;
  int a;       // the groups' A operands: [group][hi, lo] of kWsAPart
  int x;       // the row tile's points: dpad x 128 floats
  int bars;    // uint64 full[stages], empty[stages], rows
  int bytes;   // with kWsAlign of room to align the base
};

__host__ __device__ constexpr WsLayout ws_layout(int bn, int dpad) {
  WsLayout L{};
  L.part = bn * kWsPts * 4;
  L.y = 2 * L.part;
  L.stage = (L.y + dpad * kWsPts * 4 + kWsAlign - 1) / kWsAlign * kWsAlign;
  const int a = kWsGroups * 2 * kWsAPart, x = dpad * kWsRows * 4;
  const int bars = (2 * kWsMaxStages + 1) * 8;
  const int fit = (kWsSmem - kWsAlign - a - x - bars) / L.stage;
  L.stages = fit < kWsMaxStages ? fit : kWsMaxStages;
  L.a = L.stages * L.stage;
  L.x = L.a + a;
  L.bars = L.x + x;
  L.bytes = L.bars + bars + kWsAlign;
  return L;
}

__device__ __forceinline__ float ws_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// acc (+)= A . B on the tensor cores for the warpgroup: A 64 x 8 and B 8 x
// BN tf32, both K-major in shared memory through their descriptors;
// scale_d 0 overwrites acc.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  static_assert(BN == 64 || BN == 128 || BN == 168, "64, 128 or 168 output columns a block");
  if constexpr (BN == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
                 "}, %32, %33, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else if constexpr (BN == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
                 "}, %64, %65, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
                   "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else if constexpr (BN == 168) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %86, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n168k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
                 "%80, %81, %82, %83"
                 "}, %84, %85, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                   "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
                   "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
                   "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
                   "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
                   "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// The thread's values of a tile: rows i < 4 at xs (the row tile's points,
// 128 a feature) against the tile's points p < 4 at ys (32 a feature), over
// d features (gram_tile.cuh's dist_step), then the family's value.
template <int KIND>
__device__ __forceinline__ void ws_values(float (&v)[4][4], const float* xs, const float* ys,
                                          int d) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p) v[i][p] = 0.0f;
#if WIDE_WS_ABLATE & 2
  (void)xs;
  (void)ys;
  (void)d;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p) v[i][p] = 1.0f;
#else
#pragma unroll 4
  for (int f = 0; f < d; ++f) {
    float x[4], y[4];
    load4(xs + f * kWsRows, x);
    load4(ys + f * kWsPts, y);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int p = 0; p < 4; ++p) v[i][p] = dist_step<KIND>(v[i][p], x[i], y[p]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p) v[i][p] = tile_value<KIND>(v[i][p]);
#endif
}

// The values' TF32 parts into the group's A operand: hi at a, lo at a +
// kWsAPart, row r0 + i a 128-byte row of the tile's 32 points, its 16-byte
// chunks c at c ^ (row % 8) (the 128-byte swizzle); the thread's points are
// chunk t8.
__device__ __forceinline__ void ws_store(const float (&v)[4][4], unsigned char* a, int r0,
                                         int t8) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    float hi[4], lo[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      hi[p] = ws_tf32(v[i][p]);
      lo[p] = ws_tf32(v[i][p] - hi[p]);
    }
    unsigned char* at = a + r * 128 + ((t8 ^ (r & 7)) * 16);
    *reinterpret_cast<float4*>(at) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(at + kWsAPart) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Issues and commits the tile's 12 products into acc (overwritten), A's
// parts at a (hi) and a + kWsAPart (lo), V's at st (hi) and st + part (lo):
// hi.lo, lo.hi, then hi.hi.
template <int BN>
__device__ __forceinline__ void ws_products(float (&acc)[BN / 2], const unsigned char* a,
                                            const unsigned char* st, int part) {
  const uint64_t ah = wgmma_desc<64>(a), al = wgmma_desc<64>(a + kWsAPart);
  const uint64_t bh = wgmma_desc<64>(st), bl = wgmma_desc<64>(st + part);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_tf32<BN>(acc, ah + 2 * s, bl + 2 * s, s != 0);
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_tf32<BN>(acc, al + 2 * s, bh + 2 * s, 1);
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_tf32<BN>(acc, ah + 2 * s, bh + 2 * s, 1);
  wgmma_commit();
}

// tm_x: XT1 (dpad, npad) in boxes of 128 points x dpad; tm_y: XT2 (dpad,
// mpad) in boxes of 32 x dpad; tm_vh, tm_vl: V's parts (k, mpad) in boxes of
// 32 points x BN columns, swizzled; nt tiles of 32 points; out (n, k).
template <int KIND, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
    gram_wide_ws(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_y,
                 const __grid_constant__ CUtensorMap tm_vh,
                 const __grid_constant__ CUtensorMap tm_vl, float* __restrict__ out, int n,
                 int k, int d, int dpad, int nt, double c) {
  constexpr int NA = BN / 2;
  const WsLayout L = ws_layout(BN, dpad);
  const int S = L.stages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kWsAlign - (smem_u32(smem_raw) & (kWsAlign - 1))) & (kWsAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;
  uint64_t* rows_full = empty + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kWsRows, c0 = blockIdx.y * BN;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kWsGroups);
    }
    mbar_init(rows_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kWsGroups) {
    // the producer: the row tile's points, then the tiles into the ring,
    // from one lane
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWsProducerRegs));
    if (warp == 4 * kWsGroups && elect_one()) {
      mbar_arrive_tx(rows_full, dpad * kWsRows * 4);
      tma_2d(smem + L.x, &tm_x, row0, 0, rows_full);
      const int tx = L.y + dpad * kWsPts * 4;
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < nt; ++j) {
        if (j >= S) mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = smem + s * L.stage;
        mbar_arrive_tx(&full[s], tx);
        tma_2d(st, &tm_vh, j * kWsPts, c0, &full[s]);
        tma_2d(st + L.part, &tm_vl, j * kWsPts, c0, &full[s]);
        tma_2d(st + L.y, &tm_y, j * kWsPts, 0, &full[s]);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWsConsumerRegs));
  // warp q4 of group w; for the values lane (g4, t8) holds rows 16 q4 + 4 g4
  // + i against points 4 t8 + p (i, p < 4), for the products lane (g, t)
  // the accumulator's rows 16 q4 + g and + 8 against columns 8 j + 2 t + e
  const int w = warp / 4, q4 = warp % 4, g = lane / 4, t = lane % 4;
  const int g4 = lane / 8, t8 = lane % 8;
  const float* xs = reinterpret_cast<const float*>(smem + L.x) + 64 * w + 16 * q4 + 4 * g4;
  const auto ys = [&](int s) {
    return reinterpret_cast<const float*>(smem + s * L.stage + L.y) + 4 * t8;
  };
  unsigned char* a = smem + L.a + w * 2 * kWsAPart;
  // acc: the tile's products, sums: the running sums since the last flush
  // to out; entry 4 j + 2 r + e is row 64 w + 16 q4 + g + 8 r, column 8 j +
  // 2 t + e of the block's
  float sums[NA], acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) sums[i] = acc[i] = 0.0f;
  float v[4][4];
  const int r0 = row0 + 64 * w + 16 * q4 + g;
  // the thread's sums added to its entries of out (the first time written
  // there), and zeroed; out holds unscaled sums until the end
  const auto flush = [&](bool first) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + 8 * r, col = c0 + 8 * j + 2 * t + e;
          float& sum = sums[4 * j + 2 * r + e];
          if (row < n && col < k) {
            float* o = out + (size_t)row * k + col;
            *o = first ? sum : *o + sum;
          }
          sum = 0.0f;
        }
  };
  // the tile's values into A, visible to the group's products, which are
  // then issued into acc
  const auto issue = [&](int s) {
#if WIDE_WS_ABLATE & 1
    (void)s;
#pragma unroll
    for (int i = 0; i < 16; ++i) sums[0] += (&v[0][0])[i];
#else
    ws_store(v, a, 16 * q4 + 4 * g4, t8);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(w);
    ws_products<BN>(acc, a, smem + s * L.stage, L.part);
    fence_acc(acc);
#endif
  };

  mbar_wait(rows_full, 0);
  mbar_wait(&full[0], 0);
  ws_values<KIND>(v, xs, ys(0), d);
  issue(0);
  int s = 0;
  uint32_t ph = 0;
  for (int j = 1; j < nt; ++j) {
    const int sp = s;
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
    mbar_wait(&full[s], ph);
    ws_values<KIND>(v, xs, ys(s), d);
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < NA; ++i) sums[i] += acc[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[sp]);
    if (j % kWsFlush == 0) flush(j == kWsFlush);
    issue(s);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the last tile's products and the sums since the last flush, times c
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * r, col = c0 + 8 * j + 2 * t + e, i = 4 * j + 2 * r + e;
        if (row < n && col < k) {
          float* o = out + (size_t)row * k + col;
          const float sum = sums[i] + acc[i];
          *o = (float)((nt > kWsFlush ? *o + sum : sum) * c);
        }
      }
}

template <int KIND, int BN>
int launch_wide_ws(const float* XT1, const float* XT2, const float* VTh, const float* VTl,
                   float* out, int n, int m, int npad, int mpad, int d, int dpad, int k,
                   double c, cudaStream_t s) {
  const WsLayout L = ws_layout(BN, dpad);
  if (L.stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!f32_tensor_map_2d(&maps[0], XT1, dpad, npad, kWsRows, dpad) ||
      !f32_tensor_map_2d(&maps[1], XT2, dpad, mpad, kWsPts, dpad) ||
      !f32_tensor_map_2d(&maps[2], VTh, k, mpad, kWsPts, BN, true) ||
      !f32_tensor_map_2d(&maps[3], VTl, k, mpad, kWsPts, BN, true))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gram_wide_ws<KIND, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int nt = (m + kWsPts - 1) / kWsPts;
  const dim3 grid((n + kWsRows - 1) / kWsRows, (k + BN - 1) / BN);
  gram_wide_ws<KIND, BN><<<grid, kWsThreads, L.bytes, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                           out, n, k, d, dpad, nt, c);
  return (int)cudaGetLastError();
}

template <int KIND>
int wide_ws_by_bn(int bn, const float* XT1, const float* XT2, const float* VTh,
                  const float* VTl, float* out, int n, int m, int npad, int mpad, int d, int dpad,
                  int k, double c, cudaStream_t s) {
  if (bn == 168)
    return launch_wide_ws<KIND, 168>(XT1, XT2, VTh, VTl, out, n, m, npad, mpad, d, dpad, k, c, s);
  if (bn == 128)
    return launch_wide_ws<KIND, 128>(XT1, XT2, VTh, VTl, out, n, m, npad, mpad, d, dpad, k, c, s);
  return launch_wide_ws<KIND, 64>(XT1, XT2, VTh, VTl, out, n, m, npad, mpad, d, dpad, k, c, s);
}

}  // namespace

// K1 and K3 past 16 columns on the warpgroup form: out (n, k) = c * k(X1,
// X2) @ V for the family `kind` from the tile's operands XT1 (dpad, npad),
// XT2 (dpad, mpad) (as rl_gram_matmat_narrow; dpad <= 128) and V's TF32
// parts VTh, VTl, each (k, mpad) float32 (kernel_cuda.wide_ws_rhs); bn: 64,
// 128 or 168 output columns a block. Every pointer 16-byte aligned. Plain C
// interface, as gram.cu's.
extern "C" int rl_gram_matmat_wide_ws(int kind, const void* XT1, const void* XT2,
                                      const void* VTh, const void* VTl, void* out, int n, int m,
                                      int npad, int mpad, int d, int dpad, int k, int bn,
                                      double c, void* stream) {
  if (k < 1 || (bn != 64 && bn != 128 && bn != 168) || dpad > kWsMaxDepth ||
      !tile_operand_ok(n, npad, d, dpad) || !tile_operand_ok(m, mpad, d, dpad) ||
      ((uintptr_t)XT1 | (uintptr_t)XT2 | (uintptr_t)VTh | (uintptr_t)VTl) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(XT1);
  const float* B = static_cast<const float*>(XT2);
  const float* H = static_cast<const float*>(VTh);
  const float* Lo = static_cast<const float*>(VTl);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return wide_ws_by_bn<RBF>(bn, A, B, H, Lo, o, n, m, npad, mpad, d, dpad, k, c, s);
    case MATERN12:
      return wide_ws_by_bn<MATERN12>(bn, A, B, H, Lo, o, n, m, npad, mpad, d, dpad, k, c, s);
    case MATERN32:
      return wide_ws_by_bn<MATERN32>(bn, A, B, H, Lo, o, n, m, npad, mpad, d, dpad, k, c, s);
    case MATERN52:
      return wide_ws_by_bn<MATERN52>(bn, A, B, H, Lo, o, n, m, npad, mpad, d, dpad, k, c, s);
    case LAPLACE:
      return wide_ws_by_bn<LAPLACE>(bn, A, B, H, Lo, o, n, m, npad, mpad, d, dpad, k, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
