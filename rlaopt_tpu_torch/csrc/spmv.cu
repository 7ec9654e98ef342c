// CSR sparse-dense products for Hopper (sm_90a): y = A @ x and Y = A @ X.
//
//   csr_spmv / csr_spmm   replace rlaopt_tpu/sparse/laned.py :: laned_matvec
//                         (and laned_matmat, which maps it over columns)
//
// A is CSR: indptr (n_rows + 1) int64, indices (nnz) int32 column numbers,
// values (nnz) float or double. X is row-major (n_cols, k) of the values'
// type, Y row-major (n_rows, k). Rows may repeat a column: such entries are
// summed like any other. An empty row gives 0.
//
// The TPU kernel re-laid A out host-side so that every entry sat in the
// lane of its column, because Mosaic's only vector gather cannot cross
// lanes (laned.py:3-45), and it was capped at n_cols <= 1024. The H100
// gathers in hardware, so A stays CSR and nothing is re-laid out. Both
// directions of a sparse operator run through this kernel: the caller keeps
// the CSR of A for A @ x and the CSR of A^T, built once, for A^T @ y, so
// every apply is a gather with no scatter and no atomics.
//
// What bounds it on the H100: bytes. Each nonzero is read once (4 bytes of
// index, 4 or 8 of value) and costs k FMAs; X and Y are read and written
// once at the least, so the bound is (nnz (4 + s) + 8 n_rows + s k (n_cols +
// n_rows)) / 3.35 TB/s with s the value size. The re-reads of X by the
// gather are the kernel's cost, not the bound's: they hit L2 when X is small
// (the SpMV's x is 4 KB or 4 MB here) and cost DRAM traffic when it is not
// (the sketch's X^T is 17 GB).
//
// The schedule is chosen by the wrapper (kernel_cuda._csr_launch) from k
// and the operand's plan (kernel_cuda.csr_plan: the row lengths read once
// per CSR, and the segments of the rows longer than its segment length S).
// A schedule's unit is a row, or a segment of a long row: the entries
// [lo[u], hi[u]) (for the rows of a CSR, lo = indptr and hi = indptr + 1).
//   * k <= 16, short rows: L lanes a row, L a power of two from 2 to 32
//     taken from the mean row length (about four entries a lane), 32 / L
//     rows a warp. The first version gave every row a whole warp: on path
//     S's forward CSR (16 entries a row) half of each warp idled, each warp
//     had one 128-byte load in flight, every lane read the row's indptr
//     pair, and each sum paid five shuffle rounds for one lane's store. It
//     ran at 15.6% of its bound, 1.7x slower than cuSPARSE, bound by
//     latency, not bytes. Now:
//       - the entries are walked in aligned chunks of four: a lane loads a
//         chunk's indices as one 16-byte load and its values as one (float)
//         or two (double) 16-byte loads, through the read-only path, and
//         masks the entries outside its row; where the buffers are not
//         16-byte aligned, or at the arrays' last partial chunk, the same
//         chunk is read entry by entry, in the same order;
//       - one lane reads a row's indptr pair and shares it by shuffle, and
//         the next row group's pair is loaded before the current group's
//         entries are summed, so its latency hides behind them;
//       - a warp walks row groups grid-stride, with as many blocks as the
//         card holds at once (one wave), so each SM keeps many independent
//         chunk loads in flight and no block waits for a second wave;
//       - the L partial sums of a row are added by a butterfly of log2 L
//         shuffles inside the row's lanes, and the lanes of a row store its
//         k sums, one column each.
//     x is gathered through the read-only path; at path S's 1,024 columns
//     it is 4 KB and stays in L1 and L2 (staging it in shared memory is not
//     measured).
//   * k <= 16, long rows of about one length (the adjoint CSR of path S:
//     1,024 rows of ~16,384 entries): a block of 256 threads a row, so that
//     1,024 rows still fill 132 SMs in one wave; the threads stride over
//     the row, a warp butterfly adds each warp's sums, and the eight warps'
//     sums are added in a fixed order through shared memory.
//   * k > 16, wide: a warp per (unit, tile of 32 * CPT columns); the lanes
//     fetch 32 (index, value) pairs at a time and broadcast them by
//     shuffle, and each lane sums its CPT columns over the unit in order.
//     Units are the fastest grid axis, so the blocks in flight walk the
//     same column tiles and share X's rows in L2.
//   * segmented, at any k: rows of more than S entries (the plan's
//     segment, 256) where the rows' lengths differ (the mean under 256
//     entries or the longest more than twice it). Before, a long row was
//     one warp's (or one block's) serial walk: 320 rows of 0 to 20,000
//     entries at k = 300 made 960 warps, fewer than 8 an SM, and the 120
//     warps of the 20,000-entry rows each took 20,000 dependent steps while
//     the rest of the card idled (3.82 ms, 19.6x cuSPARSE's time; NVIDIA
//     H100 80GB HBM3 at 700 W). Now
//       - each long row is cut into segments of S entries (the last one
//         shorter), each segment a unit of the schedule of its k: a warp of
//         the short-row kernel up to 16 columns; past 16 a warp per tile of
//         32 columns that gathers the X rows of 8 entries before it adds
//         them, so that a segment's loads overlap 8 at a time;
//         its sums go to part[segment] (a partial buffer the wrapper
//         allocates and caps by taking the columns in chunks);
//       - the short rows take the schedule of their k (their lanes from
//         their own mean length) in the same launch as the segments, and
//         skip every row of more than S entries;
//       - a second launch adds each long row's partials in segment order
//         and writes its row of Y. No float atomics: two launches on the
//         same inputs give the same bits.
//     Past 16 columns the segments launch in the order (index in the row,
//     row), so that the blocks in flight walk the same window of X's rows
//     where the rows keep one order of their columns. Rows of about one
//     length stay whole at any k: they fill the card with no tail, and the
//     sketch's transposed CSR (1,024 rows of ~16,384, k = 4,096), whose
//     segments were to share Omega^T's windows in L2, took 63-68 ms in
//     segments of 128 to 2,048 against 42.5 whole (chip_smoke.py, NVIDIA
//     H100 80GB HBM3 at 700 W). It is bound by the bytes the gathers bring
//     from L2 to the SMs, nnz k 4 = 275 GB (6.7 TB/s at 40.8 ms), not by
//     its 17 GB from DRAM: every entry gathers 16 KB of its X row, and the
//     16 entries that gather one row of Omega^T lie in 16 different rows
//     of A^T, on 16 different warps.
// Every sum runs in the operand's type in an order fixed by the shape, the
// plan and the schedule: two launches on the same inputs give the same
// bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kAll = 0x7fffffffffffffffLL;  // skip: no unit is too long

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

// Every lane ends with the sum of the warp's 32 values (each lane in its
// own fixed order).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Four entries of an aligned chunk: their column numbers and values.
template <typename T>
struct Chunk {
  int32_t c[4];
  T v[4];
};

__device__ __forceinline__ void load_values(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_values(const double* p, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// The chunk of entries [e0, e0 + 4) (e0 a multiple of 4): by 16-byte loads
// when `vec` (both buffers 16-byte aligned) and the chunk lies inside the
// arrays, else entry by entry (entries past nnz read as column 0, value 0).
template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const int32_t* __restrict__ indices,
                                               const T* __restrict__ values, int64_t e0,
                                               int64_t nnz, bool vec) {
  Chunk<T> ch;
  if (vec && e0 + 4 <= nnz) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(indices + e0));
    ch.c[0] = c.x; ch.c[1] = c.y; ch.c[2] = c.z; ch.c[3] = c.w;
    load_values(values + e0, ch.v);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = e0 + u < nnz;
      ch.c[u] = in ? __ldg(indices + e0 + u) : 0;
      ch.v[u] = in ? __ldg(values + e0 + u) : T(0);
    }
  }
  return ch;
}

// k <= 16: L lanes a unit, 32 / L units a warp, the warps of the grid
// walking the unit groups grid-stride (see the note at the top): the units
// [lo[u], hi[u]) for u < n_units, unit u's sums into Y + u k. A unit of
// more than `skip` entries is neither summed nor written.
template <typename T, int KMAX, int L>
__device__ __forceinline__ void lanes_walk(const int64_t* __restrict__ lo,
                                           const int64_t* __restrict__ hi,
                                           const int32_t* __restrict__ indices,
                                           const T* __restrict__ values,
                                           const T* __restrict__ X, T* __restrict__ Y,
                                           int64_t n_units, int64_t nnz, int k, int64_t skip,
                                           bool vec) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, li = lane % L;
  const int head = lane & ~(L - 1);  // the lane that reads the unit's bounds
  const int64_t groups = (n_units + G - 1) / G;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // whole warps leave together: g is the same on every lane
  int64_t b0 = 0, b1 = 0;
  if (li == 0 && g < groups && g * G + sub < n_units) {
    b0 = __ldg(lo + g * G + sub);
    b1 = __ldg(hi + g * G + sub);
  }
  for (; g < groups; g += stride) {
    const int64_t row = g * G + sub;
    const int64_t start = __shfl_sync(kFull, b0, head);
    int64_t end = __shfl_sync(kFull, b1, head);
    const bool mine = end - start <= skip;  // a longer row is the segments'
    if (!mine) end = start;
    // the next group's bounds, in flight while this group is summed
    const int64_t next = (g + stride) * G + sub;
    b0 = b1 = 0;
    if (li == 0 && g + stride < groups && next < n_units) {
      b0 = __ldg(lo + next);
      b1 = __ldg(hi + next);
    }
    T acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
    for (int64_t e0 = ((start >> 2) + li) << 2; e0 < end; e0 += 4 * L) {
      const Chunk<T> ch = load_chunk(indices, values, e0, nnz, vec);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e0 + u >= start && e0 + u < end) {
          const T* x = X + (int64_t)ch.c[u] * k;
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j < k) acc[j] = mad(ch.v[u], __ldg(x + j), acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    }
    if (row < n_units && mine) {
      T* y = Y + row * k;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k && j % L == li) y[j] = acc[j];
    }
  }
}

// k <= 16, in one launch: the rows on L lanes each (rows of more than
// `skip` entries left alone), then the n_segs segments of the long rows on
// a warp each, their sums into part (n_segs x k).
template <typename T, int KMAX, int L>
__global__ void __launch_bounds__(kThreads)
csr_spmm_lanes(const int64_t* __restrict__ indptr, const int64_t* __restrict__ seg_lo,
               const int64_t* __restrict__ seg_hi, const int32_t* __restrict__ indices,
               const T* __restrict__ values, const T* __restrict__ X, T* __restrict__ Y,
               T* __restrict__ part, int64_t n_rows, int64_t n_segs, int64_t nnz, int k,
               int64_t skip, bool vec) {
  lanes_walk<T, KMAX, L>(indptr, indptr + 1, indices, values, X, Y, n_rows, nnz, k, skip, vec);
  if (n_segs > 0)
    lanes_walk<T, KMAX, 32>(seg_lo, seg_hi, indices, values, X, part, n_segs, nnz, k, kAll, vec);
}

// Long rows of about one length, k <= 16: a block of 256 threads a row
// (rows of more than `skip` entries are left alone).
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
csr_spmm_block_row(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                   const T* __restrict__ values, const T* __restrict__ X, T* __restrict__ Y,
                   int64_t n_rows, int k, int64_t skip) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  const int64_t start = indptr[row], end = indptr[row + 1];
  if (end - start > skip) return;  // the whole block: before any barrier

  T acc[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
  for (int64_t e = start + threadIdx.x; e < end; e += kThreads) {
    const T v = values[e];
    const T* x = X + (int64_t)indices[e] * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) acc[j] = mad(v, x[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = warp_sum(acc[j]);

  __shared__ T part[kWarps][KMAX];
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) part[warp][j] = acc[j];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    T s = part[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][j];
    acc[j] = s;
  }
  T* y = Y + row * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k && lane == j) y[j] = acc[j];
}

// Past k = 16: a warp per (unit, tile of 32 CPT of the kc columns). Units
// q < n_rows are the rows (rows of more than `skip` entries left alone),
// their sums into Y + q ldy; the next n_segs units are the segments of the
// long rows in `order` (the launch order), segment u's sums into part + u
// kc. X's rows are ldx apart. With U > 1 the lanes gather the X rows of U
// entries at a time before they add them (in entry order), so that a warp
// has U rows in flight: one at a time, a segment's entries wait out a whole
// load each. Where every row is whole (U = 1) the loop stays as it was: the
// sketch's 32,768 warps are bound by the bytes the gathers bring from L2,
// and the batched loop's registers would cost it warps.
template <typename T, int CPT, int U>
__global__ void __launch_bounds__(kThreads)
csr_spmm_wide(const int64_t* __restrict__ indptr, const int64_t* __restrict__ seg_lo,
              const int64_t* __restrict__ seg_hi, const int32_t* __restrict__ order,
              const int32_t* __restrict__ indices, const T* __restrict__ values,
              const T* __restrict__ X, T* __restrict__ Y, T* __restrict__ part,
              int64_t n_rows, int64_t n_segs, int kc, int64_t ldx, int64_t ldy, int64_t skip) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int64_t start, end;
  T* y;
  if (q < n_rows) {
    start = indptr[q];
    end = indptr[q + 1];
    if (end - start > skip) return;
    y = Y + q * ldy;
  } else {
    if (q - n_rows >= n_segs) return;
    const int64_t u = order[q - n_rows];
    start = seg_lo[u];
    end = seg_hi[u];
    y = part + u * kc;
  }
  const int64_t col0 = (int64_t)blockIdx.y * (32 * CPT) + lane;

  T acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = T(0);
  for (int64_t base = start; base < end; base += 32) {
    int32_t c_lane = 0;
    T v_lane = T(0);
    if (base + lane < end) {
      c_lane = indices[base + lane];
      v_lane = values[base + lane];
    }
    const int count = end - base < 32 ? (int)(end - base) : 32;
    if constexpr (U == 1) {
#pragma unroll 4
      for (int t = 0; t < count; ++t) {
        const int32_t c = __shfl_sync(kFull, c_lane, t);
        const T v = __shfl_sync(kFull, v_lane, t);
        const T* x = X + (int64_t)c * ldx;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int64_t col = col0 + 32 * j;
          if (col < kc) acc[j] = mad(v, x[col], acc[j]);
        }
      }
    } else {
      for (int t0 = 0; t0 < count; t0 += U) {
        T xv[U][CPT], vv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int32_t c = __shfl_sync(kFull, c_lane, t0 + u);
          vv[u] = __shfl_sync(kFull, v_lane, t0 + u);
          const T* x = X + (int64_t)c * ldx;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int64_t col = col0 + 32 * j;
            xv[u][j] = t0 + u < count && col < kc ? __ldg(x + col) : T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t0 + u < count) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[j] = mad(vv[u], xv[u][j], acc[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int64_t col = col0 + 32 * j;
    if (col < kc) y[col] = acc[j];
  }
}

// The segmented schedule's second launch: row rows[i] of Y (its kc
// columns, ldy apart) is the sum of the long row i's partials part[first[i]]
// .. part[first[i + 1] - 1] (kc columns each), added in segment order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmm_sum_segments(const T* __restrict__ part, const int64_t* __restrict__ first,
                      const int32_t* __restrict__ rows, T* __restrict__ Y, int64_t n_long,
                      int kc, int64_t ldy) {
  const int64_t total = n_long * kc;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t i = e / kc;
    const int c = (int)(e - i * kc);
    const int64_t g0 = first[i], g1 = first[i + 1];
    T s = part[g0 * kc + c];
    for (int64_t g = g0 + 1; g < g1; ++g) s += part[g * kc + c];
    Y[(int64_t)rows[i] * ldy + c] = s;
  }
}

constexpr int kBlockRow = 256;  // lanes value of the block-a-row schedule

// The segments' arguments of a launch (none where every row is whole).
template <typename T>
struct Segs {
  const int64_t* lo = nullptr;
  const int64_t* hi = nullptr;
  const int32_t* order = nullptr;
  T* part = nullptr;
  int64_t n = 0;
};

template <typename T, int KMAX, int L>
void launch_lanes(const int64_t* indptr, const int32_t* indices, const T* values, const T* X,
                  T* Y, const Segs<T>& sg, int64_t n_rows, int64_t nnz, int k, int64_t skip,
                  cudaStream_t s) {
  // as many blocks as the card holds at once, so that every warp walks an
  // equal share of the unit groups in one wave
  static int per_sm = 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm == 0) {
    int fit = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, csr_spmm_lanes<T, KMAX, L>, kThreads, 0);
    per_sm = fit > 0 ? fit : 1;
  }
  const int64_t groups = (n_rows + 32 / L - 1) / (32 / L);
  const int64_t most = groups > sg.n ? groups : sg.n;
  int64_t blocks = (most + kWarps - 1) / kWarps;
  if (blocks > (int64_t)per_sm * sms) blocks = (int64_t)per_sm * sms;
  if (blocks < 1) blocks = 1;
  const bool vec = (reinterpret_cast<uintptr_t>(indices) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(values) % 16 == 0);
  csr_spmm_lanes<T, KMAX, L><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, sg.lo, sg.hi, indices, values, X, Y, sg.part, n_rows, sg.n, nnz, k, skip, vec);
}

// k <= 16 at the smallest KMAX that holds k: the rows (lanes a row, or a
// block of 256 a row) and, in the lanes kernel, the segments.
template <typename T, int KMAX>
int launch_narrow(const int64_t* indptr, const int32_t* indices, const T* values, const T* X,
                  T* Y, const Segs<T>& sg, int64_t n_rows, int64_t nnz, int k, int lanes,
                  int64_t skip, cudaStream_t s) {
  switch (lanes) {
    case kBlockRow:
      if (n_rows > 0x7fffffffLL || sg.n > 0) return (int)cudaErrorInvalidValue;
      csr_spmm_block_row<T, KMAX><<<(unsigned)n_rows, kThreads, 0, s>>>(
          indptr, indices, values, X, Y, n_rows, k, skip);
      break;
    case 2: launch_lanes<T, KMAX, 2>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, skip, s); break;
    case 4: launch_lanes<T, KMAX, 4>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, skip, s); break;
    case 8: launch_lanes<T, KMAX, 8>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, skip, s); break;
    case 16: launch_lanes<T, KMAX, 16>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, skip, s); break;
    case 32: launch_lanes<T, KMAX, 32>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, skip, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_narrow_k(const int64_t* indptr, const int32_t* indices, const T* values, const T* X,
                    T* Y, const Segs<T>& sg, int64_t n_rows, int64_t nnz, int k, int lanes,
                    int64_t skip, cudaStream_t s) {
  if (k == 1) return launch_narrow<T, 1>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, lanes, skip, s);
  if (k <= 4) return launch_narrow<T, 4>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, lanes, skip, s);
  return launch_narrow<T, 16>(indptr, indices, values, X, Y, sg, n_rows, nnz, k, lanes, skip, s);
}

// Past 16 columns: every row whole on tiles of 32 (kc <= 64) or 128
// columns a warp, one entry at a time; with segments, tiles of 32 columns
// and 8 entries at a time (the 32-column tile's rows of X, 128 bytes each,
// are a smaller set for L1 to hold across the warps of an SM).
template <typename T>
int launch_wide(const int64_t* indptr, const int32_t* indices, const T* values, const T* X,
                T* Y, const Segs<T>& sg, int64_t n_rows, int kc, int64_t ldx, int64_t ldy,
                int64_t skip, cudaStream_t s) {
  const int cpt = sg.n > 0 || kc <= 64 ? 1 : 4;
  const int64_t tiles = (kc + 32 * cpt - 1) / (32 * cpt);
  const int64_t warp_blocks = (n_rows + sg.n + kWarps - 1) / kWarps;
  if (warp_blocks > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)warp_blocks, (unsigned)tiles);
  if (sg.n > 0) {
    csr_spmm_wide<T, 1, 8><<<grid, kThreads, 0, s>>>(indptr, sg.lo, sg.hi, sg.order, indices,
                                                     values, X, Y, sg.part, n_rows, sg.n, kc,
                                                     ldx, ldy, skip);
  } else if (cpt == 1) {
    csr_spmm_wide<T, 1, 1><<<grid, kThreads, 0, s>>>(indptr, sg.lo, sg.hi, sg.order, indices,
                                                     values, X, Y, sg.part, n_rows, sg.n, kc,
                                                     ldx, ldy, skip);
  } else {
    csr_spmm_wide<T, 4, 1><<<grid, kThreads, 0, s>>>(indptr, sg.lo, sg.hi, sg.order, indices,
                                                     values, X, Y, sg.part, n_rows, sg.n, kc,
                                                     ldx, ldy, skip);
  }
  return (int)cudaGetLastError();
}

// Every row whole, in the schedule of its k.
template <typename T>
int launch(const void* indptr, const void* indices, const void* values, const void* X,
           void* Y, int64_t n_rows, int64_t nnz, int k, int lanes, cudaStream_t s) {
  const int64_t* p = static_cast<const int64_t*>(indptr);
  const int32_t* c = static_cast<const int32_t*>(indices);
  const T* v = static_cast<const T*>(values);
  const T* x = static_cast<const T*>(X);
  T* y = static_cast<T*>(Y);
  const Segs<T> none;
  if (k <= 16) return launch_narrow_k<T>(p, c, v, x, y, none, n_rows, nnz, k, lanes, kAll, s);
  return launch_wide<T>(p, c, v, x, y, none, n_rows, k, k, k, kAll, s);
}

// The segmented schedule: per chunk of columns (all k up to 16 columns)
// one launch of the short rows and the segments together (the short rows
// on a block each first, where their lanes value is 256), then the sums of
// the segments into Y.
template <typename T>
int launch_segmented(const void* indptr, const void* indices, const void* values,
                     const void* X, void* Y, void* part, const void* seg_lo,
                     const void* seg_hi, const void* seg_order, const void* first,
                     const void* rows, int64_t n_rows, int64_t nnz, int64_t n_long,
                     int64_t n_segs, int64_t segment, int k, int lanes, int chunk,
                     cudaStream_t s) {
  const int64_t* p = static_cast<const int64_t*>(indptr);
  const int32_t* c = static_cast<const int32_t*>(indices);
  const T* v = static_cast<const T*>(values);
  const T* x = static_cast<const T*>(X);
  T* y = static_cast<T*>(Y);
  Segs<T> sg;
  sg.lo = static_cast<const int64_t*>(seg_lo);
  sg.hi = static_cast<const int64_t*>(seg_hi);
  sg.order = static_cast<const int32_t*>(seg_order);
  sg.part = static_cast<T*>(part);
  sg.n = n_segs;
  const int64_t* fst = static_cast<const int64_t*>(first);
  const int32_t* rws = static_cast<const int32_t*>(rows);
  // rows of at most `segment` entries are the short ones'; all rows long:
  // no short-row units
  const int64_t n_short = n_rows > n_long ? n_rows : 0;
  int err = 0;
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int kc = k - c0 < chunk ? k - c0 : chunk;
    if (k > 16) {
      err = launch_wide<T>(p, c, v, x + c0, y + c0, sg, n_short, kc, k, k, segment, s);
    } else if (lanes == kBlockRow) {
      const Segs<T> none;
      err = n_short ? launch_narrow_k<T>(p, c, v, x, y, none, n_short, nnz, k, lanes, segment, s) : 0;
      if (err == 0) err = launch_narrow_k<T>(p, c, v, x, y, sg, 0, nnz, k, 32, segment, s);
    } else {
      err = launch_narrow_k<T>(p, c, v, x, y, sg, n_short, nnz, k, lanes, segment, s);
    }
    if (err != 0) return err;
    int64_t blocks = (n_long * kc + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    csr_spmm_sum_segments<T><<<(unsigned)blocks, kThreads, 0, s>>>(sg.part, fst, rws, y + c0,
                                                                   n_long, kc, k);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronize, allocates nothing, and returns cudaGetLastError() (0 on
// success). dtype: 0 float, 1 double. Y = A @ X with A (n_rows, n_cols) in
// CSR with nnz entries, X (n_cols, k) and Y (n_rows, k) contiguous; k >= 1.
// lanes (k <= 16 only): 2, 4, 8, 16 or 32 lanes a row, or 256 for a block
// of 256 threads a row; past k = 16 it is not read. Every row is whole.
extern "C" int rl_csr_spmm(int dtype, const void* indptr, const void* indices,
                           const void* values, const void* X, void* Y, long long n_rows,
                           long long nnz, int k, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || n_rows < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  if (dtype == 0) return launch<float>(indptr, indices, values, X, Y, n_rows, nnz, k, lanes, s);
  if (dtype == 1) return launch<double>(indptr, indices, values, X, Y, n_rows, nnz, k, lanes, s);
  return (int)cudaErrorInvalidValue;
}

// The segmented schedule, the same product. The rows of more than
// `segment` entries (n_long of them, holding n_segs segments) are the
// plan's (kernel_cuda.csr_plan): rows (n_long) int32 their numbers, first
// (n_long + 1) int64 the range of each one's segments, seg_lo and seg_hi
// (n_segs) int64 each segment's entries, seg_order (n_segs) int32 the
// segments' launch order past k = 16. part: n_segs * chunk values of
// scratch. lanes: the short rows' lanes (k <= 16); chunk: the columns a
// segment launch takes (k itself up to 16 columns).
extern "C" int rl_csr_spmm_segmented(int dtype, const void* indptr, const void* indices,
                                     const void* values, const void* X, void* Y, void* part,
                                     const void* seg_lo, const void* seg_hi,
                                     const void* seg_order, const void* first,
                                     const void* rows, long long n_rows, long long nnz,
                                     long long n_long, long long n_segs, long long segment,
                                     int k, int lanes, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || n_rows < 1 || nnz < 0 || n_long < 1 || n_long > n_rows || n_segs < n_long ||
      n_segs > 0x7fffffffLL || segment < 1 || chunk < 1 || (k <= 16 && chunk != k))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_segmented<float>(indptr, indices, values, X, Y, part, seg_lo, seg_hi,
                                   seg_order, first, rows, n_rows, nnz, n_long, n_segs,
                                   segment, k, lanes, chunk, s);
  if (dtype == 1)
    return launch_segmented<double>(indptr, indices, values, X, Y, part, seg_lo, seg_hi,
                                    seg_order, first, rows, n_rows, nnz, n_long, n_segs,
                                    segment, k, lanes, chunk, s);
  return (int)cudaErrorInvalidValue;
}
