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
// Design, chosen by k and the mean row length (the wrapper decides, see
// kernel_cuda.spmm_lanes, and passes the lanes per row):
//   * k <= 16, short rows (fewer than 256 entries on average): L lanes a
//     row, L a power of two from 2 to 32 taken from the mean row length
//     (about four entries a lane), 32 / L rows a warp. The first version
//     gave every row a whole warp: on path S's forward CSR (16 entries a
//     row) half of each warp idled, each warp had one 128-byte load in
//     flight, every lane read the row's indptr pair, and each sum paid five
//     shuffle rounds for one lane's store. It ran at 15.6% of its bound,
//     1.7x slower than cuSPARSE, bound by latency, not bytes. Now:
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
//   * k <= 16, long rows (the adjoint CSR: ~16,384 entries over 1,024
//     rows): a block of 256 threads a row, so that 1,024 rows still fill 132
//     SMs; the threads stride over the row, a warp butterfly adds each
//     warp's sums, and the eight warps' sums are added in a fixed order
//     through shared memory.
//   * k > 16, wide: a warp per (row, tile of 32 * CPT columns); the lanes
//     fetch 32 (index, value) pairs at a time and broadcast them by
//     shuffle, and each lane sums its CPT columns over the row in order.
//     Rows are the fastest grid axis, so the blocks in flight walk the same
//     column tiles and share X's rows in L2.
// Every sum runs in the operand's type in an order fixed by the shape and
// the schedule: two launches on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Short rows, k <= 16: L lanes a row, 32 / L rows a warp, warps walking row
// groups grid-stride (see the note at the top).
template <typename T, int KMAX, int L>
__global__ void __launch_bounds__(kThreads)
csr_spmm_lanes(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
               const T* __restrict__ values, const T* __restrict__ X, T* __restrict__ Y,
               int64_t n_rows, int64_t nnz, int k, bool vec) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, li = lane % L;
  const int head = lane & ~(L - 1);  // the lane that reads the row's indptr
  const int64_t groups = (n_rows + G - 1) / G;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // whole warps leave together: g is the same on every lane
  int64_t b0 = 0, b1 = 0;
  if (li == 0 && g < groups && g * G + sub < n_rows) {
    b0 = __ldg(indptr + g * G + sub);
    b1 = __ldg(indptr + g * G + sub + 1);
  }
  for (; g < groups; g += stride) {
    const int64_t row = g * G + sub;
    const int64_t start = __shfl_sync(kFull, b0, head);
    const int64_t end = __shfl_sync(kFull, b1, head);
    // the next group's indptr pair, in flight while this group is summed
    const int64_t next = (g + stride) * G + sub;
    b0 = b1 = 0;
    if (li == 0 && g + stride < groups && next < n_rows) {
      b0 = __ldg(indptr + next);
      b1 = __ldg(indptr + next + 1);
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
    if (row < n_rows) {
      T* y = Y + row * k;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k && j % L == li) y[j] = acc[j];
    }
  }
}

// Long rows, k <= 16: a block of 256 threads a row.
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads)
csr_spmm_block_row(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                   const T* __restrict__ values, const T* __restrict__ X, T* __restrict__ Y,
                   int64_t n_rows, int k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;

  T acc[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
  const int64_t end = indptr[row + 1];
  for (int64_t e = indptr[row] + threadIdx.x; e < end; e += kThreads) {
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

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
csr_spmm_wide(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
              const T* __restrict__ values, const T* __restrict__ X, T* __restrict__ Y,
              int64_t n_rows, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int64_t col0 = (int64_t)blockIdx.y * (32 * CPT) + lane;

  T acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = T(0);
  const int64_t start = indptr[row], end = indptr[row + 1];
  for (int64_t base = start; base < end; base += 32) {
    int32_t c_lane = 0;
    T v_lane = T(0);
    if (base + lane < end) {
      c_lane = indices[base + lane];
      v_lane = values[base + lane];
    }
    const int count = end - base < 32 ? (int)(end - base) : 32;
#pragma unroll 4
    for (int t = 0; t < count; ++t) {
      const int32_t c = __shfl_sync(kFull, c_lane, t);
      const T v = __shfl_sync(kFull, v_lane, t);
      const T* x = X + (int64_t)c * k;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int64_t col = col0 + 32 * j;
        if (col < k) acc[j] = mad(v, x[col], acc[j]);
      }
    }
  }
  T* y = Y + row * k;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int64_t col = col0 + 32 * j;
    if (col < k) y[col] = acc[j];
  }
}

constexpr int kBlockRow = 256;  // lanes value of the block-a-row schedule

template <typename T, int KMAX, int L>
void launch_lanes(const int64_t* indptr, const int32_t* indices, const T* values,
                  const T* X, T* Y, int64_t n_rows, int64_t nnz, int k, cudaStream_t s) {
  // as many blocks as the card holds at once, so that every warp walks an
  // equal share of the row groups in one wave
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
  int64_t blocks = (groups + kWarps - 1) / kWarps;
  if (blocks > (int64_t)per_sm * sms) blocks = (int64_t)per_sm * sms;
  const bool vec = (reinterpret_cast<uintptr_t>(indices) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(values) % 16 == 0);
  csr_spmm_lanes<T, KMAX, L><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, indices, values, X, Y, n_rows, nnz, k, vec);
}

template <typename T, int KMAX>
int launch_narrow(const int64_t* indptr, const int32_t* indices, const T* values,
                  const T* X, T* Y, int64_t n_rows, int64_t nnz, int k, int lanes,
                  cudaStream_t s) {
  switch (lanes) {
    case kBlockRow:
      if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      csr_spmm_block_row<T, KMAX><<<(unsigned)n_rows, kThreads, 0, s>>>(
          indptr, indices, values, X, Y, n_rows, k);
      break;
    case 2: launch_lanes<T, KMAX, 2>(indptr, indices, values, X, Y, n_rows, nnz, k, s); break;
    case 4: launch_lanes<T, KMAX, 4>(indptr, indices, values, X, Y, n_rows, nnz, k, s); break;
    case 8: launch_lanes<T, KMAX, 8>(indptr, indices, values, X, Y, n_rows, nnz, k, s); break;
    case 16: launch_lanes<T, KMAX, 16>(indptr, indices, values, X, Y, n_rows, nnz, k, s); break;
    case 32: launch_lanes<T, KMAX, 32>(indptr, indices, values, X, Y, n_rows, nnz, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* values, const void* X,
           void* Y, int64_t n_rows, int64_t nnz, int k, int lanes, cudaStream_t s) {
  const int64_t* p = static_cast<const int64_t*>(indptr);
  const int32_t* c = static_cast<const int32_t*>(indices);
  const T* v = static_cast<const T*>(values);
  const T* x = static_cast<const T*>(X);
  T* y = static_cast<T*>(Y);
  if (k <= 16) {
    if (k == 1) return launch_narrow<T, 1>(p, c, v, x, y, n_rows, nnz, k, lanes, s);
    if (k <= 4) return launch_narrow<T, 4>(p, c, v, x, y, n_rows, nnz, k, lanes, s);
    return launch_narrow<T, 16>(p, c, v, x, y, n_rows, nnz, k, lanes, s);
  }
  const int cpt = k <= 64 ? 1 : 4;
  const int64_t tiles = (k + 32 * cpt - 1) / (32 * cpt);
  const int64_t warp_blocks = (n_rows + kWarps - 1) / kWarps;
  if (warp_blocks > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)warp_blocks, (unsigned)tiles);
  if (cpt == 1) {
    csr_spmm_wide<T, 1><<<grid, kThreads, 0, s>>>(p, c, v, x, y, n_rows, k);
  } else {
    csr_spmm_wide<T, 4><<<grid, kThreads, 0, s>>>(p, c, v, x, y, n_rows, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronize, allocates nothing, and returns cudaGetLastError() (0 on
// success). dtype: 0 float, 1 double. Y = A @ X with A (n_rows, n_cols) in
// CSR with nnz entries, X (n_cols, k) and Y (n_rows, k) contiguous; k >= 1.
// lanes (k <= 16 only): 2, 4, 8, 16 or 32 lanes a row, or 256 for a block
// of 256 threads a row; past k = 16 it is not read.
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
