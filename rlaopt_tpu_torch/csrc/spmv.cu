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
// kernel_cuda.spmm_block_rows):
//   * k <= 16, narrow: the threads of a row stride over its nonzeros, each
//     keeping k sums in registers (KMAX = 1, 4 or 16 unrolled slots), then a
//     butterfly of warp shuffles adds them. Short rows (the forward CSR: 16
//     entries) take a warp each, eight rows to a block; long rows (the
//     adjoint CSR: ~16,384 entries over 1,024 rows) take a block of 256
//     threads each, so that 1,024 rows still fill 132 SMs, and the eight
//     warps' sums are added in a fixed order through shared memory.
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

template <typename T, int KMAX, bool BLOCK_ROW>
__global__ void __launch_bounds__(kThreads)
csr_spmm_narrow(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const T* __restrict__ values, const T* __restrict__ X, T* __restrict__ Y,
                int64_t n_rows, int k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = BLOCK_ROW ? (int64_t)blockIdx.x : (int64_t)blockIdx.x * kWarps + warp;
  // Whole warps (warp mode) or whole blocks (block mode) leave together.
  if (row >= n_rows) return;
  const int stride = BLOCK_ROW ? kThreads : 32;
  const int first = BLOCK_ROW ? (int)threadIdx.x : lane;

  T acc[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = T(0);
  const int64_t end = indptr[row + 1];
  for (int64_t e = indptr[row] + first; e < end; e += stride) {
    const T v = values[e];
    const T* x = X + (int64_t)indices[e] * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) acc[j] = mad(v, x[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = warp_sum(acc[j]);

  if constexpr (BLOCK_ROW) {
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

template <typename T, int KMAX>
void launch_narrow(const int64_t* indptr, const int32_t* indices, const T* values,
                   const T* X, T* Y, int64_t n_rows, int k, bool block_rows,
                   cudaStream_t s) {
  if (block_rows) {
    csr_spmm_narrow<T, KMAX, true><<<(unsigned)n_rows, kThreads, 0, s>>>(
        indptr, indices, values, X, Y, n_rows, k);
  } else {
    const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
    csr_spmm_narrow<T, KMAX, false><<<blocks, kThreads, 0, s>>>(
        indptr, indices, values, X, Y, n_rows, k);
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* values, const void* X,
           void* Y, int64_t n_rows, int k, bool block_rows, cudaStream_t s) {
  const int64_t* p = static_cast<const int64_t*>(indptr);
  const int32_t* c = static_cast<const int32_t*>(indices);
  const T* v = static_cast<const T*>(values);
  const T* x = static_cast<const T*>(X);
  T* y = static_cast<T*>(Y);
  const int64_t warp_blocks = (n_rows + kWarps - 1) / kWarps;
  if (k <= 16) {
    if ((block_rows ? n_rows : warp_blocks) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (k == 1) {
      launch_narrow<T, 1>(p, c, v, x, y, n_rows, k, block_rows, s);
    } else if (k <= 4) {
      launch_narrow<T, 4>(p, c, v, x, y, n_rows, k, block_rows, s);
    } else {
      launch_narrow<T, 16>(p, c, v, x, y, n_rows, k, block_rows, s);
    }
  } else {
    const int cpt = k <= 64 ? 1 : 4;
    const int64_t tiles = (k + 32 * cpt - 1) / (32 * cpt);
    if (warp_blocks > 0x7fffffffLL || tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)warp_blocks, (unsigned)tiles);
    if (cpt == 1) {
      csr_spmm_wide<T, 1><<<grid, kThreads, 0, s>>>(p, c, v, x, y, n_rows, k);
    } else {
      csr_spmm_wide<T, 4><<<grid, kThreads, 0, s>>>(p, c, v, x, y, n_rows, k);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronize, allocates nothing, and returns cudaGetLastError() (0 on
// success). dtype: 0 float, 1 double. Y = A @ X with A (n_rows, n_cols) in
// CSR, X (n_cols, k) and Y (n_rows, k) contiguous; k >= 1. block_rows != 0
// gives each row a block of 256 threads (k <= 16 only).
extern "C" int rl_csr_spmm(int dtype, const void* indptr, const void* indices,
                           const void* values, const void* X, void* Y, long long n_rows,
                           int k, int block_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  if (dtype == 0) return launch<float>(indptr, indices, values, X, Y, n_rows, k, block_rows != 0, s);
  if (dtype == 1) return launch<double>(indptr, indices, values, X, Y, n_rows, k, block_rows != 0, s);
  return (int)cudaErrorInvalidValue;
}
