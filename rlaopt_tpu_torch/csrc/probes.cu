// The ceiling probes, for Hopper (sm_90a): the TPU's on-chip probes of
// bench.py and benchmarks/, computed on operands held in registers and
// shared memory, so that a timing reads the card's rate for the op mix and
// not its memory.
//
//   #10 probe_l1<float>       replaces bench.py :: make_vpu_peak (the
//                             pallas_call of :189): the L1 matrix of X
//                             against Y summed over nb feature blocks,
//                             acc += |x - y|, the inner step of K3, K3c, K5
//                             and K6 (and at its other tile shapes
//                             benchmarks/vpu_probe_study.py ::
//                             probe_pallas_bcast, #12)
//   #12 probe_chain<ELEM>     replaces vpu_probe_study.py :: probe_pallas_elem
//                             (:130): acc = |acc - x| + y, 64 times
//   #13 probe_chain<EXP_CHAIN> replaces benchmarks/exp_probe_study.py ::
//                             probe (:124): acc = exp(-|acc - x|), 64 times
//   #11 probe_chain<EXP_SUM>, probe_chain<EPILOGUE_SUM> replace bench.py ::
//                             _make_vmem_chain_probe (:246) with the steps
//                             of make_exp_peak, exp(-c x), and of
//                             make_epilogue_bound, exp(x - y - c) y: 64
//                             independent reps summed, c = 0.25 + 0.01 r
//
// What bounds them: the FP32 pipes (#10, #12: two FADDs a pair, the
// absolute value an operand modifier; 128 a clock per SM go out as one warp
// instruction a clock per sub-partition, so every other instruction takes
// a FADD's slot) and the SFU (#11, #13: one MUFU.EX2 an exp, 16 a clock per
// SM). The exp is __expf (an FMUL by log2 e and MUFU.EX2), as in K3's tile
// (gram_tile.cuh). #12's elementwise chain reads and writes 12 bytes an
// element for 128 FADDs, about as long in bytes as in FADDs on this card;
// the TPU held its tiles in VMEM the same way. #13's 64 exps an element
// keep it on the SFU.
//
// Design:
//   * probe_l1 holds its operand block resident, as the TPU body holds its
//     (tm, 64) and (64, tn) blocks in VMEM: a 128 x 128 block of the
//     output, 256 threads, one block an SM, an 8 x 8 register tile a thread
//     (rows 16 w + (lane >> 4) + 2 i of warp w, columns 4 (lane & 15) + j
//     and 64 + 4 (lane & 15) + j). Each stage is a whole feature block of
//     64 (float; 32 for double): X's rows as they lie in memory and Y's
//     columns, both copied by 16-byte cp.async (every request coalesced,
//     16 a thread a stage), two buffers, the next stage in flight while
//     this one is summed, one barrier a stage. A thread reads X's rows 16
//     bytes along the features (4 features of a row in one float4; the rows
//     padded by 16 bytes so that a warp's two rows fall in other banks) and
//     Y's columns as float4, then adds 8 x 8 pairs a feature. The sums stay
//     in registers across the nb feature blocks, as the TPU body keeps them
//     in a VMEM scratch, and add feature after feature in the plain
//     version's order. It does not share K3's staging (gram_tile.cuh
//     stages 32 features at a time and transposes X element by element),
//     so its rate is the card's for the pair, against which K3's tile is
//     read. T = double is the FP64 ceiling of the float64 tiles (K3c, K1c's
//     triangle), 8 x 8 doubles a thread, 2 features a read, stages of 32.
//     The TPU's one core runs a grid step after another; 132 SMs need many
//     blocks, so the timing launches B independent instances in one grid
//     (blockIdx.z), as the TPU's chain of calls repeats its one instance.
//   * probe_chain: each thread walks four elements a grid stride apart, so
//     four independent chains hide the pipes' latency; 64 reps unrolled,
//     the rep constants folded at compile time.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kPTile = 128;     // output rows and columns of a probe_l1 block
constexpr int kPThreads = 256;
constexpr int kReps = 64;         // the TPU probes' reps

enum ChainMode { ELEM = 0, EXP_CHAIN = 1, EXP_SUM = 2, EPILOGUE_SUM = 3 };

__device__ __forceinline__ float absdiff(float a, float b) { return fabsf(a - b); }
__device__ __forceinline__ double absdiff(double a, double b) { return fabs(a - b); }

// A stage's features (fb is a multiple of it) and the features of one
// 16-byte read of an X row.
template <typename T> struct L1Shape;
template <> struct L1Shape<float> { static constexpr int kFeat = 64, kStep = 4; };
template <> struct L1Shape<double> { static constexpr int kFeat = 32, kStep = 2; };

// 16 bytes of shared memory into kStep registers, and 4 elements.
__device__ __forceinline__ void load_step(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_step(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load4(const float* p, float* v) { load_step(p, v); }
__device__ __forceinline__ void load4(const double* p, double* v) {
  load_step(p, v);
  load_step(p + 2, v + 2);
}

// cp.async of 16 bytes, not cached in L1 (every piece is read once).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <typename T>
struct __align__(16) ProbeSmem {
  static constexpr int kFeat = L1Shape<T>::kFeat;
  static constexpr int kLd = kFeat + 16 / sizeof(T);  // a padded X row
  T x[2][kPTile][kLd];     // the block's rows, as stored
  T y[2][kFeat][kPTile];   // its columns
};

// X (B, nb, tm, fb), Y (B, nb, fb, tn), out (B, tm, tn); tm and tn
// multiples of 128, fb of the stage's features; block (column tile, row
// tile, instance).
template <typename T>
__global__ void __launch_bounds__(kPThreads, 1)
    probe_l1(const T* __restrict__ X, const T* __restrict__ Y, T* __restrict__ out, int nb,
             int tm, int tn, int fb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = ProbeSmem<T>;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int kFeat = Smem::kFeat, kStep = L1Shape<T>::kStep;
  constexpr int kVec = 16 / sizeof(T);                  // elements of a 16-byte piece
  constexpr int kXPieces = kPTile * kFeat / kVec;       // pieces of a stage's X rows
  constexpr int kYPieces = kFeat * kPTile / kVec;       // of its Y columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * kPTile, col0 = blockIdx.x * kPTile;
  const int rbase = 16 * warp + (lane >> 4), cbase = 4 * (lane & 15);
  const size_t inst = blockIdx.z;
  const int per_block = fb / kFeat, steps = nb * per_block;
  const auto load = [&](int st) {
    if (st < steps) {
      const int buf = st & 1, b = st / per_block, f0 = (st % per_block) * kFeat;
      const T* xb = X + ((inst * nb + b) * tm + row0) * fb + f0;
      const T* yb = Y + ((inst * nb + b) * (size_t)fb + f0) * tn + col0;
#pragma unroll
      for (int e = tid; e < kXPieces; e += kPThreads) {
        const int r = e / (kFeat / kVec), q = kVec * (e % (kFeat / kVec));
        cp_async16(&sm.x[buf][r][q], xb + (size_t)r * fb + q);
      }
#pragma unroll
      for (int e = tid; e < kYPieces; e += kPThreads) {
        const int f = e / (kPTile / kVec), q = kVec * (e % (kPTile / kVec));
        cp_async16(&sm.y[buf][f][q], yb + (size_t)f * tn + q);
      }
    }
    asm volatile("cp.async.commit_group;\n");
  };
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  load(0);
  for (int st = 0; st < steps; ++st) {
    asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();  // this stage is in; every thread is done with the other buffer
    load(st + 1);
    const int buf = st & 1;
#pragma unroll 2
    for (int f = 0; f < kFeat; f += kStep) {
      T a[8][kStep], y[kStep][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) load_step(&sm.x[buf][rbase + 2 * i][f], a[i]);
#pragma unroll
      for (int s = 0; s < kStep; ++s) {
        load4(&sm.y[buf][f + s][cbase], y[s]);
        load4(&sm.y[buf][f + s][64 + cbase], y[s] + 4);
      }
#pragma unroll
      for (int s = 0; s < kStep; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += absdiff(a[i][s], y[s][j]);
    }
  }
  T* o = out + (inst * tm + row0) * tn + col0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? cbase + j : 64 + cbase + j - 4);
      o[(size_t)(rbase + 2 * i) * tn + c] = acc[i][j];
    }
}

__host__ __device__ constexpr float rep_constant(int r) { return (float)(0.25 + 0.01 * r); }

template <int MODE>
__device__ __forceinline__ float chain(float x, float y) {
  float acc = (MODE == ELEM || MODE == EXP_CHAIN) ? y : 0.0f;
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    if constexpr (MODE == ELEM) {
      acc = fabsf(acc - x) + y;
    } else if constexpr (MODE == EXP_CHAIN) {
      acc = __expf(-fabsf(acc - x));
    } else if constexpr (MODE == EXP_SUM) {
      acc += __expf(x * -rep_constant(r));
    } else {
      const float t = x - y;
      acc += __expf(t - rep_constant(r)) * y;
    }
  }
  return acc;
}

// X, Y, out: count floats each. Four independent chains a thread.
template <int MODE>
__global__ void __launch_bounds__(kPThreads)
    probe_chain(const float* __restrict__ X, const float* __restrict__ Y,
                float* __restrict__ out, size_t count) {
  const size_t stride = (size_t)gridDim.x * kPThreads;
  for (size_t i = blockIdx.x * (size_t)kPThreads + threadIdx.x; i < count; i += 4 * stride) {
    float x[4], y[4], r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t e = i + u * stride;
      x[u] = e < count ? X[e] : 0.0f;
      y[u] = e < count ? Y[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) r[u] = chain<MODE>(x[u], y[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t e = i + u * stride;
      if (e < count) out[e] = r[u];
    }
  }
}

template <typename T>
cudaError_t launch_l1(const void* X, const void* Y, void* out, int B, int nb, int tm, int tn,
                      int fb, cudaStream_t s) {
  const int bytes = (int)sizeof(ProbeSmem<T>);
  const cudaError_t err = cudaFuncSetAttribute(
      probe_l1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(tn / kPTile, tm / kPTile, B);
  probe_l1<T><<<grid, kPThreads, bytes, s>>>(static_cast<const T*>(X),
                                             static_cast<const T*>(Y), static_cast<T*>(out),
                                             nb, tm, tn, fb);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes; launches on `stream`, does not
// synchronize, returns a CUDA error code (0 on success).

// #10 / #12: out (B, tm, tn) = sum over nb blocks and fb features of
// |X[., b, r, f] - Y[., b, f, c]|; X (B, nb, tm, fb), Y (B, nb, fb, tn),
// contiguous, float32 (dtype 0) or float64 (1); tm, tn multiples of 128,
// fb of 64 (float32) or 32 (float64).
extern "C" int rl_probe_l1(int dtype, const void* X, const void* Y, void* out, int B, int nb,
                           int tm, int tn, int fb, void* stream) {
  const int feat = dtype == 0 ? L1Shape<float>::kFeat : L1Shape<double>::kFeat;
  if (B < 1 || nb < 1 || tm < kPTile || tn < kPTile || tm % kPTile || tn % kPTile || fb < feat ||
      fb % feat || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_l1<float>(X, Y, out, B, nb, tm, tn, fb, s);
  if (dtype == 1) return (int)launch_l1<double>(X, Y, out, B, nb, tm, tn, fb, s);
  return (int)cudaErrorInvalidValue;
}

// #11 / #12 / #13: out = chain(X, Y) elementwise over count float32 values;
// mode ELEM 0, EXP_CHAIN 1, EXP_SUM 2, EPILOGUE_SUM 3.
extern "C" int rl_probe_chain(int mode, const void* X, const void* Y, void* out,
                              long long count, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const float* y = static_cast<const float*>(Y);
  float* o = static_cast<float*>(out);
  long long blocks = (count + 4LL * kPThreads - 1) / (4LL * kPThreads);
  if (blocks > 132 * 64) blocks = 132 * 64;
  const size_t n = (size_t)count;
  switch (mode) {
    case ELEM: probe_chain<ELEM><<<(unsigned)blocks, kPThreads, 0, s>>>(x, y, o, n); break;
    case EXP_CHAIN: probe_chain<EXP_CHAIN><<<(unsigned)blocks, kPThreads, 0, s>>>(x, y, o, n); break;
    case EXP_SUM: probe_chain<EXP_SUM><<<(unsigned)blocks, kPThreads, 0, s>>>(x, y, o, n); break;
    case EPILOGUE_SUM:
      probe_chain<EPILOGUE_SUM><<<(unsigned)blocks, kPThreads, 0, s>>>(x, y, o, n);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
