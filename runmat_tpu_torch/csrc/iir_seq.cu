// IIR filter, direct form II transposed, of any order (MATLAB `filter(b, a,
// x, z0)` with a normalised a(1) = 1), on Hopper (sm_90a), bound through
// ctypes: the sample recurrence in order, in one block.
//
// Replaces runmat_tpu/accel/dense.py:_b_iir (706-728), a jax.lax.scan that
// XLA compiles into one device loop, for the orders the chunked scan of
// iir.cuh does not take (N > kMaxN = 33 coefficients, where its state
// matrix no longer fits a template instantiation). With N coefficients and
// the state z of M = N-1 values, each sample does
//   y_i      = b_0 x_i + z_0
//   z_k      = (b_{k+1} x_i + z_{k+1}) - a_{k+1} y_i,   k = 0 .. M-1,
// where z_M is 0: the scan's step in its order of operations, every
// product, sum and difference a separately rounded __fmul_rn/__fadd_rn/
// __fsub_rn (f32) or __dmul_rn/__dadd_rn/__dsub_rn (f64), no FMA
// contraction, so every output is bit-equal to the sequential scan
// (ops/iir.py:plain_iir).
//
// What bounds it on this card: the chain, not bytes. Sample i needs the
// state that sample i-1 wrote, so the samples run one after another. The
// M state updates of a sample are independent of each other, so the block
// splits them: thread t owns states t, t + T, ... (T threads, M rounded up
// to whole warps, at most 1024), the state double-buffered (a sample reads
// one copy and writes the other, then the block meets at one barrier).
// A sample then costs a few dependent operations and one barrier, whatever
// M up to T: far from the 3.35 TB/s its x and y would allow (PERF.md has
// its time beside that bound). The state and the coefficients past b_0
// sit in shared memory while four copies of M values fit in 32 KB (M up to
// 1024 in f64, 2048 in f32), else in the caller's scratch in device memory
// (cached in L1). Each thread also keeps its first state's coefficients in
// registers. x comes in and y goes out in tiles of kSeqTile samples
// through shared memory, loaded and stored coalesced by the whole block.
//
// A NaN or Inf in x reaches every later output, as in the sequential scan.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry returns the first cudaGetLastError() that is
// not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeqTile = 1024;          // samples staged a tile
constexpr int kMaxThreads = 1024;
constexpr int kSharedState = 32 * 1024;  // bytes of dynamic shared memory

struct S32 {
  using T = float;
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
};

struct S64 {
  using T = double;
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
};

int threads_for(int m) {
  const int t = (m + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// the four arrays of M values the state region holds (two state copies,
// b[1:], a[1:]), in shared memory when they fit
int64_t state_bytes(int m, int elem) { return int64_t(4) * m * elem; }

// One block. `global_state` is the caller's scratch (4 M values) or null,
// in which case the state region is the block's dynamic shared memory.
template <typename Op>
__global__ void seq_kernel(const typename Op::T* __restrict__ x,
                           typename Op::T* __restrict__ y, int64_t n, int m,
                           const typename Op::T* __restrict__ b,
                           const typename Op::T* __restrict__ a,
                           const typename Op::T* __restrict__ z0,
                           typename Op::T* global_state) {
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T xs[kSeqTile];
  __shared__ T ys[kSeqTile];
  T* st = global_state ? global_state : reinterpret_cast<T*>(dyn);
  T* zc = st;
  T* zn = st + m;
  T* sb = st + 2 * m;
  T* sa = st + 3 * m;
  const int t = threadIdx.x, nt = blockDim.x;
  for (int k = t; k < m; k += nt) {
    zc[k] = z0[k];
    sb[k] = b[k + 1];
    sa[k] = a[k + 1];
  }
  const T b0 = b[0];
  const bool own = t < m;
  const T bk0 = own ? b[t + 1] : T(0);
  const T ak0 = own ? a[t + 1] : T(0);
  __syncthreads();
  for (int64_t base = 0; base < n; base += kSeqTile) {
    const int len = static_cast<int>(n - base < kSeqTile ? n - base
                                                         : kSeqTile);
    for (int i = t; i < len; i += nt) xs[i] = x[base + i];
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const T xi = xs[j];
      const T yi = Op::add(Op::mul(b0, xi), zc[0]);
      if (own) {
        const T up = t + 1 < m ? zc[t + 1] : T(0);
        zn[t] = Op::sub(Op::add(Op::mul(bk0, xi), up), Op::mul(ak0, yi));
      }
      for (int k = t + nt; k < m; k += nt) {
        const T up = k + 1 < m ? zc[k + 1] : T(0);
        zn[k] = Op::sub(Op::add(Op::mul(sb[k], xi), up),
                        Op::mul(sa[k], yi));
      }
      if (t == 0) ys[j] = yi;
      T* tmp = zc;
      zc = zn;
      zn = tmp;
      __syncthreads();
    }
    for (int i = t; i < len; i += nt) y[base + i] = ys[i];
    __syncthreads();
  }
}

bool valid(int dtype, int64_t n, int ncoef) {
  return (dtype == 0 || dtype == 1) && ncoef >= 2 && n >= 0;
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 8; }

}  // namespace

// Bytes of device scratch a call needs: 0 where the state fits in shared
// memory, else 4 (ncoef - 1) values; -1 where the arguments are refused.
extern "C" int64_t runmat_iir_seq_scratch(int dtype, int64_t n, int ncoef) {
  if (!valid(dtype, n, ncoef)) return -1;
  const int64_t bytes = state_bytes(ncoef - 1, elem_size(dtype));
  return bytes <= kSharedState ? 0 : bytes;
}

// dtype 0: float32, 1: float64. x, y: n values; b, a: ncoef values (a[0]
// is 1 and not read); z0: ncoef - 1 values; scratch:
// runmat_iir_seq_scratch(...) bytes (null where that is 0). All on
// `device`, contiguous.
extern "C" int runmat_iir_seq(int dtype, const void* x, void* y, int64_t n,
                              int ncoef, const void* b, const void* a,
                              const void* z0, void* scratch,
                              int64_t scratch_bytes, void* stream,
                              int device) {
  const int64_t need = runmat_iir_seq_scratch(dtype, n, ncoef);
  if (need < 0 || scratch_bytes < need || (need > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = ncoef - 1;
  const int threads = threads_for(m);
  const size_t shared =
      need > 0 ? 0 : static_cast<size_t>(state_bytes(m, elem_size(dtype)));
  if (dtype == 0) {
    seq_kernel<S32><<<1, threads, shared, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, m,
        static_cast<const float*>(b), static_cast<const float*>(a),
        static_cast<const float*>(z0),
        need > 0 ? static_cast<float*>(scratch) : nullptr);
  } else {
    seq_kernel<S64><<<1, threads, shared, s>>>(
        static_cast<const double*>(x), static_cast<double*>(y), n, m,
        static_cast<const double*>(b), static_cast<const double*>(a),
        static_cast<const double*>(z0),
        need > 0 ? static_cast<double*>(scratch) : nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
