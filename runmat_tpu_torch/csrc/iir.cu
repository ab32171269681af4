// IIR filter, direct form II transposed (MATLAB `filter(b, a, x)` with a
// normalised a(1) = 1), on Hopper (sm_90a), bound through ctypes.
//
// Replaces runmat_tpu/accel/dense.py:_b_iir (706-728), a jax.lax.scan that
// XLA compiles into one device loop; it has no Pallas twin. With N
// coefficients (order N-1) and the state z of N-1 values, each sample does
//   y_i      = b_0 x_i + z_0
//   z_k      = (b_{k+1} x_i + z_{k+1}) - a_{k+1} y_i,   k = 0 .. N-2,
// where z_{N-1} is 0: the scan's step, in its order of operations
// (`bv[1:] * xi + concat([z[1:], 0]) - av[1:] * yi`). Every product and
// sum is a separately rounded __fmul_rn/__fadd_rn/__fsub_rn (f32) or
// __dmul_rn/__dadd_rn/__dsub_rn (f64): no FMA contraction, so the kernel
// is bit-equal to its plain version (runmat_tpu_torch/ops/iir.py), which
// runs the same step as separate torch ops.
//
// What bounds it on this card: not bytes. A sample reads x_i and writes y_i
// (16 B in f64; 2^22 samples are 67 MB, 0.020 ms at 3.35 TB/s), but each
// sample's state depends on the last one's: y_i waits for z_0, and the new
// z_0 waits for y_i through a product and a difference. That chain of
// about three dependent floating-point operations a sample bounds any
// sequential walk; on an H100 this one takes 141 ms for 2^22 samples in
// f64 and 84 ms in f32 (PERF.md), ~33 ns a sample in f64, more than the
// chain alone, so the loads are not all hidden behind it either. The
// design is the simple one: one thread walks the whole vector. It keeps the state in
// registers (N is a template argument, so every index into z is known when
// compiling) and the coefficients in registers too, read once from device
// memory (the caller's tensors; nothing is read back to the host). x is
// read kChunk samples at a time, the next chunk's loads issued before the
// current chunk's samples are filtered, so the loads' latency hides behind
// the chain instead of adding to it. A chunked parallel scan (each block
// filters its stretch from a zero state, then the state carried into each
// stretch is propagated through the stretch's linear map) is the
// redesign for a later change (ROADMAP).
//
// Orders 1 .. kMaxN-1 (N = 2 .. kMaxN coefficients). The launch uses the
// caller's stream, allocates nothing and does not synchronise; the C entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 33;
constexpr int kChunk = 16;

struct F32 {
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

struct F64 {
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

template <typename Op, int N>
__device__ __forceinline__ typename Op::T step(
    typename Op::T xi, typename Op::T (&z)[N - 1],
    const typename Op::T (&b)[N], const typename Op::T (&a)[N]) {
  using T = typename Op::T;
  const T yi = Op::add(Op::mul(b[0], xi), z[0]);
#pragma unroll
  for (int k = 0; k < N - 2; ++k) {
    z[k] = Op::sub(Op::add(Op::mul(b[k + 1], xi), z[k + 1]),
                   Op::mul(a[k + 1], yi));
  }
  // the scan shifts a zero into the last state: (b x + 0) - a y
  z[N - 2] = Op::sub(Op::add(Op::mul(b[N - 1], xi), T(0)),
                     Op::mul(a[N - 1], yi));
  return yi;
}

template <typename Op, int N>
__global__ void __launch_bounds__(1) iir_kernel(
    const typename Op::T* __restrict__ x, typename Op::T* __restrict__ y,
    int64_t n, const typename Op::T* __restrict__ bp,
    const typename Op::T* __restrict__ ap,
    const typename Op::T* __restrict__ z0) {
  using T = typename Op::T;
  T b[N], a[N], z[N - 1];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    b[k] = bp[k];
    a[k] = ap[k];
  }
#pragma unroll
  for (int k = 0; k < N - 1; ++k) z[k] = z0[k];

  const int64_t full = n - n % kChunk;
  T cur[kChunk];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = x[j];
  }
  for (int64_t i = 0; i < full; i += kChunk) {
    T nxt[kChunk];
    if (i + kChunk < full) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) nxt[j] = x[i + kChunk + j];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) y[i + j] = step<Op, N>(cur[j], z, b, a);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = nxt[j];
  }
  for (int64_t i = full; i < n; ++i) y[i] = step<Op, N>(x[i], z, b, a);
}

template <typename Op, int N>
cudaError_t launch_n(const void* x, void* y, int64_t n, const void* b,
                     const void* a, const void* z0, cudaStream_t s) {
  using T = typename Op::T;
  iir_kernel<Op, N><<<1, 1, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n,
      static_cast<const T*>(b), static_cast<const T*>(a),
      static_cast<const T*>(z0));
  return cudaGetLastError();
}

// N = 2 .. kMaxN, one instantiation each
template <typename Op, int N>
cudaError_t dispatch(int ncoef, const void* x, void* y, int64_t n,
                     const void* b, const void* a, const void* z0,
                     cudaStream_t s) {
  if (ncoef == N) return launch_n<Op, N>(x, y, n, b, a, z0, s);
  if constexpr (N < kMaxN) {
    return dispatch<Op, N + 1>(ncoef, x, y, n, b, a, z0, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: float64. x, y: n values; b, a: ncoef values (a[0]
// is 1 and not read); z0: ncoef - 1 values. All on `device`, contiguous.
extern "C" int runmat_iir(int dtype, const void* x, void* y, int64_t n,
                          int ncoef, const void* b, const void* a,
                          const void* z0, void* stream, int device) {
  if (ncoef < 2 || ncoef > kMaxN || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<F32, 2>(ncoef, x, y, n, b, a, z0, s));
    case 1:
      return static_cast<int>(dispatch<F64, 2>(ncoef, x, y, n, b, a, z0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
