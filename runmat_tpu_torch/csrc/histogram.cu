// Histogram counts (MATLAB histcounts with explicit edges) on Hopper
// (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernels of runmat_tpu/ops/pallas/histogram.py:
//   histcounts_pallas (216)        counts over B+1 non-decreasing edges as
//                                  differences of the cumulative counts
//                                  #(x >= e_k), the last bin right-closed
//                                  through #(x > e_B);
//   histcounts_pallas_affine (67)  the same counts for exact power-of-two
//                                  affine edges e_k = (m + k) * 2^-k_exp,
//                                  through a direct bin index.
// NaN and out-of-range values count nowhere. It computes what those kernels
// compute, not their form: the per-edge compare slabs and the two-level
// one-hot/MXU product were ways to keep a TPU's vector and matrix units busy.
//
// What bounds it on this card: each element is read once (4 or 8 bytes) and
// needs a bin index, so the floor is device-memory bandwidth (2^26 f32 values
// are 268 MB). The index is either a binary search over the edges (search
// mode, at most 9 steps for 256 bins) or an exact scaling and a floor (direct
// mode). Each thread keeps kUnroll loads in flight before it bins them, and a
// grid of up to kBlocksPerSm blocks per SM strides over x, so enough bytes
// are in flight to stream.
//
// Where the counts go depends on how many bins there are; every count of
// bins takes the kernel:
//   per warp   one int32 histogram per warp in shared memory, so shared
//              atomics only collide within a warp, while the histograms and
//              the edges fit the 48 KB a block gets without opting in
//              (up to 1365 bins in f32 search mode, 1228 in f64, 1536 in
//              direct mode);
//   per block  one shared histogram per block, with the larger shared memory
//              the device allows a block on request (227 KB on an H100:
//              up to 29055 bins in f32 search mode, 19369 in f64, 58112 in
//              direct mode);
//   global     above that, atomics straight into the global counts, with
//              the edges read from global memory.
// A block merges its shared histograms into the global counts with one
// 64-bit atomicAdd per bin at its end. The shared counts are int32: a block
// sees at most ceil(n / grid) values, and when that could reach 2^31 the
// launch takes the global layout instead, so no count wraps for any n.
//
// Integer counts are exact in any order of atomics, so the result equals the
// plain PyTorch version (runmat_tpu_torch/ops/histogram.py) bit for bit.
// Search mode gives j = #(e_k <= x) over e_0..e_B; the bin is j-1 when
// 1 <= j <= B, and B-1 when x == e_B (j = B+1). That is the cumulative-
// difference definition element by element, repeated edges included.
// Direct mode scales a = x*2^k_exp, which is exact (a power of two) unless
// it underflows, and then keeps x itself, which lies on the same side of
// every edge (all edges are 0 or at least 2^-k_exp away from it). Then
// x >= e_k exactly when a >= m + k, so the bin is floor(a) - m in integers,
// valid when m <= a <= m + B. The Pallas kernel's y = x*2^k_exp - m in f32
// is not exact when m < 0: a value within an ulp of a zero edge rounds onto
// it and lands one bin off (or in range when it is not).
//
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the caller zeroes `counts` on that stream first. The C entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;
constexpr size_t kDefaultSmem = 48 * 1024;  // per block without opting in

template <typename T>
__device__ __forceinline__ int search_bin(T v, const T* e, int nb) {
  int lo = 0;
  int hi = nb + 1;  // j = #(e_k <= v) lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo >= 1 && lo <= nb) return lo - 1;
  return (lo == nb + 1 && v == e[nb]) ? nb - 1 : -1;  // NaN: lo == 0
}

__device__ __forceinline__ int direct_bin(float v, float scale, int m,
                                          int nb) {
  float a = __fmul_rn(v, scale);
  if (a == 0.0f) a = v;  // an underflow keeps v's side of a zero edge
  if (!(a >= static_cast<float>(m) && a <= static_cast<float>(m + nb))) {
    return -1;  // NaN fails both
  }
  return min(static_cast<int>(floorf(a)) - m, nb - 1);
}

template <typename T, bool kDirect>
__device__ __forceinline__ int bin_of(T v, const T* e, int nb, float scale,
                                      int m) {
  if constexpr (kDirect) {
    return direct_bin(v, scale, m, nb);
  } else {
    return search_bin(v, e, nb);
  }
}

// The layout is a template argument, so each kernel's loads and atomics
// address one memory space. kCopies > 0: shared memory holds the nb + 1
// edges (search mode), then kCopies histograms of nb int32 counts (kWarps:
// one per warp; 1: one per block). kCopies == 0 counts straight into
// `counts` and reads the edges from global memory.
template <typename T, bool kDirect, int kCopies>
__global__ void __launch_bounds__(kThreads)
histcounts_kernel(const T* __restrict__ x, int64_t n,
                  const T* __restrict__ edges, int nb, float scale, int m,
                  unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* e = edges;
  int* hist = nullptr;
  int* mine = nullptr;
  if constexpr (kCopies > 0) {
    size_t edge_bytes = 0;
    if constexpr (!kDirect) {
      T* shared_edges = reinterpret_cast<T*>(smem);
      for (int i = threadIdx.x; i <= nb; i += kThreads) {
        shared_edges[i] = edges[i];
      }
      e = shared_edges;
      edge_bytes = sizeof(T) * (nb + 1);
    }
    hist = reinterpret_cast<int*>(smem + edge_bytes);
    for (int i = threadIdx.x; i < kCopies * nb; i += kThreads) hist[i] = 0;
    __syncthreads();
    mine = hist + (kCopies == kWarps ? threadIdx.x >> 5 : 0) * nb;
  }
  auto add = [&](int b) {
    if (b < 0) return;
    if constexpr (kCopies > 0) {
      atomicAdd(&mine[b], 1);
    } else {
      atomicAdd(&counts[b], 1ull);
    }
  };

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add(bin_of<T, kDirect>(v[u], e, nb, scale, m));
    }
  }
  for (; i < n; i += stride) add(bin_of<T, kDirect>(x[i], e, nb, scale, m));

  if constexpr (kCopies > 0) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      unsigned long long s = 0;
#pragma unroll
      for (int w = 0; w < kCopies; ++w) s += hist[w * nb + b];
      if (s != 0) atomicAdd(&counts[b], s);
    }
  }
}

// Launches the kCopies layout with `bytes` of shared memory on `s`: up to
// kBlocksPerSm blocks per SM, as many as the shared memory lets run at once.
template <typename T, bool kDirect, int kCopies>
cudaError_t launch_layout(const T* x, int64_t n, const T* edges, int nb,
                          float scale, int m, unsigned long long* counts,
                          cudaStream_t s, int sms, size_t bytes) {
  auto kernel = histcounts_kernel<T, kDirect, kCopies>;
  cudaError_t err = cudaSuccess;
  if (bytes > kDefaultSmem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  per_sm = per_sm < 1 ? 1 : (per_sm > kBlocksPerSm ? kBlocksPerSm : per_sm);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  if constexpr (kCopies > 0) {
    if ((n + blocks - 1) / blocks > INT32_MAX) {
      // a block's shared int32 counts could wrap
      return launch_layout<T, kDirect, 0>(x, n, edges, nb, scale, m, counts,
                                          s, sms, 0);
    }
  }
  kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, bytes, s>>>(
      x, n, edges, nb, scale, m, counts);
  return cudaGetLastError();
}

// Picks the layout for nb bins.
template <typename T, bool kDirect>
cudaError_t launch(const T* x, int64_t n, const T* edges, int nb, float scale,
                   int m, unsigned long long* counts, cudaStream_t s,
                   int device) {
  int sms = 0;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t edge_bytes = kDirect ? 0 : sizeof(T) * (nb + 1);
  const size_t hist_bytes = sizeof(int) * static_cast<size_t>(nb);
  if (edge_bytes + kWarps * hist_bytes <= kDefaultSmem) {
    return launch_layout<T, kDirect, kWarps>(x, n, edges, nb, scale, m,
                                             counts, s, sms,
                                             edge_bytes + kWarps * hist_bytes);
  }
  if (edge_bytes + hist_bytes <= static_cast<size_t>(optin)) {
    return launch_layout<T, kDirect, 1>(x, n, edges, nb, scale, m, counts, s,
                                        sms, edge_bytes + hist_bytes);
  }
  return launch_layout<T, kDirect, 0>(x, n, edges, nb, scale, m, counts, s,
                                      sms, 0);
}

}  // namespace

// mode: 0 search f32, 1 search f64, 2 direct f32 (edges unused; k_exp, m).
// x: n contiguous values of the mode's type; edges: n_bins + 1 values of it;
// counts: n_bins 64-bit counts, zeroed by the caller on `stream`.
extern "C" int runmat_histcounts(int mode, const void* x, int64_t n,
                                 const void* edges, int n_bins, int k_exp,
                                 int m, void* counts, void* stream,
                                 int device) {
  if (n_bins < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<unsigned long long*>(counts);
  switch (mode) {
    case 0:
      return static_cast<int>(launch<float, false>(
          static_cast<const float*>(x), n, static_cast<const float*>(edges),
          n_bins, 0.0f, 0, out, s, device));
    case 1:
      return static_cast<int>(launch<double, false>(
          static_cast<const double*>(x), n, static_cast<const double*>(edges),
          n_bins, 0.0f, 0, out, s, device));
    case 2:
      return static_cast<int>(launch<float, true>(
          static_cast<const float*>(x), n, nullptr, n_bins,
          std::ldexp(1.0f, k_exp), m, out, s, device));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
