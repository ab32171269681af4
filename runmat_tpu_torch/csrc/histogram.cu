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
// are 268 MB, 0.080 ms at 3.35 TB/s). The kernel of the shared layouts below
// keeps the work per value small enough to stream (the global layout keeps a
// plain loop):
//   * x is read in 16-byte vectors (float4 / double2; a scalar head and tail
//     where x is not 16-byte aligned), kUnroll vectors in flight per thread,
//     by a grid of up to kBlocksPerSm blocks per SM that strides over x.
//   * Search mode finds the bin through a guide table, not a binary search
//     over all edges. Each block builds, in its prologue and in one pass
//     over the edges, a table of G cells over [e_0, e_B] (G a power of two,
//     up to 8*B and at most 4096): cell(v) = clamp(floor(fma(v, inv, off)),
//     0, G-1) with inv = G / (e_B - e_0), off = -e_0 * inv, and cell c
//     holds the pair (T(c), T(c+1)) with
//     T(c) = #(k : cell(e_k) < c). cell() is monotone in v (a correctly
//     rounded fma of a monotone function, then floor and clamp), and the
//     table is built with the same cell() as the lookup, so for any v in
//     [e_0, e_B]: T(c) <= j(v) <= T(c+1), where j(v) = #(e_k <= v). The
//     value then settles j with exact compares against the edges inside that
//     bracket (none or one for G >= 8*B; a binary search inside the bracket
//     where edges cluster). The bin is still decided only by exact compares
//     with the edges, so the counts stay exact whatever the rounding of the
//     cell. Edges that give no usable table (an infinite end, e_B == e_0, a
//     span that overflows) take a binary search over all edges instead.
//   * Direct mode scales a = x*2^k_exp, which is exact (a power of two) unless
//     it underflows, and then keeps x itself, which lies on the same side of
//     every edge (all edges are 0 or at least 2^-k_exp away from it). Then
//     x >= e_k exactly when a >= m + k, so the bin is floor(a) - m in
//     integers, valid when m <= a <= m + B. (The Pallas kernel's
//     y = x*2^k_exp - m in f32 is not exact when m < 0.)
//   * Hot bins (normals pile into a few central bins) collide in shared
//     atomics. kSub private copies per warp, chosen by lane & (kSub - 1) and
//     laid out with an odd stride so that one bin of different copies lies in
//     different banks, cut the collisions of a warp's 32 adds by kSub. (One
//     atomicAdd per distinct bin of the warp after __match_any_sync measured
//     3-5x slower in f32: PERF.md.)
//
// Where the counts go depends on how many bins there are; every count of
// bins takes the kernel:
//   sub-copies  kSub int32 histograms per warp in shared memory, when they,
//               the table and the edges fit the 48 KB a block gets without
//               opting in;
//   per warp    one per warp, when that fits the 48 KB;
//   per block   one per block, with the larger shared memory the device
//               allows a block on request (227 KB on an H100);
//   global      above that, a kernel of its own: atomics straight into the
//               global counts, a binary search over the edges in global
//               memory, one value per load, at most kGlobalBlocksPerSm
//               blocks per SM. Its time is the global atomics'; a guide
//               table and 16-byte loads made it slower there (PERF.md).
// The table shrinks (down to 64 cells) before a layout is given up. A block
// merges its shared histograms into the global counts with one 64-bit
// atomicAdd per bin at its end. The shared counts are int32: a block sees at
// most ceil(n / grid) values, and when that could reach 2^31 the launch takes
// the global layout instead, so no count wraps for any n.
//
// Integer counts are exact in any order of atomics, so the result equals the
// plain PyTorch version (runmat_tpu_torch/ops/histogram.py) bit for bit.
// Search mode gives j = #(e_k <= x) over e_0..e_B for x in [e_0, e_B] (other
// x and NaN are dropped: by two compares first, or in the global layout
// where j is 0, or B+1 with x != e_B); the bin is min(j, B) - 1, so
// x == e_B (j = B+1) lands in bin B-1. That is the cumulative-difference
// definition element by element, repeated edges included.
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
constexpr int kBlocksPerSm = 8;
constexpr int kSub = 4;          // private copies per warp (lane & (kSub-1))
constexpr int kMaxCells = 4096;  // guide table cells, at most
constexpr int kMinCells = 64;
constexpr int kGlobalBlocksPerSm = 4;
constexpr size_t kDefaultSmem = 48 * 1024;  // per block without opting in

// where a block's shared counts go; the edges are in shared memory too
enum Layout {
  kSubCopies = 0,  // kSub copies of the counts per warp
  kPerWarp = 1,    // one copy per warp
  kPerBlock = 2    // one copy per block
};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& w, float* v) {
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& w, double* v) {
    v[0] = w.x;
    v[1] = w.y;
  }
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ int floor_int(float t) { return __float2int_rd(t); }
__device__ __forceinline__ int floor_int(double t) {
  return __double2int_rd(t);
}

// The guide table's cell of v; monotone non-decreasing in v.
template <typename T>
__device__ __forceinline__ int cell_of(T v, T inv, T off, int cells) {
  // clamp in T first, so the conversion never sees an out-of-range value
  T t = fma_rn(v, inv, off);
  t = t < T(0) ? T(0) : t;
  t = t > T(cells - 1) ? T(cells - 1) : t;
  return floor_int(t);
}

// j = #(e_k <= v) given lo <= j <= hi and e sorted: exact compares only
template <typename T>
__device__ __forceinline__ int settle(T v, const T* e, int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Guide {
  const int2* table;  // nullptr: no table, search all edges
  int cells;
};

template <typename T>
__device__ __forceinline__ int search_bin(T v, const T* e, int nb, T e0,
                                          T eB, const Guide& g, T inv,
                                          T off) {
  if (!(v >= e0 && v <= eB)) return -1;  // out of range or NaN
  int lo = 1;                             // e_0 <= v
  int hi = nb + 1;
  if (g.table != nullptr) {
    const int2 br = g.table[cell_of(v, inv, off, g.cells)];
    lo = br.x;
    hi = br.y;
  }
  return min(settle(v, e, lo, hi), nb) - 1;
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

// The layout is a template argument, so each kernel's atomics address one
// copy scheme. Shared memory holds, in order: the nb + 1 edges and the guide
// table (search mode), then the histograms, `stride` int32 apart.
template <typename T, bool kDirect, int kLayout>
__global__ void __launch_bounds__(kThreads)
histcounts_kernel(const T* __restrict__ x, int64_t n,
                  const T* __restrict__ edges, int nb, int cells, int stride,
                  float scale, int m,
                  unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kCopies = kLayout == kSubCopies ? kWarps * kSub
                          : kLayout == kPerWarp ? kWarps
                                                : 1;
  unsigned char* next = smem;
  const T* e = edges;
  Guide guide{nullptr, cells};
  T e0 = T(0), eB = T(0), inv = T(0), off = T(0);
  if constexpr (!kDirect) {
    T* shared_edges = reinterpret_cast<T*>(next);
    for (int i = threadIdx.x; i <= nb; i += kThreads) {
      shared_edges[i] = edges[i];
    }
    e = shared_edges;
    next += (sizeof(T) * (nb + 1) + 15) / 16 * 16;
    e0 = edges[0];
    eB = edges[nb];
    const T span = eB - e0;
    inv = T(cells) / span;
    off = -e0 * inv;
    int2* table = reinterpret_cast<int2*>(next);
    next += sizeof(int2) * cells;
    if (isfinite(span) && span > T(0) && isfinite(inv) && inv > T(0) &&
        isfinite(off)) {
      // T(c) = #(k : cell(e_k) < c) is k exactly for the cells c in
      // (cell(e_{k-1}), cell(e_k)], with cell(e_{-1}) = -1 and
      // cell(e_{nb+1}) = cells; those runs cover 0..cells once. The thread
      // of edge k writes T(c) = k into pair c (.x) and pair c-1 (.y), so
      // the edges are read once, in order.
      int* t = reinterpret_cast<int*>(table);
      for (int k = threadIdx.x; k <= nb + 1; k += kThreads) {
        const int first =
            k == 0 ? 0 : cell_of(edges[k - 1], inv, off, cells) + 1;
        const int last =
            k == nb + 1 ? cells : cell_of(edges[k], inv, off, cells);
        for (int c = first; c <= last; ++c) {
          if (c < cells) t[2 * c] = k;
          if (c > 0) t[2 * c - 1] = k;
        }
      }
      guide.table = table;
    }
  }
  int* hist = reinterpret_cast<int*>(next);
  for (int i = threadIdx.x; i < kCopies * stride; i += kThreads) hist[i] = 0;
  int copy = 0;
  if constexpr (kLayout == kSubCopies) {
    copy = (threadIdx.x >> 5) * kSub + (threadIdx.x & (kSub - 1));
  } else if constexpr (kLayout == kPerWarp) {
    copy = threadIdx.x >> 5;
  }
  int* mine = hist + copy * stride;
  __syncthreads();

  auto add = [&](T v) {
    int b;
    if constexpr (kDirect) {
      b = direct_bin(v, scale, m, nb);
    } else {
      b = search_bin(v, e, nb, e0, eB, guide, inv, off);
    }
    if (b >= 0) atomicAdd(&mine[b], 1);
  };

  // 16-byte vectors between a scalar head (to alignment) and a scalar tail
  using V = Vec<T>;
  const int64_t misalign =
      (reinterpret_cast<uintptr_t>(x) % 16) / static_cast<int64_t>(sizeof(T));
  const int64_t head =
      misalign == 0 ? 0 : (n < V::n - misalign ? n : V::n - misalign);
  const int64_t nvec = (n - head) / V::n;
  const auto* xv = reinterpret_cast<const typename V::type*>(x + head);
  const int64_t stride_g = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  int64_t i = gtid;
  for (; i + (kUnroll - 1) * stride_g < nvec; i += kUnroll * stride_g) {
    typename V::type w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(&xv[i + u * stride_g]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      T v[V::n];
      V::unpack(w[u], v);
#pragma unroll
      for (int k = 0; k < V::n; ++k) add(v[k]);
    }
  }
  for (; i < nvec; i += stride_g) {
    T v[V::n];
    V::unpack(__ldg(&xv[i]), v);
#pragma unroll
    for (int k = 0; k < V::n; ++k) add(v[k]);
  }
  const int64_t tail0 = head + nvec * V::n;
  const int64_t scalars = head + (n - tail0);
  for (int64_t k = gtid; k < scalars; k += stride_g) {
    add(x[k < head ? k : tail0 + (k - head)]);
  }

  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    unsigned long long s = 0;
#pragma unroll 4
    for (int w = 0; w < kCopies; ++w) s += hist[w * stride + b];
    if (s != 0) atomicAdd(&counts[b], s);
  }
}

// The global layout: counts and edges in global memory, kUnroll values in
// flight per thread, one per load.
template <typename T, bool kDirect>
__global__ void __launch_bounds__(kThreads)
histcounts_global_kernel(const T* __restrict__ x, int64_t n,
                         const T* __restrict__ edges, int nb, float scale,
                         int m, unsigned long long* __restrict__ counts) {
  const T eB = kDirect ? T(0) : edges[nb];
  auto add = [&](T v) {
    int b;
    if constexpr (kDirect) {
      b = direct_bin(v, scale, m, nb);
    } else {
      // j = #(e_k <= v) by a binary search from 0 over all edges; NaN and
      // v < e_0 give 0. (The same search from 1 after a range check ran
      // 1.5x slower at 65536 bins: PERF.md.)
      const int j = settle(v, edges, 0, nb + 1);
      b = j >= 1 && j <= nb ? j - 1 : (j == nb + 1 && v == eB ? nb - 1 : -1);
    }
    if (b >= 0) atomicAdd(&counts[b], 1ull);
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(v[u]);
  }
  for (; i < n; i += stride) add(x[i]);
}

// Shared bytes of a layout: edges, table, histograms.
template <typename T, bool kDirect>
size_t layout_bytes(int copies, int nb, int cells, int stride) {
  size_t bytes = 0;
  if (!kDirect) {
    bytes += (sizeof(T) * (nb + 1) + 15) / 16 * 16;
    bytes += sizeof(int2) * static_cast<size_t>(cells);
  }
  return bytes + sizeof(int) * static_cast<size_t>(copies) * stride;
}

// The grid of `kernel` with `bytes` of shared memory: as many blocks as run
// at once, at most `most` per SM, and no more than n values need.
template <typename K>
cudaError_t grid_of(K kernel, size_t bytes, int most, int64_t n, int sms,
                    int64_t* blocks) {
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
  per_sm = per_sm < 1 ? 1 : (per_sm > most ? most : per_sm);
  *blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  if (*blocks > cap) *blocks = cap;
  return cudaSuccess;
}

template <typename T, bool kDirect>
cudaError_t launch_global(const T* x, int64_t n, const T* edges, int nb,
                          float scale, int m, unsigned long long* counts,
                          cudaStream_t s, int sms) {
  auto kernel = histcounts_global_kernel<T, kDirect>;
  int64_t blocks = 0;
  const cudaError_t err =
      grid_of(kernel, 0, kGlobalBlocksPerSm, n, sms, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, 0, s>>>(
      x, n, edges, nb, scale, m, counts);
  return cudaGetLastError();
}

// Launches the kLayout kernel with `bytes` of shared memory on `s`.
template <typename T, bool kDirect, int kLayout>
cudaError_t launch_layout(const T* x, int64_t n, const T* edges, int nb,
                          int cells, int stride, float scale, int m,
                          unsigned long long* counts, cudaStream_t s, int sms,
                          size_t bytes) {
  auto kernel = histcounts_kernel<T, kDirect, kLayout>;
  int64_t blocks = 0;
  const cudaError_t err = grid_of(kernel, bytes, kBlocksPerSm, n, sms,
                                  &blocks);
  if (err != cudaSuccess) return err;
  if ((n + blocks - 1) / blocks > INT32_MAX) {
    // a block's shared int32 counts could wrap
    return launch_global<T, kDirect>(x, n, edges, nb, scale, m, counts, s,
                                     sms);
  }
  kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, bytes, s>>>(
      x, n, edges, nb, cells, stride, scale, m, counts);
  return cudaGetLastError();
}

// Picks the layout and the table size for nb bins: the first layout, in
// the order of the header, that fits with the largest table that lets it.
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
  int top = kMinCells;  // the largest table: a power of two >= 8 * nb
  while (top < kMaxCells && top < 8 * nb) top <<= 1;
  const int lo_cells = kDirect ? 0 : kMinCells;
  const int hi_cells = kDirect ? 0 : top;
  const int odd = nb | 1;  // one bin of different copies: different banks
  for (int layout = kSubCopies; layout <= kPerBlock; ++layout) {
    const int copies = layout == kSubCopies ? kWarps * kSub
                       : layout == kPerWarp ? kWarps
                                            : 1;
    const int stride = layout == kSubCopies ? odd : nb;
    const size_t limit = layout == kPerBlock ? static_cast<size_t>(optin)
                                             : kDefaultSmem;
    for (int cells = hi_cells; cells >= lo_cells; cells >>= 1) {
      const size_t bytes =
          layout_bytes<T, kDirect>(copies, nb, cells, stride);
      if (bytes <= limit) {
        switch (layout) {
          case kSubCopies:
            return launch_layout<T, kDirect, kSubCopies>(
                x, n, edges, nb, cells, stride, scale, m, counts, s, sms,
                bytes);
          case kPerWarp:
            return launch_layout<T, kDirect, kPerWarp>(
                x, n, edges, nb, cells, stride, scale, m, counts, s, sms,
                bytes);
          default:
            return launch_layout<T, kDirect, kPerBlock>(
                x, n, edges, nb, cells, stride, scale, m, counts, s, sms,
                bytes);
        }
      }
      if (cells == 0) break;
    }
  }
  return launch_global<T, kDirect>(x, n, edges, nb, scale, m, counts, s, sms);
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
