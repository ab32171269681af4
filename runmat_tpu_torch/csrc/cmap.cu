// Device colormapping for imagesc on Hopper (sm_90a), bound through ctypes.
//
// Replaces what XLA compiled from runmat_tpu/accel/dense.py:_b_cmap
// (1064-1083; no Pallas twin): an image-style plot of a device array is
// normalised and looked up in the colormap's table on the card, and one
// byte a channel crosses to the host instead of the float64 field. For a
// field a of n values (float64 or float32, T):
//
//   lo = nanmin(a), hi = nanmax(a)       (NaN where every value is NaN)
//   hi2 = hi == lo ? lo + 1 : hi
//   t = (a - lo) / (hi2 - lo) * 255      (in T, each operation rounded)
//   idx = isfinite(t) ? (int)clamp(t, 0, 255) : 0
//   rgb[3 i + c] = lut[3 idx + c]
//
// lut is the colormap's 256 x 3 byte table, rounded once on the host in
// float32 as the JAX builder rounds it (runmat_tpu_torch/ops/cmap.py); the
// kernel only looks it up. Every subtraction, quotient and product is
// rounded apart (__dsub_rn, __ddiv_rn, __dmul_rn and their float forms:
// nvcc would otherwise be free to contract), so the image equals the plain
// version's (ops/cmap.py:plain_cmap) bit for bit.
//
// Two launches on the caller's stream, no host read between them:
//   1. cmap_range: each block takes the NaN-ignoring min and max of its
//      share (fmin/fmax, which return the other operand where one is NaN,
//      so the result is exact in any order), writes them as partials, and
//      counts itself at an unsigned counter with release semantics; the
//      block that arrives last (the tail, as in csrc/spcg.cu) reduces the
//      partials and writes lo, hi and hi2 to device memory, then resets
//      the counter for the next call.
//   2. cmap_map: reads lo and hi2 from device memory, stages the table in
//      shared memory and maps a tile of 1024 values a block a step, four a
//      thread, their colours staged in shared memory and stored as 16-byte
//      words.
//
// What bounds it on this card: bytes. The field is read once by each pass
// and the image written once: at 1080 x 1920 float64 the least traffic is
// 16.6 MB read and 6.2 MB written (6.8 us at 3.35 TB/s); the second read
// of a field that fits the 50 MB L2 comes mostly from there. The range
// pass keeps four 16-byte loads in flight a thread, at most 4 blocks of
// 256 threads an SM (fewer partials for the tail); every load and store of
// the map is a whole contiguous run of a warp.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;       // the map's grid, at most
constexpr int kRangeBlocksPerSm = 4;  // the range pass's grid, at most
constexpr int kAhead = 4;             // the range pass's loads in flight
constexpr int kTile = 4 * kThreads;   // values a block maps a step

__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T qnan() {
  return static_cast<T>(NAN);
}

// 16 bytes of T
template <typename T> struct Vec;
template <> struct Vec<double> {
  using type = double2;
  static constexpr int kN = 2;
  __device__ static void get(const type& v, double* o) { o[0] = v.x; o[1] = v.y; }
};
template <> struct Vec<float> {
  using type = float4;
  static constexpr int kN = 4;
  __device__ static void get(const type& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

// min and max over the block, NaN ignored; thread 0 gets them
template <typename T>
__device__ void block_range(T& lo, T& hi) {
  __shared__ T slo[kThreads / 32], shi[kThreads / 32];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = fmin(lo, __shfl_down_sync(0xffffffffu, lo, s));
    hi = fmax(hi, __shfl_down_sync(0xffffffffu, hi, s));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kThreads / 32 ? slo[lane] : qnan<T>();
    hi = lane < kThreads / 32 ? shi[lane] : qnan<T>();
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lo = fmin(lo, __shfl_down_sync(0xffffffffu, lo, s));
      hi = fmax(hi, __shfl_down_sync(0xffffffffu, hi, s));
    }
  }
}

// Called by every thread once thread 0 has stored the block's partials:
// thread 0 counts the block with release semantics; in the block that
// takes the last count it fences to acquire every block's partials. True
// in every thread of that block (csrc/spcg.cu's last_to_arrive).
__device__ bool last_to_arrive(unsigned* count) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.release.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(count) : "memory");
    last = prev == gridDim.x - 1;
    if (last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  return last;
}

// part[b] and part[nb + b]: block b's min and max. sc = (lo, hi, hi2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cmap_range(const T* __restrict__ a, int64_t n, int aligned, T* part,
           unsigned* count, T* sc) {
  using V = Vec<T>;
  T lo = qnan<T>(), hi = qnan<T>();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t done = 0;
  if (aligned) {
    const auto* av = reinterpret_cast<const typename V::type*>(a);
    const int64_t nv = n / V::kN;
    int64_t j = tid;
    // kAhead 16-byte loads in flight a thread
    for (; j + (kAhead - 1) * stride < nv; j += kAhead * stride) {
      typename V::type v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v[u] = __ldg(av + j + u * stride);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        T x[V::kN];
        V::get(v[u], x);
#pragma unroll
        for (int k = 0; k < V::kN; ++k) {
          lo = fmin(lo, x[k]);
          hi = fmax(hi, x[k]);
        }
      }
    }
    for (; j < nv; j += stride) {
      T x[V::kN];
      V::get(__ldg(av + j), x);
#pragma unroll
      for (int k = 0; k < V::kN; ++k) {
        lo = fmin(lo, x[k]);
        hi = fmax(hi, x[k]);
      }
    }
    done = nv * V::kN;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const T x = __ldg(a + i);
    lo = fmin(lo, x);
    hi = fmax(hi, x);
  }
  block_range(lo, hi);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = lo;
    part[gridDim.x + blockIdx.x] = hi;
  }
  if (!last_to_arrive(count)) return;
  // the tail: every block's partials, through L2 (written in this launch)
  lo = qnan<T>();
  hi = qnan<T>();
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    lo = fmin(lo, __ldcg(part + b));
    hi = fmax(hi, __ldcg(part + gridDim.x + b));
  }
  __syncthreads();   // block_range's shared arrays are reused
  block_range(lo, hi);
  if (threadIdx.x == 0) {
    sc[0] = lo;
    sc[1] = hi;
    sc[2] = hi == lo ? add_rn(lo, static_cast<T>(1)) : hi;
    *count = 0;
  }
}

template <typename T>
__device__ __forceinline__ int index_of(T x, T lo, T den) {
  const T t = mul_rn(div_rn(sub_rn(x, lo), den), static_cast<T>(255));
  if (!isfinite(t)) return 0;
  return static_cast<int>(fmin(fmax(t, static_cast<T>(0)),
                               static_cast<T>(255)));
}

// out[3 i + c] = lut[3 idx(a[i]) + c]. A block maps a tile of kTile values
// a step: each thread four, loaded so that every load instruction of a
// warp reads contiguous bytes, their colours staged in shared memory, then
// the tile's 3 kTile bytes stored as 16-byte words by the first 192
// threads. What is left (a field or image not 16-byte aligned, the last
// part-tile) goes a value a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cmap_map(const T* __restrict__ a, int64_t n, int aligned,
         const T* __restrict__ sc, const uint8_t* __restrict__ lut,
         uint8_t* __restrict__ out) {
  __shared__ uint32_t table[256];                  // r | g << 8 | b << 16
  __shared__ __align__(16) uint8_t stage[3 * kTile];
  for (int k = threadIdx.x; k < 256; k += kThreads)
    table[k] = lut[3 * k] | (lut[3 * k + 1] << 8) | (lut[3 * k + 2] << 16);
  const T lo = __ldcg(sc), den = sub_rn(__ldcg(sc + 2), lo);
  __syncthreads();
  const int t = threadIdx.x;
  const int64_t tiles = aligned ? n / kTile : 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const T* at = a + tile * kTile;
    T x[4];
    int e[4];   // each value's place in the tile
    if constexpr (sizeof(T) == 8) {
      const auto* av = reinterpret_cast<const double2*>(at);
      const double2 p = __ldcs(av + t), q = __ldcs(av + kThreads + t);
      x[0] = p.x; x[1] = p.y; x[2] = q.x; x[3] = q.y;
      e[0] = 2 * t; e[1] = 2 * t + 1;
      e[2] = 2 * kThreads + 2 * t; e[3] = 2 * kThreads + 2 * t + 1;
    } else {
      const float4 p = __ldcs(reinterpret_cast<const float4*>(at) + t);
      x[0] = p.x; x[1] = p.y; x[2] = p.z; x[3] = p.w;
      e[0] = 4 * t; e[1] = 4 * t + 1; e[2] = 4 * t + 2; e[3] = 4 * t + 3;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t c = table[index_of(x[k], lo, den)];
      stage[3 * e[k]] = static_cast<uint8_t>(c);
      stage[3 * e[k] + 1] = static_cast<uint8_t>(c >> 8);
      stage[3 * e[k] + 2] = static_cast<uint8_t>(c >> 16);
    }
    __syncthreads();
    if (t < 3 * kTile / 16)
      __stcs(reinterpret_cast<uint4*>(out + tile * (3 * kTile)) + t,
             reinterpret_cast<const uint4*>(stage)[t]);
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = tiles * kTile + static_cast<int64_t>(blockIdx.x) *
       kThreads + t; i < n; i += stride) {
    const uint32_t c = table[index_of(a[i], lo, den)];
    out[3 * i] = static_cast<uint8_t>(c);
    out[3 * i + 1] = static_cast<uint8_t>(c >> 8);
    out[3 * i + 2] = static_cast<uint8_t>(c >> 16);
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || v <= 0)
      v = 132;
    cached[device] = v;
  }
  return cached[device];
}

int capped(int64_t want, int64_t cap) {
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// the range pass's blocks for n values (counted at 8 bytes a value): about
// kAhead 16-byte loads a thread at least, so a thread has loads in flight
int range_blocks(int64_t n, int device) {
  return capped((n * 8 + kThreads * kAhead * 16 - 1) /
                    (kThreads * kAhead * 16),
                static_cast<int64_t>(sm_count(device)) * kRangeBlocksPerSm);
}

template <typename T>
cudaError_t launch(int64_t n, const void* a, void* part, void* count,
                   void* sc, const void* lut, void* out, int upto,
                   cudaStream_t stream, int device) {
  const int blocks = range_blocks(n, device);
  const T* x = static_cast<const T*>(a);
  const int aligned = (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
                      (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  cmap_range<T><<<blocks, kThreads, 0, stream>>>(
      x, n, aligned, static_cast<T*>(part), static_cast<unsigned*>(count),
      static_cast<T*>(sc));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || upto < 2) return err;
  const int map_blocks = capped((n + kTile - 1) / kTile,
                                static_cast<int64_t>(sm_count(device)) *
                                    kBlocksPerSm);
  cmap_map<T><<<map_blocks, kThreads, 0, stream>>>(
      x, n, aligned, static_cast<const T*>(sc),
      static_cast<const uint8_t*>(lut), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// The number of blocks the range pass launches for n values on `device`:
// the partials buffer holds two values a block.
extern "C" int runmat_cmap_blocks(int64_t n, int device) {
  return range_blocks(n, device);
}

// f64 != 0: a, part and sc are double, else float. a holds n > 0 values;
// part 2 * runmat_cmap_blocks(n) values; count one unsigned, 0 before the
// call and after it; sc three values (lo, hi, hi2); lut 768 bytes; out
// 3 n bytes. upto 1 runs the range pass only (for timing).
extern "C" int runmat_cmap(int f64, int64_t n, const void* a, void* part,
                           void* count, void* sc, const void* lut, void* out,
                           int upto, void* stream, int device) {
  if (n <= 0 || a == nullptr || part == nullptr || count == nullptr ||
      sc == nullptr || lut == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f64 ? launch<double>(n, a, part, count, sc, lut, out, upto, s, device)
          : launch<float>(n, a, part, count, sc, lut, out, upto, s, device);
  return static_cast<int>(err);
}
