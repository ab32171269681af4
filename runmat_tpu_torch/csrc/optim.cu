// The optimizer update (K2) on Hopper (sm_90a), bound through ctypes.
//
// Replaces what XLA compiled from the tree_maps of adam_step and sgdm_step
// in runmat_tpu/runtime/builtins/dl_layers.py:629-644 (no Pallas twin):
// every leaf of the learnables updated in one jitted step. The port keeps
// the learnables p, their gradient g and the moments m and v each as one
// flat float32 buffer (runmat_tpu_torch/ops/optim.py drives the kernel),
// and updates them in one launch, in the JAX order of operations:
//
//   Adam:  m = b1 m + (1 - b1) g
//          v = b2 v + ((1 - b2) g) g
//          p = p - (lr (m / c1)) / (sqrt(v / c2) + eps)
//   SGDM:  m = 0.9 m + g
//          p = p - lr m
//
// with c1 = (float)(1 - 0.9^t) and c2 = (float)(1 - 0.999^t) formed in
// float64 by CUDA's pow(double, double), the routine torch's pow calls on
// the card. Every product, sum, quotient and square root is rounded apart
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nvcc would
// otherwise contract a product and a sum into an FFMA), as ops/optim.py:
// plain_update's separate torch ops compute them, so the kernel equals it
// bit for bit.
//
// The step count t (a float64 in device memory, so a captured CUDA graph of
// the training step replays the right bias correction) advances inside the
// launch, so the step needs no launch of its own for it. SGDM reads t
// nowhere else: thread 0 of block 0 adds one. Adam's blocks all need this
// launch's count, and none may take another's advance for it: each
// block's thread 0 loads t, then adds a share to it (a relaxed load and a
// relaxed reduction of the same address, so in that order), and takes the
// count as floor(what it loaded) + 1. The shares are 2^-d (d the least
// with blocks <= 2^d) and, for block 0, what makes them sum to 1: every
// partial sum is exact (t below 2^(52 - d)), a block loads t plus less than
// one whatever the order, and t holds t + 1 after the launch. t holds a
// whole number between launches. No block waits for another or for its
// reduction, and nothing is reset. (Two designs measured slower, PERF.md:
// a last-block counter, the pattern of csrc/spcg.cu, whose release fence
// came before every block's pows, and an atomic add whose old value gave
// the count, whose round trip every block waited for.)
//
// What bounds it on this card: at the paths' 21,690 and 46,109 learnables
// the bytes (SGDM 20 an element, Adam 28) take 0.13-0.39 us at 3.35 TB/s,
// below a launch's fixed cost (~2 us back to back), so latency sets the
// time: a thread's chain of IEEE divisions and square root, which a
// thread's elements do not overlap, and Adam's load of t, its two pows and
// a barrier. What the design does: one element a thread (at four, through
// 16-byte loads, a thread's chain is four elements long, and Adam measured
// 5.0-5.8 us against 3.2, PERF.md), the element loads issued before the
// pows, which
// lanes 0 and 1 of the first warp evaluate side by side once a block (PR
// 15's Triton kernel evaluated both in every thread before its first
// quotient, at eight elements a thread: 9.1 us), and blocks of 512 threads,
// 91 for Adam's 46,109, so 91 shares are added to t.
//
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr double kB1 = 0.9;     // Adam's beta1, the bias correction's base
constexpr double kB2 = 0.999;   // beta2
constexpr int kThreads = 512;   // a block's threads

// Lane k (0 or 1) of the first warp: (float)(1 - b^s), b = kB1 or kB2.
__device__ float correction(int k, double s) {
  return __double2float_rn(__dsub_rn(1.0, pow(k == 0 ? kB1 : kB2, s)));
}

// A thread: element i of n, i its index in the grid. t advances by one in
// this launch (Adam: block b adds `first` if b is 0, else `share`).
template <bool kAdam>
__global__ void optim_kernel(int64_t n, float* p, const float* g, float* m,
                             float* v, double* t, double share, double first,
                             float lr, float b1, float omb1, float b2,
                             float omb2, float eps) {
  __shared__ float corr[2];
  // Adam: the step count first, so its load and the element loads are in
  // flight together. The block then adds its share to t, which no one
  // waits for: its load came first (one thread, one address), so it saw t
  // plus other blocks' shares only, less than one.
  double s = 0.0;
  if (kAdam && threadIdx.x == 0) {
    asm volatile("ld.relaxed.gpu.f64 %0, [%1];"
                 : "=d"(s) : "l"(t) : "memory");
    asm volatile("red.relaxed.gpu.add.f64 [%0], %1;"
                 :: "l"(t), "d"(blockIdx.x == 0 ? first : share)
                 : "memory");
    s = __dadd_rn(floor(s), 1.0);
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool in = i < n;
  float pv = 0.f, gv = 0.f, mv = 0.f, vv = 0.f;
  // the element loads before the bias corrections' pows
  if (in) {
    pv = p[i];
    gv = g[i];
    mv = m[i];
    if (kAdam) vv = v[i];
  }
  if (kAdam) {
    if (threadIdx.x < 2) {
      s = __shfl_sync(0x3u, s, 0);
      corr[threadIdx.x] = correction(threadIdx.x, s);
    }
    __syncthreads();
    const float c1 = corr[0], c2 = corr[1];
    mv = __fadd_rn(__fmul_rn(b1, mv), __fmul_rn(omb1, gv));
    vv = __fadd_rn(__fmul_rn(b2, vv), __fmul_rn(__fmul_rn(omb2, gv), gv));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), eps);
    pv = __fsub_rn(pv, __fdiv_rn(__fmul_rn(lr, __fdiv_rn(mv, c1)), den));
  } else {
    // SGDM reads t nowhere else: one thread advances it
    if (blockIdx.x == 0 && threadIdx.x == 0)
      t[0] = __dadd_rn(__ldcg(t), 1.0);
    mv = __fadd_rn(__fmul_rn(b1, mv), gv);
    pv = __fsub_rn(pv, __fmul_rn(lr, mv));
  }
  if (in) {
    p[i] = pv;
    m[i] = mv;
    if (kAdam) v[i] = vv;
  }
}

}  // namespace

// adam != 0: Adam (v needed), else SGDM (b1 the momentum; v, omb1, b2,
// omb2, eps unused). The launch advances t by one: one block at least, so
// t advances at n = 0 too.
extern "C" int runmat_optim_update(int adam, int64_t n, void* p, const void* g,
                                   void* m, void* v, void* t, float lr,
                                   float b1, float omb1, float b2, float omb2,
                                   float eps, void* stream, int device) {
  if (n < 0 || p == nullptr || g == nullptr || m == nullptr ||
      t == nullptr || (adam && v == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = n == 0 ? 1 : (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto b = static_cast<unsigned>(blocks);
  // the blocks' shares of Adam's advance: 2^-d for a block, d the least
  // with blocks <= 2^d, and what makes them 1 for block 0. Each is a
  // multiple of 2^-d, so every partial sum t + k 2^-d is exact (t below
  // 2^(52 - d)) in whatever order the blocks add, and t + 1 after all.
  int d = 0;
  while ((1ull << d) < b) ++d;
  const double share = ldexp(1.0, -d);
  const double first = 1.0 - static_cast<double>(b - 1) * share;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fp = static_cast<float*>(p);
  const auto* fg = static_cast<const float*>(g);
  auto* fm = static_cast<float*>(m);
  auto* fv = static_cast<float*>(v);
  auto* dt = static_cast<double*>(t);
  if (adam)
    optim_kernel<true><<<b, kThreads, 0, s>>>(n, fp, fg, fm, fv, dt, share,
                                              first, lr, b1, omb1, b2, omb2,
                                              eps);
  else
    optim_kernel<false><<<b, kThreads, 0, s>>>(n, fp, fg, fm, fv, dt, share,
                                               first, lr, b1, omb1, b2, omb2,
                                               eps);
  return static_cast<int>(cudaGetLastError());
}
