// Sparse conjugate gradient on Hopper (sm_90a), bound through ctypes.
//
// Replaces what XLA compiled from runmat_tpu/sparse.py:_cg_device (234-288):
// a jax.jit of a lax.while_loop whose body is a BCOO product A @ p (a gather
// of p at the column indices, a multiply, a scatter-add into rows), three
// vdots and the vector updates of Jacobi-preconditioned CG, with the
// condition norm(r) > tol * norm(b) & k < maxit. No Pallas kernel; the
// port writes the loop by hand (runmat_tpu_torch/ops/spcg.py drives it).
//
// Three kernels, three launches an iteration:
//   spmv_f64      y = A p over a CSR (int64 row pointers, int32 columns,
//                 float64 values), one thread a row adding its products in
//                 ascending column order from 0, each product and sum
//                 rounded apart (the BCOO scatter-add's order); with
//                 partials, the partials of p.y a tile of 256 rows, and
//                 with a counter the alpha tail: p.Ap and alpha = r.z /
//                 p.Ap (sparse.py:265-266).
//   cg_update     x += alpha p, r -= alpha Ap, z = invd r, the tiles'
//                 partials of r.z and r.r; its tail: r.z, r.r, beta =
//                 (rn.zn) / (r.z), k + 1 and the done flag
//                 !(sqrt(r.r) > tol sqrt(b.b) && k < maxit) (267-270, 276).
//                 At a solve's start (init) z = invd r only, and the tail
//                 writes b.b, r.z, r.r, k = 0 and the flag.
//   cg_direction  p = z + beta p (271).
// Every kernel reads the done flag first and writes nothing once it is set,
// so a captured graph of many iterations may be replayed past convergence
// and leave x as the while-loop leaves it. No floating-point atomics: every
// sum has one order, so two solves agree bit for bit.
//
// The tails are the loop's scalar reductions and its condition
// (sparse.py:265-266, 267-270 and 276: the three vdots and the test). Each
// block stores its tiles' partials; its thread 0 counts the block in the
// kernel's unsigned arrival counter with an atomic add of release
// semantics; the block that takes the last count fences to acquire, reads
// all the partials back through L2 (__ldcg: other blocks wrote them in this
// launch), sums them, writes the scalars and resets the counter to 0, so
// the replays of a graph reuse it. What bounds a tail: the latency of the
// last block's loads and adds on one SM while the other 131 idle (one
// partial a tile of 256 rows, 4096 at n = 2^20), and each block's wait
// for its count to come back. What the design does: no launch of its own
// (the one-block cg_scalars kernel it replaces ran twice an iteration);
// one wave of blocks, each walking several tiles and counting itself once,
// so the counts' round trips are paid once a launch and not once a wave
// of tiles; and each thread of the last block has kAhead loads of partials
// in flight before it adds them in their order: thread t adds part[t],
// part[t + 256], ... from 0, then the block's tree (shared memory, then
// warp 0's shuffles, pairing the same values). That is the order
// cg_scalars took, so every sum, and x, stays what it was bit for bit;
// ops/spcg.py:ordered_sum is its model. A block that finds the done flag
// set returns before it counts itself; the flag changes only in
// cg_update's tail, after every block of that launch has arrived.
//
// What bounds the rest on this card: bytes. An iteration reads the CSR once
// (12 bytes a nonzero and 8 a row) and streams about a dozen float64
// vectors of n; its 2 nnz + ~12 n flops are far below the float64 rate.
// The design assumes few nonzeros a row (the 5-point Poisson rows hold 3-5):
// one thread walks its row, so a warp's loads of values and columns cover
// one contiguous stretch of the CSR a step. A row of thousands of nonzeros
// is right but walked by one thread; rows that long want a warp a row
// (a later design).
//
// The launches use the caller's stream, allocate nothing and do not
// synchronise; the C entries return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // ops/spcg.py:THREADS
constexpr int kAhead = 8;       // a tail's partial loads in flight a thread

// the slots of the scalar state (ops/spcg.py:SLOTS)
enum Slot { kRz = 0, kBb = 1, kAlpha = 2, kBeta = 3, kRr = 4, kPap = 5 };

// The sums over the block of each thread's v[c], as a tree in a fixed
// order: at s = 128, 64, ..., 1, value t += value t + s for t < s. The
// levels 128 and 64 go through shared memory, 32 to 1 through warp 0's
// registers and shuffles, which pair the same values (lane t takes lane
// t + s). Thread 0 gets the sums in v; `sh` holds K rows of kThreads
// doubles, free again after the next __syncthreads().
template <int K>
__device__ void block_sums(double (&v)[K], double (*sh)[kThreads]) {
  const unsigned t = threadIdx.x;
#pragma unroll
  for (int c = 0; c < K; ++c) sh[c][t] = v[c];
  __syncthreads();
  for (unsigned s = kThreads / 2; s > 32; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int c = 0; c < K; ++c) sh[c][t] = __dadd_rn(sh[c][t], sh[c][t + s]);
    }
    __syncthreads();
  }
  if (t >= 32) return;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    double a = __dadd_rn(sh[c][t], sh[c][t + 32]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      a = __dadd_rn(a, __shfl_down_sync(0xffffffffu, a, s));
    v[c] = a;
  }
}

__device__ bool done(const int64_t* ctl) {
  return ctl != nullptr && ctl[0] != 0;
}

// Called by every thread once thread 0 has stored the block's partials:
// thread 0 counts the block at `count` with release semantics (its stores
// are visible to whoever sees the count); in the block that takes the last
// count it then fences to acquire every block's partials. True in every
// thread of that block.
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

// s[c] = the sum of part[c nb + j] over j < nb in a fixed order: thread t
// adds part[t], part[t + kThreads], ... from 0, with kAhead loads a row in
// flight ahead of its adds, then the block's tree. Thread 0 gets them. The
// loads go through L2 (__ldcg): other blocks wrote the partials in this
// launch.
template <int K>
__device__ void ordered_sums(const double* part, int64_t nb,
                             double (*sh)[kThreads], double (&s)[K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) s[c] = 0.0;
  int64_t j = threadIdx.x;
  for (; j + (kAhead - 1) * kThreads < nb; j += kAhead * kThreads) {
    double v[K][kAhead];
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        v[c][u] = __ldcg(part + c * nb + j + u * kThreads);
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int u = 0; u < kAhead; ++u) s[c] = __dadd_rn(s[c], v[c][u]);
  }
  for (; j < nb; j += kThreads) {
#pragma unroll
    for (int c = 0; c < K; ++c)
      s[c] = __dadd_rn(s[c], __ldcg(part + c * nb + j));
  }
  block_sums<K>(s, sh);
}

// __launch_bounds__(kThreads, kBlocks): the tails may not take registers
// from the rows; 32 a thread keep 8 blocks, 2048 threads, on an SM. The
// product and the update launch at most kBlocks blocks an SM, each walking
// tiles of kThreads rows blockIdx.x, + gridDim.x, ...: a block counts
// itself once, after all its tiles, so the arrivals' round trips cost one
// wave of blocks, not one a tile. A tile's partial is the same tree of the
// same values whichever block takes it.
constexpr int kBlocks = 8;

__global__ void __launch_bounds__(kThreads, kBlocks)
spmv_kernel(int64_t n, int64_t nb, const int64_t* __restrict__ rowptr,
            const int32_t* __restrict__ col, const double* __restrict__ val,
            const double* __restrict__ p, double* __restrict__ y,
            double* part, double* sc, unsigned* count, const int64_t* ctl) {
  // two buffers, a tile's sums in each by turns: a tile's block_sums
  // passes a barrier after warp 0 has read the last tile's
  __shared__ double sh[2][1][kThreads];
  if (done(ctl)) return;
  int turn = 0;
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x, turn ^= 1) {
    const int64_t i = b * kThreads + threadIdx.x;
    double py[1] = {0.0};
    if (i < n) {
      double acc = 0.0;
      const int64_t end = rowptr[i + 1];
      for (int64_t k = rowptr[i]; k < end; ++k)
        acc = __dadd_rn(acc, __dmul_rn(val[k], p[col[k]]));
      y[i] = acc;
      py[0] = __dmul_rn(p[i], acc);
    }
    if (part == nullptr) continue;
    block_sums<1>(py, sh[turn]);
    if (threadIdx.x == 0) part[b] = py[0];
  }
  if (count == nullptr || !last_to_arrive(count)) return;
  const double rz = threadIdx.x == 0 ? sc[kRz] : 0.0;   // ahead of the sum
  double pap[1];
  ordered_sums<1>(part, nb, sh[0], pap);
  if (threadIdx.x != 0) return;
  sc[kPap] = pap[0];
  sc[kAlpha] = __ddiv_rn(rz, pap[0]);
  *count = 0;
}

__global__ void __launch_bounds__(kThreads, kBlocks)
update_kernel(int64_t n, int64_t nb, int init, double* sc,
              double* __restrict__ x, double* __restrict__ r,
              double* __restrict__ z, const double* __restrict__ p,
              const double* __restrict__ ap, const double* __restrict__ invd,
              double* part, unsigned* count, int64_t* ctl, double tol,
              int64_t maxit) {
  __shared__ double sh[2][2][kThreads];   // as in spmv_kernel
  if (done(ctl)) return;
  const double alpha = init ? 0.0 : sc[kAlpha];
  int turn = 0;
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x, turn ^= 1) {
    const int64_t i = b * kThreads + threadIdx.x;
    double dots[2] = {0.0, 0.0};   // r.z, r.r
    if (i < n) {
      const double di = invd[i];
      double ri = r[i];
      if (!init) {
        const double xi = x[i], pi = p[i], api = ap[i];
        x[i] = __dadd_rn(xi, __dmul_rn(alpha, pi));
        ri = __dsub_rn(ri, __dmul_rn(alpha, api));
        r[i] = ri;
      }
      const double zi = __dmul_rn(di, ri);
      z[i] = zi;
      dots[0] = __dmul_rn(ri, zi);
      dots[1] = __dmul_rn(ri, ri);
    }
    block_sums<2>(dots, sh[turn]);
    if (threadIdx.x == 0) {
      part[b] = dots[0];
      part[nb + b] = dots[1];
    }
  }
  if (count == nullptr || !last_to_arrive(count)) return;
  double rz = 0.0, bb = 0.0;   // thread 0, ahead of the sums
  int64_t k = 0;
  if (threadIdx.x == 0) {
    rz = sc[kRz];
    bb = sc[kBb];
    k = ctl[1];
  }
  double s[2];   // r.z, r.r
  ordered_sums<2>(part, nb, sh[0], s);
  if (threadIdx.x != 0) return;
  if (init) {
    bb = s[1];
    sc[kBb] = bb;
    k = 0;
  } else {
    sc[kBeta] = __ddiv_rn(s[0], rz);
    k += 1;
  }
  sc[kRz] = s[0];
  sc[kRr] = s[1];
  ctl[1] = k;
  const bool go =
      __dsqrt_rn(s[1]) > __dmul_rn(tol, __dsqrt_rn(bb)) && k < maxit;
  ctl[0] = go ? 0 : 1;
  *count = 0;
}

__global__ void __launch_bounds__(kThreads)
direction_kernel(int64_t n, const double* __restrict__ sc,
                 const double* __restrict__ z, double* __restrict__ p,
                 const int64_t* ctl) {
  if (done(ctl)) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) p[i] = __dadd_rn(z[i], __dmul_rn(sc[kBeta], p[i]));
}

// kThreads-row tiles of n rows: the count of block partials
int64_t tiles(int64_t n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

unsigned grid(int64_t n) { return static_cast<unsigned>(tiles(n)); }

// A wave of blocks, at most: kBlocks an SM, no more than there are tiles.
cudaError_t wave(int64_t n, int device, unsigned* out) {
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t most = static_cast<int64_t>(sms) * kBlocks;
  *out = static_cast<unsigned>(tiles(n) < most ? tiles(n) : most);
  return cudaSuccess;
}

bool rows_ok(int64_t n) {
  // int32 columns; a grid dimension of at most 2^31 - 1 blocks
  return n >= 0 && n < (int64_t{1} << 31);
}

}  // namespace

// y = A p (n rows; rowptr n + 1 int64, col int32, val float64, p and y n
// float64). part: tiles(n) partials of p.y, one a tile of kThreads rows,
// or null. count: the arrival counter (one unsigned, 0 between launches)
// for the alpha tail, which writes sc's p.Ap and alpha, or null for no
// tail. ctl: the done flag [done, k] (int64), or null.
extern "C" int runmat_spmv_f64(int64_t n, const void* rowptr, const void* col,
                               const void* val, const void* p, void* y,
                               void* part, void* sc, void* count,
                               const void* ctl, void* stream, int device) {
  if (!rows_ok(n) || (count != nullptr && (part == nullptr || sc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  unsigned blocks = 0;
  const cudaError_t sized = wave(n, device, &blocks);
  if (sized != cudaSuccess) return static_cast<int>(sized);
  spmv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, tiles(n), static_cast<const int64_t*>(rowptr),
      static_cast<const int32_t*>(col),
      static_cast<const double*>(val), static_cast<const double*>(p),
      static_cast<double*>(y), static_cast<double*>(part),
      static_cast<double*>(sc), static_cast<unsigned*>(count),
      static_cast<const int64_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

// init != 0: z = invd r only (the start of a solve). part: 2 tiles(n).
// count: the arrival counter for the tail (beta, k and the flag; at init
// b.b, k = 0 and the flag), or null for none.
extern "C" int runmat_cg_update(int64_t n, int init, void* sc, void* x,
                                void* r, void* z, const void* p,
                                const void* ap, const void* invd, void* part,
                                void* count, void* ctl, double tol,
                                int64_t maxit, void* stream, int device) {
  if (!rows_ok(n) || ctl == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  unsigned blocks = 0;
  const cudaError_t sized = wave(n, device, &blocks);
  if (sized != cudaSuccess) return static_cast<int>(sized);
  update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, tiles(n), init, static_cast<double*>(sc), static_cast<double*>(x),
      static_cast<double*>(r), static_cast<double*>(z),
      static_cast<const double*>(p), static_cast<const double*>(ap),
      static_cast<const double*>(invd), static_cast<double*>(part),
      static_cast<unsigned*>(count), static_cast<int64_t*>(ctl), tol, maxit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int runmat_cg_direction(int64_t n, const void* sc, const void* z,
                                   void* p, const void* ctl, void* stream,
                                   int device) {
  if (!rows_ok(n) || ctl == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  direction_kernel<<<grid(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const double*>(sc), static_cast<const double*>(z),
      static_cast<double*>(p), static_cast<const int64_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}
