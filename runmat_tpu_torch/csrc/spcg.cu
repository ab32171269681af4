// Sparse conjugate gradient on Hopper (sm_90a), bound through ctypes.
//
// Replaces what XLA compiled from runmat_tpu/sparse.py:_cg_device (234-288):
// a jax.jit of a lax.while_loop whose body is a BCOO product A @ p (a gather
// of p at the column indices, a multiply, a scatter-add into rows), three
// vdots and the vector updates of Jacobi-preconditioned CG, with the
// condition norm(r) > tol * norm(b) & k < maxit. No Pallas kernel; the
// port writes the loop by hand (runmat_tpu_torch/ops/spcg.py drives it).
//
// Four kernels, five launches an iteration:
//   spmv_f64      y = A p over a CSR (int64 row pointers, int32 columns,
//                 float64 values), one thread a row adding its products in
//                 ascending column order from 0, each product and sum
//                 rounded apart (the BCOO scatter-add's order); the block
//                 partials of p.y beside it.
//   cg_scalars    one block: the partials of all blocks summed in a fixed
//                 order, then alpha, or beta with k and the done flag.
//   cg_update     x += alpha p, r -= alpha Ap, z = invd r, the block partials
//                 of r.z and r.r.
//   cg_direction  p = z + beta p.
// Every kernel reads the done flag first and writes nothing once it is set,
// so a captured graph of many iterations may be replayed past convergence
// and leave x as the while-loop leaves it. No floating-point atomics: every
// sum has one order, so two solves agree bit for bit.
//
// What bounds it on this card: bytes. An iteration reads the CSR once
// (12 bytes a nonzero and 8 a row) and streams about a dozen float64
// vectors of n; its 2 nnz + ~12 n flops are far below the float64 rate.
// The design assumes few nonzeros a row (the 5-point Poisson rows hold 3-5):
// one thread walks its row, so a warp's loads of values and columns cover
// one contiguous stretch of the CSR a step. A row of thousands of nonzeros
// is right but walked by one thread; rows that long want a warp a row
// (a later design). The one-block cg_scalars reads blocks(n) partials
// (4096 at n = 2^20) twice an iteration.
//
// The launches use the caller's stream, allocate nothing and do not
// synchronise; the C entries return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // ops/spcg.py:THREADS

// cg_scalars' modes and the slots of the scalar state (ops/spcg.py)
enum Mode { kInit = 0, kAlpha = 1, kBeta = 2 };
enum Slot { kRz = 0, kBb = 1, kAlphaSlot = 2, kBetaSlot = 3, kRr = 4,
            kPap = 5 };

// The sum of each thread's v over the block, as a tree in a fixed order;
// every thread gets it. `sh` holds kThreads doubles.
__device__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      sh[threadIdx.x] = __dadd_rn(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

__device__ bool done(const int64_t* ctl) {
  return ctl != nullptr && ctl[0] != 0;
}

__global__ void __launch_bounds__(kThreads)
spmv_kernel(int64_t n, const int64_t* __restrict__ rowptr,
            const int32_t* __restrict__ col, const double* __restrict__ val,
            const double* __restrict__ p, double* __restrict__ y,
            double* __restrict__ part, const int64_t* ctl) {
  __shared__ double sh[kThreads];
  if (done(ctl)) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  double py = 0.0;
  if (i < n) {
    double acc = 0.0;
    const int64_t end = rowptr[i + 1];
    for (int64_t k = rowptr[i]; k < end; ++k)
      acc = __dadd_rn(acc, __dmul_rn(val[k], p[col[k]]));
    y[i] = acc;
    py = __dmul_rn(p[i], acc);
  }
  if (part != nullptr) {
    const double s = block_sum(py, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
update_kernel(int64_t n, int init, const double* __restrict__ sc,
              double* __restrict__ x, double* __restrict__ r,
              double* __restrict__ z, const double* __restrict__ p,
              const double* __restrict__ ap, const double* __restrict__ invd,
              double* __restrict__ part, const int64_t* ctl) {
  __shared__ double sh[kThreads];
  if (done(ctl)) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  double rz = 0.0, rr = 0.0;
  if (i < n) {
    double ri = r[i];
    if (!init) {
      const double alpha = sc[kAlphaSlot];
      x[i] = __dadd_rn(x[i], __dmul_rn(alpha, p[i]));
      ri = __dsub_rn(ri, __dmul_rn(alpha, ap[i]));
      r[i] = ri;
    }
    const double zi = __dmul_rn(invd[i], ri);
    z[i] = zi;
    rz = __dmul_rn(ri, zi);
    rr = __dmul_rn(ri, ri);
  }
  rz = block_sum(rz, sh);
  rr = block_sum(rr, sh);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = rz;
    part[gridDim.x + blockIdx.x] = rr;
  }
}

// One block. part: nb partials (alpha: p.Ap) or 2 nb (init, beta: r.z then
// r.r). The condition is the JAX package's, in norms: it decides the last
// iteration.
__global__ void __launch_bounds__(kThreads)
scalars_kernel(int mode, int64_t nb, const double* __restrict__ part,
               double* __restrict__ sc, int64_t* ctl, double tol,
               int64_t maxit) {
  __shared__ double sh[kThreads];
  if (done(ctl)) return;
  double a = 0.0, b = 0.0;
  for (int64_t j = threadIdx.x; j < nb; j += kThreads) {
    a = __dadd_rn(a, part[j]);
    if (mode != kAlpha) b = __dadd_rn(b, part[nb + j]);
  }
  a = block_sum(a, sh);
  b = block_sum(b, sh);
  if (threadIdx.x != 0) return;
  if (mode == kAlpha) {
    sc[kPap] = a;
    sc[kAlphaSlot] = __ddiv_rn(sc[kRz], a);
    return;
  }
  int64_t k = 0;
  if (mode == kInit) {
    sc[kBb] = b;
  } else {
    sc[kBetaSlot] = __ddiv_rn(a, sc[kRz]);
    k = ctl[1] + 1;
  }
  sc[kRz] = a;
  sc[kRr] = b;
  ctl[1] = k;
  const bool go = __dsqrt_rn(b) > __dmul_rn(tol, __dsqrt_rn(sc[kBb])) &&
                  k < maxit;
  ctl[0] = go ? 0 : 1;
}

__global__ void __launch_bounds__(kThreads)
direction_kernel(int64_t n, const double* __restrict__ sc,
                 const double* __restrict__ z, double* __restrict__ p,
                 const int64_t* ctl) {
  if (done(ctl)) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) p[i] = __dadd_rn(z[i], __dmul_rn(sc[kBetaSlot], p[i]));
}

unsigned grid(int64_t n) {
  return static_cast<unsigned>(n > 0 ? (n + kThreads - 1) / kThreads : 1);
}

bool rows_ok(int64_t n) {
  // int32 columns; a grid dimension of at most 2^31 - 1 blocks
  return n >= 0 && n < (int64_t{1} << 31);
}

}  // namespace

// y = A p (n rows; rowptr n + 1 int64, col int32, val float64, p and y n
// float64). part: grid(n) block partials of p.y, or null. ctl: the done
// flag [done, k] (int64), or null.
extern "C" int runmat_spmv_f64(int64_t n, const void* rowptr, const void* col,
                               const void* val, const void* p, void* y,
                               void* part, const void* ctl, void* stream,
                               int device) {
  if (!rows_ok(n)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  spmv_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int64_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const double*>(val), static_cast<const double*>(p),
      static_cast<double*>(y), static_cast<double*>(part),
      static_cast<const int64_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

// init != 0: z = invd r only (the start of a solve). part: 2 grid(n).
extern "C" int runmat_cg_update(int64_t n, int init, const void* sc, void* x,
                                void* r, void* z, const void* p,
                                const void* ap, const void* invd, void* part,
                                const void* ctl, void* stream, int device) {
  if (!rows_ok(n) || ctl == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  update_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, init, static_cast<const double*>(sc), static_cast<double*>(x),
      static_cast<double*>(r), static_cast<double*>(z),
      static_cast<const double*>(p), static_cast<const double*>(ap),
      static_cast<const double*>(invd), static_cast<double*>(part),
      static_cast<const int64_t*>(ctl));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int runmat_cg_scalars(int mode, int64_t nb, const void* part,
                                 void* sc, void* ctl, double tol,
                                 int64_t maxit, void* stream, int device) {
  if (mode < kInit || mode > kBeta || nb < 1 || ctl == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  scalars_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, nb, static_cast<const double*>(part), static_cast<double*>(sc),
      static_cast<int64_t*>(ctl), tol, maxit);
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
