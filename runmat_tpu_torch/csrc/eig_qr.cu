// The general (nonsymmetric) eigenproblem on Hopper (sm_90a), bound through
// ctypes: three kernels, each a loop of runmat_tpu/accel/eig_qr.py.
//
// The JAX package runs a real nonsymmetric eig as one XLA program (no
// Pallas twin): balance, Hessenberg reduction, Francis QR, the read-off of
// the quasi-triangular T and, for [V, D], the eigenvectors of T. Balancing,
// the read-off and V = D Q Z Y stay torch ops (runmat_tpu_torch/accel/
// eig_qr.py); the three loops are here (runmat_tpu_torch/ops/eig_qr.py
// drives them and holds their plain versions):
//
//   eig_hess     hessenberg / hessenberg_q (eig_qr.py:48-80, 108-141): n - 2
//                Householder steps on the n x n H (and Q), each four
//                dependent passes: v from column k (scaled by its largest
//                magnitude, then normalised), H -= 2 v (v'H), H -= 2 (Hv) v',
//                column k below the subdiagonal set to exact zeros, and
//                Q -= 2 (Qv) v'. One cooperative launch: every block
//                computes v itself from column k (no barrier for it) and
//                keeps that column in shared memory; the column pass gives
//                each block tiles of 32 columns from k + 1 (lane = column,
//                the 8 warps share the rows, their partial sums added in
//                warp order), so v'H and its update need no barrier between
//                them, and no block writes column k while another reads it;
//                a grid barrier; the row pass gives each warp rows (lanes
//                over the columns), Hv, its update, Q's row and column k's
//                entry: the new subdiagonal, from the kept column, in the
//                row k + 1, exact zeros below it; a grid barrier. H and Q
//                are read through L2 (__ldcg): other blocks wrote them
//                before the barrier.
//   eig_francis  francis_qr_z (eig_qr.py:151-284): the whole while-loop in
//                one block of 1024 threads, no host read: the lo scan (a
//                block max), the branch among deflating one, deflating two,
//                skipping a converged 1x1/2x2 block and a sweep (thread 0),
//                the shifts with the exceptional shift every 10 stalls, the
//                chase of 3x3 reflectors, the exact zeros restored below the
//                subdiagonal of the active window, and the 40 n + 100
//                iteration safeguard. A bulge position is one block
//                barrier: thread 0 applies P to the bulge itself (rows
//                k..k+2 of columns k..k+2, then rows k..min(k+3, hi) of
//                those columns) and forms the next P from the new H[k+1..
//                k+3, k]; beside it, warps 1-31 apply P to rows k..k+2 of
//                the other columns from k-1 rightwards, to columns k..k+2
//                of the rows above the bulge and to Z's columns k..k+2,
//                each thread loading its items before it stores any.
//                Neither side reads what the other writes. Z is kept
//                transposed, so its three columns are contiguous rows.
//                It writes [ok, iterations, chain] to device memory, the
//                chain being the sum of the sweeps' lengths. Outside
//                dlahqr's window the JAX version's whole-width products
//                only add exact zeros and O(eps) bulge remnants that never
//                reach the window: within it the sums are the same ones,
//                and the remnants' band (two and three below the
//                diagonal) is what the restore clears.
//   eig_trevc    trevc (eig_qr.py:362-482): the back-substitution of each
//                eigen-column is independent of the others (the JAX full
//                matvec T[i,:] @ Y picks up only settled rows of the same
//                column), so a warp takes a column: its seed chosen by
//                norm, rows n-1..0 walked with the smin replacement of a
//                vanishing denominator (dtrevc's) and Cramer's rule for the
//                rows of a 2x2 block. The column is written as a row of
//                yt (coalesced), which the wrapper returns transposed.
//
// Every product, sum, quotient and square root is rounded apart
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn, __dsqrt_rn: nvcc would
// otherwise contract a * b + c into an FMA), in the plain version's order.
// eig_francis equals plain_francis on the same H: its scalars are the
// plain version's Python floats, its reflector products the plain
// version's left-to-right torch sums, and the Frobenius norm that sets the
// deflation floor comes in from the same torch call. eig_hess and
// eig_trevc sum their long dot products in their own fixed order, so they
// agree with the plain versions (torch.matmul) within rounding.
//
// What bounds them on this card: not bytes (H is 2 MB at n = 512 and stays
// in the 50 MB L2) and not the float64 rate (about 10/3 n^3 operations
// for the reduction, 10 n^3 for the QR, n^3 for trevc: 2-20 microseconds
// at 67 TFLOP/s), but dependent chains: the reduction's 2 (n - 2)
// grid barriers, the QR's sweep positions (each thread 0's bulge and
// reflector beside the block's pass, a barrier, and the L2 round trips of
// both), and trevc's n dependent rows a column.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr double kEps = 2.220446049250313e-16;
constexpr double kEps4 = 4.0 * kEps;   // the absolute deflation floor's
constexpr double kEps8 = 8.0 * kEps;   // the relative deflation test's
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHessThreads = 256;
constexpr int kHessWarps = kHessThreads / 32;
constexpr int kFrancisThreads = 1024;
constexpr int kTrevcWarps = 4;

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// jnp.maximum: NaN if either is NaN
__device__ __forceinline__ double maxnan(double a, double b) {
  return (a != a || a > b) ? a : b;
}
// jnp.sign of a nonzero value (NaN stays NaN)
__device__ __forceinline__ double sgn(double t) {
  return t > 0 ? 1.0 : (t < 0 ? -1.0 : t);
}

// ----------------------------------------------------------- eig_hess

// A grid barrier for a cooperative launch (every block resident): the
// count only grows within a launch (the C entry zeroes it first), barrier
// b of the launch waits for b * gridDim.x arrivals.
__device__ __forceinline__ void grid_sync(unsigned long long* count,
                                          unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned long long seen;
    asm volatile("atom.release.gpu.add.u64 %0, [%1], 1;"
                 : "=l"(seen) : "l"(count) : "memory");
    seen += 1;
    while (seen < target)
      asm volatile("ld.acquire.gpu.u64 %0, [%1];"
                   : "=l"(seen) : "l"(count) : "memory");
    __threadfence();
  }
  __syncthreads();
}

// Sum (max) over the block's kHessThreads threads, the same in every thread:
// each warp's tree, then the warps' results in warp order.
__device__ double hess_sum(double x, double* scratch) {
  for (int s = 16; s > 0; s >>= 1) x = add(x, __shfl_down_sync(kFull, x, s));
  __syncthreads();
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = scratch[0];
    for (int w = 1; w < kHessWarps; ++w) t = add(t, scratch[w]);
    scratch[kHessWarps] = t;
  }
  __syncthreads();
  return scratch[kHessWarps];
}

__device__ double hess_max(double x, double* scratch) {
  for (int s = 16; s > 0; s >>= 1)
    x = maxnan(x, __shfl_down_sync(kFull, x, s));
  __syncthreads();
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = scratch[0];
    for (int w = 1; w < kHessWarps; ++w) t = maxnan(t, scratch[w]);
    scratch[kHessWarps] = t;
  }
  __syncthreads();
  return scratch[kHessWarps];
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int s = 16; s > 0; s >>= 1) x = add(x, __shfl_down_sync(kFull, x, s));
  return __shfl_sync(kFull, x, 0);
}

// H (n x n, row-major) reduced in place; Q (n x n, the identity on entry)
// accumulated unless null. bar: the barrier's count, 0 on entry.
__global__ void __launch_bounds__(kHessThreads)
eig_hess(double* __restrict__ H, double* __restrict__ Q, int n,
         unsigned long long* bar) {
  extern __shared__ double v[];                  // the reflector, n values
  double* const col = v + n;                     // column k as read, n more
  __shared__ double scratch[kHessWarps + 1];
  __shared__ double part[kHessWarps][32];
  __shared__ double wcol[32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const unsigned long long nb = gridDim.x;
  unsigned long long target = 0;
  for (int k = 0; k < n - 2; ++k) {
    // v from column k, in every block
    double m = 0.0;
    for (int i = t; i < n; i += kHessThreads) {
      const double x = i > k ? __ldcg(H + static_cast<size_t>(i) * n + k)
                             : 0.0;
      v[i] = x;
      col[i] = x;
      m = maxnan(m, fabs(x));
    }
    const double mx = hess_max(m, scratch);
    const double mxs = mx == 0 ? 1.0 : mx;
    double ss = 0.0;
    for (int i = k + 1 + t; i < n; i += kHessThreads) {
      const double x = quo(v[i], mxs);
      v[i] = x;
      ss = add(ss, mul(x, x));
    }
    const double nrm = root(hess_sum(ss, scratch));
    const double x1 = v[k + 1];
    const double alpha = mul(-sgn(x1 == 0 ? 1.0 : x1), nrm);
    __syncthreads();                         // every thread has read x1
    double vv = 0.0;
    for (int i = k + 1 + t; i < n; i += kHessThreads) {
      const double x = i == k + 1 ? sub(x1, alpha) : v[i];
      v[i] = x;
      vv = add(vv, mul(x, x));
    }
    const double vn2 = hess_sum(vv, scratch);
    const bool safe = vn2 > 0;
    const double r = root(safe ? vn2 : 1.0);
    for (int i = t; i < n; i += kHessThreads)
      v[i] = (safe && i > k) ? quo(v[i], r) : 0.0;
    __syncthreads();
    // column k's v'H, from the kept column, in the block whose row pass
    // takes row k + 1 (the rows' order below)
    const int warps = gridDim.x * kHessWarps;
    const bool owner = (k + 1) % warps / kHessWarps == blockIdx.x;
    double wk = 0.0;
    if (owner) {
      double p = 0.0;
      for (int i = k + 1 + t; i < n; i += kHessThreads)
        p = add(p, mul(v[i], col[i]));
      wk = hess_sum(p, scratch);
    }

    // H -= 2 v (v'H): tiles of 32 columns from column k + 1 (v'H is 0 left
    // of k; column k is the row pass's), rows below k (v is 0 elsewhere)
    const int tiles = (n - k - 1 + 31) / 32;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int j = k + 1 + 32 * tile + lane;
      double p = 0.0;
      if (j < n)
        for (int i = k + 1 + warp; i < n; i += kHessWarps)
          p = add(p, mul(v[i], __ldcg(H + static_cast<size_t>(i) * n + j)));
      part[warp][lane] = p;
      __syncthreads();
      if (warp == 0) {
        double w = part[0][lane];
        for (int q = 1; q < kHessWarps; ++q) w = add(w, part[q][lane]);
        wcol[lane] = w;
      }
      __syncthreads();
      const double w = wcol[lane];
      if (j < n)
        for (int i = k + 1 + warp; i < n; i += kHessWarps) {
          double* h = H + static_cast<size_t>(i) * n + j;
          *h = sub(__ldcg(h), mul(2.0, mul(v[i], w)));
        }
      __syncthreads();
    }
    target += nb;
    grid_sync(bar, target);

    // H -= 2 (Hv) v' and Q -= 2 (Qv) v': a warp a row, columns right of k;
    // column k: H[k+1, k] -= 2 v[k+1] (v'H)[k], zeros below
    for (int i = blockIdx.x * kHessWarps + warp; i < n; i += warps) {
      double* hrow = H + static_cast<size_t>(i) * n;
      double u = 0.0;
      for (int j = k + 1 + lane; j < n; j += 32)
        u = add(u, mul(__ldcg(hrow + j), v[j]));
      u = warp_sum(u);
      for (int j = k + 1 + lane; j < n; j += 32)
        hrow[j] = sub(__ldcg(hrow + j), mul(2.0, mul(u, v[j])));
      if (lane == 0 && i > k + 1) hrow[k] = 0.0;
      if (lane == 0 && i == k + 1)
        hrow[k] = sub(col[k + 1], mul(2.0, mul(v[k + 1], wk)));
      if (Q != nullptr) {
        double* qrow = Q + static_cast<size_t>(i) * n;
        double uq = 0.0;
        for (int j = k + 1 + lane; j < n; j += 32)
          uq = add(uq, mul(__ldcg(qrow + j), v[j]));
        uq = warp_sum(uq);
        for (int j = k + 1 + lane; j < n; j += 32)
          qrow[j] = sub(__ldcg(qrow + j), mul(2.0, mul(uq, v[j])));
      }
    }
    target += nb;
    grid_sync(bar, target);
  }
}

// ----------------------------------------------------------- eig_francis

// |H[i, i-1]| <= 8 eps (|H[i-1, i-1]| + |H[i, i]|) or <= floor
__device__ __forceinline__ bool sub_small(const double* H, int N, int i,
                                          double floor) {
  double a = add(fabs(H[(i - 1) * N + i - 1]), fabs(H[i * N + i]));
  if (a == 0) a = 1.0;
  const double s = fabs(H[i * N + i - 1]);
  return s <= mul(kEps8, a) || s <= floor;
}

// P = I - 2 v v' (row-major), the reflector of (x, y, z) (eig_qr.py:_house3)
__device__ void house3(double x, double y, double z, bool use3, double* P) {
  if (!use3) z = 0.0;
  const double m = maxnan(maxnan(fabs(x), fabs(y)), fabs(z));
  const double ms = m == 0 ? 1.0 : m;
  x = quo(x, ms);
  y = quo(y, ms);
  z = quo(z, ms);
  const double nrm = root(add(add(mul(x, x), mul(y, y)), mul(z, z)));
  const double alpha = mul(-sgn(x == 0 ? 1.0 : x), nrm);
  const double u[3] = {sub(x, alpha), y, z};
  const double un2 = add(add(mul(u[0], u[0]), mul(u[1], u[1])),
                         mul(u[2], u[2]));
  double v[3] = {0.0, 0.0, 0.0};
  if (un2 > 0 && m > 0) {
    const double r = root(un2);
    for (int q = 0; q < 3; ++q) v[q] = quo(u[q], r);
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      P[3 * r + c] = sub(r == c ? 1.0 : 0.0, mul(2.0, mul(v[r], v[c])));
}

__device__ __forceinline__ double dot3(double a0, double a1, double a2,
                                       double b0, double b1, double b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// out[0..2] = v[0..2] @ P: one row of three columns, loaded as v
__device__ __forceinline__ void col3(double* out, const double* v,
                                     const double* P) {
  out[0] = dot3(v[0], v[1], v[2], P[0], P[3], P[6]);
  out[1] = dot3(v[0], v[1], v[2], P[1], P[4], P[7]);
  out[2] = dot3(v[0], v[1], v[2], P[2], P[5], P[8]);
}

// The iteration on the padded N x N H (N = n + 3, row-major), Z (N x N,
// the identity on entry, transposed: row c is Z's column c) accumulated
// unless null. info: [ok, iterations, chain].
__global__ void __launch_bounds__(kFrancisThreads)
eig_francis(double* __restrict__ H, double* __restrict__ Z, int n,
            int max_iters, const double* __restrict__ hfro,
            long long* __restrict__ info) {
  __shared__ int wbest[kFrancisThreads / 32];
  __shared__ int s_lo, s_branch, s_hi;
  __shared__ double s_P[2][9];
  const int N = n + 3, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const double floor = mul(kEps4, *hfro);
  int hi = n - 1, stall = 0, it = 0;
  long long chain = 0;
  while (hi >= 1 && it < max_iters) {
    // the largest i in 1..hi whose subdiagonal is negligible, else 0
    int best = 0;
    for (int i = 1 + t; i <= hi; i += kFrancisThreads)
      if (sub_small(H, N, i, floor)) best = i;
    for (int s = 16; s > 0; s >>= 1)
      best = max(best, __shfl_down_sync(kFull, best, s));
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (t == 0) {
      int lo = 0;
      for (int w = 0; w < kFrancisThreads / 32; ++w) lo = max(lo, wbest[w]);
      if (lo > 0) H[lo * N + lo - 1] = 0.0;
      int b, nh = hi;
      if (sub_small(H, N, hi, floor)) {
        b = 0;
        H[hi * N + hi - 1] = 0.0;
        nh = hi - 1;
      } else if (hi - 2 >= lo && sub_small(H, N, hi - 1, floor)) {
        b = 1;
        H[(hi - 1) * N + hi - 2] = 0.0;
        nh = hi - 2;
      } else if (hi - lo <= 1) {
        b = 2;
        nh = lo - 1;
      } else {
        b = 3;
        const double t11 = H[(hi - 1) * N + hi - 1], t12 = H[(hi - 1) * N + hi];
        const double t21 = H[hi * N + hi - 1], t22 = H[hi * N + hi];
        double s = add(t11, t22);
        double p = sub(mul(t11, t22), mul(t12, t21));
        if (stall > 0 && stall % 10 == 0) {     // the exceptional shift
          const double ssum = add(fabs(t21), fabs(H[(hi - 1) * N + hi - 2]));
          const double e = add(t22, mul(0.75, ssum));
          s = mul(2.0, e);
          p = mul(e, e);
        }
        const double h11 = H[lo * N + lo], h12 = H[lo * N + lo + 1];
        const double h21 = H[(lo + 1) * N + lo];
        const double h22 = H[(lo + 1) * N + lo + 1];
        const double h32 = H[(lo + 2) * N + lo + 1];
        house3(add(sub(add(mul(h11, h11), mul(h12, h21)), mul(s, h11)), p),
               mul(h21, sub(add(h11, h22), s)), mul(h32, h21), true, s_P[0]);
      }
      s_lo = lo;
      s_branch = b;
      s_hi = nh;
    }
    __syncthreads();
    if (s_branch == 3) {
      const int lo = s_lo;
      for (int k = lo; k < hi; ++k) {
        const int cur = (k - lo) & 1;        // s_P[cur] is position k's P
        double P[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) P[q] = s_P[cur][q];
        if (t == 0) {
          // the bulge: rows k..k+2 of columns k..k+2 (P @ R), then rows
          // k..min(k+3, hi) of those columns (C @ P), and the next
          // position's reflector from the new H[k+1..k+3, k]
          const int last = k + 3 < hi ? k + 3 : hi;
          double b[4][3];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < 3 || k + q <= last)
#pragma unroll
              for (int e = 0; e < 3; ++e) b[q][e] = H[(k + q) * N + k + e];
          double rr[3][3];
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int e = 0; e < 3; ++e)
              rr[q][e] = dot3(b[0][e], b[1][e], b[2][e], P[3 * q],
                              P[3 * q + 1], P[3 * q + 2]);
          double x[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            double* h = H + (k + q) * N + k;
            if (k + q <= last) {
              const double* v = q < 3 ? rr[q] : b[3];
              x[q] = dot3(v[0], v[1], v[2], P[0], P[3], P[6]);
              col3(h, v, P);
            } else if (q < 3) {          // row k+2 = hi+1: rows only
              h[0] = rr[q][0];
              h[1] = rr[q][1];
              h[2] = rr[q][2];
            }
          }
          if (k + 1 < hi) house3(x[1], x[2], x[3], k + 3 <= hi, s_P[cur ^ 1]);
        } else if (t >= 32) {
          // the rest of the position, beside thread 0 (warp 0 stays out of
          // it): rows k..k+2 of the other columns from k-1 rightwards
          // (P @ R), columns k..k+2 of the rows above the bulge (C @ P)
          // and Z's columns k..k+2, which are rows of the transposed Z.
          // A thread loads its items of all three before it stores any,
          // so their round trips overlap.
          const int c0 = k > 0 ? k - 1 : 0;
          const int left = k - c0, nr = left + N - k - 3;
          const int nz = Z != nullptr ? N : 0;
          const int most = max(max(nr, k), nz);
          for (int j = t - 32; j < most; j += kFrancisThreads - 32) {
            double* rp = H + k * N + (j < left ? c0 + j : k + 3 + j - left);
            double* cp = H + j * N + k;
            double* zp = Z != nullptr ? Z + k * N + j : nullptr;
            double r[3] = {0.0, 0.0, 0.0}, c[3] = {0.0, 0.0, 0.0};
            double z[3] = {0.0, 0.0, 0.0};
            if (j < nr) {
              r[0] = rp[0];
              r[1] = rp[N];
              r[2] = rp[2 * N];
            }
            if (j < k) {
              c[0] = cp[0];
              c[1] = cp[1];
              c[2] = cp[2];
            }
            if (j < nz) {
              z[0] = zp[0];
              z[1] = zp[N];
              z[2] = zp[2 * N];
            }
            if (j < nr) {
              rp[0] = dot3(r[0], r[1], r[2], P[0], P[1], P[2]);
              rp[N] = dot3(r[0], r[1], r[2], P[3], P[4], P[5]);
              rp[2 * N] = dot3(r[0], r[1], r[2], P[6], P[7], P[8]);
            }
            if (j < k) col3(cp, c, P);
            if (j < nz) {
              zp[0] = dot3(z[0], z[1], z[2], P[0], P[3], P[6]);
              zp[N] = dot3(z[0], z[1], z[2], P[1], P[4], P[7]);
              zp[2 * N] = dot3(z[0], z[1], z[2], P[2], P[5], P[8]);
            }
          }
        }
        __syncthreads();
      }
      // exact Hessenberg zeros in the window: the bulge's remnants lie two
      // and three below the diagonal, everything further down is zero
      for (int c = lo + t; c <= hi; c += kFrancisThreads) {
        if (c + 2 <= hi) H[(c + 2) * N + c] = 0.0;
        if (c + 3 <= hi) H[(c + 3) * N + c] = 0.0;
      }
      chain += hi - lo;
      ++stall;
    } else {
      stall = 0;
    }
    ++it;
    hi = s_hi;
    __syncthreads();
  }
  if (t == 0) {
    info[0] = hi < 1 ? 1 : 0;
    info[1] = it;
    info[2] = chain;
  }
}

// ----------------------------------------------------------- eig_trevc

// Column j of Y (T Y = Y diag(w)) for each warp's j, written as row j of
// yt (re, then im n x n further on). is2[i]: row i tops a 2x2 block of T;
// prev2[i]: row i is a block's second row.
__global__ void __launch_bounds__(kTrevcWarps * 32)
eig_trevc(const double* __restrict__ T, const double* __restrict__ wr,
          const double* __restrict__ wi, const bool* __restrict__ is2,
          const bool* __restrict__ prev2, int n,
          const double* __restrict__ sminp, double* yt) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * kTrevcWarps + threadIdx.x / 32;
  if (j >= n) return;
  double* yr = yt + static_cast<size_t>(j) * n;
  double* yi = yt + static_cast<size_t>(n) * n + static_cast<size_t>(j) * n;
  const double smin = *sminp, smin2 = mul(smin, smin);
  const bool pair = is2[j] || prev2[j];
  const int js = prev2[j] ? j - 1 : j;          // the seed block's top row
  // the seed: two algebraically equal forms, the one of larger norm
  const double a_p = T[static_cast<size_t>(js) * n + js];
  const double b_p = js < n - 1 ? T[static_cast<size_t>(js) * n + js + 1]
                                : 0.0;
  const double c_p = js < n - 1 ? T[static_cast<size_t>(js + 1) * n + js]
                                : 0.0;
  const int jd = js + 1 < n - 1 ? js + 1 : n - 1;
  const double d_p = T[static_cast<size_t>(jd) * n + jd];
  const double lr = wr[j], li = wi[j];
  const double war = sub(lr, a_p), wdr = sub(lr, d_p);
  const double n_b = root(add(add(mul(b_p, b_p), mul(war, war)), mul(li, li)));
  const double n_c = root(add(add(mul(c_p, c_p), mul(wdr, wdr)), mul(li, li)));
  const bool use_b = n_b >= n_c;
  double tr = use_b ? b_p : wdr, ti = use_b ? 0.0 : li;
  double br = use_b ? war : c_p, bi = use_b ? li : 0.0;
  const double snrm = maxnan(
      root(add(add(add(mul(tr, tr), mul(ti, ti)), mul(br, br)), mul(bi, bi))),
      1e-300);
  tr = quo(tr, snrm);
  ti = quo(ti, snrm);
  br = quo(br, snrm);
  bi = quo(bi, snrm);
  for (int m = lane; m < n; m += 32) {
    yr[m] = 0.0;
    yi[m] = 0.0;
  }
  __syncwarp();
  if (lane == 0) {
    if (pair) {
      yr[js] = tr;
      yi[js] = ti;
      yr[js + 1] = br;
      yi[js + 1] = bi;
    } else {
      yr[j] = 1.0;
    }
  }
  __syncwarp();
  const int top = pair ? js + 1 : j;            // the last settled row
  for (int i = js - 1; i >= 0; --i) {
    const bool blk = is2[i];
    const bool one = !blk && !prev2[i];
    const bool two = blk && i + 1 < js;
    if (!one && !two) continue;
    const double* ti_row = T + static_cast<size_t>(i) * n;
    double sr = 0.0, si = 0.0;
    for (int m = i + 1 + lane; m <= top; m += 32) {
      const double tv = ti_row[m];
      sr = add(sr, mul(tv, yr[m]));
      si = add(si, mul(tv, yi[m]));
    }
    const double r1r = -warp_sum(sr), r1i = -warp_sum(si);
    if (one) {
      double den_r = sub(ti_row[i], lr), den_i = -li;
      if (hypot(den_r, den_i) < smin) {
        den_r = smin;
        den_i = 0.0;
      }
      const double dd = add(mul(den_r, den_r), mul(den_i, den_i));
      if (lane == 0) {
        yr[i] = quo(add(mul(r1r, den_r), mul(r1i, den_i)), dd);
        yi[i] = quo(sub(mul(r1i, den_r), mul(r1r, den_i)), dd);
      }
    } else {
      const double* t2_row = ti_row + n;
      double s2r = 0.0, s2i = 0.0;
      for (int m = i + 2 + lane; m <= top; m += 32) {
        const double tv = t2_row[m];
        s2r = add(s2r, mul(tv, yr[m]));
        s2i = add(s2i, mul(tv, yi[m]));
      }
      const double r2r = -warp_sum(s2r), r2i = -warp_sum(s2i);
      const double aa = ti_row[i], bb = ti_row[i + 1];
      const double cc = t2_row[i], ddg = t2_row[i + 1];
      const double m11r = sub(aa, lr), m11i = -li;
      const double m22r = sub(ddg, lr), m22i = -li;
      double detr = sub(sub(mul(m11r, m22r), mul(m11i, m22i)), mul(bb, cc));
      double deti = add(mul(m11r, m22i), mul(m11i, m22r));
      if (hypot(detr, deti) < smin2) {
        detr = smin2;
        deti = 0.0;
      }
      const double dmag = add(mul(detr, detr), mul(deti, deti));
      const double n1r = sub(sub(mul(r1r, m22r), mul(r1i, m22i)), mul(bb, r2r));
      const double n1i = sub(add(mul(r1r, m22i), mul(r1i, m22r)), mul(bb, r2i));
      const double n2r = sub(sub(mul(m11r, r2r), mul(m11i, r2i)), mul(cc, r1r));
      const double n2i = sub(add(mul(m11r, r2i), mul(m11i, r2r)), mul(cc, r1i));
      if (lane == 0) {
        yr[i] = quo(add(mul(n1r, detr), mul(n1i, deti)), dmag);
        yi[i] = quo(sub(mul(n1i, detr), mul(n1r, deti)), dmag);
        yr[i + 1] = quo(add(mul(n2r, detr), mul(n2i, deti)), dmag);
        yi[i + 1] = quo(sub(mul(n2i, detr), mul(n2r, deti)), dmag);
      }
    }
    __syncwarp();
  }
}

int sm_count(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || v <= 0)
    v = 132;
  return v;
}

}  // namespace

// H (n x n float64, row-major) to Hessenberg form in place, Q (n x n, the
// identity on entry) accumulated unless null; n >= 3. barrier: 8 bytes of
// scratch on the card (zeroed here on the stream). One cooperative launch
// of as many blocks as the passes use and the card holds at once.
extern "C" int runmat_eig_hess(void* H, void* Q, int n, void* barrier,
                               void* stream, int device) {
  if (H == nullptr || barrier == nullptr || n < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(double);
  err = cudaFuncSetAttribute(eig_hess,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eig_hess,
                                                      kHessThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + 31) / 32, rows = (n + kHessWarps - 1) / kHessWarps;
  const int want = tiles > rows ? tiles : rows;
  const int most = per_sm * sm_count(device);
  const int blocks = want < most ? want : most;
  auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  double* h = static_cast<double*>(H);
  double* q = static_cast<double*>(Q);
  unsigned long long* bar = static_cast<unsigned long long*>(barrier);
  void* args[] = {&h, &q, &n, &bar};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(eig_hess),
                                    dim3(blocks), dim3(kHessThreads), args,
                                    smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The Francis iteration on the padded (n+3) x (n+3) Hessenberg H in place,
// Z ((n+3)^2, the identity on entry) accumulated transposed unless null;
// n >= 2.
// hfro: ||H||_F on the card; info: three int64, [ok, iterations, chain].
extern "C" int runmat_eig_francis(void* H, void* Z, int n, int max_iters,
                                  const void* hfro, void* info, void* stream,
                                  int device) {
  if (H == nullptr || hfro == nullptr || info == nullptr || n < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  eig_francis<<<1, kFrancisThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(H), static_cast<double*>(Z), n, max_iters,
      static_cast<const double*>(hfro), static_cast<long long*>(info));
  return static_cast<int>(cudaGetLastError());
}

// The right eigenvectors of the n x n quasi-triangular T (row-major) with
// eigenvalues wr + i wi and blocks is2/prev2 (n bytes each): column j of
// Y into row j of yt (2 n x n float64, real then imaginary). smin: dtrevc's
// smallest denominator on the card.
extern "C" int runmat_eig_trevc(const void* T, const void* wr, const void* wi,
                                const void* is2, const void* prev2, int n,
                                const void* smin, void* yt, void* stream,
                                int device) {
  if (T == nullptr || wr == nullptr || wi == nullptr || is2 == nullptr ||
      prev2 == nullptr || smin == nullptr || yt == nullptr || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + kTrevcWarps - 1) / kTrevcWarps;
  eig_trevc<<<blocks, kTrevcWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(T), static_cast<const double*>(wr),
      static_cast<const double*>(wi), static_cast<const bool*>(is2),
      static_cast<const bool*>(prev2), n, static_cast<const double*>(smin),
      static_cast<double*>(yt));
  return static_cast<int>(cudaGetLastError());
}
