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
//                one block of 768 threads, no host read: the lo scan (a
//                block max), the branch among deflating one, deflating two,
//                skipping a converged 1x1/2x2 block and a sweep (thread 0),
//                the shifts with the exceptional shift every 10 stalls, the
//                chase of 3x3 reflectors, the exact zeros restored below the
//                subdiagonal of the active window, and the 40 n + 100
//                iteration safeguard. The chase has no block barrier
//                between bulge positions: a chaser warp keeps the bulge
//                in registers, forms each reflector and publishes it to a
//                ring in shared memory; a helper warp keeps the 32
//                columns right of it; owner threads apply the reflectors
//                in order to the columns right of the band, the rows
//                above the bulge and Z's rows, each entry loaded and
//                stored once a sweep (the design and its hand-offs above
//                the kernel). The earlier design, one block barrier a
//                position, stays as the bench-only eig_francis_barrier. Z
//                is kept transposed, so its three columns are contiguous
//                rows.
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
// grid barriers, the QR's sweep positions (the chaser's dot3s, shuffles
// and house3's two square roots and divisions a position, one after
// another, with the helper's band and the owners' 15 (n + 3) float64
// operations a position, 30 (n + 3) with Z, beside it on one SM), and
// trevc's n dependent rows a column.

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
constexpr int kFrancisThreads = 1024;   // the earlier eig_francis' block
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
__device__ __forceinline__ void house3(double x, double y, double z,
                                       bool use3, double* P) {
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

// (a, b, c)' <- P (a, b, c)': three rows of one column (P @ R)
__device__ __forceinline__ void by_rows(double& a, double& b, double& c,
                                        const double* P) {
  const double r0 = dot3(a, b, c, P[0], P[1], P[2]);
  const double r1 = dot3(a, b, c, P[3], P[4], P[5]);
  const double r2 = dot3(a, b, c, P[6], P[7], P[8]);
  a = r0;
  b = r1;
  c = r2;
}

// (a, b, c) <- (a, b, c) P: three columns of one row (C @ P)
__device__ __forceinline__ void by_cols(double& a, double& b, double& c,
                                        const double* P) {
  const double r0 = dot3(a, b, c, P[0], P[3], P[6]);
  const double r1 = dot3(a, b, c, P[1], P[4], P[7]);
  const double r2 = dot3(a, b, c, P[2], P[5], P[8]);
  a = r0;
  b = r1;
  c = r2;
}

// The chase, one bulge position j = lo..hi-1 after another, on three kinds
// of warp with no block barrier between positions:
//
//   the chaser (warp 0) holds only the bulge: lanes 0-3 hold columns
//     j-1..j+2, rows j..j+3, in registers. At position j it applies P_j to
//     rows j..j+2 of them (P @ R), then to columns j..j+2 of rows
//     j..min(j+3, hi) (C @ P, the rows passed by shuffles), forms P_{j+1}
//     from the new H[j+1..j+3, j] (house3 with its three divisions in
//     three lanes at once) and publishes it into a ring of kRing entries
//     in shared memory, with row j's entries j+1, j+2 (for row j's owner)
//     and the finished (j, j-1), (j+1, j-1), (j+2, j-1), (j, j) (for the
//     helper to store): a block fence, then the count of published
//     reflectors. Then it takes column j+3 (rows j+1..j+4) and H[j+4,
//     j+1..j+2] from the helper's delivery slot and slides by one column.
//     No global load or store in its loop.
//   the helper (warp kHelper, on the chaser's scheduler) holds the band
//     right of the bulge: columns j+3..j+34, one column a lane (lane l
//     the column = l mod 32), rows j..j+2 and rows j+3, j+4 fetched. At
//     position j, once P_j is published, it applies P_j to the band,
//     delivers column j+3 and H[j+4, j+1..j+2] to the chaser and row j's
//     entries j+3..j+5 to P_{j+1}'s ring entry (a block fence, then its
//     count of positions done), stores the rest of row j and the chaser's
//     finished entries of position j-1, and slides: column j+3's lane
//     takes column j+35 from its owner (below).
//   owners (the other warps' threads, `owner_slots`) apply the published
//     reflectors, in order, to everything else. Thread s owns index t = s
//     (and t + S, ... where N > S): column t while it lies right of the
//     band (rows j..j+2, P @ R, until position t-35), row t once the
//     bulge has passed it (columns j..j+2, C @ P, from position t+1) and,
//     for Z, row t of Z (its columns j..j+2, the transposed Z's rows).
//     Each keeps a sliding window of three entries and the next one in
//     registers: an entry is loaded once, when the first reflector
//     reaches it, and stored once, when the last leaves it. A row and a
//     column take the same three dot3s in the same order as in
//     plain_francis, so every entry sees the same sums: the kernel equals
//     plain_francis value for value. An owner reads both counts (acquire)
//     and takes every position both have done; each owner warp then
//     writes how far it has come (a block fence, then the count), which
//     the chaser and the helper read (acquire) before they write a ring
//     entry again.
//
// The hand-offs, where a race would hide:
//   the chaser takes column j+3 at the end of position j, current through
//     P_j: the helper applied P_j to it while the chaser ran its C @ P,
//     house3 and publication, and published it with a fence and its
//     count; the chaser polls that count (acquire).
//   column t enters the band at position t-34 and must then carry P_lo..
//     P_{t-35}. Its owner applies P_{t-35}, puts the column's rows t-35
//     (done), t-34, t-33 into a hand-off slot, a block fence, the slot's
//     tag (the position's running count); the helper, at the end of its
//     position t-35, polls that tag (acquire), takes the rows, stores row
//     t-35's entry and fetches rows t-32, t-31, which nothing has touched
//     since the sweep began. So the owners may fall behind by less than
//     one position at the band's edge, whatever its width: an entering
//     column must be current through the position before it enters.
//     kBand = 32 makes the band one column a lane: P_j on all of it is
//     one dot3 triple a lane, and it takes 32 columns' work a position
//     off the owners.
//   row t's owner starts at position t+1 with row t's entries t+1..t+5
//     from P_{t+1}'s ring entry (the chaser's and the helper's: neither
//     stores them, their owner stores each when its last reflector
//     leaves it); from position t+2 on it loads entry (t, p+4) at the end
//     of position p: the helper stored row t's other band entries before
//     the fence that publishes its position t+1, and so before the row's
//     owner stores any of them; an entry right of the band got its last
//     row reflector from its column's owner, which stored it before the
//     hand-off's fence, and the helper took the hand-off before the fence
//     that publishes its position t-34 (fence, count; count, fence
//     chain). Rows above the bulge never enter the band within a sweep.
//   Z's rows take only the reflectors.
//   ring entry g % kRing is written again, for g + kRing, only once every
//     owner warp has counted position g done: its lanes' reads of the
//     entry, a block fence, the count; the chaser and the helper read the
//     counts with acquire (ring_room).
// After the sweep one block barrier; the restore of exact zeros, the lo
// scan, the branch and the shifts stay as they were.
constexpr int kQrThreads = 768;           // 24 warps: chaser, helper, owners
constexpr int kQrWarps = kQrThreads / 32;
constexpr int kBand = 32;                 // the band: columns j+3..j+34
constexpr int kLead = kBand + 3;          // column t's owner: up to t-35
constexpr int kHelper = 4;                // the band's warp
constexpr int kRingLog = 8;
constexpr int kRing = 1 << kRingLog;      // reflectors in flight
constexpr int kHand = 64;                 // hand-off slots, by column
// bench modes (runmat_eig_francis_chain): record the branch sequence;
// replay it with the owners idle (the chaser and the helper alone); one
// owner warp (so several indices a thread at small n: the looped
// instantiation of larger n, tested small)
constexpr int kRecord = 1, kAlone = 2, kOneOwnerWarp = 16;
// and kProfile (8): clock64 sums into a bench buffer of kProfSlots
// (the chaser's phases 0-5, the helper's waits 6 and work 7, thread 0's
// scan 8, sweeps 9, after them 10, positions 11, hand-off polls 12;
// owner warp r's waits 16 + 2 r and work 17 + 2 r), one owner index a
// thread only
constexpr int kProfile = 8, kProfSlots = 64;

// The owner threads: the warps other than 0 and kHelper, less the others
// that share their scheduler (8, 12, ...).
__host__ __device__ constexpr int owner_slots(int mode) {
  return (mode & kOneOwnerWarp) != 0 ? 32
                                     : 32 * (kQrWarps - 1 - (kQrWarps - 1) / 4);
}

__device__ __forceinline__ int owner_rank(int w) {
  return w % 4 == 0 ? -1 : w - 1 - w / 4;
}

__device__ __forceinline__ void write_count(long long* p, long long v) {
  *static_cast<volatile long long*>(p) = v;
}

// orders this thread's earlier accesses before its later ones for the
// block (with a relaxed store after it, a release; the seq_cst
// __threadfence_block is stronger than a count needs)
__device__ __forceinline__ void fence_block() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

// a count in shared memory, read with acquire (a plain load on this card)
__device__ __forceinline__ long long get_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];" : "=l"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

// house3 in every lane of a warp, its three divisions by one lane each:
// the same operations on the same values as house3, P in every lane
__device__ __forceinline__ void house3_warp(double x, double y, double z,
                                            bool use3, double* P) {
  const int k = (threadIdx.x % 32) % 3;
  if (!use3) z = 0.0;
  const double m = maxnan(maxnan(fabs(x), fabs(y)), fabs(z));
  const double ms = m == 0 ? 1.0 : m;
  const double d = quo(k == 0 ? x : (k == 1 ? y : z), ms);
  x = __shfl_sync(kFull, d, 0);
  y = __shfl_sync(kFull, d, 1);
  z = __shfl_sync(kFull, d, 2);
  const double nrm = root(add(add(mul(x, x), mul(y, y)), mul(z, z)));
  const double alpha = mul(-sgn(x == 0 ? 1.0 : x), nrm);
  const double u[3] = {sub(x, alpha), y, z};
  const double un2 = add(add(mul(u[0], u[0]), mul(u[1], u[1])),
                         mul(u[2], u[2]));
  double v[3] = {0.0, 0.0, 0.0};
  if (un2 > 0 && m > 0) {                     // the same in every lane
    const double r = root(un2);
    const double q = quo(k == 0 ? u[0] : (k == 1 ? u[1] : u[2]), r);
    v[0] = __shfl_sync(kFull, q, 0);
    v[1] = __shfl_sync(kFull, q, 1);
    v[2] = __shfl_sync(kFull, q, 2);
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      P[3 * r + c] = sub(r == c ? 1.0 : 0.0, mul(2.0, mul(v[r], v[c])));
}

struct Chase {
  double (*ring)[9];            // P_g in ring[g % kRing]
  double (*rows)[5];            // with row j's entries j+1..j+5 (g = j+1)
  double (*outs)[4];            // and the chaser's (j, j-1), (j+1, j-1),
                                // (j+2, j-1), (j, j) for the helper
  long long* published;         // reflectors published (the chaser)
  long long* delivered;         // positions the helper has done
  double (*deliver)[6];         // column j+3's rows j+1..j+4, H[j+4, j+1],
                                // H[j+4, j+2] for the chaser's j+1
  long long* progress;          // each owner warp's positions done
  double (*hand)[3];            // an entering column's rows t-35..t-33
  long long* tag;               // its running count + 1
  unsigned long long* prof;     // kProfile's sums, else null
};

// wait until no owner warp still reads ring entry g - kRing
__device__ __forceinline__ void ring_room(const Chase& ch, long long g,
                                          int owners, long long& safe,
                                          bool alone) {
  const int lane = threadIdx.x % 32;
  while (!alone && g - kRing >= safe) {
    long long p = lane < owners ? get_acquire(&ch.progress[lane])
                                : 0x7fffffffffffffffLL;
    for (int s = 16; s > 0; s >>= 1) p = min(p, __shfl_xor_sync(kFull, p, s));
    safe = p;
  }
}

// warp 0 over one sweep: lanes 0-3 hold columns j-1..j+2, rows j..j+3;
// P_lo in sP, g0 the running count of position lo
template <bool PROF>
__device__ __forceinline__ void chase_chaser(double* __restrict__ H, int N,
                                             int lo, int hi, long long g0,
                                             const double* sP, int owners,
                                             const Chase& ch, bool alone) {
  const int lane = threadIdx.x % 32;
  long long acc[6] = {0, 0, 0, 0, 0, 0};
  long long last = PROF ? clock64() : 0;
  auto tick = [&](int k) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[k] += now - last;
      last = now;
    }
  };
  long long safe = 0;
  double P[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) P[q] = sP[q];
  double h0 = 0.0, h1 = 0.0, h2 = 0.0, h3 = 0.0;
  {
    const int c = lo - 1 + lane;
    if (lane < 4 && c >= 0) {
      h0 = H[lo * N + c];
      h1 = H[(lo + 1) * N + c];
      h2 = H[(lo + 2) * N + c];
      h3 = H[(lo + 3) * N + c];
    }
  }
  // C @ P's lane: column e of P for the bulge's column j+e (lanes 1-3)
  const int e = lane - 1;
  ring_room(ch, g0, owners, safe, alone);
  if (lane == 0) {
    const int s = static_cast<int>(g0 & (kRing - 1));
#pragma unroll
    for (int q = 0; q < 9; ++q) ch.ring[s][q] = P[q];
    fence_block();
    write_count(ch.published, g0 + 1);
  }
  for (int j = lo; j < hi; ++j) {
    const long long g = g0 + (j - lo);
    const int c = j - 1 + lane;
    const bool valid = lane < 4 && c >= 0;
    if (valid) by_rows(h0, h1, h2, P);
    tick(0);
    // columns j..j+2 of rows j..min(j+3, hi), every row shuffled at once
    const double p0 = e == 0 ? P[0] : (e == 1 ? P[1] : P[2]);
    const double p1 = e == 0 ? P[3] : (e == 1 ? P[4] : P[5]);
    const double p2 = e == 0 ? P[6] : (e == 1 ? P[7] : P[8]);
    auto cside = [&](double v) {
      const double a0 = __shfl_sync(kFull, v, 1);
      const double a1 = __shfl_sync(kFull, v, 2);
      const double a2 = __shfl_sync(kFull, v, 3);
      return dot3(a0, a1, a2, p0, p1, p2);
    };
    const double c0 = cside(h0), c1 = cside(h1), c2 = cside(h2),
                 c3 = cside(h3);
    if (lane >= 1 && lane <= 3) {
      h0 = c0;
      h1 = c1;
      if (j + 2 <= hi) h2 = c2;
      if (j + 3 <= hi) h3 = c3;
    }
    const double x = __shfl_sync(kFull, h1, 1);
    const double y = __shfl_sync(kFull, h2, 1);
    const double z = __shfl_sync(kFull, h3, 1);
    tick(1);
    if (j + 1 == hi) {                        // the sweep's last position
      if (valid) {
        H[j * N + c] = h0;
        H[(j + 1) * N + c] = h1;
        H[(j + 2) * N + c] = h2;
      }
      break;
    }
    house3_warp(x, y, z, j + 3 <= hi, P);
    tick(2);
    // publish P_{j+1} with row j's entries j+1, j+2 (lanes 2, 3) and the
    // finished (j, j-1), (j+1, j-1), (j+2, j-1), (j, j) for the helper
    ring_room(ch, g + 1, owners, safe, alone);
    const int s = static_cast<int>((g + 1) & (kRing - 1));
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 9; ++q) ch.ring[s][q] = P[q];
      ch.outs[s][0] = h0;
      ch.outs[s][1] = h1;
      ch.outs[s][2] = h2;
    }
    if (lane == 1) ch.outs[s][3] = h0;
    if (lane == 2 || lane == 3) ch.rows[s][lane - 2] = h0;
    fence_block();
    __syncwarp();
    if (lane == 0) write_count(ch.published, g + 2);
    tick(3);
    // column j+3 from the helper (the whole warp polls one address)
    while (get_acquire(ch.delivered) < g + 1) {
    }
    const double* d = ch.deliver[(j + 1) & 3];
    const double d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3], d4 = d[4],
                 d5 = d[5];
    tick(4);
    // slide: lane l takes lane l+1's rows j+1..j+3, lane 3 column j+3;
    // row j+4 of columns j+1, j+2 from the helper too
    const double n1 = __shfl_down_sync(kFull, h1, 1);
    const double n2 = __shfl_down_sync(kFull, h2, 1);
    const double n3 = __shfl_down_sync(kFull, h3, 1);
    if (lane == 3) {
      h0 = d0;
      h1 = d1;
      h2 = d2;
      h3 = d3;
    } else {
      h0 = n1;
      h1 = n2;
      h2 = n3;
      h3 = lane == 1 ? d4 : (lane == 2 ? d5 : 0.0);
    }
    tick(5);
  }
  if constexpr (PROF) {
    if (lane == 0) {
      for (int k = 0; k < 6; ++k)
        atomicAdd(&ch.prof[k], static_cast<unsigned long long>(acc[k]));
      atomicAdd(&ch.prof[11], static_cast<unsigned long long>(hi - lo));
    }
  }
}

// the helper's column at position p: the one = lane mod 32 in p+3..p+34
__device__ __forceinline__ int help_col(int p, int lane) {
  return p + 3 + ((lane - p - 3) & (kBand - 1));
}

// warp kHelper over one sweep: the band, columns j+3..j+34, rows j..j+2
// (and rows j+3, j+4 fetched), one column a lane
template <bool PROF>
__device__ __forceinline__ void chase_helper(double* __restrict__ H, int N,
                                             int lo, int hi, long long g0,
                                             int owners, const Chase& ch,
                                             bool alone) {
  const int lane = threadIdx.x % 32;
  long long waits = 0, work = 0, polls = 0;
  long long last = PROF ? clock64() : 0;
  long long safe = 0;
  int c = help_col(lo, lane);
  bool valid = c < N;
  double h0 = 0.0, h1 = 0.0, h2 = 0.0, q3 = 0.0, q4 = 0.0;
  if (valid) {
    h0 = H[lo * N + c];
    h1 = H[(lo + 1) * N + c];
    h2 = H[(lo + 2) * N + c];
    q3 = H[(lo + 3) * N + c];
    q4 = H[(lo + 4) * N + c];
  }
  for (int j = lo; j < hi; ++j) {
    const long long g = g0 + (j - lo);
    const bool end = j + 1 == hi;
    // H[j+4, j+1], H[j+4, j+2] (lanes 0, 1): untouched since the sweep began
    const double r4 = (lane < 2 && !end) ? H[(j + 4) * N + j + 1 + lane]
                                         : 0.0;
    if constexpr (PROF) {
      const long long now = clock64();
      work += now - last;
      last = now;
    }
    while (get_acquire(ch.published) <= g) __nanosleep(16);
    if constexpr (PROF) {
      const long long now = clock64();
      waits += now - last;
      last = now;
    }
    const int s = static_cast<int>(g & (kRing - 1));
    double P[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) P[q] = ch.ring[s][q];
    double out = 0.0;                         // the chaser's of position j-1
    if (j > lo && lane < 4) out = ch.outs[s][lane];
    if (valid) by_rows(h0, h1, h2, P);
    const int e = c - j;                      // 3..34
    if (!end) {
      // deliver column j+3 (lane (j+3) mod 32) and H[j+4, j+1..j+2]; row
      // j's entries j+3..j+5 for its owner into P_{j+1}'s ring entry
      const int l3 = (j + 3) & (kBand - 1);
      const double d0 = __shfl_sync(kFull, h1, l3);
      const double d1 = __shfl_sync(kFull, h2, l3);
      const double d2 = __shfl_sync(kFull, q3, l3);
      const double d3 = __shfl_sync(kFull, q4, l3);
      const double d4 = __shfl_sync(kFull, r4, 0);
      const double d5 = __shfl_sync(kFull, r4, 1);
      ring_room(ch, g + 1, owners, safe, alone);
      if (lane == 0) {
        double* d = ch.deliver[(j + 1) & 3];
        d[0] = d0;
        d[1] = d1;
        d[2] = d2;
        d[3] = d3;
        d[4] = d4;
        d[5] = d5;
      }
      if (e >= 3 && e <= 5)
        ch.rows[static_cast<int>((g + 1) & (kRing - 1))][e - 1] = h0;
      fence_block();
      __syncwarp();
      if (lane == 0) write_count(ch.delivered, g + 1);
    }
    // row j, but for the entries j+3..j+5 its owner took from the ring
    // and stores itself; the chaser's finished entries of position j-1
    if (valid && (end || e > min(5, hi + 1 - j))) H[j * N + c] = h0;
    if (valid && end) {
      H[(j + 1) * N + c] = h1;
      H[(j + 2) * N + c] = h2;
    }
    if (j > lo && lane < 4) {
      const int r = lane == 3 ? j - 1 : j - 1 + lane;
      const int k = lane == 3 ? j - 1 : j - 2;
      if (k >= 0) H[r * N + k] = out;
    }
    if (end) break;
    // column j+3 leaves (to the chaser); its lane takes column j+35, rows
    // j+1..j+3 from its owner. The whole warp polls and loads.
    const int cn = help_col(j + 1, lane), tn = j + kLead;
    double a = 0.0, b = 0.0, top = 0.0;
    if (tn < N) {
      const int hs = tn & (kHand - 1);
      if (alone) {              // the owners idle: the column as it stands
        top = H[j * N + tn];
        a = H[(j + 1) * N + tn];
        b = H[(j + 2) * N + tn];
      } else {
        while (get_acquire(&ch.tag[hs]) != g + 1) {
          if constexpr (PROF) ++polls;
        }
        top = ch.hand[hs][0];
        a = ch.hand[hs][1];
        b = ch.hand[hs][2];
      }
    }
    if (cn != c) {
      if (cn < N) {
        H[j * N + cn] = top;
        h0 = a;
        h1 = b;
        h2 = H[(j + 3) * N + cn];
        q3 = H[(j + 4) * N + cn];
        q4 = H[(j + 5) * N + cn];
      }
    } else {
      h0 = h1;
      h1 = h2;
      h2 = q3;
      q3 = q4;
      q4 = valid ? H[(j + 5) * N + c] : 0.0;
    }
    c = cn;
    valid = c < N;
  }
  if constexpr (PROF) {
    work += clock64() - last;
    if (lane == 0) {
      atomicAdd(&ch.prof[6], static_cast<unsigned long long>(waits));
      atomicAdd(&ch.prof[7], static_cast<unsigned long long>(work));
    }
    if (polls > 0)
      atomicAdd(&ch.prof[12], static_cast<unsigned long long>(polls));
  }
}

// one owner index t at position j (after P_j was read; row: P_j's ring
// entry s): column t, then row t, then row t of Z (the transposed Z's
// column t)
__device__ __forceinline__ void chase_item(double* __restrict__ H,
                                           double* __restrict__ Z, int N,
                                           int lo, int hi, int j, int t,
                                           long long g, int s,
                                           const double* P, double (&w)[4],
                                           double (&v)[4], const Chase& ch) {
  if (j <= t - kLead) {                       // column t, right of the band
    by_rows(w[0], w[1], w[2], P);
    if (j == t - kLead && j + 1 < hi) {       // the helper's at j+1
      const int hs = t & (kHand - 1);
      ch.hand[hs][0] = w[0];
      ch.hand[hs][1] = w[1];
      ch.hand[hs][2] = w[2];
      fence_block();
      write_count(&ch.tag[hs], g + 1);
    } else {
      H[j * N + t] = w[0];
      if (j + 1 == hi) {
        H[(j + 1) * N + t] = w[1];
        H[(j + 2) * N + t] = w[2];
      } else {
        w[0] = w[1];
        w[1] = w[2];
        w[2] = w[3];
        w[3] = H[(j + 4) * N + t];
      }
    }
  } else if (j > t) {                         // row t, above the bulge
    double* row = H + static_cast<size_t>(t) * N;
    const bool first = j == t + 1 && t >= lo;
    if (first) {                              // from P_j's ring entry
      w[0] = ch.rows[s][0];
      w[1] = ch.rows[s][1];
      w[2] = ch.rows[s][2];
      w[3] = ch.rows[s][3];
    }
    by_cols(w[0], w[1], w[2], P);
    row[j] = w[0];
    if (j + 1 == hi) {
      row[j + 1] = w[1];
      row[j + 2] = w[2];
    } else {
      w[0] = w[1];
      w[1] = w[2];
      w[2] = w[3];
      w[3] = first ? ch.rows[s][4] : row[j + 4];
    }
  }
  if (Z != nullptr) {
    by_cols(v[0], v[1], v[2], P);
    Z[j * N + t] = v[0];
    if (j + 1 == hi) {
      Z[(j + 1) * N + t] = v[1];
      Z[(j + 2) * N + t] = v[2];
    } else {
      v[0] = v[1];
      v[1] = v[2];
      v[2] = v[3];
      v[3] = Z[(j + 4) * N + t];
    }
  }
}

__device__ __forceinline__ void item_start(const double* __restrict__ H,
                                           const double* __restrict__ Z,
                                           int N, int lo, int t,
                                           double (&w)[4], double (&v)[4]) {
  if (t - kLead >= lo) {                      // column t, rows lo..lo+3
    for (int i = 0; i < 4; ++i) w[i] = H[(lo + i) * N + t];
  } else if (t < lo) {                        // row t, columns lo..lo+3
    for (int i = 0; i < 4; ++i) w[i] = H[t * N + lo + i];
  }
  if (Z != nullptr)
    for (int i = 0; i < 4; ++i) v[i] = Z[(lo + i) * N + t];
}

// an owner thread over one sweep: slot s of S, indices s, s + S, ...
template <int TPT, bool PROF>
__device__ __forceinline__ void chase_owner(double* __restrict__ H,
                                            double* __restrict__ Z, int N,
                                            int lo, int hi, long long g0,
                                            int s, int S, const Chase& ch) {
  const int lane = threadIdx.x % 32;
  double w[TPT][4], v[TPT][4];
  if constexpr (TPT == 1) {
    if (s < N) item_start(H, Z, N, lo, s, w[0], v[0]);
  } else {
#pragma unroll 1
    for (int q = 0; q < TPT; ++q)
      if (s + q * S < N) item_start(H, Z, N, lo, s + q * S, w[q], v[q]);
  }
  long long avail = g0, wait = 0, work = 0, last = PROF ? clock64() : 0;
  for (int j = lo; j < hi; ++j) {
    const long long g = g0 + (j - lo);
    if (g >= avail) {           // every reflector published so far, then
      if constexpr (PROF) {     // one fence for all of them
        const long long now = clock64();
        work += now - last;
        last = now;
      }
      // P_g published, and the helper done with position g-1 (row g-1's
      // entries for its owner in P_g's ring entry, its stores ordered)
      while ((avail = min(get_acquire(ch.published),
                          get_acquire(ch.delivered) + 1)) <= g)
        __nanosleep(32);
      if constexpr (PROF) {
        const long long now = clock64();
        wait += now - last;
        last = now;
      }
    }
    const int slot = static_cast<int>(g & (kRing - 1));
    double P[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) P[q] = ch.ring[slot][q];
    if constexpr (TPT == 1) {
      if (s < N) chase_item(H, Z, N, lo, hi, j, s, g, slot, P, w[0], v[0], ch);
    } else {
#pragma unroll 1
      for (int q = 0; q < TPT; ++q)
        if (s + q * S < N)
          chase_item(H, Z, N, lo, hi, j, s + q * S, g, slot, P, w[q], v[q],
                     ch);
    }
    // the warp's reads of ring entry g ordered before the count that lets
    // the chaser and the helper write it again (a release)
    fence_block();
    __syncwarp();
    if (lane == 0) write_count(&ch.progress[s / 32], g + 1);
  }
  if constexpr (PROF) {
    work += clock64() - last;
    if (lane == 0) {
      atomicAdd(&ch.prof[16 + 2 * (s / 32)],
                static_cast<unsigned long long>(wait));
      atomicAdd(&ch.prof[17 + 2 * (s / 32)],
                static_cast<unsigned long long>(work));
    }
  }
}

// The iteration on the padded N x N H (N = n + 3, row-major), Z (N x N,
// the identity on entry, transposed: row c is Z's column c) accumulated
// unless null. info: [ok, iterations, chain]. mode 0 on the main path;
// rec: 3 ints an iteration (branch, lo, new hi), written under kRecord,
// read under kAlone (then max_iters is the recorded count).
template <int TPT, bool PROF>
__global__ void __launch_bounds__(kQrThreads)
eig_francis(double* __restrict__ H, double* __restrict__ Z, int n,
            int max_iters, const double* __restrict__ hfro,
            long long* __restrict__ info, int mode, int* __restrict__ rec,
            unsigned long long* __restrict__ prof) {
  __shared__ double ring[kRing][9];
  __shared__ double rows[kRing][5];
  __shared__ double outs[kRing][4];
  __shared__ double deliver[4][6];
  __shared__ double hand[kHand][3];
  __shared__ long long tag[kHand];
  __shared__ long long progress[kQrWarps];
  __shared__ long long published, delivered;
  __shared__ int wbest[kQrWarps];
  __shared__ int s_lo, s_branch, s_hi;
  __shared__ double s_P[9];
  const int N = n + 3, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const bool alone = mode & kAlone;
  const int S = owner_slots(mode);
  const int owners = (min(N, S) + 31) / 32;  // owner warps with an index
  const int rank = owner_rank(warp);
  const Chase ch{ring,     rows,     outs, &published, &delivered,
                 deliver,  progress, hand, tag,        prof};
  if (t < kHand) {
    tag[t] = 0;
    hand[t][0] = 0.0;
    hand[t][1] = 0.0;
    hand[t][2] = 0.0;
  }
  if (t < kQrWarps) progress[t] = 0;
  if (t == 0) {
    published = 0;
    delivered = 0;
  }
  const double floor = mul(kEps4, *hfro);
  int hi = n - 1, stall = 0, it = 0;
  long long chain = 0, t_scan = 0, t_sweep = 0, t_after = 0;
  __syncthreads();
  while (hi >= 1 && it < max_iters) {
    const long long t_top = PROF ? clock64() : 0;
    // the largest i in 1..hi whose subdiagonal is negligible, else 0
    int best = 0;
    for (int i = 1 + t; i <= hi; i += kQrThreads)
      if (sub_small(H, N, i, floor)) best = i;
    for (int s = 16; s > 0; s >>= 1)
      best = max(best, __shfl_down_sync(kFull, best, s));
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (t == 0) {
      int lo = 0;
      for (int w = 0; w < kQrWarps; ++w) lo = max(lo, wbest[w]);
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
      }
      if (alone) {
        b = rec[3 * it];
        lo = rec[3 * it + 1];
        nh = rec[3 * it + 2];
      } else if (mode & kRecord) {
        rec[3 * it] = b;
        rec[3 * it + 1] = lo;
        rec[3 * it + 2] = nh;
      }
      if (b == 3) {
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
               mul(h21, sub(add(h11, h22), s)), mul(h32, h21), true, s_P);
      }
      s_lo = lo;
      s_branch = b;
      s_hi = nh;
    }
    __syncthreads();
    const long long t_start = PROF ? clock64() : 0;
    long long t_end = t_start;
    if (s_branch == 3) {
      const int lo = s_lo;
      if (warp == 0)
        chase_chaser<PROF>(H, N, lo, hi, chain, s_P, owners, ch, alone);
      else if (warp == kHelper)
        chase_helper<PROF>(H, N, lo, hi, chain, owners, ch, alone);
      else if (!alone && rank >= 0 && rank < owners)
        chase_owner<TPT, PROF>(H, Z, N, lo, hi, chain, rank * 32 + lane, S,
                               ch);
      if constexpr (PROF) t_end = clock64();
      __syncthreads();
      // exact Hessenberg zeros in the window: the bulge's remnants lie two
      // and three below the diagonal, everything further down is zero
      for (int c = lo + t; c <= hi; c += kQrThreads) {
        if (c + 2 <= hi) H[(c + 2) * N + c] = 0.0;
        if (c + 3 <= hi) H[(c + 3) * N + c] = 0.0;
      }
      chain += hi - lo;
      if (t == 0) delivered = chain;       // the sweep's last position too
      ++stall;
    } else {
      stall = 0;
    }
    ++it;
    hi = s_hi;
    __syncthreads();
    if constexpr (PROF) {
      const long long now = clock64();
      t_scan += t_start - t_top;
      t_sweep += t_end - t_start;
      t_after += now - t_end;
    }
  }
  if (t == 0) {
    info[0] = hi < 1 ? 1 : 0;
    info[1] = it;
    info[2] = chain;
    if constexpr (PROF) {
      prof[8] = t_scan;
      prof[9] = t_sweep;
      prof[10] = t_after;
    }
  }
}

// The earlier design, kept for the bench only (linalgbench.py
// times it in turns with eig_francis): the same iteration in one block of
// 1024 threads, one block barrier a bulge position: thread 0 applies P
// to the bulge itself (rows k..k+2 of columns k..k+2, then rows
// k..min(k+3, hi) of those columns) and forms the next P; beside it,
// warps 1-31 apply P to rows k..k+2 of the other columns from k-1
// rightwards, to columns k..k+2 of the rows above the bulge and to Z's
// columns k..k+2, each thread loading its items before it stores any.
__global__ void __launch_bounds__(kFrancisThreads)
eig_francis_barrier(double* __restrict__ H, double* __restrict__ Z, int n,
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
        if (stall > 0 && stall % 10 == 0) {
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
        const int cur = (k - lo) & 1;
        double P[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) P[q] = s_P[cur][q];
        if (t == 0) {
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
            } else if (q < 3) {
              h[0] = rr[q][0];
              h[1] = rr[q][1];
              h[2] = rr[q][2];
            }
          }
          if (k + 1 < hi) house3(x[1], x[2], x[3], k + 3 <= hi, s_P[cur ^ 1]);
        } else if (t >= 32) {
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

namespace {

template <int TPT, bool PROF = false>
cudaError_t francis_launch(double* H, double* Z, int n, int max_iters,
                           const double* hfro, long long* info, int mode,
                           int* rec, unsigned long long* prof,
                           cudaStream_t s) {
  eig_francis<TPT, PROF><<<1, kQrThreads, 0, s>>>(H, Z, n, max_iters, hfro,
                                                  info, mode, rec, prof);
  return cudaGetLastError();
}

// one launch of eig_francis: one owner index a thread (n <= 573 on the
// main path), else a loop over up to 64
int francis_run(void* H, void* Z, int n, int max_iters, const void* hfro,
                void* info, int mode, void* rec, void* prof, void* stream,
                int device) {
  if (H == nullptr || hfro == nullptr || info == nullptr || n < 2 ||
      ((mode & (kRecord | kAlone)) != 0 && rec == nullptr) ||
      ((mode & kProfile) != 0 && prof == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int S = owner_slots(mode);
  const int per = (n + 3 + S - 1) / S;
  double* h = static_cast<double*>(H);
  double* z = static_cast<double*>(Z);
  const double* f = static_cast<const double*>(hfro);
  long long* out = static_cast<long long*>(info);
  int* r = static_cast<int*>(rec);
  auto* pr = static_cast<unsigned long long*>(prof);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if ((mode & kProfile) != 0) {
    if (per <= 1)
      err = francis_launch<1, true>(h, z, n, max_iters, f, out, mode, r, pr,
                                    s);
  } else if (per <= 1) {
    err = francis_launch<1>(h, z, n, max_iters, f, out, mode, r, pr, s);
  } else if (per <= 64) {
    err = francis_launch<64>(h, z, n, max_iters, f, out, mode, r, pr, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// The Francis iteration on the padded (n+3) x (n+3) Hessenberg H in place,
// Z ((n+3)^2, the identity on entry) accumulated transposed unless null;
// n >= 2.
// hfro: ||H||_F on the card; info: three int64, [ok, iterations, chain].
extern "C" int runmat_eig_francis(void* H, void* Z, int n, int max_iters,
                                  const void* hfro, void* info, void* stream,
                                  int device) {
  return francis_run(H, Z, n, max_iters, hfro, info, 0, nullptr, nullptr,
                     stream, device);
}

// Bench only (runmat_tpu_torch/linalgbench.py): eig_francis with `mode`
// bits kRecord (1: write each iteration's branch, lo and new hi into rec,
// 3 int32 an iteration), kAlone (2: replay rec's iterations, max_iters of
// them, with the owners idle: the chaser's and helper's chain alone),
// kProfile (8: clock64 sums into prof,
// kProfSlots uint64 zeroed by the caller; n <= 573) and kOneOwnerWarp
// (16: one owner warp, several indices a thread).
extern "C" int runmat_eig_francis_chain(void* H, void* Z, int n,
                                        int max_iters, const void* hfro,
                                        void* info, int mode, void* rec,
                                        void* prof, void* stream,
                                        int device) {
  return francis_run(H, Z, n, max_iters, hfro, info, mode, rec, prof, stream,
                     device);
}

// Bench only: the earlier design (eig_francis_barrier), the same arguments as
// runmat_eig_francis.
extern "C" int runmat_eig_francis_barrier(void* H, void* Z, int n, int max_iters,
                                      const void* hfro, void* info,
                                      void* stream, int device) {
  if (H == nullptr || hfro == nullptr || info == nullptr || n < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  eig_francis_barrier<<<1, kFrancisThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
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
