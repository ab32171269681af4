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
//                Q -= 2 (Qv) v'. Routed by n alone (res_smem against
//                kResBudget; ops/eig_qr.py hess_route): up to n = 627, H
//                resident in the shared memory of one cluster of 16 blocks
//                (block b owns rows b, b + 16, ...), two exchanges a step
//                through st.async and mbarriers, no grid or cluster barrier
//                inside the loop, and Q on a second cluster that trails the
//                first, both in one cooperative launch so that they are
//                resident together (the design and its hand-offs above
//                eig_hess_resident); above 627, the earlier cooperative
//                design (one launch, a grid barrier after each of its two
//                passes a step, H and Q through L2), which also stays as the
//                bench-only runmat_eig_hess_grid.
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
//                eigen-column is independent of the others, and is taken in
//                dtrevc's column (axpy) order: once row i is solved, every
//                row above takes its term, r[0:i] -= T[0:i, i] y_i, so the
//                dependent chain a row is the owner lane's quotient(s), one
//                shuffle and the next row's multiply and subtract. Routed by
//                n alone (ops/eig_qr.py trevc_route): up to n = 512
//                (kTrevcRingN) eig_trevc_ring, a block of kTrevcCols
//                adjacent columns a warp each, each column's right-hand side
//                in registers (row m in lane m % 32, slot m / 32), T's
//                columns streamed by a producer warp through a ring in
//                shared memory with cp.async.bulk onto mbarriers, each row's
//                denominators computed before the walk (the design above
//                the kernel); above 512 the first design (a warp a column,
//                the JAX row-dot form), which also stays as the bench-only
//                runmat_eig_trevc_warp. The smin replacement of a vanishing
//                denominator is dtrevc's; the rows of a 2x2 block are solved
//                jointly by Cramer's rule.
//
// Every product, sum, quotient and square root is rounded apart
// (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn, __dsqrt_rn: nvcc would
// otherwise contract a * b + c into an FMA), in the plain version's order.
// eig_francis equals plain_francis on the same H: its scalars are the
// plain version's Python floats, its reflector products the plain
// version's left-to-right torch sums, and the Frobenius norm that sets the
// deflation floor comes in from the same torch call. eig_hess and
// eig_trevc sum their long dot products in their own fixed order, so they
// agree with the plain versions (torch.matmul) within rounding; the
// resident eig_hess equals ops/eig_qr.py's ordered_hessenberg and
// eig_trevc_ring its ordered_trevc (their orders written out on the CPU)
// bit for bit.
//
// What bounds them on this card: not bytes (H is 2 MB at n = 512 and stays
// in the 50 MB L2) and not the float64 rate (about 10/3 n^3 operations
// for the reduction, 10 n^3 for the QR, n^3 for trevc: 2-20 microseconds
// at 67 TFLOP/s), but dependent chains: the reduction's n - 2 steps, each
// two exchanges between the cluster's blocks and the latency chains of its
// scalars, row pass and publication (the numbers above eig_hess_resident),
// the QR's sweep positions (the chaser's dot3s, shuffles
// and house3's two square roots and divisions a position, one after
// another, with the helper's band and the owners' 15 (n + 3) float64
// operations a position, 30 (n + 3) with Z, beside it on one SM), and
// trevc's n dependent rows a column (a quotient, a shuffle and an update
// each).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr double kEps = 2.220446049250313e-16;
constexpr double kEps4 = 4.0 * kEps;   // the absolute deflation floor's
constexpr double kEps8 = 8.0 * kEps;   // the relative deflation test's
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHessThreads = 256;
constexpr int kHessWarps = kHessThreads / 32;
constexpr int kResThreads = 256;        // the resident eig_hess' block
constexpr int kResWarps = kResThreads / 32;
constexpr int kResBlocks = 16;          // its cluster (non-portable size)
constexpr int kResPhases = 5;           // its profile's phases (bench only)
constexpr int kResFlagEvery = 4;        // steps between v releases to Q's
constexpr int kFrancisThreads = 1024;   // the earlier eig_francis' block
constexpr int kTrevcWarps = 4;         // the earlier eig_trevc's block
constexpr int kTrevcCols = 4;          // eig_trevc_ring: column warps a block
constexpr int kTrevcDepth = 12;        // its ring of T's columns
constexpr int kTrevcSlots = 16;        // its registers: 32 rows a slot
constexpr int kTrevcRingN = 32 * kTrevcSlots;   // the largest n it takes

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

// The two halves of a cluster barrier: every thread of the cluster's
// blocks arrives (its earlier shared-memory writes released to the
// cluster), and waits for all of them (acquiring theirs). Between the two
// a thread may do work that no peer reads in the next phase.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Bench only: `count` cluster barriers with nothing between them, at the
// launch's block, cluster and dynamic shared memory (the resident
// eig_hess' floor)
__global__ void __launch_bounds__(kResThreads, 1)
hess_cluster_floor(int count) {
  for (int i = 0; i < count; ++i) {
    cluster_arrive();
    cluster_wait();
  }
}

// Bench only: `count` grid barriers with nothing between them, at the
// launch's grid of kHessThreads blocks (the cooperative eig_hess' floor)
__global__ void __launch_bounds__(kHessThreads)
hess_grid_floor(int count, unsigned long long* bar) {
  unsigned long long target = 0;
  for (int i = 0; i < count; ++i) {
    target += gridDim.x;
    grid_sync(bar, target);
  }
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

// ------------------------------------------------ eig_hess, H resident

// The resident design's shared memory, in doubles (ops/eig_qr.py:
// hess_smem is the same formula): R = ceil(n / 16) rows of H a block; by
// step parity, what the two exchanges deliver into it (each block's [m, s]:
// 32, row k + 1's entry: 2, each block's X over the block's slice of
// columns: 16 R, row k + 1 over the slice: R, v and w: n each); four
// mbarriers.
__host__ __device__ inline int res_rows(int n) {
  return (n + kResBlocks - 1) / kResBlocks;
}
__host__ inline size_t res_smem(int n) {
  const size_t R = res_rows(n), N = n;
  return sizeof(double) * (R * N + 2 * (2 * kResBlocks + 2 + 17 * R + 2 * N) +
                           4);
}
// the H100's dynamic shared memory a block may opt in to (227 KB): the
// resident route takes every n whose res_smem fits (n <= 627)
constexpr size_t kResBudget = 232448;
// a wait on an exchange that outlasts this (about a second) traps rather
// than hang the card. The launch is cooperative, so every block it waits
// on is resident and only a fault of the kernel can reach the trap; a trap
// is a sticky error that leaves the process's CUDA context unusable, not
// only this launch.
constexpr long long kResWaitCycles = 1LL << 31;

// The shared memory of the resident kernel's block, carved from the
// dynamic allocation; the delivered arrays by step parity p.
struct ResSmem {
  double* hs;      // own rows, R x n: local row r is row b + 16 r
  double* d0;      // parity 0's delivered arrays; parity 1's `stride` on
  size_t stride;
  int R, n;
  unsigned long long* bar;   // [exchange 1 p0, p1, exchange 2 p0, p1]
  __device__ ResSmem(double* sm, int n_) : n(n_) {
    R = res_rows(n);
    hs = sm;
    d0 = hs + static_cast<size_t>(R) * n;
    stride = 2 * kResBlocks + 2 + 17 * static_cast<size_t>(R) + 2 * n;
    bar = reinterpret_cast<unsigned long long*>(d0 + 2 * stride);
  }
  // [m_q, s_q] of each block q
  __device__ double* S(int p) const { return d0 + p * stride; }
  // H[k+1, k], from row k + 1's owner
  __device__ double* H1(int p) const { return S(p) + 2 * kResBlocks; }
  // X_q[j] for the block's slice: [q][j - b R]
  __device__ double* X(int p) const { return H1(p) + 2; }
  // H[k+1, j] for the block's slice
  __device__ double* Rk(int p) const { return X(p) + kResBlocks * R; }
  // v, by column
  __device__ double* v(int p) const { return Rk(p) + R; }
  // v'H, by column
  __device__ double* w(int p) const { return v(p) + n; }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// v into the same place of block `rank`'s shared memory as `local`'s,
// counted in bytes on the mbarrier there that `bar` names here
__device__ __forceinline__ void send(const void* local, int rank, double v,
                                     const unsigned long long* bar) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(dst) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];" ::"r"(dst), "d"(v), "r"(rbar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// the phase's one arrival, expecting `bytes` from the peers' sends
__device__ __forceinline__ void mbar_arm(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of `parity` completes (acquiring what the peers' sends
// delivered); traps after kResWaitCycles
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster."
        "shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > kResWaitCycles) __trap();
  }
}

// The bytes block c receives in exchange 1 of step k: every block's X and
// row k + 1 over c's slice's columns j >= k, every block's [m, s], and
// H[k+1, k]; in exchange 2: w_j for j >= k and v_i for i > k.
__device__ __forceinline__ int res_bytes1(int n, int k, int c, int nb) {
  const int R = res_rows(n);
  const int lo = k > c * R ? k : c * R;
  const int hi = n < c * R + R ? n : c * R + R;
  const int cnt = hi > lo ? hi - lo : 0;
  return 8 * (nb * cnt + cnt + 2 * nb + 1);
}
__device__ __forceinline__ int res_bytes2(int n, int k) {
  return 8 * ((n - k) + (n - k - 1));
}

// Loads in this kernel are unpredicated, from indices clamped into range,
// and values past the range are masked after all of a batch's loads are
// issued: a load under a predicate whose value is merged right after
// stalls the warp for the load's whole latency before the next one issues
// (the row pass and the publication took over a third longer so).
__device__ __forceinline__ int clampi(int i, int hi) { return i < hi ? i : hi; }

// Exchange 1 of the step that reduces column kn, from block b (rows b,
// b + 16, ...), into parity p of the nb blocks: X[j] = the sum over the
// block's rows i > kn, in ascending order, of (H[i, kn] 2^-e) H[i, j] for
// j >= kn, to column j's slice owner, where 2^e bounds the block's largest
// |H[i, kn]| (frexp: an exact scaling, so no product underflows that the
// reference's scaled column keeps); m, that largest magnitude, and s, the
// scaled entries' sum of squares without row kn + 1's (each lane's rows r
// and r + 32, then the lanes' tree), to every block; by row kn + 1's
// owner, its entry of column kn to every block and the row from column kn
// to the slice owners. Reads only the block's own rows; every thread of the
// block calls it after the block barrier that follows the rows' last
// update.
__device__ void hess_publish(const ResSmem& s, int n, int b, int rows,
                             int nb, int kn, int p) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int R = res_rows(n);
  const double* hs = s.hs;
  const unsigned long long* bar = s.bar + p;
  const int ra = kn < b ? 0 : (kn - b) / kResBlocks + 1;   // first row > kn
  // lane r holds local row r's entry, lane r - 32 row r (R <= 40)
  const double c0 = hs[static_cast<size_t>(clampi(lane, rows - 1)) * n + kn];
  const double c1 =
      hs[static_cast<size_t>(clampi(lane + 32, rows - 1)) * n + kn];
  const bool in0 = lane >= ra && lane < rows;
  const bool in1 = lane + 32 >= ra && lane + 32 < rows;
  double m = maxnan(in0 ? fabs(c0) : 0.0, in1 ? fabs(c1) : 0.0);
  for (int q = 16; q > 0; q >>= 1)
    m = maxnan(m, __shfl_xor_sync(kFull, m, q));
  int e = 0;
  frexp(m, &e);
  const double xs0 = in0 ? ldexp(c0, -e) : 0.0;
  const double xs1 = in1 ? ldexp(c1, -e) : 0.0;
  const int rn = (kn + 1) % kResBlocks == b ? (kn + 1) / kResBlocks : -1;
  if (warp == 0) {
    double q2 = 0.0;
    if (in0 && b + kResBlocks * lane != kn + 1) q2 = add(q2, mul(xs0, xs0));
    if (in1 && b + kResBlocks * (lane + 32) != kn + 1)
      q2 = add(q2, mul(xs1, xs1));
    for (int q = 16; q > 0; q >>= 1)
      q2 = add(q2, __shfl_down_sync(kFull, q2, q));
    q2 = __shfl_sync(kFull, q2, 0);
    if (lane < nb) {
      send(s.S(p) + 2 * b, lane, m, bar);
      send(s.S(p) + 2 * b + 1, lane, q2, bar);
      if (rn >= 0)
        send(s.H1(p), lane, hs[static_cast<size_t>(rn) * n + kn], bar);
    }
  }
  // the columns j >= kn, a lane each in up to three slots of the block's
  // width, their sums interleaved; eight rows' loads issued together
  const int slots = (n - kn - 32 * warp + kResThreads - 1) / kResThreads;
  int jc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    jc[c] = clampi(kn + 32 * warp + c * kResThreads + lane, n - 1);
  double x[3] = {0.0, 0.0, 0.0};
  for (int r = ra; r < rows; r += 8) {
    double xv[8], hv[3][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int rr = r + u;
      xv[u] = __shfl_sync(kFull, rr < 32 ? xs0 : xs1, rr % 32);
      const double* row = hs + static_cast<size_t>(clampi(rr, rows - 1)) * n;
#pragma unroll
      for (int c = 0; c < 3; ++c) hv[c][u] = row[jc[c]];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (r + u < rows) {
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = add(x[c], mul(xv[u], hv[c][u]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int j = kn + 32 * warp + c * kResThreads + lane;
    if (c < slots && j < n) {
      const int d = j / R, jj = j - d * R;
      send(s.X(p) + b * R + jj, d, x[c], bar);
      if (rn >= 0) send(s.Rk(p) + jj, d, hs[static_cast<size_t>(rn) * n + j],
                        bar);
    }
  }
}

// v_j for the lane's columns j = k + 1 + lane + 32 q of step k, 0 past n
// and past the step's nq chunks (so a product with it adds a zero)
template <int MAXQ>
__device__ __forceinline__ void hess_lane_v(const double* v, int n, int k,
                                            double (&vr)[MAXQ]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < MAXQ; ++q)
    vr[q] = v[clampi(k + 1 + 32 * q + lane, n - 1)];
#pragma unroll
  for (int q = 0; q < MAXQ; ++q)
    if (k + 1 + 32 * q + lane >= n) vr[q] = 0.0;
}

// The warp's rows of the block (local rows warp, warp + kResWarps, ...)
// through step k, two at a time, lanes over the columns j > k, v_j and w_j
// held in registers for all of them: on a row below k, H -= 2 v (v'H)
// (x = h - (2 v_i) w_j); then H -= 2 (Hv) v' (h = x - (2 u) v_j, u each
// lane's sum of x v_j in ascending j, then the lanes' tree). Columns go in
// chunks of four, each chunk's loads issued together. Column k is
// hess_column's.
template <int MAXQ>
__device__ __forceinline__ void hess_rows(const ResSmem& s, const double* v,
                                          const double* w, int n, int k,
                                          int b, int rows) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int base = k + 1, nq = (n - base + 31) / 32;
  double vr[MAXQ], wr[MAXQ];
  hess_lane_v<MAXQ>(v, n, k, vr);
#pragma unroll
  for (int q = 0; q < MAXQ; ++q) wr[q] = w[clampi(base + 32 * q + lane, n - 1)];
  for (int ra = warp; ra < rows; ra += 2 * kResWarps) {
    const int rb = ra + kResWarps < rows ? ra + kResWarps : ra;
    const bool two = rb != ra;
    double* const ha = s.hs + static_cast<size_t>(ra) * n;
    double* const hb = s.hs + static_cast<size_t>(rb) * n;
    const int ia = b + kResBlocks * ra, ib = b + kResBlocks * rb;
    const double va = ia > k ? mul(2.0, v[ia]) : 0.0;
    const double vb = ib > k ? mul(2.0, v[ib]) : 0.0;
    double xa[MAXQ], xb[MAXQ];
    double ua = 0.0, ub = 0.0;
#pragma unroll
    for (int qc = 0; qc < MAXQ; qc += 4) {
      if (qc < nq) {
#pragma unroll
        for (int q = qc; q < qc + 4 && q < MAXQ; ++q) {
          const int jc = clampi(base + 32 * q + lane, n - 1);
          xa[q] = ha[jc];
          xb[q] = hb[jc];
        }
#pragma unroll
        for (int q = qc; q < qc + 4 && q < MAXQ; ++q) {
          if (ia > k) xa[q] = sub(xa[q], mul(va, wr[q]));
          if (ib > k) xb[q] = sub(xb[q], mul(vb, wr[q]));
          ua = add(ua, mul(xa[q], vr[q]));
          ub = add(ub, mul(xb[q], vr[q]));
        }
      }
    }
    for (int q = 16; q > 0; q >>= 1) {
      ua = add(ua, __shfl_down_sync(kFull, ua, q));
      ub = add(ub, __shfl_down_sync(kFull, ub, q));
    }
    const double a2 = mul(2.0, __shfl_sync(kFull, ua, 0));
    const double b2 = mul(2.0, __shfl_sync(kFull, ub, 0));
#pragma unroll
    for (int qc = 0; qc < MAXQ; qc += 4) {
      if (qc < nq) {
#pragma unroll
        for (int q = qc; q < qc + 4 && q < MAXQ; ++q) {
          const int j = base + 32 * q + lane;
          const double na = sub(xa[q], mul(a2, vr[q]));
          const double nb2 = sub(xb[q], mul(b2, vr[q]));
          if (j < n) ha[j] = na;
          if (j < n && two) hb[j] = nb2;
        }
      }
    }
  }
}

// Column k of the block's rows after step k: the new subdiagonal in row
// k + 1 (H[k+1, k] - (2 v_{k+1}) w_k), exact zeros below it; a thread a
// row. The row pass leaves column k alone, and step k's v was formed from
// it before the second exchange.
__device__ __forceinline__ void hess_column(const ResSmem& s, const double* v,
                                            const double* w, int n, int k,
                                            int b, int rows) {
  const int t = threadIdx.x;
  if (t < rows) {
    const int i = b + kResBlocks * t;
    double* const h = s.hs + static_cast<size_t>(t) * n + k;
    if (i == k + 1) *h = sub(*h, mul(mul(2.0, v[i]), w[k]));
    if (i > k + 1) *h = 0.0;
  }
}

// The second cluster of a launch with Q: Q's rows b + 16 r of its block b,
// the identity at first, held in its shared memory where the first
// cluster's blocks hold H's, through every step k: Q -= 2 (Qv) v', v_k read
// from row k of Q in device memory, where the first cluster's block 0 left
// it, once `flag` (its count of such rows, released every kResFlagEvery
// steps and at the end) passes k. Each warp takes its rows two at a time,
// the sums as hess_rows', with no block barrier: the cluster trails the H
// chain and never holds it back. After the last step, a cluster barrier
// (every block has read every v_k) and the rows go out.
template <int MAXQ>
__device__ void hess_qcluster(const ResSmem& s, double* Q, int n, int b,
                              int rows, const unsigned long long* flag) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (size_t e = threadIdx.x; e < static_cast<size_t>(rows) * n;
       e += kResThreads)
    s.hs[e] = e % n == b + kResBlocks * (e / n) ? 1.0 : 0.0;
  __syncthreads();
  unsigned long long seen = 0;
  for (int k = 0; k < n - 2; ++k) {
    const long long start = clock64();
    while (seen <= static_cast<unsigned long long>(k)) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(seen) : "l"(flag) : "memory");
      if (clock64() - start > kResWaitCycles) __trap();
    }
    const int base = k + 1, nq = (n - base + 31) / 32;
    double vr[MAXQ];
#pragma unroll
    for (int q = 0; q < MAXQ; ++q)
      vr[q] = __ldcg(Q + static_cast<size_t>(k) * n +
                     clampi(base + 32 * q + lane, n - 1));
#pragma unroll
    for (int q = 0; q < MAXQ; ++q)
      if (base + 32 * q + lane >= n) vr[q] = 0.0;
    for (int ra = warp; ra < rows; ra += 2 * kResWarps) {
      const int rb = ra + kResWarps < rows ? ra + kResWarps : ra;
      const bool two = rb != ra;
      double* const qa = s.hs + static_cast<size_t>(ra) * n;
      double* const qb = s.hs + static_cast<size_t>(rb) * n;
      double ga[MAXQ], gb[MAXQ];
      double ua = 0.0, ub = 0.0;
#pragma unroll
      for (int qc = 0; qc < MAXQ; qc += 4) {
        if (qc < nq) {
#pragma unroll
          for (int q = qc; q < qc + 4 && q < MAXQ; ++q) {
            const int jc = clampi(base + 32 * q + lane, n - 1);
            ga[q] = qa[jc];
            gb[q] = qb[jc];
          }
#pragma unroll
          for (int q = qc; q < qc + 4 && q < MAXQ; ++q) {
            ua = add(ua, mul(ga[q], vr[q]));
            ub = add(ub, mul(gb[q], vr[q]));
          }
        }
      }
      for (int q = 16; q > 0; q >>= 1) {
        ua = add(ua, __shfl_down_sync(kFull, ua, q));
        ub = add(ub, __shfl_down_sync(kFull, ub, q));
      }
      const double a2 = mul(2.0, __shfl_sync(kFull, ua, 0));
      const double b2 = mul(2.0, __shfl_sync(kFull, ub, 0));
#pragma unroll
      for (int qc = 0; qc < MAXQ; qc += 4) {
        if (qc < nq) {
#pragma unroll
          for (int q = qc; q < qc + 4 && q < MAXQ; ++q) {
            const int j = base + 32 * q + lane;
            const double na = sub(ga[q], mul(a2, vr[q]));
            const double nb2 = sub(gb[q], mul(b2, vr[q]));
            if (j < n) qa[j] = na;
            if (j < n && two) qb[j] = nb2;
          }
        }
      }
    }
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  for (size_t e = threadIdx.x; e < static_cast<size_t>(rows) * n;
       e += kResThreads) {
    const size_t r = e / n;
    Q[(b + kResBlocks * r) * n + e % n] = s.hs[e];
  }
}

// block 0 of the H cluster: v_k into row k of Q (v arrives as 0 where the
// step is skipped) for the Q cluster
__device__ __forceinline__ void hess_vrow(double* Q, const double* v, int n,
                                          int k) {
  for (int j = k + 1 + static_cast<int>(threadIdx.x); j < n; j += kResThreads)
    Q[static_cast<size_t>(k) * n + j] = v[j];
}

// the count of v rows in Q, released to the Q cluster (after a block
// barrier that follows the rows' stores)
__device__ __forceinline__ void hess_flag(unsigned long long* flag,
                                          unsigned long long rows) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               ::"l"(flag), "l"(rows) : "memory");
}

// H (n x n, row-major) reduced in place, Q (the identity on entry)
// accumulated unless null; one cluster of kResBlocks blocks of kResThreads,
// res_smem(n) bytes of dynamic shared memory each; n - 1 <= 32 MAXQ. PROF
// (bench only): each block's thread 0 sums clock64 cycles a phase into
// prof[8 b + phase], kResPhases of them.
//
// Step k, parity p = k % 2, in block b (rows b, b + 16, ...; the slice of
// columns [b R, b R + R)):
//   exchange 1  wait on bar[p] for the peers' sends of step k's
//               publication (hess_publish at the end of step k - 1);
//               the scalars from the blocks' [m, s] and H[k+1, k], the
//               same in every block; w_j on the slice and v_i on the rows
//               below k, each sent to every block's w[p], v[p] (st.async:
//               the data and its count travel together, no fence)
//   exchange 2  wait on bar[2 + p]; the column fix and the row pass from
//               v[p], w[p]; hess_publish for step k + 1 into parity 1 - p;
//               Q's rows from v[p], while the peers catch up
// Each mbarrier takes one arrival a phase, thread 0's arm with the phase's
// byte count (res_bytes1, res_bytes2), which may come before or after the
// bytes. Where a race would hide:
//   - a parity's buffers are rewritten two steps later. A peer sends step
//     k + 2's exchange 1 only after its own exchange 2 of step k + 1,
//     which needs this block's sends of step k + 1, which come after this
//     block read step k's exchange-1 buffers (and a block barrier); it
//     sends step k + 2's exchange 2 only after its exchange 1 of step
//     k + 2, which needs this block's publication at the end of step k + 1,
//     after this block's row pass and Q rows of step k read v[p], w[p].
//   - bar[p] is re-armed for step k + 2 after the block barrier that
//     follows every thread's wait on it at step k, and its next phase
//     needs bytes the peers send only later, so no thread can miss the
//     phase it waits for.
//   - H's rows come in before the first cluster barrier (which also
//     orders the mbarriers' initialisation before any peer's send) and go
//     out after the last step; a last cluster barrier keeps every block
//     resident until every block has received all it waits for.
//   - Q's cluster reads row k of Q (v_k) only after block 0's release of a
//     count above k, which follows a block barrier after the rows' stores;
//     it writes its rows of Q only after its own cluster barrier, when no
//     block of it reads a v row any more.
//
// Why this shape (an H100 80GB HBM3 at 700 W, n = 512; linalgbench's
// hess_floor, hess_profile and eig_rows): a cluster barrier across the 16
// blocks costs 0.5-0.7 us and a grid barrier across 16-64 blocks 1.5 us,
// so the earlier design's 1,020 grid barriers alone take 1.6 of its
// 8.4 ms; a barrier's release is a GPU-scope fence, which st.async does
// without: its bytes complete an mbarrier at the receiver. With the exchanges so, a step is
// ~11,300 clock64 cycles (2.9 ms in all, with or without Q): the scalars
// (two square roots and four divisions deep, 16 shuffles wide) with their
// sends ~3,150, the row pass ~3,850, the next publication ~3,050 and the
// two waits ~1,250. Q's rows, put between the H chain's exchanges, added
// ~6,400 cycles a step; on a cluster of their own they add nothing.

template <int MAXQ, bool PROF = false>
__global__ void __launch_bounds__(kResThreads, 1)
eig_hess_resident(double* __restrict__ H, double* __restrict__ Q, int n,
                  unsigned long long* flag, unsigned long long* prof) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ double sm[];
  const ResSmem s(sm, n);
  const int R = res_rows(n);
  const int b = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t % 32;
  const int rows = b < n ? (n - b + kResBlocks - 1) / kResBlocks : 0;
  const int nb = n < kResBlocks ? n : kResBlocks;         // blocks with rows
  if (blockIdx.x >= kResBlocks) {                         // the Q cluster
    if (rows > 0) {
      hess_qcluster<MAXQ>(s, Q, n, b, rows, flag);
    } else {
      cluster_arrive();
      cluster_wait();
    }
    return;
  }
  long long acc[kResPhases] = {};
  long long last = PROF ? clock64() : 0;
  auto lap = [&](int phase) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[phase] += now - last;
      last = now;
    }
  };

  for (size_t e = t; e < static_cast<size_t>(rows) * n; e += kResThreads) {
    const size_t r = e / n;
    s.hs[e] = H[(b + kResBlocks * r) * n + e % n];
  }
  if (t == 0 && rows > 0) {
    for (int q = 0; q < 4; ++q) mbar_init(s.bar + q);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < 2 && k < n - 2; ++k) {
      mbar_arm(s.bar + k, res_bytes1(n, k, b, nb));
      mbar_arm(s.bar + 2 + k, res_bytes2(n, k));
    }
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  if (rows == 0) return;                  // nothing is sent to such a block
  hess_publish(s, n, b, rows, nb, 0, 0);

  for (int k = 0; k < n - 2; ++k) {
    const int p = k % 2, phase = (k / 2) % 2;
    mbar_wait(s.bar + p, phase);
    lap(0);
    // exchange 1's data: lane q block q's [m, s]; the slice's X_q and row
    // k + 1; the scalars, the same in every warp: mxs = ms 2^E the
    // column's largest magnitude, block q's terms rescaled by 2^(e_q - E)
    // (exact where they are not far below the largest; 0 for a block whose
    // entries are all 0, whose exponent 0 may lie far above E), the sum of
    // squares of x / mxs without row k + 1's (sum_q s_q 4^(e_q - E)) /
    // ms^2
    const double* const S = s.S(p);
    const int lq = clampi(lane, nb - 1);
    double mq = S[2 * lq], sq = S[2 * lq + 1];
    if (lane >= nb) mq = sq = 0.0;
    const double hk1 = s.H1(p)[0];
    const int j = b * R + t;
    const bool slice = t < R && j >= k && j < n;
    const int tc = clampi(t, R - 1);
    double xq[kResBlocks];
#pragma unroll
    for (int q = 0; q < kResBlocks; ++q)
      xq[q] = s.X(p)[clampi(q, nb - 1) * R + tc];
    const double rk = s.Rk(p)[tc];
    double mx = mq;
    for (int q = 16; q > 0; q >>= 1)
      mx = maxnan(mx, __shfl_xor_sync(kFull, mx, q));
    const double mxs = mx == 0 ? 1.0 : mx;
    int E = 0;
    const double ms = frexp(mxs, &E);
    int eq = 0;
    frexp(mq, &eq);
    const double sc = mq > 0 ? ldexp(1.0, eq - E) : 0.0;
    double scq[kResBlocks], tq[kResBlocks];
    const double term = mul(sq, mul(sc, sc));
#pragma unroll
    for (int q = 0; q < kResBlocks; ++q) {
      scq[q] = __shfl_sync(kFull, sc, q);
      tq[q] = __shfl_sync(kFull, term, q);
    }
    double ss = 0.0;
#pragma unroll
    for (int q = 0; q < kResBlocks; ++q)
      if (q < nb) ss = add(ss, tq[q]);
    // the quotients that need only mxs first, off the chain below: the
    // slice's Y / ms (X[j] / mxs = Y[j] 2^E / mxs, Y = sum_q X_q[j] 2^(e_q
    // - E), in block order) and the rows' x / mxs
    double yq = 0.0;
    if (slice) {
      double y = 0.0;
#pragma unroll
      for (int q = 0; q < kResBlocks; ++q)
        if (q < nb) y = add(y, mul(xq[q], scq[q]));
      yq = quo(y, ms);
    }
    const int i = b + kResBlocks * t;
    const bool mine = t < rows && i > k;
    const double xt =
        mine ? quo(s.hs[static_cast<size_t>(clampi(t, rows - 1)) * n + k],
                   mxs)
             : 0.0;
    const double sp = quo(ss, mul(ms, ms));
    const double x1 = quo(hk1, mxs);
    const double nrm = root(add(sp, mul(x1, x1)));
    const double alpha = mul(-sgn(x1 == 0 ? 1.0 : x1), nrm);
    const double v1 = sub(x1, alpha);
    const double vn2 = add(sp, mul(v1, v1));
    const bool safe = vn2 > 0;
    const double r = root(safe ? vn2 : 1.0);
    // exchange 2: v'H on the slice, (X[j] / mxs - alpha H[k+1, j]) / r, and
    // v on the rows below k, to every block
    if (slice) {
      const double wj = safe ? quo(sub(yq, mul(alpha, rk)), r) : 0.0;
      for (int d = 0; d < nb; ++d) send(s.w(p) + j, d, wj, s.bar + 2 + p);
    }
    if (mine) {
      const double vi = safe ? quo(i == k + 1 ? v1 : xt, r) : 0.0;
      for (int d = 0; d < nb; ++d) send(s.v(p) + i, d, vi, s.bar + 2 + p);
    }
    // block 0: step k - 1's v (intact until step k + 1's exchange 2) into
    // row k - 1 of Q for the Q cluster, released every kResFlagEvery steps
    // by a thread that would wait on exchange 2 anyway
    if (Q != nullptr && b == 0 && k > 0) hess_vrow(Q, s.v(1 - p), n, k - 1);
    lap(1);
    __syncthreads();                      // every thread is past bar[p]
    if (t == 0 && k + 2 < n - 2)
      mbar_arm(s.bar + p, res_bytes1(n, k + 2, b, nb));
    if (Q != nullptr && b == 0 && t == 0 && k % kResFlagEvery == 0 && k > 0)
      hess_flag(flag, k);
    mbar_wait(s.bar + 2 + p, phase);
    lap(2);
    hess_column(s, s.v(p), s.w(p), n, k, b, rows);
    hess_rows<MAXQ>(s, s.v(p), s.w(p), n, k, b, rows);
    __syncthreads();
    if (t == 0 && k + 2 < n - 2) mbar_arm(s.bar + 2 + p, res_bytes2(n, k + 2));
    lap(3);
    if (k + 1 < n - 2) hess_publish(s, n, b, rows, nb, k + 1, 1 - p);
    lap(4);
  }
  if (Q != nullptr && b == 0) {           // the last v, and all of them out
    hess_vrow(Q, s.v((n - 3) % 2), n, n - 3);
    __syncthreads();
    if (t == 0) hess_flag(flag, n - 2);
  }
  for (size_t e = t; e < static_cast<size_t>(rows) * n; e += kResThreads) {
    const size_t r = e / n;
    H[(b + kResBlocks * r) * n + e % n] = s.hs[e];
  }
  cluster_arrive();
  cluster_wait();
  if constexpr (PROF) {
    if (t == 0)
      for (int q = 0; q < kResPhases; ++q) prof[8 * b + q] = acc[q];
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

// The earlier design (the route above kTrevcRingN, and the
// bench-only runmat_eig_trevc_warp): column j of Y (T Y = Y diag(w)) for
// each warp's j, T row-major, written as row j of yt (re, then im n x n
// further on). is2[i]: row i tops a 2x2 block of T; prev2[i]: row i is a
// block's second row.
__global__ void __launch_bounds__(kTrevcWarps * 32)
eig_trevc_warp(const double* __restrict__ T, const double* __restrict__ wr,
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

// ------------------------------------------ eig_trevc in dtrevc's order

// eig_trevc_ring. Block b takes the columns j = b0 + kTrevcCols b + w
// (warp w < kTrevcCols, `cols` of them in the last block) and a producer
// warp (w = kTrevcCols). Column j's seed block tops at js (j, or j - 1 for
// a block's second column) and its settled rows end at top (js + 1 for a
// complex pair, else j). The block walks the stages c = cmax ... 0, cmax
// the largest top among its columns; at stage c a warp whose top is below
// c only waits, else:
//   seed    (js <= c <= top): y_c is the seed's entry for row c;
//   one     (row c a 1x1 block, c < js): y_c = r_c / den_c, the complex
//           den_c with dtrevc's smin replacement;
//   two     (row c tops a 2x2 block, c + 1 < js): rows c and c + 1
//           jointly by Cramer's rule, r_{c+1} taken at stage c + 1;
//   neither (row c a block's second row): r_c kept for stage c - 1;
// and then every row above takes its term, r_m = r_m - T[m, c] y_c (for
// a 2x2 block first column c + 1's term with y_{c+1}, then column c's),
// each product and difference rounded apart. So r_m collects its terms in
// descending c, dtrevc's order (ops/eig_qr.py:ordered_trevc writes it out
// on the CPU and equals the kernel bit for bit); r starts at +0, so r_m is
// minus the sum of its terms, the JAX version's -(T[m, :] @ Y).
//
// The dependent chain a row is the next row's multiply and subtract, one
// shuffle of r and the quotient(s): the right-hand sides live in
// registers (row m in lane m % 32, slot m / 32, two planes; the walk over
// slots is a template recursion, so every slot index is a constant); row
// c's r reaches every lane by one shuffle from its owner; the two (1x1) or
// four (2x2) correctly rounded quotients are taken one a lane, side by
// side, and shuffled to every lane (in one lane after another they were
// the larger part of a row's time); slot s, which holds row c - 1 unless
// c % 32 == 0, is updated first, and a 2x2 block's two terms go into each
// slot together. Rows at or below c take the update too (they are never
// read again), so no mask is needed; y goes to yt from the row's owner.
// The ring's waits are at cta scope (a cluster-scope acquire invalidates
// L1 at every stage).
//
// Off the chain: the row constants (den and |den|^2 of a 1x1 row; m11,
// m22, b, c, det and |det|^2 of a 2x2 block), which depend on T and the
// column's eigenvalue alone, are computed before the walk by the column's
// lanes, a row each, into shared memory; and T's columns stream in as T'
// (the wrapper passes T.mT padded to an even leading dimension ld, so
// column c of T is a row of T' whose start and length, rounded up to an
// even count, meet cp.async.bulk's 16-byte rule): the producer's lane 0
// copies column c's rows 0..c + 1 (a 2x2 block's subdiagonal is T[c + 1,
// c]) into ring slot k % kTrevcDepth for stage k = cmax - c, completing on
// full[slot], and the column warps release a slot on empty[slot] one
// stage after they used it (a 2x2 block reads column c + 1 at stage c).
// So T is read from L2 once a block, not once a warp. A wait traps after
// kResWaitCycles rather than hang. CHAIN (bench only) updates only the
// slots that hold row c - 1: the chain alone, the kernel's floor.

// The ring kernel's slot stride in doubles, and its dynamic shared memory
// in bytes (ops/eig_qr.py:trevc_smem is the same formula): the ring, each
// column's row constants (8 doubles a row), the full and empty mbarriers,
// each column's row kinds (a byte a row).
__host__ __device__ inline int trevc_stride(int n) {
  return 32 * ((n + 31) / 32);
}
__host__ inline size_t trevc_smem(int n) {
  return sizeof(double) * (static_cast<size_t>(kTrevcDepth) *
                               trevc_stride(n) +
                           static_cast<size_t>(kTrevcCols) * 8 * n) +
         2 * kTrevcDepth * sizeof(unsigned long long) +
         static_cast<size_t>(kTrevcCols) * n;
}

__device__ __forceinline__ void mbar_init_count(unsigned long long* bar,
                                                int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of `parity` of the block's own mbarrier completes
// (acquiring what the bulk copy delivered: cta scope, so no L1 invalidation
// as mbar_wait's cluster scope costs); traps after kResWaitCycles
__device__ __forceinline__ bool ring_ready(unsigned long long* bar,
                                           int parity) {
  unsigned done = 0;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
      "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void ring_wait(unsigned long long* bar,
                                          int parity) {
  if (ring_ready(bar, parity)) return;
  const long long start = clock64();
  while (!ring_ready(bar, parity))
    if (clock64() - start > kResWaitCycles) __trap();
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// A column warp's state over the walk
struct TrevcWalk {
  const double* ring;
  const double* pre;              // 8 doubles a row
  const unsigned char* kinds;     // 0 neither, 1 one, 2 two
  unsigned long long* full;
  unsigned long long* empty;
  double* yr;                     // row j of yt, real and imaginary
  double* yi;
  int rs, cmax, js, top, lane, k;
  int slot, phase;                // stage k's ring slot and its parity
  bool pair;
  double tr, ti, br, bi, mi;      // the seed, -Im(lambda)
  double pr, pi;                  // r of the row kept by a `neither` stage
};

// r_m -= T[m, c] y for the rows of slots 0..S (CHAIN: S and S - 1 only)
template <bool CHAIN, int S>
__device__ __forceinline__ void trevc_axpy(double (&rr)[kTrevcSlots],
                                           double (&ri)[kTrevcSlots],
                                           const double* col, int lane,
                                           double yr, double yi) {
#pragma unroll
  for (int q = S; q >= 0; --q) {
    if (!CHAIN || q >= S - 1) {
      const double t = col[32 * q + lane];
      rr[q] = sub(rr[q], mul(t, yr));
      ri[q] = sub(ri[q], mul(t, yi));
    }
  }
}

// a 2x2 block's two terms, r_m -= T[m, c + 1] y_{c+1}, then T[m, c] y_c,
// slot by slot (col1: column c + 1, col0: column c)
template <bool CHAIN, int S>
__device__ __forceinline__ void trevc_axpy2(double (&rr)[kTrevcSlots],
                                            double (&ri)[kTrevcSlots],
                                            const double* col1,
                                            const double* col0, int lane,
                                            double y1r, double y1i,
                                            double y0r, double y0i) {
#pragma unroll
  for (int q = S; q >= 0; --q) {
    if (!CHAIN || q >= S - 1) {
      const double t1 = col1[32 * q + lane], t0 = col0[32 * q + lane];
      rr[q] = sub(sub(rr[q], mul(t1, y1r)), mul(t0, y0r));
      ri[q] = sub(sub(ri[q], mul(t1, y1i)), mul(t0, y0i));
    }
  }
}

// the stages of slot S (rows 32 S .. 32 S + 31), then the slots below
template <bool CHAIN, int S>
__device__ __forceinline__ void trevc_slot(TrevcWalk& w,
                                           double (&rr)[kTrevcSlots],
                                           double (&ri)[kTrevcSlots]) {
  if (32 * S <= w.cmax) {
    const int lhi = w.cmax - 32 * S < 31 ? w.cmax - 32 * S : 31;
    for (int l = lhi; l >= 0; --l, ++w.k) {
      const int c = 32 * S + l;
      if (c <= w.top) {
        ring_wait(w.full + w.slot, w.phase);
        const double* col = w.ring + static_cast<size_t>(w.slot) * w.rs;
        double yr = 1.0, yi = 0.0;
        bool upd = true;
        if (c >= w.js) {
          if (w.pair) {
            yr = c == w.js ? w.tr : w.br;
            yi = c == w.js ? w.ti : w.bi;
          }
        } else {
          const int kd = w.kinds[c];
          const double* p = w.pre + 8 * c;
          const double r1r = __shfl_sync(kFull, rr[S], l);
          const double r1i = __shfl_sync(kFull, ri[S], l);
          // the quotients, one a lane (lane q % 2 or q % 4 divides by
          // dd or |det|^2), then shuffled: the divisions run side by side
          if (kd == 1) {
            const double nr = add(mul(r1r, p[0]), mul(r1i, p[1]));
            const double ni = sub(mul(r1i, p[0]), mul(r1r, p[1]));
            const double q = quo((w.lane & 1) ? ni : nr, p[2]);
            yr = __shfl_sync(kFull, q, 0);
            yi = __shfl_sync(kFull, q, 1);
          } else if (kd == 2) {
            const double m11r = p[0], m22r = p[1], bb = p[2], cc = p[3];
            const double detr = p[4], deti = p[5], dmag = p[6], mi = w.mi;
            const double r2r = w.pr, r2i = w.pi;
            const double n1r =
                sub(sub(mul(r1r, m22r), mul(r1i, mi)), mul(bb, r2r));
            const double n1i =
                sub(add(mul(r1r, mi), mul(r1i, m22r)), mul(bb, r2i));
            const double n2r =
                sub(sub(mul(m11r, r2r), mul(mi, r2i)), mul(cc, r1r));
            const double n2i =
                sub(add(mul(m11r, r2i), mul(mi, r2r)), mul(cc, r1i));
            const double a0 = add(mul(n1r, detr), mul(n1i, deti));
            const double a1 = sub(mul(n1i, detr), mul(n1r, deti));
            const double a2 = add(mul(n2r, detr), mul(n2i, deti));
            const double a3 = sub(mul(n2i, detr), mul(n2r, deti));
            const int sel = w.lane & 3;
            const double q = quo(sel == 0 ? a0 : sel == 1 ? a1
                                 : sel == 2 ? a2 : a3, dmag);
            yr = __shfl_sync(kFull, q, 0);
            yi = __shfl_sync(kFull, q, 1);
            const double ybr = __shfl_sync(kFull, q, 2);
            const double ybi = __shfl_sync(kFull, q, 3);
            if (w.lane == ((l + 1) & 31)) {
              w.yr[c + 1] = ybr;
              w.yi[c + 1] = ybi;
            }
            if (w.lane == l) {
              w.yr[c] = yr;
              w.yi[c] = yi;
            }
            // column c + 1 is stage k - 1's slot, not yet released
            const int prev = w.slot == 0 ? kTrevcDepth - 1 : w.slot - 1;
            trevc_axpy2<CHAIN, S>(rr, ri,
                                  w.ring + static_cast<size_t>(prev) * w.rs,
                                  col, w.lane, ybr, ybi, yr, yi);
            upd = false;
          } else {
            w.pr = r1r;
            w.pi = r1i;
            upd = false;
          }
        }
        if (upd) {
          if (w.lane == l) {
            w.yr[c] = yr;
            w.yi[c] = yi;
          }
          trevc_axpy<CHAIN, S>(rr, ri, col, w.lane, yr, yi);
        }
      }
      // every lane is done with stage k - 1's slot
      __syncwarp();
      if (w.k > 0 && w.lane == 0)
        mbar_arrive(w.empty + (w.slot == 0 ? kTrevcDepth - 1 : w.slot - 1));
      if (++w.slot == kTrevcDepth) {
        w.slot = 0;
        w.phase ^= 1;
      }
    }
  }
  if constexpr (S > 0) trevc_slot<CHAIN, S - 1>(w, rr, ri);
}

// Columns b0 + kTrevcCols blockIdx.x + w of Y (T Y = Y diag(w)), written
// as rows of yt (re, then im n x n further on); T' = T.mT with leading
// dimension ld (even, >= n); n <= kTrevcRingN. is2/prev2 as for
// eig_trevc_warp.
template <bool CHAIN>
__global__ void __launch_bounds__((kTrevcCols + 1) * 32)
eig_trevc_ring(const double* __restrict__ Tt, int ld,
               const double* __restrict__ wr, const double* __restrict__ wi,
               const bool* __restrict__ is2, const bool* __restrict__ prev2,
               int n, const double* __restrict__ sminp, double* yt, int b0) {
  extern __shared__ __align__(16) unsigned char trevc_sm[];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int rs = trevc_stride(n);
  double* const ring = reinterpret_cast<double*>(trevc_sm);
  double* const pre0 = ring + static_cast<size_t>(kTrevcDepth) * rs;
  auto* const full = reinterpret_cast<unsigned long long*>(
      pre0 + static_cast<size_t>(kTrevcCols) * 8 * n);
  unsigned long long* const empty = full + kTrevcDepth;
  unsigned char* const kinds0 =
      reinterpret_cast<unsigned char*>(empty + kTrevcDepth);
  const int j0 = b0 + blockIdx.x * kTrevcCols;
  const int cols = n - j0 < kTrevcCols ? n - j0 : kTrevcCols;
  int cmax = 0;
  for (int q = 0; q < cols; ++q) {
    const int j = j0 + q;
    const int top = prev2[j] ? j : (is2[j] ? j + 1 : j);
    cmax = top > cmax ? top : cmax;
  }
  cmax = cmax < n - 1 ? cmax : n - 1;
  if (threadIdx.x == 0) {
    for (int d = 0; d < kTrevcDepth; ++d) {
      mbar_init_count(full + d, 1);
      mbar_init_count(empty + d, cols);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wid == kTrevcCols) {            // the producer
    if (lane == 0) {
      for (int k = 0; k <= cmax; ++k) {
        const int slot = k % kTrevcDepth;
        if (k >= kTrevcDepth)
          ring_wait(empty + slot, (k / kTrevcDepth - 1) & 1);
        const int c = cmax - k;
        int len = (c + 3) & ~1;       // rows 0..c + 1, an even count
        if (len > ld) len = ld;
        mbar_arm(full + slot, 8 * len);
        bulk_load(ring + static_cast<size_t>(slot) * rs,
                  Tt + static_cast<size_t>(c) * ld, 8 * len, full + slot);
      }
    }
    return;
  }
  if (wid >= cols) return;
  const int j = j0 + wid;
  auto T = [&](int r, int c) { return Tt[static_cast<size_t>(c) * ld + r]; };
  TrevcWalk w;
  w.ring = ring;
  w.pre = pre0 + static_cast<size_t>(wid) * 8 * n;
  w.kinds = kinds0 + static_cast<size_t>(wid) * n;
  w.full = full;
  w.empty = empty;
  w.yr = yt + static_cast<size_t>(j) * n;
  w.yi = yt + static_cast<size_t>(n) * n + static_cast<size_t>(j) * n;
  w.rs = rs;
  w.cmax = cmax;
  w.lane = lane;
  w.k = 0;
  w.slot = 0;
  w.phase = 0;
  w.pr = 0.0;
  w.pi = 0.0;
  const double smin = *sminp, smin2 = mul(smin, smin);
  w.pair = is2[j] || prev2[j];
  w.js = prev2[j] ? j - 1 : j;
  w.top = w.pair ? w.js + 1 : j;
  const int js = w.js;
  // the seed: two algebraically equal forms, the one of larger norm
  const double a_p = T(js, js);
  const double b_p = js < n - 1 ? T(js, js + 1) : 0.0;
  const double c_p = js < n - 1 ? T(js + 1, js) : 0.0;
  const int jd = js + 1 < n - 1 ? js + 1 : n - 1;
  const double d_p = T(jd, jd);
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
  w.tr = quo(tr, snrm);
  w.ti = quo(ti, snrm);
  w.br = quo(br, snrm);
  w.bi = quo(bi, snrm);
  w.mi = -li;
  for (int m = lane; m < n; m += 32) {
    w.yr[m] = 0.0;
    w.yi[m] = 0.0;
  }
  // the row constants, a row a lane
  double* const pre = pre0 + static_cast<size_t>(wid) * 8 * n;
  unsigned char* const kinds = kinds0 + static_cast<size_t>(wid) * n;
  for (int m = lane; m < js; m += 32) {
    const bool blk = is2[m];
    const bool one = !blk && !prev2[m];
    const bool two = blk && m + 1 < js;
    kinds[m] = one ? 1 : (two ? 2 : 0);
    double* p = pre + 8 * m;
    if (one) {
      double den_r = sub(T(m, m), lr), den_i = -li;
      if (hypot(den_r, den_i) < smin) {
        den_r = smin;
        den_i = 0.0;
      }
      p[0] = den_r;
      p[1] = den_i;
      p[2] = add(mul(den_r, den_r), mul(den_i, den_i));
    } else if (two) {
      const double aa = T(m, m), bb = T(m, m + 1);
      const double cc = T(m + 1, m), ddg = T(m + 1, m + 1);
      const double m11r = sub(aa, lr), m11i = -li;
      const double m22r = sub(ddg, lr), m22i = -li;
      double detr = sub(sub(mul(m11r, m22r), mul(m11i, m22i)), mul(bb, cc));
      double deti = add(mul(m11r, m22i), mul(m11i, m22r));
      if (hypot(detr, deti) < smin2) {
        detr = smin2;
        deti = 0.0;
      }
      p[0] = m11r;
      p[1] = m22r;
      p[2] = bb;
      p[3] = cc;
      p[4] = detr;
      p[5] = deti;
      p[6] = add(mul(detr, detr), mul(deti, deti));
    }
  }
  __syncwarp();
  double rr[kTrevcSlots], ri[kTrevcSlots];
#pragma unroll
  for (int q = 0; q < kTrevcSlots; ++q) {
    rr[q] = 0.0;
    ri[q] = 0.0;
  }
  trevc_slot<CHAIN, kTrevcSlots - 1>(w, rr, ri);
  if (lane == 0) mbar_arrive(empty + cmax % kTrevcDepth);
}

// a launch refused at its configuration leaves its error as the last
// error: clear it, or the next unrelated launch check reports it
int launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// `groups` clusters of `blocks` blocks of kResThreads with `smem` bytes of
// dynamic shared memory each; a cooperative launch (every block resident
// at once) with `cooperative`, attr then holding two
cudaLaunchConfig_t cluster_config(int blocks, size_t smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr, int groups = 1,
                                  bool cooperative = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * groups, 1, 1);
  cfg.blockDim = dim3(kResThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cooperative) {
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
  }
  return cfg;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory and a cluster of
// `blocks` (non-portable above 8); `clusters` receives how many such
// clusters the card holds at once (0: it cannot run one).
cudaError_t cluster_prepare(const void* kernel, int blocks, size_t smem,
                            int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(blocks, smem, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

int sm_count(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || v <= 0)
    v = 132;
  return v;
}

}  // namespace

namespace {

// the cooperative eig_hess (the route for n > 627): one launch of as many
// blocks as its passes use and the card holds at once
int hess_grid_run(double* h, double* q, int n, unsigned long long* bar,
                  cudaStream_t s, int device) {
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      eig_hess, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return launched(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eig_hess,
                                                      kHessThreads, smem);
  if (err != cudaSuccess) return launched(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + 31) / 32, rows = (n + kHessWarps - 1) / kHessWarps;
  const int want = tiles > rows ? tiles : rows;
  const int most = per_sm * sm_count(device);
  const int blocks = want < most ? want : most;
  err = cudaMemsetAsync(bar, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&h, &q, &n, &bar};
  return launched(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(eig_hess), dim3(blocks), dim3(kHessThreads),
      args, smem, s));
}

// One launch of the resident eig_hess: the H cluster, and with Q the Q
// cluster beside it, cooperative so that both are resident at once (the Q
// cluster waits on the H cluster's count); flag zeroed on the stream
// first.
template <int MAXQ, bool PROF = false>
int hess_resident_launch(double* h, double* q, int n,
                         unsigned long long* flag, unsigned long long* prof,
                         cudaStream_t s) {
  const size_t smem = res_smem(n);
  const void* k =
      reinterpret_cast<const void*>(eig_hess_resident<MAXQ, PROF>);
  const int groups = q != nullptr ? 2 : 1;
  int clusters = 0;
  cudaError_t err = cluster_prepare(k, kResBlocks, smem, &clusters);
  if (err != cudaSuccess) return launched(err);
  if (clusters < groups)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaMemsetAsync(flag, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg =
      cluster_config(kResBlocks, smem, s, attr, groups, true);
  return launched(cudaLaunchKernelEx(&cfg, eig_hess_resident<MAXQ, PROF>, h,
                                     q, n, flag, prof));
}

// the resident eig_hess (n <= 627): H in one cluster's shared memory (and Q
// in a second's); MAXQ = 16 covers the n - 1 columns right of column 0 up
// to n = 513 (dense_linalg's 512; chunks of columns past n - 1 are
// skipped, so smaller n take the same code and sums), 20 the rest
int hess_resident_run(double* h, double* q, int n, unsigned long long* flag,
                      cudaStream_t s) {
  if (n - 1 <= 32 * 16)
    return hess_resident_launch<16>(h, q, n, flag, nullptr, s);
  return hess_resident_launch<20>(h, q, n, flag, nullptr, s);
}

}  // namespace

// H (n x n float64, row-major) to Hessenberg form in place, Q (n x n, the
// identity on entry) accumulated unless null; n >= 3. barrier: 8 bytes of
// scratch on the card (the cooperative route zeroes it on the stream). One
// launch, routed by n alone: the resident design where res_smem(n) <=
// kResBudget (n <= 627), else the cooperative one.
extern "C" int runmat_eig_hess(void* H, void* Q, int n, void* barrier,
                               void* stream, int device) {
  if (H == nullptr || barrier == nullptr || n < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  double* h = static_cast<double*>(H);
  double* q = static_cast<double*>(Q);
  auto* bar = static_cast<unsigned long long*>(barrier);
  if (res_smem(n) <= kResBudget) return hess_resident_run(h, q, n, bar, s);
  return hess_grid_run(h, q, n, bar, s, device);
}

// Bench only (runmat_tpu_torch/linalgbench.py): the cooperative design at
// any n >= 3 (the earlier kernel, the route above 627), the same arguments as
// runmat_eig_hess.
extern "C" int runmat_eig_hess_grid(void* H, void* Q, int n, void* barrier,
                                    void* stream, int device) {
  if (H == nullptr || barrier == nullptr || n < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return hess_grid_run(static_cast<double*>(H), static_cast<double*>(Q), n,
                       static_cast<unsigned long long*>(barrier),
                       static_cast<cudaStream_t>(stream), device);
}

// Bench only (runmat_tpu_torch/linalgbench.py): the resident eig_hess at
// n <= 513 (the instantiation dense_linalg's 512 takes), as
// runmat_eig_hess launches it (flag: its 8 bytes of scratch), with each H
// block's thread 0 summing clock64 cycles a phase into prof (8 uint64 a
// block, 16 blocks, zeroed by the caller): 0 the wait on exchange 1, 1 the
// scalars, w and v and their sends (and block 0's row of v for Q), 2 the
// wait on exchange 2, 3 the column fix and the row pass, 4 the next
// publication and its sends.
extern "C" int runmat_eig_hess_profile(void* H, void* Q, int n, void* flag,
                                       void* prof, void* stream, int device) {
  if (H == nullptr || flag == nullptr || prof == nullptr || n < 3 ||
      n - 1 > 32 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return hess_resident_launch<16, true>(
      static_cast<double*>(H), static_cast<double*>(Q), n,
      static_cast<unsigned long long*>(flag),
      static_cast<unsigned long long*>(prof),
      static_cast<cudaStream_t>(stream));
}

// Bench only (runmat_tpu_torch/linalgbench.py): `count` barriers with
// nothing between them. design 0: cluster barriers in one cluster of
// `blocks` (<= 16) blocks of kResThreads with `smem` bytes of dynamic shared
// memory each (clusters receives how many such clusters the card holds at
// once; a card that holds none refuses the launch); design 1: grid_sync
// across a cooperative grid of `blocks` blocks of kHessThreads (barrier: 8
// bytes of scratch, zeroed here).
extern "C" int runmat_eig_hess_floor(int design, int blocks, int count,
                                     int smem, void* barrier, int* clusters,
                                     void* stream, int device) {
  if (blocks < 1 || count < 0 || smem < 0 ||
      (design == 0 && (blocks > kResBlocks || clusters == nullptr)) ||
      (design == 1 && barrier == nullptr) || (design != 0 && design != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    const void* k = reinterpret_cast<const void*>(hess_cluster_floor);
    err = cluster_prepare(k, blocks, smem, clusters);
    if (err != cudaSuccess) return launched(err);
    if (*clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(blocks, smem, s, attr);
    return launched(cudaLaunchKernelEx(&cfg, hess_cluster_floor, count));
  }
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* bar = static_cast<unsigned long long*>(barrier);
  void* args[] = {&count, &bar};
  return launched(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(hess_grid_floor), dim3(blocks),
      dim3(kHessThreads), args, 0, s));
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

namespace {

// one launch of the earlier eig_trevc (T row-major), a warp a column
int trevc_warp_run(const void* T, const void* wr, const void* wi,
                   const void* is2, const void* prev2, int n,
                   const void* smin, void* yt, void* stream, int device) {
  if (T == nullptr || wr == nullptr || wi == nullptr || is2 == nullptr ||
      prev2 == nullptr || smin == nullptr || yt == nullptr || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + kTrevcWarps - 1) / kTrevcWarps;
  eig_trevc_warp<<<blocks, kTrevcWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(T), static_cast<const double*>(wr),
      static_cast<const double*>(wi), static_cast<const bool*>(is2),
      static_cast<const bool*>(prev2), n, static_cast<const double*>(smin),
      static_cast<double*>(yt));
  return static_cast<int>(cudaGetLastError());
}

// one launch of eig_trevc_ring over `blocks` blocks from block b0 (Tt =
// T.mT, leading dimension ld: even, >= n; 16-byte aligned)
template <bool CHAIN>
int trevc_ring_run(const void* Tt, int ld, const void* wr, const void* wi,
                   const void* is2, const void* prev2, int n,
                   const void* smin, void* yt, int b0, int blocks,
                   void* stream, int device) {
  if (Tt == nullptr || wr == nullptr || wi == nullptr || is2 == nullptr ||
      prev2 == nullptr || smin == nullptr || yt == nullptr || n < 1 ||
      n > kTrevcRingN || ld < n || ld % 2 != 0 ||
      reinterpret_cast<uintptr_t>(Tt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the largest n's shared memory, opted in to once a process
  static bool opted[64] = {false};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[device]) {
    err = cudaFuncSetAttribute(eig_trevc_ring<CHAIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(trevc_smem(kTrevcRingN)));
    if (err != cudaSuccess) return launched(err);
    opted[device] = true;
  }
  const size_t smem = trevc_smem(n);
  eig_trevc_ring<CHAIN><<<blocks, (kTrevcCols + 1) * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(Tt), ld, static_cast<const double*>(wr),
      static_cast<const double*>(wi), static_cast<const bool*>(is2),
      static_cast<const bool*>(prev2), n, static_cast<const double*>(smin),
      static_cast<double*>(yt), b0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The right eigenvectors of the n x n quasi-triangular T with eigenvalues
// wr + i wi and blocks is2/prev2 (n bytes each): column j of Y into row j
// of yt (2 n x n float64, real then imaginary). smin: dtrevc's smallest
// denominator on the card. One launch, routed by n alone: up to
// kTrevcRingN eig_trevc_ring, T passed as T.mT with an even leading
// dimension ld >= n (16-byte aligned); above it the earlier design, T
// row-major (ld == n).
extern "C" int runmat_eig_trevc(const void* T, int ld, const void* wr,
                                const void* wi, const void* is2,
                                const void* prev2, int n, const void* smin,
                                void* yt, void* stream, int device) {
  if (n <= kTrevcRingN)
    return trevc_ring_run<false>(T, ld, wr, wi, is2, prev2, n, smin, yt, 0,
                                 (n + kTrevcCols - 1) / kTrevcCols, stream,
                                 device);
  if (ld != n) return static_cast<int>(cudaErrorInvalidValue);
  return trevc_warp_run(T, wr, wi, is2, prev2, n, smin, yt, stream, device);
}

// Bench only (runmat_tpu_torch/linalgbench.py): the earlier design (a warp
// a column, T row-major) at any n >= 1, the other arguments as
// runmat_eig_trevc's.
extern "C" int runmat_eig_trevc_warp(const void* T, const void* wr,
                                     const void* wi, const void* is2,
                                     const void* prev2, int n,
                                     const void* smin, void* yt,
                                     void* stream, int device) {
  return trevc_warp_run(T, wr, wi, is2, prev2, n, smin, yt, stream, device);
}

// Bench only (runmat_tpu_torch/linalgbench.py): eig_trevc_ring's last
// block alone (the columns whose walk is longest) with only the slots that
// hold the next row updated: the quotient, shuffle and update chain, the
// kernel's floor (its yt is wrong). The arguments as runmat_eig_trevc's,
// n <= kTrevcRingN.
extern "C" int runmat_eig_trevc_chain(const void* Tt, int ld, const void* wr,
                                      const void* wi, const void* is2,
                                      const void* prev2, int n,
                                      const void* smin, void* yt,
                                      void* stream, int device) {
  const int last = n < 1 ? 0 : (n - 1) / kTrevcCols * kTrevcCols;
  return trevc_ring_run<true>(Tt, ld, wr, wi, is2, prev2, n, smin, yt, last,
                              1, stream, device);
}
