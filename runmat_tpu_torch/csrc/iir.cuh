// IIR filter, direct form II transposed (MATLAB `filter(b, a, x, z0)` with
// a normalised a(1) = 1), on Hopper (sm_90a), bound through ctypes: a
// chunked parallel scan.
//
// Replaces runmat_tpu/accel/dense.py:_b_iir (706-728), a jax.lax.scan that
// XLA compiles into one device loop; it has no Pallas twin. With N
// coefficients (order N-1) and the state z of M = N-1 values, each sample
// does
//   y_i      = b_0 x_i + z_0
//   z_k      = (b_{k+1} x_i + z_{k+1}) - a_{k+1} y_i,   k = 0 .. M-1,
// where z_M is 0: the scan's step, in its order of operations
// (`bv[1:] * xi + concat([z[1:], 0]) - av[1:] * yi`), every product and sum
// a separately rounded __fmul_rn/__fadd_rn/__fsub_rn (f32) or
// __dmul_rn/__dadd_rn/__dsub_rn (f64), no FMA contraction. As a
// state-space system, z_{i+1} = A z_i + beta x_i with A = (shift up by one)
// - a[1:] e_0^T, so over a stretch of L samples the end state is
// A^L z_start + s, s the stretch's end state from a zero state.
//
// What bounds it on this card: not bytes, but the chain. A sample reads
// x_i and writes y_i (16 B in f64: 2^22 samples are 67 MB, 0.020 ms at
// 3.35 TB/s), yet each state waits for the last through about three
// dependent floating-point operations, so one thread walking all 2^22
// samples took 140 ms (the design this one replaces). The design cuts the
// chain into P = ceil(n / L) stretches of L samples (L a power of two,
// chosen by the caller: ops/iir.py's CHUNK, 64, the fastest of 32 .. 4096
// at spectral.m's call on an H100) and runs four phases on the caller's
// stream:
//   1. powers: one block squares A in shared memory, writing
//      Q[e] = A^(2^e) for every e the carry scan needs (G = A^L = Q[lg L]);
//      nothing is read back to the host;
//   2. chunk states: one thread a stretch walks it from a zero state with
//      the step above and writes its end state s_j (stretch 0 too, so that
//      z0 enters only through the carries); V[0] = z0, V[j+1] = s_j;
//   3. carries: the inclusive scan c_j = G c_{j-1} + V[j], c_0 = z0, so
//      c_j is the state entering stretch j. The powers and the carries are
//      double whatever the signal's type: a float32 filter with a pole near
//      the unit circle loses ~50 times its sequential scan's accuracy
//      through float32 powers (G^(2^k) by squaring carries an error that
//      grows with the exponent), and keeps it in double. A block of
//      kScanThreads threads takes a run of R consecutive elements a thread
//      (R = 16 for orders up to 4, fewer above, so that a run fits in
//      registers; V is laid out so that the block loads and stores runs
//      coalesced, `slot`): each thread folds its run, the block scans the
//      runs' totals in log steps over the powers G^(R 2^k) (Hillis-Steele,
//      through shared memory, where the block stages the powers it uses),
//      and each thread walks its run again from its prefix, writing c_j in
//      place of V[j]. Where more than one block is needed, a first launch
//      writes each block's total; up to kScanThreads of them, the second
//      launch's blocks each scan the totals the same way (step matrix
//      G^(kScanThreads R)) to find the value before themselves, so two
//      launches cover 2^22 samples at any L >= 16; beyond, the totals are
//      scanned one level up first. A block starts from the value c before
//      it: v' = G c + v at its first element. The element c_0 is z0 copied,
//      never recomputed;
//   4. output: one thread a stretch walks it again from c_j (rounded to
//      the signal's type), same step, writing y. Stretch 0 starts from z0
//      itself, so its L outputs, and the whole call when n <= L (a single
//      stretch, phases 1-3 skipped), are bit-equal to the sequential scan.
//      Elsewhere the carried states are rounded in another order (the
//      carry arithmetic may contract into FMAs); the error is held to a
//      tolerance (ops/iir.py).
// Phases 2 and 4 stage x (and y on the way out) through shared memory in
// tiles of kTile samples of each of the block's kWalkThreads stretches:
// the block loads a tile coalesced (runs of kTile consecutive samples)
// while each thread walks the previous one from a row padded against bank
// conflicts; the next tile's loads are issued into registers before the
// current tile is walked, so their latency hides behind the chain. The
// coefficients and the state stay in registers (N is a template argument,
// so every index into them is known when compiling). Phases 2 and 4 read
// x twice and write y once: about 1.5 times the bytes of the bound.
//
// A NaN or Inf in x reaches every later output of the sequential scan; here
// it reaches s_j, every later carry (a non-finite component makes every
// component of G c non-finite) and so every later output.
//
// Orders 1 .. kMaxN-1. The launches use the caller's stream, allocate
// nothing (the caller passes the scratch, `runmat_iir_scratch` bytes) and
// do not synchronise; the C entry returns the first cudaGetLastError()
// that is not cudaSuccess. The float64 instantiations and the C entries
// are compiled in iir.cu, the float32 ones in iir_f32.cu, so that nvcc
// builds the two halves side by side.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 33;
constexpr int kWalkThreads = 128;  // stretches a block of phases 2 and 4
constexpr int kLgTile = 5;
constexpr int kTile = 1 << kLgTile;  // samples of each stretch a tile
constexpr int kLgScanThreads = 7;
constexpr int kScanThreads = 1 << kLgScanThreads;
// log2 of the carries a scan thread folds in order (its run, at most 64
// doubles, held in registers) and of those a scan block covers
__host__ __device__ constexpr int lg_run(int m) {
  return m <= 4 ? 4 : m <= 8 ? 3 : m <= 16 ? 2 : 1;
}
__host__ __device__ constexpr int lg_block(int m) {
  return kLgScanThreads + lg_run(m);
}

// Where carry i of a scan level lies (its component k at + k *
// kScanThreads): a block's carries are stored by run position, component
// and thread, so that the block's threads read and write them coalesced
// (element r of every thread's run, component k, side by side).
__host__ __device__ inline int64_t slot(int64_t i, int m) {
  const int lg = lg_run(m);
  const int64_t block = i >> lg_block(m);
  const int t = static_cast<int>((i >> lg) & (kScanThreads - 1));
  const int r = static_cast<int>(i & ((1 << lg) - 1));
  return ((block << lg_block(m)) + int64_t(r) * kScanThreads) * m + t;
}
constexpr int kMaxLgChunk = 20;
constexpr int kMaxLevels = 8;

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

// Phase 1: Q[e] = A^(2^e), e = 0 .. count-1, in double whatever T, by
// squaring in shared memory; one block of M * M threads, thread (r, c)
// owns element (r, c).
template <typename T, int M>
__global__ void __launch_bounds__(M * M) powers_kernel(
    const T* __restrict__ ap, double* __restrict__ q, int count) {
  __shared__ double m[M][M + 1];
  const int r = threadIdx.x / M, c = threadIdx.x % M;
  m[r][c] = (c == 0 ? -static_cast<double>(ap[r + 1]) : 0.0) +
            (c == r + 1 ? 1.0 : 0.0);
  for (int e = 0; e < count; ++e) {
    __syncthreads();
    q[(static_cast<int64_t>(e) * M + r) * M + c] = m[r][c];
    if (e + 1 == count) break;
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < M; ++k) acc += m[r][k] * m[k][c];
    __syncthreads();
    m[r][c] = acc;
  }
}

// Phases 2 (kOut false) and 4 (kOut true): thread j of the grid walks
// stretch j, samples [j L, (j + 1) L), L = 2^lg_chunk; samples at or past n
// read as 0 and are not written. Phase 2 starts from zero and writes its
// end state to states[j + 1] (the last stretch's is not needed) and z0 to
// states[0], in double; phase 4 starts from states[j] rounded to T
// (stretch 0 from z0 itself) and writes y.
template <typename Op, int N, bool kOut>
__global__ void __launch_bounds__(kWalkThreads) walk_kernel(
    const typename Op::T* __restrict__ x, typename Op::T* __restrict__ y,
    int64_t n, int lg_chunk, const typename Op::T* __restrict__ bp,
    const typename Op::T* __restrict__ ap,
    const typename Op::T* __restrict__ z0, double* states,
    int64_t stretches) {
  using T = typename Op::T;
  constexpr int M = N - 1;
  __shared__ T tile[kWalkThreads][kTile + 1];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWalkThreads;
  const int64_t j = first + threadIdx.x;
  const int64_t chunk = int64_t(1) << lg_chunk;
  const int lg_w = lg_chunk < kLgTile ? lg_chunk : kLgTile;
  const int w = 1 << lg_w;

  T b[N], a[N], z[M];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    b[k] = bp[k];
    a[k] = ap[k];
  }
#pragma unroll
  for (int k = 0; k < M; ++k)
    z[k] = !kOut ? T(0)
           : j == 0 ? z0[k]
           : j < stretches
               ? static_cast<T>(states[slot(j, M) + k * kScanThreads])
               : T(0);
  if (!kOut && blockIdx.x == 0 && threadIdx.x < M)
    states[threadIdx.x * kScanThreads] = z0[threadIdx.x];

  // this thread's share of a tile of w samples of each of the block's
  // stretches: element q * kWalkThreads + tid, q < w, which is row
  // q * rows + r0, column c0
  const int rows = kWalkThreads >> lg_w;
  const int r0 = threadIdx.x >> lg_w, c0 = threadIdx.x & (w - 1);
  const int64_t g0 = ((first + r0) << lg_chunk) + c0;
  const int64_t dg = static_cast<int64_t>(rows) << lg_chunk;
  T* const t0 = &tile[r0][c0];
  const int dt = rows * (kTile + 1);
  T nxt[kTile];
  auto load = [&](int64_t s) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int64_t g = g0 + s + q * dg;
      nxt[q] = q < w && g < n ? x[g] : T(0);
    }
  };
  load(0);
  for (int64_t s = 0; s < chunk; s += w) {
    __syncthreads();  // the last tile is walked (and stored)
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      if (q < w) t0[q * dt] = nxt[q];
    }
    __syncthreads();
    if (s + w < chunk) load(s + w);
#pragma unroll 8
    for (int c = 0; c < w; ++c) {
      const T yi = step<Op, N>(tile[threadIdx.x][c], z, b, a);
      if (kOut) tile[threadIdx.x][c] = yi;
    }
    if (kOut) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const int64_t g = g0 + s + q * dg;
        if (q < w && g < n) y[g] = t0[q * dt];
      }
    }
  }
  if (!kOut && j + 1 < stretches) {
#pragma unroll
    for (int k = 0; k < M; ++k)
      states[slot(j + 1, M) + k * kScanThreads] = z[k];
  }
}

// out = g u + v: g an M x M matrix (row-major, in shared or device
// memory), out may be u or v. Unrolled for M <= 8, so that the vectors
// stay in registers; above, loops (the vectors then live in local memory,
// which keeps the build short for the orders no script reaches).
template <int M>
__device__ __forceinline__ void affine(const double* g, const double (&u)[M],
                                       const double (&v)[M],
                                       double (&out)[M]) {
  double r[M];
  if constexpr (M <= 8) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      double acc = v[i];
#pragma unroll
      for (int k = 0; k < M; ++k) acc += g[i * M + k] * u[k];
      r[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) out[i] = r[i];
  } else {
#pragma unroll 1
    for (int i = 0; i < M; ++i) {
      double acc = v[i];
#pragma unroll 1
      for (int k = 0; k < M; ++k) acc += g[i * M + k] * u[k];
      r[i] = acc;
    }
#pragma unroll 1
    for (int i = 0; i < M; ++i) out[i] = r[i];
  }
}

// The block's threads' values c, scanned in place in log steps (Hillis-
// Steele): thread t ends with sum over t' <= t of P^(t - t') c_t', where
// mat(k) is P^(2^k). sh holds each thread's value (row stride S) on entry
// and on return.
template <int M, int S, typename Mat>
__device__ __forceinline__ void block_scan(double (&c)[M], double* sh,
                                           Mat mat) {
  const int t = threadIdx.x;
  for (int k = 0; k < kLgScanThreads; ++k) {
    const int d = 1 << k;
    __syncthreads();
    if (t >= d) {
      double u[M];
#pragma unroll
      for (int r = 0; r < M; ++r) u[r] = sh[(t - d) * S + r];
      affine<M>(mat(k), u, c, c);
    }
    __syncthreads();
    if (t >= d) {
#pragma unroll
      for (int r = 0; r < M; ++r) sh[t * S + r] = c[r];
    }
  }
  __syncthreads();
}

// Phase 3, one level: the inclusive scan c_i = G c_{i-1} + v_i over
// `count` elements of M values (row-major in v, double whatever the
// signal's type, so that a float32 filter's carries keep the accuracy of
// its sequential scan), G = Q[e_step], in blocks of kScanThreads runs of
// 2^lg_run(M) elements, each run loaded into registers at once. The
// powers a block uses (G, G^(R 2^k), G^(B 2^k) for its block of B
// elements) are staged in shared memory for orders up to 8. Modes:
//   totals given: each block writes only its total (the scan of its
//     elements from zero, at its last element);
//   otherwise each block writes its scan in place of v, its first element
//     taking G cin + v, cin the value before the block: where `carry` is
//     given, carry[block - 1] if `ntotals` is 0 (the scanned totals of the
//     level above), else the scan of the ntotals (<= kScanThreads)
//     unscanned totals in `carry` up to block - 1, made by each block in
//     shared memory, so that two launches cover up to kScanThreads blocks.
// Element 0 of block 0 is copied, never recomputed.
template <int M>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    double* v, int64_t count, const double* __restrict__ q, int e_step,
    const double* __restrict__ carry, int ntotals,
    double* __restrict__ totals) {
  constexpr int kLg = lg_run(M);
  constexpr int R = 1 << kLg;
  constexpr int S = M | 1;  // an odd row stride: no bank conflicts
  constexpr bool kStaged = M <= 8;
  constexpr int kMats = 1 + 2 * kLgScanThreads;
  __shared__ double sh[kScanThreads * S];
  __shared__ double qs[kStaged ? kMats * M * M : 1];
  const int t = threadIdx.x;
  const int64_t lo = (static_cast<int64_t>(blockIdx.x) * kScanThreads + t)
                     << kLg;
  const int len = count - lo >= R ? R : count > lo ? int(count - lo) : 0;
  const int64_t base = slot(lo, M);  // this thread's run: base + r M T + k T
  const bool carried = carry != nullptr && blockIdx.x > 0;
  const bool chained = carry != nullptr && ntotals > 0;
  // the powers: slot 0 G, 1 + k G^(R 2^k), 1 + kLgScanThreads + k
  // G^(B 2^k), at Q[e_step], Q[e_step + kLg + k], Q[e_step + lg_block + k]
  auto power = [&](int slot) {
    return slot == 0 ? e_step
           : slot <= kLgScanThreads ? e_step + kLg + slot - 1
                                    : e_step + lg_block(M) + slot - 1 -
                                          kLgScanThreads;
  };
  auto mat = [&](int slot) -> const double* {
    return kStaged ? qs + slot * M * M
                   : q + static_cast<int64_t>(power(slot)) * M * M;
  };
  double w[R][M], c[M], cin[M];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k)
      w[i][k] = i < len ? v[base + (i * M + k) * kScanThreads] : 0.0;
  }
  if (kStaged) {
    const int used = chained ? kMats : 1 + kLgScanThreads;
    for (int i = t; i < used * M * M; i += kScanThreads)
      qs[i] = q[static_cast<int64_t>(power(i / (M * M))) * M * M +
                i % (M * M)];
  }
  if (chained) {
    // the value before this block, from the level's unscanned totals
#pragma unroll
    for (int k = 0; k < M; ++k) {
      cin[k] = t < ntotals ? carry[slot(t, M) + k * kScanThreads] : 0.0;
      sh[t * S + k] = cin[k];
    }
    block_scan<M, S>(cin, sh, [&](int k) {
      return mat(1 + kLgScanThreads + k);
    });
#pragma unroll
    for (int k = 0; k < M; ++k)
      cin[k] = blockIdx.x > 0 ? sh[(blockIdx.x - 1) * S + k] : 0.0;
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k)
      cin[k] = carried ? carry[slot(blockIdx.x - 1, M) + k * kScanThreads]
                       : 0.0;
  }
  __syncthreads();
  // fold the run (thread 0 from the value before the block, if any)
  bool have = carried && t == 0;
#pragma unroll
  for (int k = 0; k < M; ++k) c[k] = cin[k];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < len) {
      if (have) {
        affine<M>(mat(0), c, w[i], c);
      } else {
#pragma unroll
        for (int k = 0; k < M; ++k) c[k] = w[i][k];
      }
      have = true;
    }
  }
  // the runs' totals, scanned: thread t then holds the inclusive value at
  // the end of its run (every run before the last is full)
#pragma unroll
  for (int k = 0; k < M; ++k) sh[t * S + k] = have ? c[k] : 0.0;
  block_scan<M, S>(c, sh, [&](int k) { return mat(1 + k); });
  if (totals != nullptr) {
    if (t == kScanThreads - 1) {
#pragma unroll
      for (int k = 0; k < M; ++k)
        totals[slot(blockIdx.x, M) + k * kScanThreads] = c[k];
    }
    return;
  }
  // walk the run again from the value before it
  have = t > 0 || carried;
#pragma unroll
  for (int k = 0; k < M; ++k) c[k] = t > 0 ? sh[(t - 1) * S + k] : cin[k];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < len) {
      if (have) {
        affine<M>(mat(0), c, w[i], c);
      } else {
#pragma unroll
        for (int k = 0; k < M; ++k) c[k] = w[i][k];
      }
#pragma unroll
      for (int k = 0; k < M; ++k) v[base + (i * M + k) * kScanThreads] = c[k];
      have = true;
    }
  }
}

// Where each part of the scratch lies, for n samples, M states and
// stretches of 2^lg_chunk samples: the powers Q, then one buffer of
// carries a scan level (level 0 is V, one element a stretch).
struct Layout {
  int64_t stretches;
  int levels;              // scan levels (0: a single stretch, no scan)
  int powers;              // matrices in Q
  int64_t count[kMaxLevels];
  int64_t off[kMaxLevels];
  int64_t bytes;
};

Layout layout(int64_t n, int m, int lg_chunk) {
  constexpr int elem = sizeof(double);
  Layout l{};
  l.stretches = n > 0 ? ((n - 1) >> lg_chunk) + 1 : 0;
  if (l.stretches <= 1) return l;
  int64_t c = l.stretches;
  l.count[0] = c;
  l.levels = 1;
  const int lg = lg_block(m);
  while (c > (int64_t(1) << lg) && l.levels < kMaxLevels) {
    c = ((c - 1) >> lg) + 1;
    l.count[l.levels++] = c;
  }
  l.powers = lg_chunk + l.levels * lg;
  auto align = [](int64_t b) { return (b + 255) / 256 * 256; };
  int64_t at = align(static_cast<int64_t>(l.powers) * m * m * elem);
  for (int k = 0; k < l.levels; ++k) {
    l.off[k] = at;
    // whole scan blocks: the last one's slots lie past its carries
    at += align((((l.count[k] - 1) >> lg) + 1) * (int64_t(1) << lg) * m *
                elem);
  }
  l.bytes = at;
  return l;
}

template <int M>
cudaError_t scan_level(const Layout& l, char* scratch, const double* q,
                       int level, int e_step, cudaStream_t s) {
  double* v = reinterpret_cast<double*>(scratch + l.off[level]);
  const int64_t count = l.count[level];
  const int64_t blocks = ((count - 1) >> lg_block(M)) + 1;
  if (blocks == 1) {
    scan_kernel<M><<<1, kScanThreads, 0, s>>>(v, count, q, e_step, nullptr,
                                               0, nullptr);
    return cudaGetLastError();
  }
  double* up = reinterpret_cast<double*>(scratch + l.off[level + 1]);
  scan_kernel<M><<<blocks, kScanThreads, 0, s>>>(v, count, q, e_step,
                                                  nullptr, 0, up);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // up to kScanThreads totals: each block scans them itself
  const int chained = blocks <= kScanThreads ? static_cast<int>(blocks) : 0;
  if (!chained) {
    err = scan_level<M>(l, scratch, q, level + 1, e_step + lg_block(M), s);
    if (err != cudaSuccess) return err;
  }
  scan_kernel<M><<<blocks, kScanThreads, 0, s>>>(v, count, q, e_step, up,
                                                  chained, nullptr);
  return cudaGetLastError();
}

// the phases up to `upto` (1 powers, 2 chunk states, 3 carries, 4 output;
// a single stretch runs phase 4 alone, from z0)
template <typename Op, int N>
cudaError_t run_n(const void* xv, void* yv, int64_t n, int lg_chunk,
                  const void* bv, const void* av, const void* zv,
                  void* scratch, int upto, cudaStream_t s) {
  using T = typename Op::T;
  constexpr int M = N - 1;
  const T* x = static_cast<const T*>(xv);
  const T* b = static_cast<const T*>(bv);
  const T* a = static_cast<const T*>(av);
  const T* z0 = static_cast<const T*>(zv);
  const Layout l = layout(n, M, lg_chunk);
  const int64_t grid = (l.stretches + kWalkThreads - 1) / kWalkThreads;
  if (l.levels == 0) {
    if (upto < 4) return cudaSuccess;
    walk_kernel<Op, N, true><<<grid, kWalkThreads, 0, s>>>(
        x, static_cast<T*>(yv), n, lg_chunk, b, a, z0, nullptr,
        l.stretches);
    return cudaGetLastError();
  }
  char* base = static_cast<char*>(scratch);
  double* q = reinterpret_cast<double*>(base);
  double* states = reinterpret_cast<double*>(base + l.off[0]);
  powers_kernel<T, M><<<1, M * M, 0, s>>>(a, q, l.powers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || upto < 2) return err;
  walk_kernel<Op, N, false><<<grid, kWalkThreads, 0, s>>>(
      x, nullptr, n, lg_chunk, b, a, z0, states, l.stretches);
  err = cudaGetLastError();
  if (err != cudaSuccess || upto < 3) return err;
  err = scan_level<M>(l, base, q, 0, lg_chunk, s);
  if (err != cudaSuccess || upto < 4) return err;
  walk_kernel<Op, N, true><<<grid, kWalkThreads, 0, s>>>(
      x, static_cast<T*>(yv), n, lg_chunk, b, a, z0, states, l.stretches);
  return cudaGetLastError();
}

// N = 2 .. kMaxN, one instantiation each
template <typename Op, int N>
cudaError_t dispatch(int ncoef, const void* x, void* y, int64_t n,
                     int lg_chunk, const void* b, const void* a,
                     const void* z0, void* scratch, int upto,
                     cudaStream_t s) {
  if (ncoef == N)
    return run_n<Op, N>(x, y, n, lg_chunk, b, a, z0, scratch, upto, s);
  if constexpr (N < kMaxN) {
    return dispatch<Op, N + 1>(ncoef, x, y, n, lg_chunk, b, a, z0, scratch,
                               upto, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace
