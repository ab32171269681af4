// IIR filter, direct form II transposed, of orders 1 .. 64 (MATLAB
// `filter(b, a, x, z0)` with a normalised a(1) = 1), on Hopper (sm_90a),
// bound through ctypes: a chunked scan with one warp walking each stretch.
//
// Replaces runmat_tpu/accel/dense.py:_b_iir (706-728), a jax.lax.scan that
// XLA compiles into one device loop, for the orders 33 .. 64 (ops/iir.py
// routes orders 1 .. 32 to the scan of iir.cuh, whose state sits in one
// thread's registers, and orders above 64 to iir_seq.cu). With N
// coefficients and the state z of M = N-1 values, each sample does
//   y_i      = b_0 x_i + z_0
//   z_k      = (b_{k+1} x_i + z_{k+1}) - a_{k+1} y_i,   k = 0 .. M-1,
// where z_M is 0: the scan's step in its order of operations, every
// product, sum and difference a separately rounded __fmul_rn/__fadd_rn/
// __fsub_rn (f32) or __dmul_rn/__dadd_rn/__dsub_rn (f64), no FMA
// contraction. As a state-space system z_{i+1} = A z_i + beta x_i, A the
// companion matrix (shift up by one, -a[1:] in the first column), so over
// a stretch of L samples the end state is A^L z_start + s, s the stretch's
// end state from a zero state.
//
// What bounds it on this card: the chain, not bytes. Sample i needs the
// state sample i-1 wrote; the bytes (x read, y written once) would take
// 1.3 us for 2^18 f64 samples at 3.35 TB/s. iir_seq.cu walks the whole
// record in one block at one barrier a sample (~280 cycles); this design
// cuts the record into P = ceil(n / L) stretches of L samples (L a power
// of two chosen by the caller, ops/iir.py's `warp_shape`) and shortens
// each sample's chain:
//   the walk: one warp a stretch. Lane l owns the states 2l and 2l+1 and
//      their coefficients in registers (M <= 64). A batch of 8 samples'
//      x is read from shared memory and multiplied by b first, off the
//      chain. A sample: every lane takes the next lane's first state from
//      the previous sample (__shfl_down_sync, off the y chain), lane 0
//      computes y from its z_0, __shfl_sync broadcasts it, and each lane
//      updates its two states; lane 0 also keeps z_0 apart, updated from
//      its own y, so that its chain (DADD, DMUL, DSUB) waits for no
//      shuffle. No barrier and no shared-memory state. x comes in and y
//      goes out through shared memory in coalesced tiles of kTile
//      samples, the next tile loaded into registers while the warp walks
//      this one. One warp walks ~73 cycles a sample; with several warps
//      an SM sub-partition the walks are bound by issue, ~36 cycles of
//      one warp's instructions a sample;
//   1. chunk states: the walk of every stretch but the last from a zero
//      state, writing its end state s_j: V[0] = z0, V[j+1] = s_j, double.
//      Beside the stretches, M more warps make G = A^L: warp k walks L
//      samples of x = 0 from e_k in double whatever the signal's type
//      (float32 powers and carries lose ~50 times the accuracy near a
//      pole; PERF.md), so G costs no launch and no time of its own (one
//      block squaring A log2 L times took ~3 us a squaring at M = 39 on
//      an H100, more than the walks);
//   2. carries: c_0 = z0, c_j = G c_{j-1} + V[j], so c_j is the state
//      entering stretch j, in double. One block of kCarryThreads threads
//      does a carry as a block-wide matvec (G in registers, two threads a
//      row, one barrier a carry), the carries streamed through shared
//      memory in tiles. Over levels of groups of g = 2^lg_group: each
//      group's block scans it from zero for its total, the totals are
//      scanned the same way a level up with G^g (in groups again while
//      they are more than g), and each group's block scans it again from
//      the total before it: about 2 g carries in a row a level, not P.
//      Beside each level's first launch, M more blocks make the next
//      level's matrix G^g, applying G g times to e_k;
//   3. output: the walk of every stretch again from c_j (rounded to the
//      signal's type), writing y. Stretch 0 starts from z0 itself, so its
//      L outputs, and the whole call when n <= L (phase 3 alone), are
//      bit-equal to the sequential scan. Elsewhere the carries are summed
//      in another order (their multiply-adds contract into FMAs), and the
//      error is held to a tolerance (ops/iir.py).
//
// A NaN in x reaches every later output of the sequential scan; here it
// reaches s_j, every later carry (G c has a NaN in every component where c
// has one in any) and so every later output.
//
// The launches use the caller's stream, allocate nothing (the caller
// passes the scratch, `runmat_iir_warp_scratch` bytes) and do not
// synchronise; the C entry returns the first cudaGetLastError() that is
// not cudaSuccess.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxM = 64;                 // two states a lane of a warp
constexpr int kWalkWarps = 2;             // stretches a block of the walk
constexpr int kTile = 128;                // samples of a stretch a tile
constexpr int kPerLane = kTile / 32;
constexpr int kBatch = 8;                 // samples whose x is read at once
constexpr int kCarryTile = 32;            // carries a tile (phase 2)
constexpr int kCarryThreads = 2 * kMaxM;  // two threads a row of G
constexpr int kMaxLevels = 8;
constexpr int kMaxLgChunk = 20;
constexpr int kMaxLgGroup = 12;

struct W32 {
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

struct W64 {
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

// G = A^L, column k = A^L e_k, by one warp: the walk's step over L
// samples of x = 0 with b = 0, in double whatever the signal's type, from
// z = e_k (each step is z <- A z, one rounding an element); written to
// g[r M + k]. The phase-1 launch runs these warps beside the stretches.
template <typename TA>
__device__ void basis_walk(const TA* __restrict__ ap, int m, int k,
                           int64_t steps, double* __restrict__ g) {
  const int lane = threadIdx.x & 31, k0 = 2 * lane, k1 = k0 + 1;
  const bool has_lo = k0 < m, has_hi = k1 < m, feed = k1 + 1 < m;
  const double alo = has_lo ? static_cast<double>(ap[k0 + 1]) : 0.0;
  const double ahi = has_hi ? static_cast<double>(ap[k1 + 1]) : 0.0;
  double zlo = k0 == k ? 1.0 : 0.0, zhi = k1 == k ? 1.0 : 0.0;
  double head = zlo;
#pragma unroll 8
  for (int64_t i = 0; i < steps; ++i) {
    const double next = __shfl_down_sync(kFull, zlo, 1);
    const double up = feed ? next : 0.0;
    const double yi = __shfl_sync(kFull, head, 0);
    const double z1 = zhi;
    head = __dsub_rn(z1, __dmul_rn(alo, head));
    zlo = __dsub_rn(z1, __dmul_rn(alo, yi));
    zhi = has_hi ? __dsub_rn(up, __dmul_rn(ahi, yi)) : 0.0;
  }
  if (has_lo) g[k0 * m + k] = zlo;
  if (has_hi) g[k1 * m + k] = zhi;
}

// Phases 1 (kOut false) and 3 (kOut true): warp w of block b walks stretch
// j = b kWalkWarps + w, samples [j L, j L + L) below n, L = 2^lg_chunk.
// Phase 1 starts from zero and writes its end state to states[j + 1] (the
// last stretch is not walked: its end state is not needed) and z0 to
// states[0]; phase 3 starts from states[j] rounded to T (stretch 0 from z0
// itself) and writes y. Lanes past the state (2 l >= M) hold zeros that
// no lane reads. In phase 1 the blocks past the stretches' make G
// (`basis_walk`, a column a warp) into g.
template <typename Op, bool kOut>
__global__ void __launch_bounds__(kWalkWarps * 32) walk_kernel(
    const typename Op::T* __restrict__ x, typename Op::T* __restrict__ y,
    int64_t n, int lg_chunk, int m, const typename Op::T* __restrict__ bp,
    const typename Op::T* __restrict__ ap,
    const typename Op::T* __restrict__ z0, double* __restrict__ states,
    int64_t stretches, double* __restrict__ g) {
  using T = typename Op::T;
  __shared__ T xs[kWalkWarps][kTile];
  __shared__ T ys[kOut ? kWalkWarps : 1][kOut ? kTile : 1];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t walks = kOut ? stretches : stretches - 1;
  const int64_t walk_blocks = (walks + kWalkWarps - 1) / kWalkWarps;
  if (!kOut && blockIdx.x >= walk_blocks) {
    const int k = static_cast<int>(blockIdx.x - walk_blocks) * kWalkWarps + w;
    if (k < m) basis_walk(ap, m, k, int64_t(1) << lg_chunk, g);
    return;
  }
  if (!kOut && blockIdx.x == 0) {
    for (int k = threadIdx.x; k < m; k += blockDim.x)
      states[k] = static_cast<double>(z0[k]);
  }
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWalkWarps + w;
  if (j >= walks) return;  // the whole warp
  const int k0 = 2 * lane, k1 = k0 + 1;
  const bool has_lo = k0 < m, has_hi = k1 < m;
  const bool feed = k1 + 1 < m;  // the next lane's first state is a state
  const T b0 = bp[0];
  const T blo = has_lo ? bp[k0 + 1] : T(0), alo = has_lo ? ap[k0 + 1] : T(0);
  const T bhi = has_hi ? bp[k1 + 1] : T(0), ahi = has_hi ? ap[k1 + 1] : T(0);
  T zlo = T(0), zhi = T(0);
  if (kOut) {
    if (j == 0) {
      zlo = has_lo ? z0[k0] : T(0);
      zhi = has_hi ? z0[k1] : T(0);
    } else {
      const double* c = states + j * m;
      zlo = has_lo ? static_cast<T>(c[k0]) : T(0);
      zhi = has_hi ? static_cast<T>(c[k1]) : T(0);
    }
  }
  // lane 0's z_0 kept apart and updated from lane 0's own y: the y chain
  // (DADD, DMUL, DSUB) then holds no shuffle; the other lanes take y from
  // the broadcast, and zlo, which the lane below reads, is not read in
  // lane 0
  T head = zlo;
  const int64_t start = j << lg_chunk;
  const int64_t chunk = int64_t(1) << lg_chunk;
  const int64_t len = n - start < chunk ? n - start : chunk;
  T nxt[kPerLane];
  auto load = [&](int64_t s) {
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int64_t i = s + q * 32 + lane;
      nxt[q] = i < len ? x[start + i] : T(0);
    }
  };
  load(0);
  for (int64_t s = 0; s < len; s += kTile) {
    const int count = static_cast<int>(len - s < kTile ? len - s : kTile);
    __syncwarp();  // the last tile is walked and stored
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) xs[w][q * 32 + lane] = nxt[q];
    __syncwarp();
    if (s + kTile < len) load(s + kTile);
    // a batch of kBatch samples: their x read and their products with b
    // formed first (off the chain), then the steps
    for (int i0 = 0; i0 < count; i0 += kBatch) {
      const int nb = count - i0 < kBatch ? count - i0 : kBatch;
      T p0[kBatch], plo[kBatch], phi[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const T xi = xs[w][i0 + u];  // past count: the tile's stale tail
        p0[u] = Op::mul(b0, xi);
        plo[u] = Op::mul(blo, xi);
        phi[u] = Op::mul(bhi, xi);
      }
      auto step = [&](int u) {
        const T next = __shfl_down_sync(kFull, zlo, 1);
        const T up = feed ? next : T(0);
        const T yl = Op::add(p0[u], head);  // y, in lane 0
        const T yi = __shfl_sync(kFull, yl, 0);
        const T bz = Op::add(plo[u], zhi);
        head = Op::sub(bz, Op::mul(alo, yl));
        zlo = Op::sub(bz, Op::mul(alo, yi));
        const T hi = Op::sub(Op::add(phi[u], up), Op::mul(ahi, yi));
        zhi = has_hi ? hi : T(0);
        if (kOut && lane == 0) ys[w][i0 + u] = yl;
      };
      if (nb == kBatch) {  // one block of straight code to schedule
#pragma unroll
        for (int u = 0; u < kBatch; ++u) step(u);
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < nb) step(u);
        }
      }
    }
    if (kOut) {
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int i = q * 32 + lane;
        if (i < count) y[start + s + i] = ys[w][i];
      }
    }
  }
  if (!kOut) {
    double* out = states + (j + 1) * m;
    if (has_lo) out[k0] = static_cast<double>(zlo);
    if (has_hi) out[k1] = static_cast<double>(zhi);
  }
}

// Phase 2, one level: the inclusive scan c_i = G c_{i-1} + v_i over the
// elements [b per, min(count, (b + 1) per)) of block b (M values each,
// row-major in v, double). Block b > 0 starts from cin[b - 1] where cin is
// given (c = G cin + v at its first element); otherwise its first element
// is copied. With `totals`, the block writes only its last value, to
// totals[b]; otherwise it writes each value in place of v. Two threads a
// row of G: thread (r, q) holds G[r][4 i + 2 q + e], i < kMaxM / 4,
// e < 2, in registers, reads those columns of the carry from shared memory
// 16 bytes at a time (the warp's two threads of a row read adjacent 16
// bytes: no bank conflict), and one shuffle sums the row. The elements
// pass through shared memory in tiles of kCarryTile (rows padded with
// zeros to kMaxM), the next tile copied in (cp.async) while the block
// scans this one, so that a carry's step touches no device memory: one
// barrier a carry. Where `power` is given, the blocks past the groups make
// the next level's matrix: block groups + k applies G `per` times to e_k
// and writes the result, column k of G^per, to power[r M + k].
__global__ void __launch_bounds__(kCarryThreads) carry_kernel(
    double* v, int64_t count, int64_t per, int m, const double* __restrict__ g,
    const double* __restrict__ cin, double* __restrict__ totals,
    double* __restrict__ power) {
  constexpr int kC = kMaxM / 2;  // columns a thread
  __shared__ __align__(16) double vt[2][kCarryTile * kMaxM];
  __shared__ __align__(16) double cs[kMaxM];
  const int t = threadIdx.x, r = t / 2, q = t % 2;
  const bool own = q == 0 && r < m;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t hi = count - lo < per ? count : lo + per;
  const int64_t groups = (count - 1) / per + 1;
  const bool basis = power != nullptr && blockIdx.x >= groups;
  // elements [first, first + cnt) into buffer buf, row k at k * kMaxM
  auto fetch = [&](int buf, int64_t first, int cnt) {
    const double* src = v + first * m;
    for (int i = t; i < cnt * m; i += kCarryThreads)
      __pipeline_memcpy_async(&vt[buf][(i / m) * kMaxM + i % m], src + i,
                              sizeof(double));
    __pipeline_commit();
  };
  auto tile_len = [&](int64_t first) {
    return static_cast<int>(hi - first < kCarryTile ? hi - first
                                                    : kCarryTile);
  };
  if (!basis) fetch(0, lo, tile_len(lo));
  double gr[kC];
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 4 * i + 2 * q + e;
      gr[2 * i + e] = r < m && c < m ? g[r * m + c] : 0.0;
    }
  }
  // G prev, summed across the row's two threads
  auto matvec = [&](const double* prev) {
    double acc[4] = {};
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) {
      const double2 p = *reinterpret_cast<const double2*>(prev + 4 * i + 2 * q);
      acc[(2 * i) % 4] = fma(gr[2 * i], p.x, acc[(2 * i) % 4]);
      acc[(2 * i + 1) % 4] = fma(gr[2 * i + 1], p.y, acc[(2 * i + 1) % 4]);
    }
    const double sum = (acc[0] + acc[2]) + (acc[1] + acc[3]);
    return sum + __shfl_xor_sync(kFull, sum, 1);
  };
  if (basis) {
    const int k = static_cast<int>(blockIdx.x - groups);
    double* cur = vt[0];
    double* nxt = vt[1];
    for (int i = t; i < kMaxM; i += kCarryThreads) {
      cur[i] = i == k ? 1.0 : 0.0;
      nxt[i] = 0.0;
    }
    __syncthreads();
    for (int64_t i = 0; i < per; ++i) {
      const double sum = matvec(cur);
      if (own) nxt[r] = sum;
      __syncthreads();
      double* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (own) power[r * m + k] = cur[r];
    return;
  }
  // the rows' padding (the copies write columns below M only)
  for (int i = t; i < 2 * kCarryTile * kMaxM; i += kCarryThreads) {
    if (i % kMaxM >= m)
      vt[i / (kCarryTile * kMaxM)][i % (kCarryTile * kMaxM)] = 0.0;
  }
  const bool carried = cin != nullptr && blockIdx.x > 0;
  for (int i = t; i < kMaxM; i += kCarryThreads)
    cs[i] = carried && i < m ? cin[(blockIdx.x - 1) * m + i] : 0.0;
  bool have = carried;  // prev holds the value before the next element
  const double* prev = cs;
  double c = 0.0;
  for (int64_t first = lo, ti = 0; first < hi; first += kCarryTile, ++ti) {
    const int buf = static_cast<int>(ti & 1);
    const int cnt = tile_len(first);
    if (first + kCarryTile < hi) {
      fetch(buf ^ 1, first + kCarryTile, tile_len(first + kCarryTile));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    double* rows = vt[buf];
    for (int k = 0; k < cnt; ++k) {
      double* row = rows + k * kMaxM;
      if (have) {
        const double sum = matvec(prev);
        if (own) {
          c = sum + row[r];
          row[r] = c;
        }
        __syncthreads();
      } else if (own) {
        c = row[r];  // the first element, copied
      }
      have = true;
      prev = row;
    }
    if (totals == nullptr) {
      double* dst = v + first * m;
      for (int i = t; i < cnt * m; i += kCarryThreads)
        dst[i] = rows[(i / m) * kMaxM + i % m];
    }
    // the last value, kept apart: the next fetch into this buffer may land
    // before the next tile's first carry reads it
    for (int i = t; i < kMaxM; i += kCarryThreads) cs[i] = prev[i];
    __syncthreads();
    prev = cs;
  }
  if (totals != nullptr && own) totals[blockIdx.x * m + r] = c;
}

// Where each part of the scratch lies, for n samples, M states, stretches
// of 2^lg_chunk samples and carry groups of 2^lg_group: the powers Q
// (G^(g^k) for each level k), then one buffer of carries a level (level 0
// is V, one element a stretch; level k + 1 holds the totals of level k's
// groups). lg_group 0 scans all carries in one block.
struct Layout {
  int64_t stretches;
  int levels;  // carry levels (0: a single stretch, no carries)
  int64_t count[kMaxLevels];
  int64_t off[kMaxLevels];
  int64_t bytes;
};

Layout layout(int64_t n, int m, int lg_chunk, int lg_group) {
  constexpr int64_t elem = sizeof(double);
  auto align = [](int64_t b) { return (b + 255) / 256 * 256; };
  Layout l{};
  l.stretches = n > 0 ? ((n - 1) >> lg_chunk) + 1 : 0;
  if (l.stretches <= 1) return l;
  int64_t c = l.stretches;
  l.count[0] = c;
  l.levels = 1;
  while (lg_group > 0 && c > (int64_t(1) << lg_group) &&
         l.levels < kMaxLevels) {
    c = ((c - 1) >> lg_group) + 1;
    l.count[l.levels++] = c;
  }
  int64_t at = align(int64_t(l.levels) * m * m * elem);
  for (int k = 0; k < l.levels; ++k) {
    l.off[k] = at;
    at += align(l.count[k] * m * elem);
  }
  l.bytes = at;
  return l;
}

// Phase 2 from `level` down: the level's groups scanned from zero for
// their totals (the next level), the totals scanned, each group scanned
// again from the total before it; the last level in one block.
cudaError_t carries(const Layout& l, char* base, int m, int lg_group,
                    int level, cudaStream_t s) {
  const double* g = reinterpret_cast<const double*>(base) +
                    static_cast<int64_t>(level) * m * m;
  double* v = reinterpret_cast<double*>(base + l.off[level]);
  const int64_t count = l.count[level];
  if (level + 1 == l.levels) {
    carry_kernel<<<1, kCarryThreads, 0, s>>>(v, count, count, m, g,
                                              nullptr, nullptr, nullptr);
    return cudaGetLastError();
  }
  double* up = reinterpret_cast<double*>(base + l.off[level + 1]);
  double* next_g = reinterpret_cast<double*>(base) +
                   static_cast<int64_t>(level + 1) * m * m;
  const int64_t per = int64_t(1) << lg_group;
  const unsigned groups = static_cast<unsigned>(l.count[level + 1]);
  // the groups' totals, and beside them G^per for the level above
  carry_kernel<<<groups + m, kCarryThreads, 0, s>>>(v, count, per, m, g,
                                                     nullptr, up, next_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = carries(l, base, m, lg_group, level + 1, s);
  if (err != cudaSuccess) return err;
  carry_kernel<<<groups, kCarryThreads, 0, s>>>(v, count, per, m, g, up,
                                                 nullptr, nullptr);
  return cudaGetLastError();
}

template <typename Op>
cudaError_t run(const void* xv, void* yv, int64_t n, int m, int lg_chunk,
                int lg_group, const void* bv, const void* av, const void* zv,
                void* scratch, int upto, cudaStream_t s) {
  using T = typename Op::T;
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const T* b = static_cast<const T*>(bv);
  const T* a = static_cast<const T*>(av);
  const T* z0 = static_cast<const T*>(zv);
  const Layout l = layout(n, m, lg_chunk, lg_group);
  const int64_t grid = (l.stretches + kWalkWarps - 1) / kWalkWarps;
  if (l.levels == 0) {
    if (upto < 3) return cudaSuccess;
    walk_kernel<Op, true><<<grid, kWalkWarps * 32, 0, s>>>(
        x, y, n, lg_chunk, m, b, a, z0, nullptr, l.stretches, nullptr);
    return cudaGetLastError();
  }
  char* base = static_cast<char*>(scratch);
  double* states = reinterpret_cast<double*>(base + l.off[0]);
  const int64_t walk_blocks = (l.stretches - 1 + kWalkWarps - 1) / kWalkWarps;
  const int64_t g_blocks = (m + kWalkWarps - 1) / kWalkWarps;
  walk_kernel<Op, false><<<walk_blocks + g_blocks, kWalkWarps * 32, 0, s>>>(
      x, nullptr, n, lg_chunk, m, b, a, z0, states, l.stretches,
      reinterpret_cast<double*>(base));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || upto < 2) return err;
  err = carries(l, base, m, lg_group, 0, s);
  if (err != cudaSuccess || upto < 3) return err;
  walk_kernel<Op, true><<<grid, kWalkWarps * 32, 0, s>>>(
      x, y, n, lg_chunk, m, b, a, z0, states, l.stretches, nullptr);
  return cudaGetLastError();
}

bool valid(int dtype, int64_t n, int ncoef, int lg_chunk, int lg_group) {
  return (dtype == 0 || dtype == 1) && ncoef >= 2 && ncoef <= kMaxM + 1 &&
         n >= 0 && lg_chunk >= 0 && lg_chunk <= kMaxLgChunk &&
         lg_group >= 0 && lg_group <= kMaxLgGroup;
}

}  // namespace

// Bytes of scratch a call needs (0 for a single stretch), or -1 where the
// arguments are refused.
extern "C" int64_t runmat_iir_warp_scratch(int dtype, int64_t n, int ncoef,
                                           int lg_chunk, int lg_group) {
  if (!valid(dtype, n, ncoef, lg_chunk, lg_group)) return -1;
  return layout(n, ncoef - 1, lg_chunk, lg_group).bytes;
}

// dtype 0: float32, 1: float64. x, y: n values; b, a: ncoef values (2 ..
// 65; a[0] is 1 and not read); z0: ncoef - 1 values; stretches of
// 2^lg_chunk samples, carries in groups of 2^lg_group (0: one level);
// scratch: runmat_iir_warp_scratch(...) bytes, 256-byte aligned. All on
// `device`, contiguous. `upto` < 3 stops after that phase (timing).
extern "C" int runmat_iir_warp(int dtype, const void* x, void* y, int64_t n,
                               int ncoef, const void* b, const void* a,
                               const void* z0, int lg_chunk, int lg_group,
                               void* scratch, int64_t scratch_bytes,
                               int upto, void* stream, int device) {
  const int64_t need =
      runmat_iir_warp_scratch(dtype, n, ncoef, lg_chunk, lg_group);
  if (need < 0 || scratch_bytes < need || (need > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = ncoef - 1;
  if (dtype == 0)
    return static_cast<int>(run<W32>(x, y, n, m, lg_chunk, lg_group, b, a,
                                     z0, scratch, upto, s));
  return static_cast<int>(run<W64>(x, y, n, m, lg_chunk, lg_group, b, a, z0,
                                   scratch, upto, s));
}
