// An LSTM layer's recurrence, one direction: all T time steps in one launch
// of one thread-block cluster, the recurrent product inside the kernel.
//
// Replaces what XLA compiled from the JAX package's `lax.scan` over
// `lstm_dir`'s step and from its `jax.grad`
// (runmat_tpu/runtime/builtins/dl_layers.py:376-397; no Pallas twin). The
// wrappers, the plain versions and the rule that picks the cluster size
// are in runmat_tpu_torch/ops/lstm_seq.py.
//
// Forward, with zx = Wx x + b for every step, (4H, T, N), and the recurrent
// weights Wh, (4H, H), both float32, for t = 0 .. T-1:
//     z_t = zx[:, t, :] + Wh h_{t-1}            (h_{-1} = c_{-1} = 0)
//     i, f, o = sigmoid(z_i, z_f, z_o), g = tanh(z_g)
//     c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
// Backward, walking t = T-1 .. 0 with the incoming gradient of the
// outputs: the cell's backward (ops/lstm.py's formulas) gives dz_t, and
// dh_{t-1} = Wh' dz_t plus the incoming gradient of h_{t-1}. The kernel
// writes dz (4H, T, N), which is the gradient of zx; dWh = dz [0, h_0 ..
// h_{T-2}]' is one large product after the kernel (torch.matmul).
//
// Design. Block j of the C blocks of the cluster owns hidden units
// [j H / C, (j + 1) H / C). In the forward it holds the 4 |U_j| gate rows of
// Wh for its units in shared memory, transposed (loaded once with
// cp.async), the whole h_{t-1} (H, N) in a double buffer, its units' c for
// all T steps, and the next step's rows of zx (staged with cp.async while
// the step runs). A step is: each warp forms FWD_ROWS gate rows for 32
// columns (a lane a column), then a thread a (unit, column) runs the cell
// and writes h_t into the next buffer of every block of the cluster
// through distributed shared memory, then one cluster barrier. In the
// backward block j holds Wh's columns for its units, (4H, |U_j|), all of
// dz_t (4H, N) and its own rows of it in a double buffer, and the next
// step's cell inputs (staged as above). A step is: a thread a (unit,
// column) runs the cell's backward and writes dz_t's four rows of its unit
// to its own rows, one cluster barrier, each block reads all of dz_t from
// its peers' own rows 16 bytes a load, then each warp forms dh_{t-1} for
// BWD_UNITS units and 32 columns. Double buffers make one barrier a step
// enough: a block writes a buffer that a peer reads only after the barrier
// that follows the peer's last read of it. A block's shared memory must
// outlive every access of a peer to it: the forward's last writes to peers
// are followed by a barrier, and the backward ends with one after the
// cell of step 0, since the peers read dz_1 after the barrier before it.
// h and dz never go through device memory on the way, and the layer is one
// launch a direction where it was a cuBLAS product and a cell kernel a
// step.
//
// On an H100 80GB HBM3 at 700 W, dl_vowels' layer and 16 blocks, a step
// is about 4.3 us forward and 6.4 us backward (runmat_tpu_torch/dlbench.py,
// seq_rows: (time at T - time at T = 1) / (T - 1)).
//
// Numbers. Every product is a serial dot product in ascending order of
// its inner index, from 0, each product and sum rounded apart
// (__fmul_rn/__fadd_rn: no FMA contraction), and zx (or the incoming
// gradient) added last; divisions are IEEE, expf and tanhf are CUDA's
// (no fast math), as torch computes them on the card. So the kernels equal
// ops/lstm_seq.py's `plain_seq_forward`/`plain_seq_backward` with
// ordered=True bit for bit, and no floating-point atomics: two runs give
// the same bits.
//
// Bound. At dl_vowels' shape (T 26, H 100, N 27) a step's product is
// 2.2 MFLOP over C SMs in a chain of H (forward) or 4H (backward)
// dependent adds a column: the serial chain and the cluster barrier, not
// bytes (about 3 MB a direction) or the card's FLOP rate, set the time.
// Tensor cores do not apply: the path computes float32 with TF32 off.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdRows = 4;       // gate rows a lane carries (forward)
constexpr int kBwdUnits = 2;      // hidden units a lane carries (backward)
constexpr int kMaxCluster = 16;
constexpr int kStaged = 7;        // rows of the backward's staged inputs
constexpr int kPull = 4;          // remote loads in flight a thread

__host__ __device__ inline int most_units(int h, int c) {
  return (h + c - 1) / c;
}

__host__ __device__ inline int unit_start(int rank, int c, int h) {
  return static_cast<int>(static_cast<long long>(rank) * h / c);
}

// The dynamic shared memory of a block, in bytes (ops/lstm_seq.py:
// smem_bytes is the same formula).
__host__ inline size_t fwd_smem(int h, int n, int c) {
  const size_t u = most_units(h, c), hs = h, ns = n;
  // wt, two h buffers, z, two zx stages, c
  return sizeof(float) * (hs * 4 * u + 2 * hs * ns + 4 * u * ns +
                          2 * 4 * u * ns + u * ns);
}

__host__ inline size_t bwd_smem(int h, int n, int c) {
  const size_t u = most_units(h, c), hs = h, ns = n;
  const size_t ub = (u + kBwdUnits - 1) / kBwdUnits * kBwdUnits;
  const size_t np = (ns + 3) / 4 * 4;
  // wt, the whole dz, two of its own dz rows, two stages of the cell's
  // inputs, dh and dc, and each row's source (two ints)
  return sizeof(float) * (4 * hs * ub + 4 * hs * np + 2 * 4 * u * np +
                          2 * kStaged * u * ns + 2 * u * ns + 2 * 4 * hs);
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the block of a cluster of c over h units that owns unit k
__device__ __forceinline__ int owner(int k, int c, int h) {
  return static_cast<int>((static_cast<long long>(k + 1) * c - 1) / h);
}

// zx (4H, T, N); wh (4H, H). Outputs, each optional (null: not written):
// hs (H, T + 1, N), slot 0 zeros and slot t + 1 h_t; hlast (H, N), h_{T-1};
// cs (T, H, N), c_t; act (T, 4H, N), the gate activations i, f, g, o.
__global__ void __launch_bounds__(kThreads)
    lstm_seq_fwd_kernel(int T, int H, int NG, int G,
                        const float* __restrict__ zx,
                        const float* __restrict__ wh, float* __restrict__ hs,
                        float* __restrict__ hlast, float* __restrict__ cs,
                        float* __restrict__ act) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int umax = most_units(H, C);
  const int start = unit_start(rank, C, H);
  const int u = unit_start(rank + 1, C, H) - start;
  const int rows = 4 * umax;                      // wt's row stride
  // cluster g of the G runs columns [n0, n0 + N) of the NG
  const int g = blockIdx.x / C;
  const int n0 = static_cast<int>(static_cast<long long>(g) * NG / G);
  const int N = static_cast<int>(static_cast<long long>(g + 1) * NG / G) - n0;
  const size_t HN = static_cast<size_t>(H) * N;
  const size_t HNG = static_cast<size_t>(H) * NG;
  const size_t RN = static_cast<size_t>(rows) * N;
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                               // [H][rows]
  float* hb = wt + static_cast<size_t>(H) * rows;  // [2][H][N]
  float* zs = hb + 2 * HN;                        // [rows][N]
  float* xs = zs + RN;                            // [2][rows][N] zx stages
  float* cl = xs + 2 * RN;                        // [umax][N]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // zx[:, t, :] of this block's rows into stage b, in flight until the
  // next cp_async_wait_all
  auto stage = [&](int t, int b) {
    for (int i = tid; i < 4 * u * N; i += kThreads) {
      const int lr = i / N, n = i - lr * N;
      const size_t grow = (lr / u) * H + start + lr % u;
      cp_async4(xs + b * RN + i, zx + (grow * T + t) * NG + n0 + n);
    }
  };

  // local row lr = q u + v is gate q of unit start + v:
  // wt[k][lr] = Wh[q H + start + v][k]
  for (int i = tid; i < 4 * u * H; i += kThreads) {
    const int lr = i / H, k = i - lr * H;
    const int grow = (lr / u) * H + start + lr % u;
    cp_async4(wt + static_cast<size_t>(k) * rows + lr,
              wh + static_cast<size_t>(grow) * H + k);
  }
  stage(0, 0);
  for (size_t i = tid; i < HN; i += kThreads) hb[i] = 0.0f;
  for (int i = tid; i < u * N; i += kThreads) {
    cl[i] = 0.0f;
    if (hs != nullptr) {
      const int v = i / N, n = i - v * N;
      hs[static_cast<size_t>(start + v) * (T + 1) * NG + n0 + n] = 0.0f;
    }
  }
  cp_async_wait_all();
  // every block of the cluster runs before any writes into another's
  // shared memory
  cluster.sync();

  const int chunks = (N + 31) / 32;
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* hc = hb + cur * HN;
    float* hnext = hb + (cur ^ 1) * HN;
    const float* xt = xs + (t & 1) * RN;
    if (t + 1 < T) stage(t + 1, (t + 1) & 1);
    for (int item = warp; item < u * chunks; item += kWarps) {
      const int rt = item / chunks;
      const int n = (item - rt * chunks) * 32 + lane;
      const bool on = n < N;
      const int lr0 = rt * kFwdRows;
      float a[kFwdRows] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* hp = hc + (on ? n : 0);
      const float* wp = wt + lr0;
#pragma unroll 10
      for (int k = 0; k < H; ++k, hp += N, wp += rows) {
        const float hv = *hp;
        const float4 w = *reinterpret_cast<const float4*>(wp);
        a[0] = __fadd_rn(a[0], __fmul_rn(w.x, hv));
        a[1] = __fadd_rn(a[1], __fmul_rn(w.y, hv));
        a[2] = __fadd_rn(a[2], __fmul_rn(w.z, hv));
        a[3] = __fadd_rn(a[3], __fmul_rn(w.w, hv));
      }
      if (on) {
#pragma unroll
        for (int r = 0; r < kFwdRows; ++r) {
          const size_t at = static_cast<size_t>(lr0 + r) * N + n;
          zs[at] = __fadd_rn(xt[at], a[r]);
        }
      }
    }
    __syncthreads();
    const bool push = t + 1 < T;
    for (int i = tid; i < u * N; i += kThreads) {
      const int v = i / N, n = i - v * N;
      const float ig = sigmoid_rn(zs[static_cast<size_t>(v) * N + n]);
      const float fg = sigmoid_rn(zs[static_cast<size_t>(u + v) * N + n]);
      const float gg = tanhf(zs[static_cast<size_t>(2 * u + v) * N + n]);
      const float og = sigmoid_rn(zs[static_cast<size_t>(3 * u + v) * N + n]);
      const float c2 = __fadd_rn(__fmul_rn(fg, cl[i]), __fmul_rn(ig, gg));
      const float h2 = __fmul_rn(og, tanhf(c2));
      cl[i] = c2;
      const size_t at = static_cast<size_t>(start + v) * N + n;
      const size_t ag = static_cast<size_t>(start + v) * NG + n0 + n;
      if (push) {
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(hnext, r)[at] = h2;
      }
      if (hs != nullptr)
        hs[(static_cast<size_t>(start + v) * (T + 1) + t + 1) * NG + n0 + n] =
            h2;
      if (hlast != nullptr && !push) hlast[ag] = h2;
      if (cs != nullptr) cs[t * HNG + ag] = c2;
      if (act != nullptr) {
        float* ap = act + 4 * t * HNG + ag;
        ap[0] = ig;
        ap[HNG] = fg;
        ap[2 * HNG] = gg;
        ap[3 * HNG] = og;
      }
    }
    // the next step's zx has landed; the last step writes no peer's
    // memory: no barrier after it
    cp_async_wait_all();
    if (push) cluster.sync();
    cur ^= 1;
  }
}

// wh (4H, H); cs (T, H, N) and act (T, 4H, N) from the forward; the
// incoming gradient: dhs (H, T, N) of every h_t, or dhlast (H, N) of h_{T-1}
// alone (one of the two is given). Writes dz (4H, T, N).
__global__ void __launch_bounds__(kThreads)
    lstm_seq_bwd_kernel(int T, int H, int NG, int G,
                        const float* __restrict__ wh,
                        const float* __restrict__ cs,
                        const float* __restrict__ act,
                        const float* __restrict__ dhs,
                        const float* __restrict__ dhlast,
                        float* __restrict__ dz) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int umax = most_units(H, C);
  const int start = unit_start(rank, C, H);
  const int u = unit_start(rank + 1, C, H) - start;
  const int ub = (umax + kBwdUnits - 1) / kBwdUnits * kBwdUnits;
  // cluster g of the G runs columns [n0, n0 + N) of the NG
  const int g = blockIdx.x / C;
  const int n0 = static_cast<int>(static_cast<long long>(g) * NG / G);
  const int N = static_cast<int>(static_cast<long long>(g + 1) * NG / G) - n0;
  const int np = (N + 3) / 4 * 4;                  // dz's padded row
  const size_t HNG = static_cast<size_t>(H) * NG;
  const size_t UN = static_cast<size_t>(umax) * N;
  const size_t own = static_cast<size_t>(4) * umax * np;
  const int H4 = 4 * H;
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                                // [4H][ub]
  float* db = wt + static_cast<size_t>(H4) * ub;   // [4H][np] all of dz_t
  float* dl = db + static_cast<size_t>(H4) * np;   // [2][4][umax][np] own
  float* st = dl + 2 * own;                        // [2][kStaged][umax][N]
  float* dr = st + 2 * kStaged * UN;               // [umax][N]
  float* dcl = dr + UN;                            // [umax][N]
  // row q H + k of dz_t (unit k) is row q umax + k - start of its owner's
  // own rows
  int* src_rank = reinterpret_cast<int*>(dcl + UN);  // [4H]
  int* src_row = src_rank + H4;                       // [4H]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the cell's inputs of step t into stage b: the activations i, f, g, o,
  // c_t, c_{t-1} and the incoming gradient of h_t (where there is one)
  auto stage = [&](int t, int b) {
    float* sb = st + b * kStaged * UN;
    for (int i = tid; i < u * N; i += kThreads) {
      const int v = i / N, n = i - v * N;
      const size_t ag = static_cast<size_t>(start + v) * NG + n0 + n;
      for (int q = 0; q < 4; ++q)
        cp_async4(sb + q * UN + i, act + (4 * t + q) * HNG + ag);
      cp_async4(sb + 4 * UN + i, cs + t * HNG + ag);
      if (t > 0) cp_async4(sb + 5 * UN + i, cs + (t - 1) * HNG + ag);
      if (dhs != nullptr)
        cp_async4(sb + 6 * UN + i,
                  dhs + (static_cast<size_t>(start + v) * T + t) * NG + n0 + n);
      else if (t == T - 1)
        cp_async4(sb + 6 * UN + i, dhlast + ag);
    }
  };

  // wt[r][v] = Wh[r][start + v]; the padding columns are zeros
  for (int i = tid; i < H4 * ub; i += kThreads) {
    const int r = i / ub, v = i - r * ub;
    if (v < u)
      cp_async4(wt + i, wh + static_cast<size_t>(r) * H + start + v);
    else
      wt[i] = 0.0f;
  }
  for (int r = tid; r < H4; r += kThreads) {
    const int q = r / H, k = r - q * H;
    const int p = owner(k, C, H);
    src_rank[r] = p;
    src_row[r] = q * umax + k - unit_start(p, C, H);
  }
  stage(T - 1, (T - 1) & 1);
  cp_async_wait_all();
  cluster.sync();

  const int chunks = (N + 31) / 32;
  const int tiles = (u + kBwdUnits - 1) / kBwdUnits;
  for (int t = T - 1; t >= 0; --t) {
    const bool pull = t > 0;      // dh_{t-1} is needed
    const bool later = t < T - 1;
    const bool incoming = dhs != nullptr || !later;
    float* dlt = dl + (t & 1) * own;
    const float* sb = st + (t & 1) * kStaged * UN;
    if (pull) stage(t - 1, (t - 1) & 1);
    for (int i = tid; i < u * N; i += kThreads) {
      const int v = i / N, n = i - v * N;
      float dh = later ? dr[i] : 0.0f;
      if (incoming) dh = later ? __fadd_rn(dh, sb[6 * UN + i]) : sb[6 * UN + i];
      const float ig = sb[i], fg = sb[UN + i], gg = sb[2 * UN + i],
                  og = sb[3 * UN + i];
      const float th = tanhf(sb[4 * UN + i]);
      const float cprev = t > 0 ? sb[5 * UN + i] : 0.0f;
      float dca = __fmul_rn(__fmul_rn(dh, og),
                            __fsub_rn(1.0f, __fmul_rn(th, th)));
      if (later) dca = __fadd_rn(dcl[i], dca);
      const float dzi = __fmul_rn(__fmul_rn(dca, gg),
                                  __fmul_rn(ig, __fsub_rn(1.0f, ig)));
      const float dzf = __fmul_rn(__fmul_rn(dca, cprev),
                                  __fmul_rn(fg, __fsub_rn(1.0f, fg)));
      const float dzg = __fmul_rn(__fmul_rn(dca, ig),
                                  __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      const float dzo = __fmul_rn(__fmul_rn(dh, th),
                                  __fmul_rn(og, __fsub_rn(1.0f, og)));
      dcl[i] = __fmul_rn(dca, fg);
      float* o = dz + (static_cast<size_t>(start + v) * T + t) * NG + n0 + n;
      const size_t gate = HNG * T;
      o[0] = dzi;
      o[gate] = dzf;
      o[2 * gate] = dzg;
      o[3 * gate] = dzo;
      if (pull) {
        float* w = dlt + static_cast<size_t>(v) * np + n;
        w[0] = dzi;
        w[static_cast<size_t>(umax) * np] = dzf;
        w[static_cast<size_t>(2 * umax) * np] = dzg;
        w[static_cast<size_t>(3 * umax) * np] = dzo;
      }
    }
    // a block's shared memory must outlive every peer's read of it: the
    // peers read this block's rows of dz_1 after the last barrier, so one
    // more barrier before any block leaves (T = 1 reads none)
    if (!pull) {
      if (T > 1) cluster.sync();
      break;
    }
    cluster.sync();
    // all of dz_t from the cluster's blocks, 16 bytes a load, kPull loads
    // in flight a thread; a thread walks (row, quad) kThreads at a time
    {
      const int quads = np / 4, total = H4 * quads;
      const int step_r = kThreads / quads, step_n = kThreads - step_r * quads;
      int r = tid / quads, n4 = tid - r * quads;
      for (int e = tid; e < total; e += kPull * kThreads) {
        float4 got[kPull];
        int at[kPull];
#pragma unroll
        for (int j = 0; j < kPull; ++j) {
          at[j] = -1;
          if (e + j * kThreads < total) {
            at[j] = r * np + 4 * n4;
            got[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(
                dlt + src_row[r] * np + 4 * n4, src_rank[r]));
          }
          n4 += step_n;
          r += step_r;
          if (n4 >= quads) {
            n4 -= quads;
            ++r;
          }
        }
#pragma unroll
        for (int j = 0; j < kPull; ++j)
          if (at[j] >= 0) *reinterpret_cast<float4*>(db + at[j]) = got[j];
      }
    }
    __syncthreads();
    for (int item = warp; item < tiles * chunks; item += kWarps) {
      const int ut = item / chunks;
      const int n = (item - ut * chunks) * 32 + lane;
      const bool on = n < N;
      const int v0 = ut * kBwdUnits;
      float a0 = 0.0f, a1 = 0.0f;
      const float* dp = db + (on ? n : 0);
      const float* wp = wt + v0;
#pragma unroll 16
      for (int r = 0; r < H4; ++r, dp += np, wp += ub) {
        const float d = *dp;
        const float2 w = *reinterpret_cast<const float2*>(wp);
        a0 = __fadd_rn(a0, __fmul_rn(w.x, d));
        a1 = __fadd_rn(a1, __fmul_rn(w.y, d));
      }
      if (on) {
        dr[static_cast<size_t>(v0) * N + n] = a0;
        if (v0 + 1 < u) dr[static_cast<size_t>(v0 + 1) * N + n] = a1;
      }
    }
    // the next step's inputs have landed
    cp_async_wait_all();
    __syncthreads();
  }
}

cudaLaunchConfig_t config(int c, int groups, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * groups, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool shape_ok(int T, int H, int N, int c, int groups) {
  return T >= 1 && H >= 1 && N >= 1 && c >= 1 && c <= kMaxCluster &&
         groups >= 1 && groups <= N;
}

// the columns of a cluster's share: the most that one of `groups` takes
int share(int n, int groups) { return (n + groups - 1) / groups; }

// a launch refused at its configuration leaves its error as the last
// error: clear it, or the next unrelated launch check reports it
int launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// which 0: the forward kernel's dynamic shared memory for a cluster of c
// blocks running n columns, 1: the backward's
extern "C" long long runmat_lstm_seq_smem(int h, int n, int c, int which) {
  if (h < 1 || n < 1 || c < 1) return -1;
  return static_cast<long long>(which == 0 ? fwd_smem(h, n, c)
                                           : bwd_smem(h, n, c));
}

// Before the first launch at this shape (n: the columns of a cluster's
// share) and cluster size, and so before any capture: lets both kernels
// take the card's largest dynamic shared memory and, above 8 blocks, a
// non-portable cluster; clusters[0..1] receive how many such clusters of
// the forward and the backward can be resident at once (0: the card
// cannot run one).
extern "C" int runmat_lstm_seq_prepare(int h, int n, int c, int device,
                                       int* clusters) {
  if (!shape_ok(1, h, n, c, 1) || clusters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernels[2] = {reinterpret_cast<const void*>(lstm_seq_fwd_kernel),
                            reinterpret_cast<const void*>(lstm_seq_bwd_kernel)};
  const size_t smem[2] = {fwd_smem(h, n, c), bwd_smem(h, n, c)};
  for (int k = 0; k < 2; ++k) {
    clusters[k] = 0;
    if (smem[k] > static_cast<size_t>(optin)) continue;
    e = cudaFuncSetAttribute(kernels[k],
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return launched(e);
    if (c > 8) {
      e = cudaFuncSetAttribute(
          kernels[k], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return launched(e);
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(c, 1, smem[k], nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(&clusters[k], kernels[k], &cfg);
    if (e != cudaSuccess) return launched(e);
  }
  return 0;
}

// One launch of `groups` clusters of c blocks, cluster g running columns
// [g N / groups, (g + 1) N / groups) of the N.
extern "C" int runmat_lstm_seq_fwd(int T, int H, int N, int c, int groups,
                                   const void* zx, const void* wh, void* hs,
                                   void* hlast, void* cs, void* act,
                                   void* stream, int device) {
  if (!shape_ok(T, H, N, c, groups) || (hs == nullptr && hlast == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(c, groups, fwd_smem(H, share(N, groups), c),
             static_cast<cudaStream_t>(stream), attr);
  return launched(cudaLaunchKernelEx(
      &cfg, lstm_seq_fwd_kernel, T, H, N, groups,
      static_cast<const float*>(zx), static_cast<const float*>(wh),
      static_cast<float*>(hs), static_cast<float*>(hlast),
      static_cast<float*>(cs), static_cast<float*>(act)));
}

extern "C" int runmat_lstm_seq_bwd(int T, int H, int N, int c, int groups,
                                   const void* wh, const void* cs,
                                   const void* act, const void* dhs,
                                   const void* dhlast, void* dz, void* stream,
                                   int device) {
  if (!shape_ok(T, H, N, c, groups) || (dhs == nullptr) == (dhlast == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(c, groups, bwd_smem(H, share(N, groups), c),
             static_cast<cudaStream_t>(stream), attr);
  return launched(cudaLaunchKernelEx(
      &cfg, lstm_seq_bwd_kernel, T, H, N, groups,
      static_cast<const float*>(wh), static_cast<const float*>(cs),
      static_cast<const float*>(act), static_cast<const float*>(dhs),
      static_cast<const float*>(dhlast), static_cast<float*>(dz)));
}
