#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (runmat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero before the last
line is printed:
  1. device: a CUDA card, its name and power limit from nvidia-smi;
  2. build: csrc/*.cu with nvcc into build/runmat_tpu_torch/ (one nvcc per
     source, all started together);
  3. kernels against plain: the Threefry kernel against its plain PyTorch
     version on the card and the port's host numpy stream, at the main
     path's shapes and more; the normal kernels' Box-Muller transform
     against its numpy model (runmat_tpu_torch/ops/boxmuller.py) over every
     float32 (u1, u2) and 2^20 float64 pairs; the time of the kernel and of
     the plain version at the main path's draws (runmat_tpu_torch/
     rngbench.py: normals f32 at 10^6, 10^7 and 2^26, f64 at 10^7, 2^22
     and 4096^2, uniforms f32 at 10^7 and 2^26, f64 at 10^7), each
     beside its bound
     and its kernel's registers; the histogram kernel against its plain
     versions, exactly, in its three modes over sizes up to 2^26 and 1 to
     256 bins, and up to 2^20+1 values at 257 to 65536 bins, which cross
     its shared-memory layouts
     (and against np.histogram up to 2^20+1 values), with the time of the
     kernel, the plain version and `torch.histc` (direct mode) at 2^26 and
     of the kernel alone at many bins (runmat_tpu_torch/histbench.py); the
     Threefry entry that reads its counter from device memory (the one a
     captured loop replays) against the launch-argument entry, bit for
     bit, in its four modes at COUNTERS and the main path's draw sizes,
     and both timed at monte_carlo's draw (normal f32, 10^6); the
     generated Triton kernels (runmat_tpu_torch/ops/fused.py) against
     their plain versions (runmat_tpu_torch/fusebench.py: every op of the
     table in float32 and float64 over NaN, +-Inf, +-0, subnormals and the
     pow identities, broadcast and strided inputs, linspace and casts, a
     chain at sizes 1 to 10^7, sum and mean over 'all' and over 1, 16 and
     4096 segments, pow with a scalar exponent of 2 and of nextafter(2, 3),
     with the tolerances fusebench states); the square arm of a pow with
     a scalar exponent over all 2^32 float32 bit patterns, equal to the
     correctly rounded square bit for bit (and how many of them torch.pow
     misses, by how many ulp); then every group the three benchmark
     scripts, dense_linalg.m, spectral.m and resample_pages.m launch at
     their default sizes,
     held to its plain version and timed against it, its bound and, where
     one PyTorch call computes it, that call;
  4. main path: benchmarks/{elementwise_math,monte_carlo,image_normalize}.m
     at their default sizes through runmat_tpu_torch.session("cuda"),
     against the port's host engine (Session(accelerate=False)) for CHECK,
     PRICE and MSE, and MSE also against a float64 evaluation of the script
     on the frames the host engine drew; with the kernel's launch count,
     the loop fold and the warm wall times. monte_carlo's fold runs as a
     captured CUDA graph: no decline, at least 255 replays and 256 normal
     draws a run, at most one capture over the four runs of its timed
     session, its step's elementwise chain one generated kernel inside the
     graph. elementwise_math and image_normalize run no b:/u:/r:/c: op
     eagerly (every one is inside a generated kernel). Each script's stream
     syncs under torch's sync debug mode
     equal what the engine counts (runmat_tpu_torch/syncs.py), here and in
     phases 5 and 6;
  5. statistics path: runmat_tpu_torch/workloads/histogram_stats.m at its
     default N = 2^26 through Session.run_source and once through
     Session.execute, HIST against the host engine, the three histograms
     against np.histogram of the port's own data, the histogram kernel's
     launches, the bytes copied to and from the card, and the warm walls;
  6. indexing path: runmat_tpu_torch/workloads/index_sets.m (indexed reads
     and writes, structural ops, sort, unique, set ops, median, mode,
     accumarray, a folded `for` and a folded `while`) at N = 2^20 against
     the host engine for RANK, then at its default N = 2^26 through
     Session.run_source and once through Session.execute: no host fallback,
     no RunMat:notPorted, one `for` fold (captured as a CUDA graph) and
     one `while` fold, under 1 MB each way, and its sort, unique, counts,
     median, membership and column writes against numpy of the port's own
     gathered data; with the warm walls;
  7. linear algebra and signal path: the IIR kernel (csrc/iir.cu, a
     chunked parallel scan) against its plain version, bit for bit on its
     first stretch of L samples and elsewhere within 1e-10 (float64) or
     1e-4 (float32) of the largest output magnitude, non-finite values in
     the same places: random filters of orders 1 to 8 in float32 and
     float64 from a nonzero state over one stretch and over 64, a pole of
     radius 0.999, a NaN in a middle stretch; spectral.m's float64 call at
     stretch lengths 32 to 4096; and its 4th-order call over 2^22 samples
     in float32, timed with its phases (runmat_tpu_torch/linalgbench.py);
     then
     runmat_tpu_torch/workloads/dense_linalg.m at N = 4096 and
     spectral.m at N = 2^22 through Session.run_source, each against the
     port's host engine: LINALG and SPECTRAL within a relative 1e-9
     (LAPACK against cuSOLVER, pocketfft against cuFFT, sums in other
     orders), dense_linalg's six residuals under 1e-10, spectral's single
     conv2 within 1e-5 of its largest value (TF32 would miss by ~1e-3);
     no host fallback and no not-ported decline, under 1 MB uploaded, the
     IIR kernel launched once a spectral.m run, its float64 call (the
     script's own signal and coefficients, all 2^22 samples) and the
     path's output z held to the plain version as above (which is timed on
     the host), the waits equal to the counted reads, and the warm walls;
  8. interpolation, selection and page path: the sequential IIR kernel
     (csrc/iir_seq.cu, the orders above 64) against its plain version,
     every output bit for bit, at orders 65 and 200 in both types; the
     warp kernel (csrc/iir_warp.cu, a chunked scan with a warp a stretch,
     orders 33-64) against its plain version as phase 7 holds the scan,
     at orders 33, 39 and 64 in both types over one stretch and over 65,
     a pole of radius 0.999 and a NaN in a middle stretch at order 39,
     its stretch length and carry group swept at resample_pages.m's
     filter over 2^18 and 2^22 samples, and that filter over 2^22 held to
     the sequential kernel's output (bit-equal to plain) and timed with
     its phases beside its bound and the sequential kernel; the script's
     device builders at its shapes timed beside their bounds and
     torch.topk / torch.bmm, and each made
     while the card is busy, none waiting for it
     (runmat_tpu_torch/linalgbench.py); then
     runmat_tpu_torch/workloads/resample_pages.m at N = 2^22 and 8192
     pages of 32 x 32 through Session.run_source against the port's host
     engine (PAGES within a relative 1e-9), with no host fallback, under
     1 MB uploaded, the warp kernel launched once (the sequential kernel
     never) and each device
     builder as often as the script calls it (interp1lin once, topk
     twice, pagemtimes three times, pagesolve, pageinv and pagenorm once),
     pagefun(@mtimes, A, B) equal to pagemtimes(A, B) bit for bit on the
     card, the path's filter call (2^18 samples) and its output w held to
     the plain version (the first L outputs bit for bit, the rest within
     1e-10 of the largest) and timed beside it and the sequential kernel
     (which is also held bit for bit on that call), the waits equal
     to the counted reads, and the warm walls; then
     each snippet of runmat_tpu_torch/parity_snippets.py (one for each
     builtin module the slice copied) in a card session against the
     host engine, skipping the one whose module needs a package this
     machine lacks (sympy);
  9. sparse path: the sparse CG kernels (csrc/spcg.cu: spmv_f64 with
     its alpha tail, cg_update with its beta, k and done-flag tail,
     cg_direction) against their plain versions
     (runmat_tpu_torch/spbench.py): the product bit for bit on rows that
     are empty, a row of 5000 nonzeros, triangles that differ in the last
     bits and the path's matrix; the whole solve on a 60^2 Poisson system
     and a seeded SPD sprandsym-style matrix, twice bit for bit the same,
     x and k equal to plain_cg(ordered=True)'s (the kernels' order of
     summing in torch ops) bit for bit and x within 1e-8 of plain_cg's
     largest entry; each kernel of one iteration at the path's shape
     against the JAX body's torch ops on the same inputs and each tail's
     scalars against the ordered model, bit for bit, each timed beside
     its bound, its plain version and cuSPARSE's product or torch.add,
     and the product without its partials and the update without its
     tail (the tails' times); then
     runmat_tpu_torch/workloads/sparse_poisson.m at N = 1024 (1,048,576
     unknowns) through Session.run_source: one device solve, its
     iterations in chunks of spcg.CHUNK, one read of the done flag a chunk
     (the engine's only syncs, and the waits torch sees equal the counted
     reads), each kernel launched as often as the chunks say, the loop's
     residual under 1e-10, x and k equal to plain_cg(ordered=True)'s on
     the card bit for bit, x within 1e-8 of plain_cg's on the card and its
     norm(b - A*x)/norm(b) no more than 1 % above plain_cg's, under 128 MB
     uploaded (the CSR, 1/diag(A) and b); the warm walls and a profile;
 10. deep learning path: the LSTM recurrence's cluster kernels
     (runmat_tpu_torch/csrc/lstm_seq.cu via ops/lstm_seq.py: a direction's
     T steps, forward or backward, in one launch) timed at dl_vowels.m's
     layer at every cluster size, held to plain_seq_forward/
     plain_seq_backward(ordered=True) bit for bit at every size that runs
     (dlbench.SEQ_SHAPES, both directions, 'last' and 'sequence', with and
     without what the backward needs), and timed at the route's size
     beside their bound, their plain versions, the earlier design (a
     product and a cell a step), cuDNN's LSTM and their time at T = 1;
     the LSTM cell's forward and backward kernels (ops/lstm.py, Triton;
     the per-step path of layers too wide for a cluster, which no script
     reaches) at dl_vowels.m's (4*100, 27)
     and two odd shapes, and the optimizer update (runmat_tpu_torch/
     csrc/optim.cu via ops/optim.py, CUDA C++; Adam and SGDM, three steps,
     t advanced once a launch) at both scripts' learnables, against
     their plain versions bit for bit, each timed beside its byte bound and the
     PyTorch call that computes the same function
     (runmat_tpu_torch/dlbench.py), and the update's machine code read
     (no contracted fma.rn.f32 in its PTX, Adam's loads before its pows'
     DFMAs); then
     runmat_tpu_torch/workloads/dl_digits.m (MathWorks' digit CNN, 7,500
     images of 28x28, 232 SGDM steps, 21,690 learnables) and dl_vowels.m
     (the Japanese Vowels LSTM, 270 sequences of 26 steps, 500 Adam steps,
     46,109 learnables) through Session.run_source: one capture of the
     training step each, replayed for every step after the two warm-up
     steps, each kernel launched as often as the steps say (dl_vowels:
     the forward cluster kernel once a step and once in predict, the
     backward once a step, the cell kernels never), the accuracy
     printed over DL_ACCURACY, the waits equal to the counted reads (none
     inside the loop); each network's first three steps on the card held
     to the CPU's plain path from the same initial weights (within
     dlbench.STEP_TOL of the largest learnable: 1e-4 for SGDM, 1e-3 for
     Adam), two trainings on the
     card and their largest difference, the step timed eagerly and
     replayed with cuDNN's deterministic algorithms and without, its
     device kernels counted, the warm walls and a profile; a dlfeval/
     dlgradient snippet on the card against the CPU;
 11. one JSON line of kernel results, then the result line
     {"ok": true, "device": {...}}.
Phase 3 also times each generated group that one PyTorch call computes
against that call in turns, ten rounds, for the run-to-run spread of
both, and prints the layout of each float64 map of more than 2^20
elements (8 warps a block since the layout sweep of fusebench.py). Each
kernel's `launches` is read from the runs of phases 4 to 10, with the
counts set to 0 just before each run (a generated map-reduce counts once
for its pair of launches, or for its one where one program covers each
segment); each generated group is a row of its own, counted by its
kernel, so its `launches` are those of one run of its script. Every
kernel of the paths must launch; the sequential IIR kernel, which no
script reaches since the warp kernel took orders 33-64, and the LSTM
cell's two kernels, which no script reaches since the cluster kernels
took the recurrence, keep their rows with their launches (0). `bound_ms`
is the larger of the bytes
the call must move over 3.35 TB/s and its operations over the card's rate
for them (runmat_tpu_torch/sass.py: for Threefry, the warp cycles of the
kernel's own loop read from its machine code, which holds no call and no
local memory, so it is what runs). Imports nothing of jax and nothing of
runmat_tpu.
"""

from __future__ import annotations

import collections
import importlib.util
import io
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

WORKLOADS = ("elementwise_math", "monte_carlo", "image_normalize")
RESULT_KEY = {"elementwise_math": ("CHECK", "checksum"),
              "monte_carlo": ("PRICE", "price"),
              "image_normalize": ("MSE", "mse")}
PARITY_RTOL = 1e-4       # f32 reductions and T compounding steps of exp
SIZES = (1, 2, 3, 1023, (1 << 20) + 1, 10 ** 7)
# (kind, n, dtype): image_normalize.m, monte_carlo.m (256 a run),
# histogram_stats.m, dense_linalg.m (A, 4096 x 4096) and spectral.m (2^22)
MAIN_PATH_DRAWS = (("rand", 16 * 2160 * 3840, "float32"),
                   ("randn", 1_000_000, "float32"),
                   ("rand", 1 << 26, "float32"),
                   ("randn", 1 << 26, "float32"),
                   ("randn", 4096 * 4096, "float64"),
                   ("randn", 1 << 22, "float64"))
# the kernel JSON line's Threefry rows, (kind, dtype) -> the draw timed:
# the main path's most-launched normal draw, the uniform draw of
# histogram_stats.m and dense_linalg.m's float64 normal draw
REPORTED_DRAWS = {("rand", "float32"): 1 << 26,
                  ("randn", "float32"): 10 ** 6,
                  ("randn", "float64"): 4096 * 4096}
# the draws' key and the normals' tolerance are rngbench.KEY and
# rngbench.NORMAL_TOL, which also check the timed draws
COUNTERS = (12345, (0xFFFFFFFD, 7))   # the second carries lo into hi
MC_STEPS = 256                        # monte_carlo.m's T: one draw a step
HIST_SIZES = (1, 2, 3, 1023, (1 << 20) + 1, 10 ** 7, 1 << 26)
HIST_BINS = (1, 2, 3, 4, 5, 6, 7, 8, 64, 80, 128, 256)
# per-warp, per-block and global counts in the kernel (histogram.cu); the
# plain search form compares every value with every edge, so these run at
# n <= HIST_NUMPY_UP_TO
HIST_MANY_BINS = (257, 1000, 4096, 30000, 65536)
HIST_AFFINE = ((7, 0), (-2, -3), (3, 5))   # (k_exp, m) of the direct mode
HIST_NUMPY_UP_TO = (1 << 20) + 1           # np.histogram as a third opinion
HIST_WORKLOAD = "runmat_tpu_torch/workloads/histogram_stats.m"
HIST_EDGES = {"cu": np.arange(129) / 128,
              "cq": np.array([0, 0.25, 0.5, 1, 2, 4, 8, 16])}
# histogram_stats.m's calls (runmat_tpu_torch/histbench.py makes their
# inputs) and the line of the Pallas kernel each replaces
HIST_MAIN_CALLS = {"direct f32": ("cu, 128 bins", "67"),
                   "search f32": ("cz, 80 bins", "216"),
                   "search f64": ("cq, 7 bins", "216")}
# the statistics path copies only scalars and edges: u, z and z.*z stay on
# the card
HIST_TRANSFER_LIMIT = 1 << 20
INDEX_WORKLOAD = "runmat_tpu_torch/workloads/index_sets.m"
INDEX_REFERENCE_N = "N = 2^20;\n"     # the host engine's unique is a Python loop
# index_sets.m copies the result, unique's count and the while conditions
INDEX_TRANSFER_LIMIT = 1 << 20
TIMING_REPS = 50
F64_SWEEP = 1 << 20       # float64 word sets through the device transform
LINALG_WORKLOAD = "runmat_tpu_torch/workloads/dense_linalg.m"
SIGNAL_WORKLOAD = "runmat_tpu_torch/workloads/spectral.m"
# LAPACK against cuSOLVER, pocketfft against cuFFT: the double sums agree
# to a few ulp of their terms; dense_linalg's factorizations reproduce
# their matrix to within rounding
SLICE_RTOL = 1e-9
RESIDUAL_LIMIT = 1e-10
RESIDUALS = ("res_chol", "res_solve", "res_qr", "res_lu", "res_inv",
             "res_pinv")
# spectral.m's single conv2: cuDNN in true FP32 against the host's f64 FFT
# rounded to single, of its largest value (TF32 misses by ~1e-3)
CONV2_SINGLE_TOL = 1e-5
# the scripts upload only short vectors: b, its first quarter, the
# filters' coefficients and the window
SLICE_TRANSFER_LIMIT = 1 << 20
# the IIR kernel's cases: one stretch (bit-equal), at least 64 stretches,
# a pole of radius 0.999 over 256 stretches; the stretch lengths timed
IIR_SHORT = 200
IIR_STRETCHES = 64
IIR_POLE_N = 1 << 16
IIR_SWEEP = (32, 64, 128, 256, 512, 1024, 4096)
PAGES_WORKLOAD = "runmat_tpu_torch/workloads/resample_pages.m"
# (coefficients, samples) the sequential IIR kernel is held to its plain
# version on: orders 65 and 200, above the warp kernel's 64
IIR_SEQ_CASES = ((66, 3001), (201, 4000))
IIR_SEQ_N = 1 << 22       # resample_pages.m's filter over the whole record
# the warp kernel's cases: orders 33, 39 (resample_pages.m's) and 64 over
# one stretch of the default L (bit-equal throughout) and over 65
# stretches (three carry levels), a pole of radius 0.999 and a NaN in a
# middle stretch at order 39
IIR_WARP_ORDERS = (33, 39, 64)
IIR_WARP_SHORT = 100
IIR_WARP_LONG = 64 * 128 + 77
# (L, g) the warp kernel is swept over at resample_pages.m's call (2^18)
# and at 2^22 (iir.WARP_SHAPES keeps the fastest): one warp over the whole
# call, the carries in one level, and groups of 8-32
IIR_WARP_SWEEP = {18: ((1 << 18, 0), (64, 0), (128, 0), (64, 16),
                       (128, 8), (128, 16), (128, 32), (256, 16),
                       (256, 32), (512, 16)),
                  22: ((512, 16), (512, 32), (1024, 8), (1024, 16),
                       (1024, 32), (2048, 16))}
# the device builders a run of resample_pages.m calls, each its count
PAGES_LINALG = {"interp1lin": 1, "topk": 2, "iir": 1, "pagemtimes": 3,
                "pagesolve": 1, "pageinv": 1, "pagenorm": 1}
SPREAD_ROUNDS = 10
SPARSE_WORKLOAD = "runmat_tpu_torch/workloads/sparse_poisson.m"
# the sparse CG kernels and the lines of runmat_tpu/sparse.py:_cg_device
# each replaces: the product with alpha; the updates with beta and the
# loop's condition; the direction
SPARSE_KERNELS = {"spmv_f64": "265-266", "cg_update": "267-270,276",
                  "cg_direction": "271"}
# the loop's own test, norm(r) > tol * norm(b) on the recurrence's r
SPARSE_TOL = 1e-10
# the true residual norm(b - A x) / norm(b) of the kernels' x against
# plain_cg's (the JAX loop in torch ops) on the same system: the
# recurrence's r drifts from b - A x over thousands of iterations in both,
# and the kernels' may not drift further by more than 1 %
SPARSE_DRIFT = 1.01
# sparse_poisson.m uploads its CSR (the CSC of A'), 1/diag(A) and b
SPARSE_TRANSFER_LIMIT = 128 << 20
# the deep learning scripts' printed accuracy on their training data must
# pass these (chance is 0.1 and 0.11): the loss fell
DL_ACCURACY = {"dl_digits": 0.9, "dl_vowels": 0.9}
DL_RESULT = {"dl_digits": "DIGITS", "dl_vowels": "VOWELS"}
# a dlfeval/dlgradient snippet in float64, card against CPU: cuBLAS and
# the CPU's BLAS sum the products in other orders
DL_SNIPPET_TOL = 1e-12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")


def phase_build():
    from runmat_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s) -> {lib._name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernel() -> list:
    import torch

    from runmat_tpu_torch import rngbench, sass
    from runmat_tpu_torch.ops import ctrng, threefry

    dev = torch.device("cuda")
    worst = {key: 0.0 for key in REPORTED_DRAWS}
    cases = [(kind, n, dt, ctr) for kind in ("rand", "randn")
             for dt in (torch.float32, torch.float64)
             for n in SIZES for ctr in COUNTERS]
    cases += [(kind, n, getattr(torch, dt), COUNTERS[0])
              for kind, n, dt in MAIN_PATH_DRAWS]
    for kind, n, dt, ctr in cases:
        got = threefry.rng_draw(kind, rngbench.KEY, ctr, n, dt, dev)
        want = threefry.plain_draw(kind, rngbench.KEY, ctr, n, dt, dev)
        torch.cuda.synchronize()
        check(got.shape == (n,) and got.dtype == dt,
              f"{kind} {dt} n={n}: shape {tuple(got.shape)} {got.dtype}")
        err = float((got - want).abs().max())
        name = str(dt).split(".")[-1]
        if kind == "rand":
            check(torch.equal(got, want),
                  f"rand {name} n={n} ctr={ctr}: not bit-exact "
                  f"against plain (max err {err:g})")
            if n <= 10 ** 7:
                c = ctr if isinstance(ctr, int) else ctr[0] | (ctr[1] << 32)
                ref, _ = ctrng.np_uniform(rngbench.KEY, c, n,
                                          np.dtype(name))
                check(np.array_equal(got.cpu().numpy(), ref),
                      f"rand {name} n={n} ctr={ctr}: not bit-exact "
                      f"against the host stream")
        else:
            tol = rngbench.NORMAL_TOL[name]
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=tol, atol=tol),
                f"randn {name} n={n} ctr={ctr}: max err {err:g} > {tol:g}")
        if (kind, name) in worst:
            worst[kind, name] = max(worst[kind, name], err)
        print(f"kernel {kind} {name} n={n} ctr={ctr}: max_abs_err={err:g}")

    _transform_sweep(threefry)
    device_counter = _device_counter_entry(threefry, rngbench)

    rows = rngbench.measure(threefry, sass, rngbench.DRAWS, TIMING_REPS,
                            plain_reps=TIMING_REPS)
    for r in rows:
        check(r["ok"], f"{r['kind']} {r['dtype']} n={r['n']}: differs from "
              f"plain by {r['max_abs_err']:g}")
        philox = f", torch.{r['kind']} (Philox, another stream) " \
            f"{r['philox_ms']:.4f} ms"
        print(f"time {r['kind']} {r['dtype']} n={r['n']}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
              f"{r['share']:.3f}{philox}; {r['registers']} registers, "
              f"{r['stack_bytes']} bytes of stack, {r['resident_warps']} "
              f"warps a SM; loop {json.dumps(r['loop'])}")
    out = []
    for (kind, dtype), n in REPORTED_DRAWS.items():
        (r,) = [r for r in rows if r["kind"] == kind
                and r["dtype"] == dtype and r["n"] == n]
        label = "uniform" if kind == "rand" else "normal"
        out.append({
            "name": f"threefry2x32_{label}_f{dtype[-2:]}", "route": "cuda",
            "source": "runmat_tpu_torch/csrc/threefry.cu",
            "replaces": "runmat_tpu/ops/pallas/threefry.py:"
                        + ("134" if kind == "rand" else "114"),
            "launches": 0, "launch_key": f"{kind} {dtype}",
            "max_abs_err": worst[kind, dtype], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # torch.rand draws Philox, another stream: no library call
            # computes these values
            "library_ms": None})
        if (kind, dtype) == ("randn", "float32"):
            out.append({**out[-1], **device_counter,
                        "bound_ms": r["bound_ms"]})
    return out


def _device_counter_entry(threefry, rngbench) -> dict:
    """The entry that reads its counter from device memory
    (runmat_threefry_draw_at) against the launch-argument entry: equal bit
    for bit in its four modes at COUNTERS (the carry case included) and the
    main path's draw sizes; then both timed at monte_carlo's draw, normal
    f32 at 10^6, with the plain version on the same tensor counter.
    Returns the fields of its kernel row."""
    import torch

    from runmat_tpu_torch import histbench
    from runmat_tpu_torch.accel.engine import counter_value
    dev = torch.device("cuda")
    cases = [(kind, n, dt, ctr) for kind in ("rand", "randn")
             for dt in (torch.float32, torch.float64)
             for n in SIZES for ctr in COUNTERS]
    cases += [(kind, n, getattr(torch, dt), ctr)
              for kind, n, dt in MAIN_PATH_DRAWS for ctr in COUNTERS]
    for kind, n, dt, ctr in cases:
        c = ctr if isinstance(ctr, int) else ctr[0] | (ctr[1] << 32)
        at = torch.full((), counter_value(c), dtype=torch.int64, device=dev)
        got = threefry.rng_draw(kind, rngbench.KEY, at, n, dt, dev)
        want = threefry.rng_draw(kind, rngbench.KEY, c, n, dt, dev)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{kind} {dt} n={n} ctr={ctr}: the device-counter entry "
              f"differs from the launch-argument entry")
    print(f"kernel device counter: {len(cases)} draws equal the "
          f"launch-argument entry bit for bit")
    n = MAIN_PATH_DRAWS[1][1]
    at = torch.zeros((), dtype=torch.int64, device=dev)
    got = threefry.rng_draw("randn", rngbench.KEY, at, n, torch.float32, dev)
    want = threefry.plain_draw("randn", rngbench.KEY, at, n, torch.float32,
                               dev)
    err = float((got - want).abs().max())
    tol = rngbench.NORMAL_TOL["float32"]
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"randn float32 (device counter): max err {err:g} > {tol:g}")
    ms = {name: histbench.time_ms(fn, TIMING_REPS) for name, fn in (
        ("at", lambda: threefry.rng_draw("randn", rngbench.KEY, at, n,
                                         torch.float32, dev)),
        ("args", lambda: threefry.rng_draw("randn", rngbench.KEY, 0, n,
                                           torch.float32, dev)),
        ("plain", lambda: threefry.plain_draw("randn", rngbench.KEY, at, n,
                                              torch.float32, dev)))}
    print(f"time randn float32 n={n}: device-counter entry {ms['at']:.4f} "
          f"ms, launch-argument entry {ms['args']:.4f} ms, plain "
          f"{ms['plain']:.4f} ms")
    return {"name": "threefry2x32_normal_f32_device_counter",
            "launch_key": "randn float32" + threefry.DEVICE_COUNTER,
            "max_abs_err": err, "ms": ms["at"], "plain_ms": ms["plain"]}


def _transform_sweep(threefry) -> None:
    """The normal kernels' device transform against its numpy model:
    float32 over every (u1, u2) (words k << 8, k < 2^24), equal bit for
    bit; float64 over F64_SWEEP word sets from a seed, within one ulp (the
    model's square root is correctly rounded, the kernel's a Goldschmidt
    iteration)."""
    import torch

    from runmat_tpu_torch.ops import boxmuller
    dev = torch.device("cuda")
    k = torch.arange(1 << 24, dtype=torch.int64, device=dev) << 8
    got = threefry.device_transform(torch.stack([k, k]), torch.float32)
    words = np.arange(1 << 24, dtype=np.uint32) << 8
    want = np.stack(boxmuller.box_muller_f32(words, words))
    bad = int((got.cpu().numpy() != want).sum())
    check(bad == 0, f"float32 transform: {bad} of {want.size} values differ "
          f"from the model")
    print(f"kernel transform float32: all {want.size} values of 2^24 (u1, "
          f"u2) equal the model")
    w = np.random.default_rng(5).integers(0, 1 << 32, (4, F64_SWEEP),
                                          dtype=np.uint64).astype(np.uint32)
    w[:, :2] = [[0, 0xFFFFFFFF]] * 4
    got = threefry.device_transform(torch.from_numpy(w.astype(np.int64)).to(
        dev), torch.float64).cpu().numpy()
    want = np.stack(boxmuller.box_muller_f64(*w))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    check(float(ulps.max()) <= 1.0, f"float64 transform: {ulps.max()} ulp "
          f"from the model")
    print(f"kernel transform float64: {want.size} values, "
          f"{int((got != want).sum())} differ from the model, at most "
          f"{float(ulps.max()):g} ulp")


def _hist_inputs(base, n: int, nb: int, dtype, affine, seed: int):
    """x: n values spread 20% beyond the edges, holding NaN, +-Inf, +-0,
    the smallest subnormals, exact hits on e_0, an interior edge and e_B,
    and the neighbours of those edges outside or on both sides; edges
    non-decreasing, with one repeated edge in search mode. `base` is a
    uniform [0, 1) f64 stream on the card."""
    import torch
    rng = np.random.default_rng(seed)
    if affine is None:
        e = np.sort(rng.uniform(-2.0, 2.0, nb + 1))
        if nb >= 2:
            e[nb // 2] = e[nb // 2 - 1]
    else:
        k, m = affine
        e = (m + np.arange(nb + 1)) * 2.0 ** -k
    e = torch.tensor(e, dtype=dtype, device=base.device)
    lo, hi = float(e[0]), float(e[-1])
    span = hi - lo
    x = (base[:n] * (1.4 * span) + (lo - 0.2 * span)).to(dtype)
    mid = e[nb // 2:nb // 2 + 1]
    up, down = torch.full_like(mid, float("inf")), -torch.full_like(
        mid, float("inf"))
    tiny = torch.finfo(dtype).smallest_normal * torch.finfo(dtype).eps
    special = torch.cat([
        torch.tensor([float("nan"), lo, hi, float("inf"), float("-inf"),
                      tiny, -tiny, 0.0], dtype=dtype, device=base.device),
        mid, torch.nextafter(mid, up), torch.nextafter(mid, down),
        torch.nextafter(e[-1:], up), torch.nextafter(e[:1], down)])
    k = min(n, special.numel())
    x[torch.arange(k, device=base.device) * max(1, n // k)] = special[:k]
    return x, e


def phase_histogram_kernel() -> list:
    import torch

    from runmat_tpu_torch import histbench, sass
    from runmat_tpu_torch.ops import histogram

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    base = torch.rand(max(HIST_SIZES), dtype=torch.float64, device=dev,
                      generator=gen)
    modes = [("search f32", torch.float32, None),
             ("search f64", torch.float64, None)]
    modes += [(f"direct k={k} m={m}", torch.float32, (k, m))
              for k, m in HIST_AFFINE]
    total = 0
    for n in HIST_SIZES:
        cases = 0
        bins = HIST_BINS + (HIST_MANY_BINS if n <= HIST_NUMPY_UP_TO else ())
        for nb in bins:
            for j, (label, dt, affine) in enumerate(modes):
                x, e = _hist_inputs(base, n, nb, dt, affine, n + 31 * nb + j)
                got = histogram.histcounts(x, e, affine)
                want = histogram.plain_histcounts(x, e) if affine is None \
                    else histogram.plain_histcounts_affine(x, nb, *affine)
                torch.cuda.synchronize()
                check(got.dtype == torch.int64 and got.shape == (nb,),
                      f"histcounts {label} n={n} B={nb}: {got.dtype} "
                      f"{tuple(got.shape)}")
                err = int((got.long() - want.long()).abs().max())
                check(torch.equal(got, want),
                      f"histcounts {label} n={n} B={nb}: max err {err} "
                      f"against plain")
                if n <= HIST_NUMPY_UP_TO:
                    ref = np.histogram(x.double().cpu().numpy(),
                                       bins=e.double().cpu().numpy())[0]
                    check(np.array_equal(got.cpu().numpy(), ref),
                          f"histcounts {label} n={n} B={nb}: not "
                          f"np.histogram")
                cases += 1
        total += cases
        print(f"kernel histcounts n={n}: {cases} cases (B in {bins}, "
              f"{len(modes)} modes) equal plain"
              + (" and np.histogram" if n <= HIST_NUMPY_UP_TO else ""))
    print(f"kernel histcounts: {total} cases bit-exact")

    # the main path's three calls, at its size: 2^26 values each
    calls = histbench.main_path_calls(gen)
    res = histbench.measure(histogram, calls, TIMING_REPS, plain_reps=5)
    out = []
    for mode, (call, line) in HIST_MAIN_CALLS.items():
        r = res["calls"][mode]
        check(r["equal"], f"histcounts {mode} ({call}) n=2^26: kernel differs "
              f"from plain by up to {r['max_abs_err']:g}")
        if "library_equal" in r:
            check(r["library_equal"],
                  f"torch.histc differs from the kernel ({call})")
        x, e, _ = calls[mode]
        bound = sass.bound(x.numel() * x.element_size()
                       + e.numel() * e.element_size() + (e.numel() - 1) * 8)
        k_ms, lib_ms = r["ms"], r["library_ms"]
        gbs = x.numel() * x.element_size() / (k_ms * 1e-3) / 1e9
        print(f"time histcounts {mode} ({call}) n=2^26: kernel {k_ms:.4f} "
              f"ms ({gbs:.0f} GB/s of x), plain {r['plain_ms']:.4f} ms, "
              f"library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}), share of bound "
              f"{bound[0] / k_ms:.2f}")
        out.append({
            "name": f"histcounts_{mode.replace(' ', '_')}", "route": "cuda",
            "source": "runmat_tpu_torch/csrc/histogram.cu",
            "replaces": f"runmat_tpu/ops/pallas/histogram.py:{line}",
            "launches": 0, "launch_key": mode,
            "max_abs_err": r["max_abs_err"], "ms": k_ms,
            "plain_ms": r["plain_ms"], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms})
    if res["torch_histogram_cuda"] is True:
        print("library: torch.histogram takes CUDA tensors")
    else:
        print(f"library: torch.histogram refuses CUDA tensors "
              f"({res['torch_histogram_cuda']}), so search mode has none")
    for nb, k_ms in res["many_bins"].items():
        print(f"time histcounts search f32 (normals, {nb} bins) n=2^26: "
              f"kernel {k_ms:.4f} ms")
    return out


def _host_reference(src: str) -> tuple:
    """The script under the port's host engine (no device engine).
    run_source skips the workspace preview."""
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.session import Session
    check(accel.active_engine() is None, "an engine is active for the host run")
    buf = io.StringIO()
    s = Session(accelerate=False, stdout=buf)
    s.run_source(src)
    return buf.getvalue(), s


def _image_normalize_f64(imgs) -> float:
    """MSE of image_normalize.m evaluated in float64, frame by frame, on the
    frames the host engine drew (the same Threefry stream as the port's):
    a second check beside the host engine, whose single means over dims
    [2 3] accumulate in double and round once."""
    gain, bias, gamma0, eps0 = (float(np.float32(v))
                                for v in (1.0123, -0.02, 1.8, 1e-6))
    total = 0.0
    for frame in imgs:
        x = frame.astype(np.float64)
        mu = x.mean()
        sigma = np.sqrt(((x - mu) ** 2).mean() + eps0)
        out = np.maximum((x - mu) / sigma * gain + bias, 0.0) ** gamma0
        total += float(((out - x) ** 2).sum())
    return total / imgs.size


def _result_value(output: str, label: str) -> float:
    m = re.search(rf"RESULT_ok {label}=(\S+)", output)
    check(m is not None, f"no 'RESULT_ok {label}=' line in {output!r}")
    return float(m.group(1))


def _sync_check(src: str, label: str) -> None:
    """The script's stream syncs, one warm run under torch's sync debug
    mode, equal the engine's counted reads (syncs plus gathers)."""
    from runmat_tpu_torch import syncs
    r = syncs.script_syncs(src)
    check(r["warnings"] == r["counted"],
          f"{label}: {r['warnings']} synchronizing calls, the engine counted "
          f"{r['counted']}: {r['sites']}")
    print(f"syncs {label}: {r['warnings']} synchronizing calls, the engine "
          f"counted {r['counted']} ({r['syncs']} syncs, {r['gathers']} "
          f"gathers)")


def _zero_launches() -> None:
    from runmat_tpu_torch.ops import (fused, histogram, iir, lstm, lstm_seq,
                                      optim, spcg, threefry)
    for mod in (histogram, threefry, fused, iir, spcg, lstm, optim,
                lstm_seq):
        mod.launches = 0
        mod.launches_by.clear()


def _read_launches() -> dict:
    from runmat_tpu_torch.ops import (fused, histogram, iir, lstm, lstm_seq,
                                      optim, spcg, threefry)
    return {"threefry": dict(threefry.launches_by),
            "histogram": dict(histogram.launches_by),
            "fused": dict(fused.launches_by),
            "iir": dict(iir.launches_by),
            "spcg": dict(spcg.launches_by),
            "lstm": dict(lstm.launches_by),
            "lstm_seq": dict(lstm_seq.launches_by),
            "optim": dict(optim.launches_by)}


def _group(name: str) -> str:
    """The launch counter a kernel row reads."""
    return "threefry" if name.startswith("threefry") else \
        "histogram" if name.startswith("histcounts") else \
        "iir" if name.startswith("iir") else \
        "spcg" if name in SPARSE_KERNELS else \
        "lstm_seq" if name.startswith("lstm_seq") else \
        "lstm" if name.startswith("lstm") else \
        "optim" if name.startswith("optim") else "fused"


def phase_fused_kernel() -> list:
    """The generated kernels against their plain versions, then the
    groups of the main path timed (runmat_tpu_torch/fusebench.py)."""
    from runmat_tpu_torch import fusebench
    from runmat_tpu_torch.accel.engine import TorchEngine
    eng = TorchEngine("cuda")
    for name, build in fusebench.table_cases():
        try:
            r = fusebench.check(eng, name, build)
        except AssertionError as e:
            raise SmokeFailure(f"generated kernel: {e}") from e
        print(f"kernel fused {name}: {r['groups']} kernel(s) equal plain, "
              f"max_abs_err={r['max_abs_err']:g}")
    t0 = time.perf_counter()
    sweep = fusebench.square_sweep(eng)
    took = time.perf_counter() - t0
    check(sweep["kernel_differ"] == 0,
          f"the square arm differs from the correctly rounded square in "
          f"{sweep['kernel_differ']} of 2^32 float32 values")
    print(f"kernel fused square arm: all 2^32 float32 values equal "
          f"float32(float64(x)^2) bit for bit ({took:.1f} s); plain "
          f"torch.pow(x, 2) on the card differs in {sweep['plain_differ']} "
          f"(by ulp: {sweep['plain_ulps']}), NaN "
          f"pattern in {sweep['plain_nan_differ']}")
    seen = fusebench.record()
    try:
        rows = fusebench.measure(eng, seen, TIMING_REPS)
    except AssertionError as e:
        raise SmokeFailure(f"generated kernel on the main path: {e}") from e
    for r in fusebench.spread(eng, seen, SPREAD_ROUNDS, TIMING_REPS):
        print(f"spread {r['label']} ({r['script']}, "
              f"{'x'.join(map(str, r['shape']))}: {' '.join(r['ops'])}), "
              f"{SPREAD_ROUNDS} rounds in turns: kernel median "
              f"{statistics.median(r['kernel_ms']):.4f} ms (range "
              f"{min(r['kernel_ms']):.4f}-{max(r['kernel_ms']):.4f}), library "
              f"median {statistics.median(r['library_ms']):.4f} ms (range "
              f"{min(r['library_ms']):.4f}-{max(r['library_ms']):.4f}), gap "
              f"{r['gap_ms']:+.4f} ms, spread {r['spread_ms']:.4f} ms: "
              f"{'within' if r['within'] else 'outside'} its spread")
    from runmat_tpu_torch.ops import fused
    for script, g, program, _ in seen:
        lay = fused.layout(g.spec)
        if g.spec.reduce is None and lay["N"] > fused.WIDE_MAP:
            print(f"layout {g.label} ({script}, "
                  f"{'x'.join(map(str, g.shape))}: "
                  f"{' '.join(program[i][0] for i in g.members)}): BLOCK "
                  f"{lay['BLOCK']}, {lay['num_warps']} warps")
    del seen
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"time {r['label']} ({r['script']}, {'x'.join(map(str, r['shape']))}"
              f", {len(r['ops'])} ops, {r['outputs']} outputs): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes']} bytes), share of bound {r['share']:.2f}; "
              f"{' '.join(r['ops'])}")
    out = []
    for r in rows:
        out.append({
            "name": r["name"], "route": "triton",
            "source": "runmat_tpu_torch/ops/fused.py",
            # no Pallas twin: XLA generated these from the jax.jit call
            "replaces": "runmat_tpu/accel/engine.py:1201",
            "launches": 0, "launch_key": r["key"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def phase_main_path() -> dict:
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.accel import loops
    from runmat_tpu_torch.ops import fused
    from runmat_tpu_torch.values import MatArray

    sources = {w: open(f"benchmarks/{w}.m").read() for w in WORKLOADS}
    refs = {}
    for w in WORKLOADS:
        t0 = time.perf_counter()
        out, s = _host_reference(sources[w])
        label, var = RESULT_KEY[w]
        refs[w] = (_result_value(out, label),
                   float(s.get(var).host().reshape(-1)[0]))
        print(f"host {w}: {out.strip()} ({time.perf_counter() - t0:.1f} s)")
        if w == "image_normalize":
            exact = _image_normalize_f64(s.get("imgs").host())
            rel = abs(refs[w][1] - exact) / exact
            print(f"host {w}: float64 evaluation MSE={exact!r}; the host "
                  f"engine's single MSE is off by {rel:.3g} (relative)")
            check(rel <= PARITY_RTOL, f"{w}: the host engine's MSE is "
                  f"{rel:.3g} off the float64 evaluation")
            mse_f64 = exact
        del s

    runs = {}
    _zero_launches()
    for w in WORKLOADS:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        before = _read_launches()
        r = s.execute(sources[w])
        torch.cuda.synchronize()
        after = _read_launches()
        graphs = [g for g in eng._jit_cache.values()
                  if isinstance(g, loops._Graph)]
        draws, kernels = ({k: v - before[group].get(k, 0)
                           for k, v in after[group].items()}
                          for group in ("threefry", "fused"))
        runs[w] = (s, eng, r, draws, dict(fused.by_label(kernels)),
                   [dict(fused.by_label(g.kernels)) for g in graphs])
        runmat_tpu_torch.uninstall()
    launches = _read_launches()

    for w, (s, eng, r, draws, kernels, graphs) in runs.items():
        check(r.error is None, f"{w}: {r.error}")
        label, var = RESULT_KEY[w]
        printed = _result_value(r.output, label)
        value = float(s.get(var).host().reshape(-1)[0])
        ref_printed, ref_value = refs[w]
        check(abs(value - ref_value) <= PARITY_RTOL * abs(ref_value),
              f"{w}: {var}={value!r} against host {ref_value!r}")
        check(abs(printed - ref_printed) <= PARITY_RTOL * abs(ref_printed),
              f"{w}: printed {label}={printed!r} against host "
              f"{ref_printed!r}")
        if w == "image_normalize":
            check(abs(value - mse_f64) <= PARITY_RTOL * mse_f64,
                  f"{w}: MSE={value!r} against the float64 evaluation "
                  f"{mse_f64!r}")
        arrays = sorted(k for k, v in s.base_frame.vars.items()
                        if isinstance(v, MatArray) and v.size > 1)
        for k in arrays:
            v = s.get(k)
            check(v.on_device, f"{w}: workspace array {k} is on the host")
            t = eng.materialize(v.dev)
            check(isinstance(t, torch.Tensor) and t.is_cuda,
                  f"{w}: workspace array {k} is not a CUDA tensor")
        st = eng.stats
        check(st["host_fallbacks"] == 0,
              f"{w}: {st['host_fallbacks']} host fallbacks")
        if w == "monte_carlo":
            _check_mc_fold(st, draws, st["graph_captures"])
            check(graphs == [{"fused_map_f32": 1}] and
                  kernels.get("fused_map_f32", 0) >= MC_STEPS,
                  f"monte_carlo: the step's chain is not one generated "
                  f"kernel in the graph: graphs {graphs}, launches {kernels}")
        else:
            eager = [op for op in eng.eager_by_op
                     if op.startswith(("b:", "u:", "r:", "c:"))]
            check(not eager and kernels,
                  f"{w}: eager elementwise ops {dict(eng.eager_by_op)}, "
                  f"generated launches {kernels}")
        if w == "image_normalize":
            check(draws.get("rand float32", 0) >= 1,
                  f"image_normalize: {draws} launches")
        print(f"port {w}: {r.output.strip()} (reference {ref_value!r}, rel err "
              f"{abs(value - ref_value) / abs(ref_value):.3g}); threefry "
              f"launches {draws}; generated kernels {kernels} (in graphs "
              f"{graphs}); eager ops {dict(eng.eager_by_op)}; cuda arrays "
              f"{arrays}; stats "
              f"{json.dumps({k: v for k, v in st.items() if v})}")
    runs.clear()

    for w in WORKLOADS:
        _sync_check(sources[w], w)
    for w in WORKLOADS:
        runs = _walls(sources[w], w)
        if w == "monte_carlo":
            captures = 0
            for st, draws in runs:
                captures += st["graph_captures"]
                _check_mc_fold(st, draws, captures)
            print(f"port monte_carlo (timed session): {captures} capture, "
                  f"graph replays {[st['graph_replays'] for st, _ in runs]}"
                  f" over its four runs")
    return launches


def _check_mc_fold(st: dict, draws: dict, captures: int) -> None:
    """monte_carlo.m's one fold in one run: a captured or cached CUDA graph
    (no decline; at least T - 1 replays, T once cached), T normal draws
    through the device-counter entry, at most one capture so far."""
    from runmat_tpu_torch.ops import threefry
    check(st["loop_folds"] == 1 and st["loop_bails"] == 0,
          f"monte_carlo: loop_folds={st['loop_folds']} "
          f"loop_bails={st['loop_bails']}")
    check(st["graph_declines"] == 0 and captures <= 1 and
          st["graph_replays"] >= MC_STEPS - 1,
          f"monte_carlo: graph declines {st['graph_declines']}, captures "
          f"{captures}, replays {st['graph_replays']}")
    got = draws.get("randn float32" + threefry.DEVICE_COUNTER, 0)
    check(got == MC_STEPS and sum(draws.values()) == MC_STEPS,
          f"monte_carlo: {draws} launches")


def _run_source(s, src: str) -> str:
    """Session.run_source with the session's output captured."""
    s.stdout = io.StringIO()
    s.run_source(src)
    return s.stdout.getvalue()


def _walls(src: str, label: str, preview: bool = True) -> list:
    """First run, then the median of 3 warm runs, in one fresh session;
    through Session.execute (which builds the workspace preview), or
    Session.run_source. Returns each run's engine counters and Threefry
    launches, moved by that run."""
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.ops import threefry
    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    walls = []
    runs = []
    for _ in range(4):
        before = dict(eng.stats)
        draws = dict(threefry.launches_by)
        t0 = time.perf_counter()
        if preview:
            r = s.execute(src)
            check(r.error is None, f"{label} (timed): {r.error}")
        else:
            _run_source(s, src)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        runs.append(({k: v - before[k] for k, v in eng.stats.items()},
                     {k: v - draws.get(k, 0)
                      for k, v in threefry.launches_by.items()
                      if v != draws.get(k, 0)}))
    runmat_tpu_torch.uninstall()
    how = "execute" if preview else "run_source"
    print(f"wall {label} ({how}): first {walls[0] * 1e3:.1f} ms, warm median "
          f"of 3 {statistics.median(walls[1:]) * 1e3:.1f} ms "
          f"({', '.join(f'{x * 1e3:.1f}' for x in walls[1:])})")
    return runs


def phase_statistics_path() -> dict:
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.errors import MatError

    src = open(HIST_WORKLOAD).read()
    t0 = time.perf_counter()
    out, host = _host_reference(src)
    ref_printed = _result_value(out, "HIST")
    ref_value = float(host.get("res").host().reshape(-1)[0])
    print(f"host histogram_stats: {out.strip()} "
          f"({time.perf_counter() - t0:.1f} s)")
    del host

    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        output = _run_source(s, src)
    except MatError as e:
        raise SmokeFailure(f"histogram_stats: {e}") from e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    st = dict(eng.stats)
    runmat_tpu_torch.uninstall()

    on_card = ("u", "z", "cu", "cz", "cq", "pz", "Fz", "sm", "dF")
    for k in on_card:
        v = s.get(k)
        check(v.on_device, f"histogram_stats: {k} is on the host")
        t = eng.materialize(v.dev)
        check(isinstance(t, torch.Tensor) and t.is_cuda,
              f"histogram_stats: {k} is not a CUDA tensor")
    check(st["gather_bytes"] < HIST_TRANSFER_LIMIT,
          f"histogram_stats: {st['gather_bytes']} bytes gathered")
    check(st["upload_bytes"] < HIST_TRANSFER_LIMIT,
          f"histogram_stats: {st['upload_bytes']} bytes uploaded (u, z or "
          f"z.*z went up again)")
    print(f"port histogram_stats: CUDA tensors {list(on_card)}; gathers "
          f"{st['gathers']} ({st['gather_bytes']} bytes), uploads "
          f"{st['uploads']} ({st['upload_bytes']} bytes)")

    printed = _result_value(output, "HIST")
    value = float(s.get("res").host().reshape(-1)[0])
    check(abs(value - ref_value) <= PARITY_RTOL * abs(ref_value),
          f"histogram_stats: res={value!r} against host {ref_value!r}")
    check(abs(printed - ref_printed) <= PARITY_RTOL * abs(ref_printed),
          f"histogram_stats: printed HIST={printed!r} against host "
          f"{ref_printed!r}")

    u = s.get("u").host().reshape(-1)
    z = s.get("z").host().reshape(-1)
    data = {"cu": (u, HIST_EDGES["cu"]),
            "cz": (z, s.get("ez").host().reshape(-1)),
            "cq": (z * z, HIST_EDGES["cq"])}
    for name, (x, edges) in data.items():
        got = s.get(name).host().reshape(-1)
        want = np.histogram(x.astype(np.float64),
                            bins=np.asarray(edges, np.float64))[0]
        check(np.array_equal(got, want.astype(got.dtype)),
              f"histogram_stats: {name} differs from np.histogram by up to "
              f"{np.abs(got - want).max()}")
        print(f"port {name}: {got.size} {got.dtype} counts equal "
              f"np.histogram of the port's own data; largest bin "
              f"{int(want.max())}")

    hist = launches["histogram"]
    check(sum(hist.values()) == 3 and all(
        hist.get(m) == 1 for m in ("direct f32", "search f32", "search f64")),
        f"histogram_stats: histogram launches {hist}")
    check(sum(launches["threefry"].values()) == 2,
          f"histogram_stats: threefry launches {launches['threefry']}")
    check(st["host_fallbacks"] == 0,
          f"histogram_stats: {st['host_fallbacks']} host fallbacks")
    print(f"port histogram_stats: {output.strip()} (reference "
          f"{ref_value!r}, rel err {abs(value - ref_value) / abs(ref_value):.3g});"
          f" launches {launches}; stats "
          f"{json.dumps({k: v for k, v in st.items() if v})}; first run "
          f"{wall * 1e3:.1f} ms")
    del s

    # once through Session.execute: its workspace preview formats no array
    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    r = s.execute(src)
    torch.cuda.synchronize()
    runmat_tpu_torch.uninstall()
    check(r.error is None, f"histogram_stats (execute): {r.error}")
    check(abs(_result_value(r.output, "HIST") - ref_printed)
          <= PARITY_RTOL * abs(ref_printed),
          f"histogram_stats (execute): {r.output.strip()}")
    check(eng.stats["gather_bytes"] < HIST_TRANSFER_LIMIT,
          f"histogram_stats (execute): {eng.stats['gather_bytes']} bytes "
          f"gathered")
    print(f"port histogram_stats (execute): {r.output.strip()}; gathers "
          f"{eng.stats['gathers']} ({eng.stats['gather_bytes']} bytes)")
    del s
    _sync_check(src, "histogram_stats")
    _walls(src, "histogram_stats", preview=False)
    _walls(src, "histogram_stats", preview=True)
    return launches


def _stable_descend(x: np.ndarray) -> np.ndarray:
    """numpy's stable descending sort: the ascending sort of the reversed
    vector, mapped back (NaN first, ties in order)."""
    n = x.size
    ia = np.argsort(x[::-1], kind="stable")
    return ((n - 1) - ia)[::-1]


def _index_sets_against_numpy(s) -> None:
    """index_sets.m's results at 2^26 against numpy of the port's own
    gathered x and q."""
    x = s.get("x").host().reshape(-1)
    i = _stable_descend(x)
    check(np.array_equal(s.get("i").host().reshape(-1), i + 1),
          "index_sets: i is not numpy's stable descending order")
    check(np.array_equal(s.get("s").host().reshape(-1), x[i]),
          "index_sets: s is not x sorted")
    del i
    med = float(s.get("med").host().reshape(-1)[0])
    check(med == float(np.median(x)),
          f"index_sets: median {med!r} against np.median {np.median(x)!r}")
    A = x.reshape(4096, -1, order="F").copy()
    A[:, 1::2] = -A[:, 1::2]
    B = np.roll(np.flip(A, 0), 7, axis=1)[:, :16]
    B = B * np.arange(1, 17, dtype=np.float32)
    check(np.array_equal(s.get("B").host()[:, :16], B),
          "index_sets: B(:, 1:16) differs from numpy")
    del x, A, B
    q = s.get("q").host().reshape(-1)
    u, ia, ic, cnt = np.unique(q, return_index=True, return_inverse=True,
                               return_counts=True)
    for name, want in (("u", u), ("ia", ia + 1), ("ic", ic.reshape(-1) + 1),
                       ("cnt", cnt)):
        got = s.get(name).host().reshape(-1)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"index_sets: {name} differs from np.unique")
    lv = np.arange(-8, 9, 2, dtype=np.float32)
    tf = int(s.get("tf").host().sum())
    check(tf == int(np.isin(q, lv).sum()),
          f"index_sets: sum(tf) {tf} against np.isin")
    print(f"port index_sets: s, i, med, B(:, 1:16), u, ia, ic, cnt and "
          f"sum(tf) equal numpy of the port's own data ({u.size} levels, "
          f"sum(tf) = {tf})")


def phase_indexing_path() -> dict:
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.errors import MatError

    src = open(INDEX_WORKLOAD).read()
    t0 = time.perf_counter()
    out, host = _host_reference(INDEX_REFERENCE_N + src)
    ref = _result_value(out, "RANK")
    print(f"host index_sets N=2^20: {out.strip()} "
          f"({time.perf_counter() - t0:.1f} s)")
    del host
    s = runmat_tpu_torch.session("cuda")
    try:
        got = _result_value(_run_source(s, INDEX_REFERENCE_N + src), "RANK")
    except MatError as e:
        raise SmokeFailure(f"index_sets N=2^20: {e}") from e
    finally:
        runmat_tpu_torch.uninstall()
    check(abs(got - ref) <= PARITY_RTOL * abs(ref),
          f"index_sets N=2^20: RANK={got!r} against host {ref!r}")
    print(f"port index_sets N=2^20: RANK={got!r} (host {ref!r}, rel err "
          f"{abs(got - ref) / abs(ref):.3g})")
    del s

    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        output = _run_source(s, src)
    except MatError as e:
        raise SmokeFailure(f"index_sets: {e}") from e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    st = dict(eng.stats)
    log = list(eng.launch_log)
    runmat_tpu_torch.uninstall()
    check(st["host_fallbacks"] == 0,
          f"index_sets: {st['host_fallbacks']} host fallbacks "
          f"{[e for e in log if e['cat'] == 'host_fallback']}")
    check(st["loop_folds"] == 1 and st["loop_bails"] == 0,
          f"index_sets: loop_folds={st['loop_folds']} "
          f"loop_bails={st['loop_bails']}")
    whiles = [e for e in log if e["cat"] == "device_while"]
    check(st["while_folds"] == 1 and len(whiles) == 1,
          f"index_sets: while_folds={st['while_folds']}")
    (fold,) = [e for e in log if e["cat"] == "device_loop"]
    check(fold["graph"] == "captured" and st["graph_declines"] == 0 and
          fold["replays"] == fold["iterations"] - 1,
          f"index_sets: the for fold was not captured: {fold}")
    back = st["gather_bytes"] + st["sync_bytes"]
    check(back < INDEX_TRANSFER_LIMIT and
          st["upload_bytes"] < INDEX_TRANSFER_LIMIT,
          f"index_sets: {back} bytes back, {st['upload_bytes']} up")
    check(launches["threefry"].get("randn float32") == 1,
          f"index_sets: threefry launches {launches['threefry']}")
    for k in ("x", "s", "i", "u", "ic", "cnt", "tf", "B", "P", "y"):
        v = s.get(k)
        check(v.on_device and eng.materialize(v.dev).is_cuda,
              f"index_sets: {k} is not a CUDA tensor")
    rank = _result_value(output, "RANK")
    print(f"port index_sets: {output.strip()}; the for fold ran "
          f"{fold['iterations']} iterations, {fold['graph']}, "
          f"{fold['replays']} graph replays; the while fold ran "
          f"{whiles[0]['iterations']} iterations ({whiles[0]['graph']}, "
          f"{whiles[0]['replays']} replays); {st['gathers']} gathers "
          f"({st['gather_bytes']} bytes), {st['syncs']} reads of a count or "
          f"condition ({st['sync_bytes']} bytes), {st['uploads']} uploads "
          f"({st['upload_bytes']} bytes); launches {launches}; stats "
          f"{json.dumps({k: v for k, v in st.items() if v})}; first run "
          f"{wall * 1e3:.1f} ms")
    _index_sets_against_numpy(s)
    del s

    # once through Session.execute
    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    r = s.execute(src)
    torch.cuda.synchronize()
    runmat_tpu_torch.uninstall()
    check(r.error is None, f"index_sets (execute): {r.error}")
    check(_result_value(r.output, "RANK") == rank,
          f"index_sets (execute): {r.output.strip()} against {rank!r}")
    back = eng.stats["gather_bytes"] + eng.stats["sync_bytes"]
    check(back < INDEX_TRANSFER_LIMIT and eng.stats["host_fallbacks"] == 0,
          f"index_sets (execute): {back} bytes back, "
          f"{eng.stats['host_fallbacks']} host fallbacks")
    print(f"port index_sets (execute): {r.output.strip()}; {back} bytes back")
    del s
    _sync_check(src, "index_sets")
    _walls(src, "index_sets", preview=False)
    _walls(src, "index_sets", preview=True)
    return launches


def _iir_cases(dev) -> list:
    """(label, x, b, a, z0) the IIR kernel is held to its plain version on:
    random filters of orders 1 to 8 in both types from a nonzero state,
    over IIR_SHORT samples (one stretch: bit-equal throughout) and over
    IIR_STRETCHES stretches; a resonator with poles of radius 0.999; a NaN
    in the middle of a middle stretch."""
    import torch
    from runmat_tpu_torch.ops import iir
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    long_n = IIR_STRETCHES * iir.CHUNK + 77
    cases = []
    for dt in (torch.float32, torch.float64):
        for order in range(1, 9):
            n = order + 1
            b = torch.randn(n, dtype=dt, device=dev, generator=gen) * 0.3
            a = torch.randn(n, dtype=dt, device=dev, generator=gen) * 0.1
            z0 = torch.randn(n - 1, dtype=dt, device=dev, generator=gen) * 0.1
            for length in (IIR_SHORT, long_n):
                x = torch.randn(length, dtype=dt, device=dev, generator=gen)
                cases.append((f"{dt} order {order} n={length}", x, b, a, z0))
        th, r = 0.05, 0.999
        b = torch.tensor([0.02, 0.01, -0.005], dtype=dt, device=dev)
        a = torch.tensor([1, -2 * r * np.cos(th), r * r], dtype=dt, device=dev)
        z0 = torch.tensor([0.3, -0.2], dtype=dt, device=dev)
        x = torch.randn(IIR_POLE_N, dtype=dt, device=dev, generator=gen)
        cases.append((f"{dt} pole radius 0.999 n={IIR_POLE_N}", x, b, a, z0))
        x = torch.randn(long_n, dtype=dt, device=dev, generator=gen)
        x[(IIR_STRETCHES // 2) * iir.CHUNK + iir.CHUNK // 2] = float("nan")
        b, a, z0 = cases[-3][2:]
        cases.append((f"{dt} order 8, NaN in stretch {IIR_STRETCHES // 2} "
                      f"n={long_n}", x, b, a, z0))
    return cases


def _iir_kernel() -> None:
    """The IIR kernel against its plain version (`linalgbench.held`: the
    first stretch bit for bit, elsewhere within iir.TOL of the largest
    output magnitude, non-finite values in the same places) on
    `_iir_cases`; the kernel at each stretch length of IIR_SWEEP on
    spectral.m's float64 call; then that call (its Butterworth filter over
    2^22 samples) in float32, timed with its phases
    (runmat_tpu_torch/linalgbench.py). The float64 call the path makes is
    held to its plain version after spectral.m's run."""
    import torch

    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import iir
    dev = torch.device("cuda")
    worst = {}
    for label, x, b, a, z0 in _iir_cases(dev):
        got, want = iir.iir(x, b, a, z0), iir.plain_iir(x, b, a, z0)
        torch.cuda.synchronize()
        r = linalgbench.held(got, want, iir.CHUNK, iir.TOL[x.dtype])
        check(r["ok"], f"iir {label}: {r}")
        key = str(x.dtype)
        worst[key] = max(worst.get(key, 0.0), r["rel_err"])
        print(f"kernel iir {label}: first {min(iir.CHUNK, x.numel())} "
              f"outputs bit-equal, non-finite in the same places, rel err "
              f"{r['rel_err']:.3g} (limit {iir.TOL[x.dtype]:g})")
    print(f"kernel iir: largest rel err {worst}; stretches of L={iir.CHUNK} "
          f"samples, {iir.SHAPE}")
    for r in linalgbench.iir_sweep(
            iir, *linalgbench.iir_inputs(torch.float64), IIR_SWEEP, 20):
        check(r["ok"], f"iir f64 at 2^22, L={r['chunk']}: {r}")
        print(f"time iir f64 (spectral.m's call) at L={r['chunk']}: "
              f"{r['ms']:.4f} ms, rel err {r['rel_err']:.3g}")
    # spectral.m filters in float64 (its coefficients are double); the
    # float32 kernel is timed at the same call beside it
    r = linalgbench.iir_row(iir, *linalgbench.iir_inputs(torch.float32), 20)
    check(r["ok"], f"iir f32 at 2^22: {r}")
    _print_iir("iir f32", r)


def _print_iir(label: str, r: dict) -> None:
    phases = ", ".join(f"{k} {v:.4f}" for k, v in r["phase_ms"].items())
    print(f"time {label} (spectral.m's call, n=2^22, order {r['order']}, "
          f"L={r['chunk']}): kernel {r['ms']:.4f} ms (phases, ms: "
          f"{phases}), plain {r['plain_ms']:.1f} ms (the host loop over all "
          f"{r['n']} samples; first stretch bit-equal, rel err "
          f"{r['rel_err']:.3g}, limit {r['tol']:g}), library none, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of bound "
          f"{r['bound_ms'] / r['ms']:.4f}")


def _iir_path_row(values: dict) -> dict:
    """spectral.m's IIR call held to the plain version over all its
    samples: the kernel on the script's own signal and coefficients, and
    the path's output z, both (`linalgbench.held`); the row of the kernel
    line."""
    import torch

    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import iir
    x, z = values["x"], values["z"]
    dev, f64 = x.device, torch.float64
    bb, aa = (np.asarray(torch.as_tensor(values[name]).cpu(),
                         dtype=np.float64).reshape(-1)
              for name in ("bb", "aa"))
    b = torch.tensor(bb / aa[0], dtype=f64, device=dev)
    a = torch.tensor(aa / aa[0], dtype=f64, device=dev)
    z0 = torch.zeros(len(bb) - 1, dtype=f64, device=dev)
    r = linalgbench.iir_row(iir, x.reshape(-1), b, a, z0, 20, path_y=z)
    check(r["ok"], f"iir f64, spectral.m's call: the kernel or the path's "
          f"z against plain: {r}")
    _print_iir("iir f64", r)
    return {"name": "iir_f64", "route": "cuda",
            "source": "runmat_tpu_torch/csrc/iir.cuh",
            "replaces": "runmat_tpu/accel/dense.py:706",
            "launches": 0, "launch_key": "iir f64",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None}


def _slice_script(path: str, label: str, key: str, keep=()) -> tuple:
    """One script of phase 7 against the port's host engine. Returns (the
    port's session, its launches, the host session, the workspace values
    named in `keep`: a device value as its CUDA tensor, a host one as its
    array)."""
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.errors import MatError

    src = open(path).read()
    t0 = time.perf_counter()
    out, host = _host_reference(src)
    ref = _result_value(out, key)
    print(f"host {label}: {out.strip()} ({time.perf_counter() - t0:.1f} s)")
    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        output = _run_source(s, src)
    except MatError as e:
        raise SmokeFailure(f"{label}: {e}") from e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    st, log = dict(eng.stats), list(eng.launch_log)
    launches["linalg"] = dict(collections.Counter(
        k for e in log if e["cat"] == "linalg" for k in e["ops"]))
    reasons = dict(eng.sync_reasons)
    kept = {}
    for name in keep:
        v = s.get(name)
        kept[name] = eng.materialize(v.dev) if v.on_device else v.host()
    runmat_tpu_torch.uninstall()
    got = _result_value(output, key)
    check(abs(got - ref) <= SLICE_RTOL * abs(ref),
          f"{label}: {key}={got!r} against host {ref!r}")
    check(st["host_fallbacks"] == 0,
          f"{label}: {st['host_fallbacks']} host fallbacks "
          f"{[e for e in log if e['cat'] == 'host_fallback']}")
    unported = [e for e in log if any(t in json.dumps(e) for t in
                                      ("(A7)", "(A8)", "not ported"))]
    check(not unported, f"{label}: declines {unported}")
    check(st["upload_bytes"] < SLICE_TRANSFER_LIMIT,
          f"{label}: {st['upload_bytes']} bytes uploaded")
    print(f"port {label}: {output.strip()} (host {ref!r}, rel err "
          f"{abs(got - ref) / abs(ref):.3g}); {st['uploads']} uploads "
          f"({st['upload_bytes']} bytes), {st['gathers']} gathers "
          f"({st['gather_bytes']} bytes), {st['syncs']} waits inside "
          f"torch.linalg {reasons}; launches {launches}; first run "
          f"{wall * 1e3:.1f} ms")
    return s, launches, host, kept


def phase_linalg_signal_path() -> dict:
    """dense_linalg.m and spectral.m at their default sizes against the
    host engine, after the IIR kernel against its plain version."""
    _iir_kernel()
    s, launches, host, _ = _slice_script(LINALG_WORKLOAD, "dense_linalg",
                                         "LINALG")
    for name in RESIDUALS:
        r = float(np.asarray(s.get(name).host()).reshape(-1)[0])
        check(r < RESIDUAL_LIMIT, f"dense_linalg: {name} = {r!r}")
    print("port dense_linalg: residuals " + ", ".join(
        f"{n} {float(np.asarray(s.get(n).host()).reshape(-1)[0]):.3g}"
        for n in RESIDUALS))
    del s, host
    _sync_check(open(LINALG_WORKLOAD).read(), "dense_linalg")
    _walls(open(LINALG_WORKLOAD).read(), "dense_linalg", preview=False)

    s, sig, host, kept = _slice_script(SIGNAL_WORKLOAD, "spectral",
                                       "SPECTRAL", ("x", "z", "bb", "aa"))
    check(sig["iir"] == {"iir f64": 1}, f"spectral: iir launches {sig['iir']}")
    phase_linalg_signal_path.kernels = [_iir_path_row(kept)]
    del kept
    G = np.asarray(s.get("G").host())
    Gh = np.asarray(host.get("G").host())
    check(G.dtype == Gh.dtype == np.float32 and G.shape == Gh.shape,
          f"spectral: G {G.dtype} {G.shape} against {Gh.dtype} {Gh.shape}")
    gerr = float(np.abs(G.astype(np.float64) - Gh).max() / np.abs(Gh).max())
    check(gerr <= CONV2_SINGLE_TOL, f"spectral: single conv2 off by {gerr:g}"
          f" of its largest value (TF32?)")
    print(f"port spectral: single conv2 within {gerr:.3g} of its largest "
          f"value of the host engine's")
    del s, host
    _sync_check(open(SIGNAL_WORKLOAD).read(), "spectral")
    _walls(open(SIGNAL_WORKLOAD).read(), "spectral", preview=False)
    for group, counts in sig.items():
        for k, v in counts.items():
            launches[group][k] = launches[group].get(k, 0) + v
    return launches


def _iir_seq_kernel() -> None:
    """The sequential IIR kernel (csrc/iir_seq.cu, more than
    MAX_WARP_COEFS coefficients) against its plain version, every output
    bit for bit, at orders 65 and 200 in both types from a nonzero
    state."""
    import torch

    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import iir
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(39)
    for dt in (torch.float32, torch.float64):
        for ncoef, n in IIR_SEQ_CASES:
            x = torch.randn(n, dtype=dt, device=dev, generator=gen)
            b = torch.randn(ncoef, dtype=dt, device=dev, generator=gen) * 0.3
            a = torch.rand(ncoef, dtype=dt, device=dev, generator=gen)
            a = a * (0.5 / float(a[1:].sum()))
            z0 = torch.randn(ncoef - 1, dtype=dt, device=dev,
                             generator=gen) * 0.1
            before = collections.Counter(iir.launches_by)
            got, want = iir.iir(x, b, a, z0), iir.plain_iir(x, b, a, z0)
            torch.cuda.synchronize()
            name = f"iir_seq {'f64' if dt == torch.float64 else 'f32'}"
            check(collections.Counter(iir.launches_by) - before == {name: 1},
                  f"iir order {ncoef - 1}: {iir.launches_by}")
            r = linalgbench.held(got, want, n, 0.0)
            check(r["ok"], f"iir_seq {dt} order {ncoef - 1} n={n}: {r}")
            print(f"kernel iir_seq {dt} order {ncoef - 1} n={n}: all "
                  f"outputs bit-equal to plain")


def _warp_cases(dev) -> list:
    """(label, x, b, a, z0) the warp kernel is held to its plain version
    on: random stable filters (sum |a[1:]| = 0.5) of IIR_WARP_ORDERS in
    both types from a nonzero state over IIR_WARP_SHORT and IIR_WARP_LONG
    samples; at order 39 a resonator of radius 0.999 times a random
    order-37 part over IIR_POLE_N samples, and a NaN in the middle of the
    middle stretch."""
    import torch
    from runmat_tpu_torch.ops import iir
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    cases = []

    def stable(order, dt):
        n = order + 1
        b = torch.randn(n, dtype=torch.float64, device=dev, generator=gen)
        a = torch.randn(n, dtype=torch.float64, device=dev, generator=gen)
        a[1:] *= 0.5 / float(a[1:].abs().sum())
        a[0] = 1.0
        z0 = torch.randn(n - 1, dtype=torch.float64, device=dev,
                         generator=gen) * 0.1
        return (b * 0.3).to(dt), a.to(dt), z0.to(dt)
    for dt in (torch.float32, torch.float64):
        for order in IIR_WARP_ORDERS:
            b, a, z0 = stable(order, dt)
            for length in (IIR_WARP_SHORT, IIR_WARP_LONG):
                x = torch.randn(length, dtype=dt, device=dev, generator=gen)
                cases.append((f"{dt} order {order} n={length}", x, b, a, z0))
        b, a, z0 = stable(37, torch.float64)
        r, th = 0.999, 0.05
        a = torch.tensor(np.convolve(a.cpu().numpy(),
                                     [1, -2 * r * np.cos(th), r * r]),
                         dtype=dt, device=dev)
        b = torch.cat([b, b[:2]]).to(dt)
        z0 = torch.cat([z0, z0[:2]]).to(dt)
        x = torch.randn(IIR_POLE_N, dtype=dt, device=dev, generator=gen)
        cases.append((f"{dt} order 39, pole radius 0.999 n={IIR_POLE_N}", x,
                      b, a, z0))
        x = torch.randn(IIR_WARP_LONG, dtype=dt, device=dev, generator=gen)
        chunk = iir.warp_shape(IIR_WARP_LONG)[0]
        x[32 * chunk + chunk // 2] = float("nan")
        b, a, z0 = stable(39, dt)
        cases.append((f"{dt} order 39, NaN in stretch 32 n={IIR_WARP_LONG}",
                      x, b, a, z0))
    return cases


def _iir_warp_kernel() -> None:
    """The warp kernel (csrc/iir_warp.cu, orders 33-64) against its plain
    version on `_warp_cases` (`linalgbench.held`: the first stretch of L
    samples bit for bit, all of a one-stretch call, elsewhere within
    iir.TOL of the largest output magnitude, non-finite values in the same
    places); the kernel at each (L, g) of IIR_WARP_SWEEP on
    resample_pages.m's filter; then that filter over 2^22 samples, held the
    same way to the sequential kernel's output (bit-equal to plain) and
    timed with its phases beside the bound and the sequential kernel (the
    path's own call, 2^18 samples, is held and timed after the script's
    run)."""
    import torch

    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import iir
    dev = torch.device("cuda")
    worst = {}
    for label, x, b, a, z0 in _warp_cases(dev):
        before = collections.Counter(iir.launches_by)
        got, want = iir.iir(x, b, a, z0), iir.plain_iir(x, b, a, z0)
        torch.cuda.synchronize()
        name = f"iir_warp {'f64' if x.dtype == torch.float64 else 'f32'}"
        check(collections.Counter(iir.launches_by) - before == {name: 1},
              f"iir {label}: {iir.launches_by}")
        chunk = iir.warp_shape(x.numel())[0]
        r = linalgbench.held(got, want, chunk, iir.TOL[x.dtype])
        check(r["ok"], f"iir_warp {label}: {r}")
        key = str(x.dtype)
        worst[key] = max(worst.get(key, 0.0), r["rel_err"])
        print(f"kernel iir_warp {label}: first {min(chunk, x.numel())} "
              f"outputs bit-equal, non-finite in the same places, rel err "
              f"{r['rel_err']:.3g} (limit {iir.TOL[x.dtype]:g})")
    print(f"kernel iir_warp: largest rel err {worst}; {iir.WARP_SHAPE}")
    for lg, shapes in IIR_WARP_SWEEP.items():
        x, b, a, z0 = linalgbench.seq_inputs(torch.float64, 1 << lg)
        for r in linalgbench.warp_sweep(iir, x, b, a, z0, shapes, 10):
            walk = "" if "cycles_a_sample" not in r else \
                f" (one warp, {r['cycles_a_sample']:.1f} cycles a sample)"
            print(f"time iir_warp f64 (resample_pages.m's filter, n=2^{lg})"
                  f" at L={r['chunk']}, g={r['group']}: {r['ms']:.4f} ms"
                  f"{walk}")
    x, b, a, z0 = linalgbench.seq_inputs(torch.float64, IIR_SEQ_N)
    seq = iir.seq_launch(x, b, a, z0)
    r = linalgbench.warp_row(iir, x, b, a, z0, TIMING_REPS // 5, want=seq,
                             seq_reps=2)
    check(r["ok"], f"iir_warp f64 at 2^22 against iir_seq: {r}")
    _print_warp("resample_pages.m's filter, n=2^22", r)


def _print_warp(label: str, r: dict) -> None:
    phases = ", ".join(f"{k} {v:.4f}" for k, v in r["phase_ms"].items())
    plain = "" if r["plain_ms"] is None else \
        f", plain {r['plain_ms']:.1f} ms (the host loop)"
    print(f"time iir_warp f64 ({label}, order {r['order']}, L={r['chunk']}, "
          f"g={r['group']}): kernel {r['ms']:.4f} ms (phases, ms: {phases})"
          f"{plain}, iir_seq on the same input {r['seq_ms']:.3f} ms, library "
          f"none, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of "
          f"bound {r['bound_ms'] / r['ms']:.4f}; first stretch bit-equal, rel "
          f"err {r['rel_err']:.3g} (limit {r['tol']:g})")


def _builders() -> None:
    """resample_pages.m's device builders at its default shapes, each timed
    beside its bound and its PyTorch call where there is one; then each
    made while the card is busy: none may wait for the card inside torch
    (where the sync debug mode of `_sync_check` does not look)."""
    from runmat_tpu_torch import linalgbench
    calls = linalgbench.builder_calls()
    for r in linalgbench.builder_rows(TIMING_REPS // 5, calls):
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"time {r['op']} ({r['call']}): {r['ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"of bound {r['share']:.3f}")
    for r in linalgbench.host_waits([(c[1], c[2]) for c in calls]):
        check(r["host_ms"] < r["card_ms"] / 4,
              f"{r['call']} waits for the card: {r}")
        print(f"no wait: {r['call']} returns in {r['host_ms']:.3f} ms while "
              f"the card is busy for {r['card_ms']:.1f} ms")


def _module_snippets() -> None:
    """Each snippet of runmat_tpu_torch/parity_snippets.py (one a builtin
    module copied with the page slice) in a card session against the
    port's host engine: the same output, error and workspace values (equal,
    or, where the snippet states a tolerance, within it of the largest
    magnitude: the dlnetwork snippet's float32 sums)."""
    import runmat_tpu_torch
    from runmat_tpu_torch.parity_snippets import NEEDS, SNIPPETS
    from runmat_tpu_torch.session import Session
    for sid, module, src, tol in SNIPPETS:
        need = NEEDS.get(module)
        if need and importlib.util.find_spec(need) is None:
            print(f"snippet {sid}: skipped, {module} needs {need}, which "
                  f"this machine does not have")
            continue
        host = Session(accelerate=False, stdout=io.StringIO())
        want = host.execute(src)
        card = runmat_tpu_torch.session("cuda")
        try:
            got = card.execute(src)
        finally:
            runmat_tpu_torch.uninstall()
        check(got.output == want.output and (got.error is None) ==
              (want.error is None), f"snippet {sid}: {got.output!r} "
              f"{got.error} against {want.output!r} {want.error}")
        names = sorted(host.workspace_names())
        check(sorted(card.workspace_names()) == names,
              f"snippet {sid}: workspace {sorted(card.workspace_names())}")
        for name in names:
            w, g = host.get(name), card.get(name)
            if hasattr(w, "host") and hasattr(w, "mclass"):
                wh, gh = np.asarray(w.host()), np.asarray(g.host())
                check(g.mclass == w.mclass and gh.shape == wh.shape and
                      gh.dtype == wh.dtype and
                      (np.array_equal(gh, wh, equal_nan=True) if tol == 0
                       or wh.dtype.kind not in "fc" else
                       np.allclose(gh, wh, rtol=0, equal_nan=True,
                                   atol=tol * np.abs(wh).max(initial=1.0))),
                      f"snippet {sid}: {name} {gh!r} against {wh!r}")
            else:
                check(type(g).__name__ == type(w).__name__,
                      f"snippet {sid}: {name} is a {type(g).__name__}")
        print(f"snippet {sid} ({module}): card session equals the host "
              f"engine ({len(names)} values)")


def phase_pages_path() -> dict:
    """resample_pages.m at its default size (N = 2^22, 8192 pages of 32 x
    32) against the host engine, after the sequential and the warp IIR
    kernels against their plain versions; then the slice's modules'
    snippets on the card."""
    import torch

    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import iir
    _iir_seq_kernel()
    _iir_warp_kernel()
    _builders()
    s, launches, host, kept = _slice_script(
        PAGES_WORKLOAD, "resample_pages", "PAGES", ("C", "D", "y", "w"))
    check(launches["iir"] == {"iir_warp f64": 1},
          f"resample_pages: iir launches {launches['iir']}")
    check(launches["linalg"] == PAGES_LINALG,
          f"resample_pages: device builders {launches['linalg']}")
    C, D = kept["C"], kept["D"]
    check(isinstance(D, torch.Tensor) and D.is_cuda and torch.equal(C, D),
          "resample_pages: pagefun(@mtimes, A, B) is not pagemtimes(A, B) "
          "on the card")
    # the path's filter: the kernel on the script's own signal and
    # coefficients, and the path's output w, against the plain version;
    # the sequential kernel on the same input, bit for bit
    y, w = kept["y"], kept["w"]
    _, b, a, z0 = linalgbench.seq_inputs(torch.float64, 1)
    x = y.reshape(-1)[:w.numel()]
    r = linalgbench.warp_row(iir, x, b, a, z0, TIMING_REPS // 5, path_y=w,
                             seq_reps=2)
    check(r["ok"], f"resample_pages: the order-39 filter or the path's w "
          f"against plain: {r}")
    _print_warp(f"resample_pages.m's call, n={r['n']}", r)
    sr = linalgbench.seq_row(iir, x, b, a, z0, 2)
    check(sr["ok"], f"resample_pages: iir_seq on the path's call: {sr}")
    print(f"time iir_seq f64 (resample_pages.m's call, n={sr['n']}, order "
          f"{sr['order']}, not on the path since the warp kernel): kernel "
          f"{sr['ms']:.3f} ms, bit-equal to plain, bound "
          f"{sr['bound_ms']:.4f} ms ({sr['bound_by']}), share of bound "
          f"{sr['bound_ms'] / sr['ms']:.6f}")
    print(f"port resample_pages: D equals C bit for bit on the card; device "
          f"builders {launches['linalg']}")
    rows = [{"name": "iir_warp_f64", "route": "cuda",
             "source": "runmat_tpu_torch/csrc/iir_warp.cu",
             "replaces": "runmat_tpu/accel/dense.py:706",
             "launches": 0, "launch_key": "iir_warp f64",
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None},
            {"name": "iir_seq_f64", "route": "cuda",
             "source": "runmat_tpu_torch/csrc/iir_seq.cu",
             "replaces": "runmat_tpu/accel/dense.py:706",
             "launches": 0, "launch_key": "iir_seq f64", "on_path": False,
             "max_abs_err": sr["max_abs_err"], "ms": sr["ms"],
             "plain_ms": sr["plain_ms"], "bound_ms": sr["bound_ms"],
             "bound_by": sr["bound_by"], "library_ms": None}]
    del s, host, kept, C, D, x, y, w
    src = open(PAGES_WORKLOAD).read()
    _sync_check(src, "resample_pages")
    _walls(src, "resample_pages", preview=False)
    _module_snippets()
    phase_pages_path.kernels = rows
    return launches


def _sparse_kernels() -> dict:
    """spmv_f64 against plain_spmv bit for bit on rows that are empty, a
    row of 5000 nonzeros, triangles that differ in the last bits and the
    path's Poisson matrix; the whole solve on a 60^2 Poisson system and a
    seeded SPD sprandsym-style one (twice, bit for bit the same) against
    plain_cg(ordered=True) bit for bit and plain_cg; then each kernel of
    one iteration at the path's shape held to the JAX body's torch ops,
    each tail's scalars to the ordered model, and timed, with and without
    its tail (runmat_tpu_torch/spbench.py)."""
    import torch

    from runmat_tpu_torch import histbench, spbench
    from runmat_tpu_torch.ops import spcg
    dev = torch.device("cuda")
    for label, *csr in spbench.spmv_cases(dev):
        r = spbench.spmv_held(spcg, *csr)
        check(r["equal"], f"spmv_f64 {label}: {r}")
        print(f"kernel spmv_f64 {label}: equal to plain_spmv bit for bit")
    for label, *system in spbench.cg_cases(dev):
        r = spbench.cg_held(spcg, *system)
        check(r["ok"], f"cg {label}: {r}")
        print(f"kernel cg {label}: {r['iterations']} iterations (plain "
              f"{r['plain_iterations']}), two solves bit-equal and equal "
              f"to the ordered model's x and k bit for bit, x within "
              f"{r['rel_err']:.3g} of plain's largest entry (limit "
              f"{spbench.X_TOL:g}), residual {r['residual']:.3g}")
    steps = spbench.step_rows(spcg, histbench.time_ms, TIMING_REPS)
    check(steps["start_ok"] and steps["timed_ok"] and
          all(r["ok"] for r in steps["rows"].values()),
          f"a CG kernel against the JAX body's torch ops and the ordered "
          f"model: {steps}")
    for name, r in steps["rows"].items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"time {name} (sparse_poisson.m, n={steps['n']}, nnz="
              f"{steps['nnz']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}, {r['bytes']} "
              f"bytes), share of bound {r['bound_ms'] / r['ms']:.3f}; max "
              f"abs err against the body's torch ops {r['max_abs_err']:.3g}"
              f", its tail's scalars equal the ordered model's")
    code = spbench.tail_code()
    for name, t in steps["tails"].items():
        print(f"time {name} tail (sparse_poisson.m): {t['ms'] * 1e3:.2f} us "
              f"(with it {steps['rows'][name]['ms']:.4f} ms, without "
              f"{t['kernel_ms']:.4f} ms, bound without "
              f"{t['kernel_bound_ms']:.6f} ms; {t['bytes']} bytes more); "
              f"its machine code (sass.py): {code[name]}")
    it = steps["iteration"]
    print(f"time cg iteration (sparse_poisson.m): three launches "
          f"{it['ms']:.4f} ms eagerly, {it['graph_ms']:.4f} ms an iteration "
          f"of a replayed graph of {spcg.CHUNK}, plain {it['plain_ms']:.4f} "
          f"ms, bound {it['bound_ms']:.4f} ms ({it['bound_by']}, "
          f"{it['bytes']} bytes), share of bound "
          f"{it['bound_ms'] / it['graph_ms']:.3f}; cuSPARSE's product alone "
          f"{it['library_ms']:.4f} ms")
    return steps["rows"]


def phase_sparse_path() -> dict:
    """sparse_poisson.m at its default N = 1024 (1,048,576 unknowns,
    5,240,830 nonzeros) through Session.run_source: A\\b solved by the CG
    kernels, every chunk of iterations a graph replay and one read of the
    done flag; x and k held to plain_cg(ordered=True) bit for bit and x to
    plain_cg on the card, the residuals, the launches
    and reads, the waits, the warm walls and a profile. After the kernels
    against their plain versions."""
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel, profile, spbench
    from runmat_tpu_torch.ops import spcg
    rows = _sparse_kernels()
    src = open(SPARSE_WORKLOAD).read()
    dev = torch.device("cuda")
    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    _zero_launches()
    t0 = time.perf_counter()
    output = _run_source(s, src)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    st, reasons = dict(eng.stats), dict(eng.sync_reasons)
    solves = [e for e in eng.launch_log if e["cat"] == "sparse_cg"]
    check(len(solves) == 1, f"sparse_poisson: device solves {solves}")
    k = solves[0]["iterations"]
    chunks = max(1, -(-k // spcg.CHUNK))
    reads = reasons.get("cg", 0)
    check(reads == chunks == st["syncs"],
          f"sparse_poisson: {reads} reads of the done flag, {st['syncs']} "
          f"syncs, for {k} iterations in chunks of {spcg.CHUNK}")
    it = chunks * spcg.CHUNK
    want = {"spmv_f64": it, "cg_update": 1 + it, "cg_direction": it}
    check(launches["spcg"] == want,
          f"sparse_poisson: launches {launches['spcg']}, want {want}")
    check(st["host_fallbacks"] == 0,
          f"sparse_poisson: {st['host_fallbacks']} host fallbacks")
    check(st["upload_bytes"] < SPARSE_TRANSFER_LIMIT,
          f"sparse_poisson: {st['upload_bytes']} bytes uploaded")
    solver = eng.spcg_cache["solver"]
    loop_res = (float(solver.sc[spcg.SLOTS["rr"]]) /
                float(solver.sc[spcg.SLOTS["bb"]])) ** 0.5
    check(k < solver.maxit and loop_res <= SPARSE_TOL,
          f"sparse_poisson: {k} iterations, the loop's residual {loop_res}")
    A, x = s.get("A"), s.get("x")
    bh = np.array(s.get("b").host(), dtype=np.float64).reshape(-1)
    xh = np.array(x.host(), dtype=np.float64).reshape(-1)
    check(xh.shape == (A.n,) and bool(np.isfinite(xh).all()),
          f"sparse_poisson: x {xh.shape}, finite {np.isfinite(xh).all()}")
    printed = _result_value(output, "POISSON")
    check(abs(printed - xh.sum()) <= 1e-12 * abs(xh.sum()),
          f"sparse_poisson: printed {printed!r}, sum(x) {xh.sum()!r}")
    rowptr, col, val = spbench.csr_of(A, dev)
    bv = torch.from_numpy(bh).to(dev)
    invd = spbench.inverse_diagonal(rowptr, col, val)
    t0 = time.perf_counter()
    xp, kp = spcg.plain_cg(rowptr, col, val, bv, invd)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xo, ko = spcg.plain_cg(rowptr, col, val, bv, invd, ordered=True)
    torch.cuda.synchronize()
    ordered_s = time.perf_counter() - t0
    xd = torch.from_numpy(xh).to(dev)
    check(k == ko and bool(torch.equal(xd, xo)),
          f"sparse_poisson: {k} iterations, the ordered model {ko}; x "
          f"{float((xd - xo).abs().max()):g} off its x")
    err = float((xd - xp).abs().max())
    scale = float(xp.abs().max())
    res = spbench.residual(rowptr, col, val, xd, bv)
    res_plain = spbench.residual(rowptr, col, val, xp, bv)
    check(err <= spbench.X_TOL * scale,
          f"sparse_poisson: x {err:g} off plain_cg's (largest {scale:g})")
    check(res <= SPARSE_DRIFT * res_plain,
          f"sparse_poisson: residual {res:g}, plain_cg's {res_plain:g}")
    print(f"port sparse_poisson: {output.strip()}; n={A.n}, nnz={A.nnz}; "
          f"{k} iterations (plain_cg {kp}, {plain_s:.1f} s), x and k "
          f"equal to the ordered model's bit for bit ({ordered_s:.1f} s), "
          f"the loop's "
          f"residual {loop_res:.3g} (limit {SPARSE_TOL:g}), "
          f"norm(b - A*x)/norm(b) {res:.3g} (plain_cg's x {res_plain:.3g}), "
          f"x within {err:.3g} of plain_cg's (largest {scale:.6g}, limit "
          f"{spbench.X_TOL:g} of it); {reads} reads of the done flag, "
          f"launches {launches['spcg']}; {st['uploads']} uploads "
          f"({st['upload_bytes']} bytes), {st['gathers']} gathers "
          f"({st['gather_bytes']} bytes); the solve "
          f"{solves[0]['enqueue_ms']:.1f} ms; first run {wall * 1e3:.1f} ms")
    del s, A, x, xd, xp, xo, bv, rowptr, col, val, invd, solver
    runmat_tpu_torch.uninstall()
    _sync_check(src, "sparse_poisson")
    _walls(src, "sparse_poisson", preview=False)
    prof = profile.profile_script(src, top=8)
    print(f"profile sparse_poisson: wall {prof['wall_ms']:.1f} ms, "
          f"{prof['device_items']} device items, busy {prof['busy_ms']:.3f} "
          f"ms, idle share {prof['idle_share']:.3f}; device top " +
          "; ".join(f"{ms:.3f} ms x{c} {key[:60]}"
                    for key, ms, c in prof["device_top"]))
    phase_sparse_path.kernels = [
        {"name": name, "route": "cuda",
         "source": "runmat_tpu_torch/csrc/spcg.cu",
         "replaces": f"runmat_tpu/sparse.py:{line}",
         "launches": 0, "launch_key": name,
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name, line in SPARSE_KERNELS.items()]
    return launches


def _dl_kernels() -> dict:
    """The LSTM recurrence's cluster kernels swept over the cluster sizes
    and held to their ordered plain versions bit for bit at every size
    that runs, then the cell and the optimizer update against their plain
    versions, bit for bit; all timed (runmat_tpu_torch/dlbench.py)."""
    import torch

    from runmat_tpu_torch import dlbench, histbench
    from runmat_tpu_torch.ops import lstm, lstm_seq, optim
    dev = torch.device("cuda")
    sweep = dlbench.seq_sweep(lstm_seq, histbench.time_ms, TIMING_REPS, dev)
    for c, r in sweep.items():
        print(f"lstm_seq cluster {c}: " + ("; ".join(
            f"{k} {v:.4f} ms" for k, v in r.items())
            if "error" not in r else f"does not run ({r['error']})"))
    runs = [c for c, r in sweep.items() if "error" not in r]
    cluster = lstm_seq.layout(dlbench.H, dlbench.N)[0]
    check(cluster in runs, f"lstm_seq: the layout's cluster {cluster} does "
                           f"not run: {sweep}")
    held_seq = dlbench.held_seq(lstm_seq, dev, runs)
    for name, r in held_seq.items():
        check(r["equal"], f"{name} against plain_seq(ordered=True): {r}")
        print(f"kernel {name}: equal to its ordered plain version bit for "
              f"bit at clusters {runs} over {len(dlbench.SEQ_SHAPES)} "
              f"shapes, both directions, 'last' and 'sequence'")
    held = {**held_seq, **dlbench.held_cell(lstm, dev),
            **dlbench.held_optim(optim, dev)}
    for name, r in held.items():
        check(r["equal"] and r.get("t_ok", True),
              f"{name} against its plain version: {r}")
        if name not in held_seq:
            print(f"kernel {name}: equal to its plain version bit for bit" +
                  (", t advanced once a launch" if "t_ok" in r else ""))
    # no float32 product and sum contracted; Adam issues its loads (p, g,
    # m, v and t at least) before its pows
    for name, c in dlbench.optim_code().items():
        check(c["fma.rn.f32"] == 0 and (
            "adam" not in name or c["ldg_before_dfma"] >= 5),
            f"{name}: machine code {c}")
        print(f"kernel {name}: machine code (sass.py) {c}")
    rows = dlbench.seq_rows(lstm, lstm_seq, histbench.time_ms, TIMING_REPS,
                            dev)
    for name, r in rows.items():
        r["max_abs_err"] = held[name]["max_abs_err"]
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"time {name} (cluster {r['cluster']}): kernel {r['ms']:.4f} "
              f"ms, at T = 1 {r['t1_ms']:.4f} ms, a step "
              f"{r['step_ms'] * 1e3:.3f} us, plain {r['plain_ms']:.3f} ms, "
              f"the earlier design (a product and a cell a step) "
              f"{r['earlier_ms']:.4f} ms, library {lib} "
              f"{r['library_note']}, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}; {r['bytes']} bytes, {r['ops']} "
              f"operations), share of bound {r['bound_ms'] / r['ms']:.4f}")
    cell = dlbench.kernel_rows(lstm, optim, histbench.time_ms, TIMING_REPS,
                               dev)
    for name, r in cell.items():
        r["max_abs_err"] = held[name]["max_abs_err"]
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} {r['library_note']}, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}, {r['bytes']} "
              f"bytes), share of bound {r['bound_ms'] / r['ms']:.4f}")
    return {**rows, **cell}


def phase_dl_path() -> dict:
    """dl_digits.m and dl_vowels.m at their default sizes through
    Session.run_source after the kernels against their plain versions:
    the captured step, the launches, the accuracy, the waits, the first
    three steps against the CPU, two trainings, the step's times, the
    warm walls and a profile; then the dlfeval/dlgradient snippet."""
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel, dlbench, histbench, profile
    from runmat_tpu_torch.runtime.builtins.dl_layers import _TrainStep
    rows = _dl_kernels()
    launches: dict = {}
    for name, path in dlbench.WORKLOADS.items():
        src = open(path).read()
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        _zero_launches()
        t0 = time.perf_counter()
        output = _run_source(s, src)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_launches()
        for group in ("lstm", "lstm_seq", "optim"):
            for k, v in got[group].items():
                launches.setdefault(group, {})
                launches[group][k] = launches[group].get(k, 0) + v
        st = dict(eng.stats)
        steps = dlbench.STEPS[name]
        (step,) = s.get("net")._train_steps.values()
        check(st["graph_captures"] == 1 and
              st["graph_replays"] == steps - _TrainStep.WARMUP ==
              step.replays and step.eager == _TrainStep.WARMUP,
              f"{name}: {st['graph_captures']} captures, "
              f"{st['graph_replays']} replays, {step.eager} eager steps "
              f"for {steps} steps")
        # dl_vowels: its direction one cluster launch a training step and
        # one in predict, its backward one a step, the cell kernel never
        vowels = name == "dl_vowels"
        want = {"lstm": {},
                "lstm_seq": {"lstm_seq_fwd": steps + 1,
                             "lstm_seq_bwd": steps} if vowels else {},
                "optim": {"optim_adam" if vowels else "optim_sgdm": steps}}
        check(all(got[g] == w for g, w in want.items()),
              f"{name}: launches {got['lstm']} {got['lstm_seq']} "
              f"{got['optim']}, want {want}")
        check(float(step.state.t) == steps,
              f"{name}: the optimizer's step count {float(step.state.t)} "
              f"after {steps} steps")
        acc = _result_value(output, DL_RESULT[name])
        check(acc >= DL_ACCURACY[name],
              f"{name}: accuracy {acc} (limit {DL_ACCURACY[name]})")
        check(st["host_fallbacks"] == 0,
              f"{name}: {st['host_fallbacks']} host fallbacks")
        print(f"port {name}: {output.strip()}; {steps} steps, "
              f"{st['graph_captures']} capture, {st['graph_replays']} "
              f"replays; launches {got['lstm_seq']} {got['optim']}; "
              f"{st['uploads']} uploads ({st['upload_bytes']} bytes), "
              f"{st['gathers']} gathers ({st['gather_bytes']} bytes), "
              f"{st['syncs']} syncs; first run {wall * 1e3:.1f} ms")
        del s, step
        runmat_tpu_torch.uninstall()
        _sync_check(src, name)
        fs = dlbench.first_steps(name)
        check(fs["rel_err"] <= fs["tol"],
              f"{name}: first steps on the card against the CPU: {fs}")
        rp = dlbench.repeat(name)
        check(all(c == {"graph_captures": 1,
                        "graph_replays": steps - _TrainStep.WARMUP}
                  for c in rp["counts"]), f"{name}: two trainings {rp}")
        print(f"{name}: the first {fs['steps']} steps on the card within "
              f"{fs['rel_err']:.3g} of the CPU's plain path (of the largest "
              f"learnable {fs['largest']:.4g}; limit {fs['tol']:g}); "
              f"two trainings on the card differ by at most "
              f"{rp['max_diff']:.3g}")
        tm = dlbench.step_times(name, histbench.time_ms, 20)
        print(f"time {name} step: replayed {tm['replay_det_ms']:.4f} ms "
              f"(eager {tm['eager_det_ms']:.4f}) with cuDNN's deterministic "
              f"algorithms, {tm['replay_free_ms']:.4f} ms (eager "
              f"{tm['eager_free_ms']:.4f}) without; {tm['kernels_a_step']} "
              f"device kernels a step")
        _walls(src, name, preview=False)
        prof = profile.profile_script(src, top=8)
        print(f"profile {name}: wall {prof['wall_ms']:.1f} ms, "
              f"{prof['device_items']} device items, busy "
              f"{prof['busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}; device top " +
              "; ".join(f"{ms:.3f} ms x{c} {key[:60]}"
                        for key, ms, c in prof["device_top"]))
    sn = dlbench.dlfeval_snippet()
    check(sn["rel_err"] <= DL_SNIPPET_TOL,
          f"dlfeval snippet on the card against the CPU: {sn}")
    print(f"dlfeval snippet: the card's loss and gradients within "
          f"{sn['rel_err']:.3g} of the CPU's (limit {DL_SNIPPET_TOL:g})")
    # the cell kernels keep their rows: the route sends no script's layer
    # to the per-step path since the cluster kernels took the recurrence
    phase_dl_path.kernels = [
        {"name": name,
         "route": "triton" if name in ("lstm_fwd", "lstm_bwd") else "cuda",
         "source": "runmat_tpu_torch/" + (
             "csrc/lstm_seq.cu" if name.startswith("lstm_seq") else
             "ops/lstm.py" if name.startswith("lstm") else "csrc/optim.cu"),
         "replaces": dlbench.REPLACES[name], "launches": 0,
         "launch_key": name, "on_path": name not in ("lstm_fwd", "lstm_bwd"),
         "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in rows.items()]
    return launches


def main() -> int:
    t0 = time.perf_counter()

    def phase(fn):
        out = fn()
        print(f"phase {fn.__name__}: done at {time.perf_counter() - t0:.1f} s")
        return out

    try:
        phase(phase_device)
        phase(phase_build)
        kernels = phase(phase_kernel) + phase(phase_histogram_kernel) + \
            phase(phase_fused_kernel)
        paths = [phase(phase_main_path), phase(phase_statistics_path),
                 phase(phase_indexing_path),
                 phase(phase_linalg_signal_path), phase(phase_pages_path),
                 phase(phase_sparse_path), phase(phase_dl_path)]
        kernels += phase_linalg_signal_path.kernels + \
            phase_pages_path.kernels + phase_sparse_path.kernels + \
            phase_dl_path.kernels
        for k in kernels:
            key = k.pop("launch_key")
            on_path = k.pop("on_path", True)
            k["launches"] = sum(p.get(_group(k["name"]), {}).get(key, 0)
                                for p in paths)
            # the sequential IIR kernel and the LSTM cell are held and
            # timed, but no script reaches an order above 64 since the
            # warp kernel took 33-64, nor a layer too wide for a cluster
            check(k["launches"] > 0 or not on_path,
                  f"{k['name']}: no launch on the paths")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    import torch
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
