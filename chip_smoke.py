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
     rngbench.py: normals f32 at 10^6, 10^7 and 2^26, f64 at 10^7,
     uniforms f32 at 10^7 and 2^26, f64 at 10^7), each beside its bound
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
     4096 segments, with the tolerances fusebench states), then every
     group the three benchmark scripts launch at their default sizes,
     timed against its plain version, its bound and, where one PyTorch
     call computes it, that call;
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
  7. one JSON line of kernel results, then the result line
     {"ok": true, "device": {...}}.
Each kernel's `launches` is read from the runs of phases 4 to 6, with the
counts set to 0 just before each run (a generated map-reduce counts once
for its pair of launches). `bound_ms` is the larger of the bytes
the call must move over 3.35 TB/s and its operations over the card's rate
for them (runmat_tpu_torch/sass.py: for Threefry, the warp cycles of the
kernel's own loop read from its machine code, which holds no call and no
local memory, so it is what runs). Imports nothing of jax and nothing of
runmat_tpu.
"""

from __future__ import annotations

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
# image_normalize.m, monte_carlo.m (256 a run) and histogram_stats.m
MAIN_PATH_DRAWS = (("rand", 16 * 2160 * 3840), ("randn", 1_000_000),
                   ("rand", 1 << 26), ("randn", 1 << 26))
# the kernel JSON line's Threefry rows: the main path's most-launched
# normal draw and its uniform draw of histogram_stats.m
REPORTED_DRAWS = {"rand": 1 << 26, "randn": 10 ** 6}
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
    worst = {"rand": 0.0, "randn": 0.0}
    cases = [(kind, n, dt, ctr) for kind in ("rand", "randn")
             for dt in (torch.float32, torch.float64)
             for n in SIZES for ctr in COUNTERS]
    cases += [(kind, n, torch.float32, COUNTERS[0])
              for kind, n in MAIN_PATH_DRAWS]
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
        worst[kind] = max(worst[kind], err)
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
    for kind, label in (("rand", "uniform"), ("randn", "normal")):
        (r,) = [r for r in rows if r["kind"] == kind
                and r["dtype"] == "float32" and r["n"] == REPORTED_DRAWS[kind]]
        out.append({
            "name": f"threefry2x32_{label}_f32", "route": "cuda",
            "source": "runmat_tpu_torch/csrc/threefry.cu",
            "replaces": "runmat_tpu/ops/pallas/threefry.py:"
                        + ("134" if kind == "rand" else "114"),
            "launches": 0, "launch_key": f"{kind} float32",
            "max_abs_err": worst[kind], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # torch.rand draws Philox, another stream: no library call
            # computes these values
            "library_ms": None})
        if kind == "randn":
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
    cases += [(kind, n, torch.float32, ctr) for kind, n in MAIN_PATH_DRAWS
              for ctr in COUNTERS]
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
    from runmat_tpu_torch.ops import fused, histogram, threefry
    for mod in (histogram, threefry, fused):
        mod.launches = 0
        mod.launches_by.clear()


def _read_launches() -> dict:
    from runmat_tpu_torch.ops import fused, histogram, threefry
    return {"threefry": dict(threefry.launches_by),
            "histogram": dict(histogram.launches_by),
            "fused": dict(fused.launches_by)}


def _group(name: str) -> str:
    """The launch counter a kernel row reads."""
    return "threefry" if name.startswith("threefry") else \
        "histogram" if name.startswith("histcounts") else "fused"


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
    try:
        rows = fusebench.measure(eng, fusebench.record(), TIMING_REPS)
    except AssertionError as e:
        raise SmokeFailure(f"generated kernel on the main path: {e}") from e
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
    for label, r in sorted(fusebench.main_path_rows(rows).items()):
        out.append({
            "name": label, "route": "triton",
            "source": "runmat_tpu_torch/ops/fused.py",
            # no Pallas twin: XLA generated these from the jax.jit call
            "replaces": "runmat_tpu/accel/engine.py:1201",
            "launches": 0, "launch_key": label,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def phase_main_path() -> dict:
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.accel import loops
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
        runs[w] = (s, eng, r, *({k: v - before[group].get(k, 0)
                                 for k, v in after[group].items()}
                                for group in ("threefry", "fused")),
                   [dict(g.kernels) for g in graphs])
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
                 phase(phase_indexing_path)]
        for k in kernels:
            key = k.pop("launch_key")
            k["launches"] = sum(p[_group(k["name"])].get(key, 0)
                                for p in paths)
            check(k["launches"] > 0, f"{k['name']}: no launch on the paths")
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
