#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (runmat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero before the last
line is printed:
  1. device: a CUDA card, its name and power limit from nvidia-smi;
  2. build: csrc/*.cu with nvcc into build/runmat_tpu_torch/ (one nvcc per
     source, all started together);
  3. kernels against plain: the Threefry kernel against its plain PyTorch
     version on the card and the host numpy stream, at the main path's
     shapes and more, with the time of both for 10^7 values of each kind;
     the histogram kernel against its plain versions, exactly, in its three
     modes over sizes up to 2^26 and 1 to 256 bins, and up to 2^20+1
     values at 257 to 65536 bins, which cross its shared-memory layouts
     (and against np.histogram up to 2^20+1 values), with the time of both
     at 2^26 and of the kernel alone at many bins;
  4. main path: benchmarks/{elementwise_math,monte_carlo,image_normalize}.m
     at their default sizes through runmat_tpu_torch.session("cuda"),
     against the jax-free host engine (Session(accelerate=False)) for
     CHECK and PRICE, and for MSE against a float64 evaluation of the
     script on the frames the host engine drew; with the kernel's launch
     count, the loop fold and the warm wall times;
  5. statistics path: runmat_tpu_torch/workloads/histogram_stats.m at its
     default N = 2^26, HIST against the host engine, the three histograms
     against np.histogram of the port's own data, the histogram kernel's
     launches, and the warm wall time;
  6. one JSON line of kernel results, then the result line
     {"ok": true, "device": {...}}.
Imports nothing of jax.
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
MAIN_PATH_DRAWS = (("rand", 16 * 2160 * 3840), ("randn", 1_000_000))
KEY = (0x2C4A_9E11, 0x51D3_07BF)
COUNTERS = (12345, (0xFFFFFFFD, 7))   # the second carries lo into hi
NORMAL_TOL = {"float32": 2e-6, "float64": 1e-13}   # atol = rtol
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


def _time_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel() -> dict:
    import numpy as np
    import torch

    from runmat_tpu.ops import ctrng as host
    from runmat_tpu_torch.ops import threefry

    dev = torch.device("cuda")
    worst = 0.0
    cases = [(kind, n, dt, ctr) for kind in ("rand", "randn")
             for dt in (torch.float32, torch.float64)
             for n in SIZES for ctr in COUNTERS]
    cases += [(kind, n, torch.float32, COUNTERS[0])
              for kind, n in MAIN_PATH_DRAWS]
    for kind, n, dt, ctr in cases:
        got = threefry.rng_draw(kind, KEY, ctr, n, dt, dev)
        want = threefry.plain_draw(kind, KEY, ctr, n, dt, dev)
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
                ref, _ = host.uniform(np, KEY, c, n, np.dtype(name))
                check(np.array_equal(got.cpu().numpy(), ref),
                      f"rand {name} n={n} ctr={ctr}: not bit-exact "
                      f"against the host stream")
        else:
            tol = NORMAL_TOL[name]
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=tol, atol=tol),
                f"randn {name} n={n} ctr={ctr}: max err {err:g} > {tol:g}")
        worst = max(worst, err)
        print(f"kernel {kind} {name} n={n} ctr={ctr}: max_abs_err={err:g}")

    timings = {}
    for kind in ("rand", "randn"):
        for dt in (torch.float32, torch.float64):
            n = 10 ** 7
            k_ms = _time_ms(lambda: threefry.rng_draw(kind, KEY, 0, n, dt, dev))
            p_ms = _time_ms(lambda: threefry.plain_draw(kind, KEY, 0, n, dt,
                                                        dev))
            name = str(dt).split(".")[-1]
            timings[(kind, name)] = (k_ms, p_ms)
            print(f"time {kind} {name} n=1e7: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms")
    k_ms, p_ms = timings[("randn", "float32")]
    return {"name": "threefry2x32", "route": "cuda",
            "source": "runmat_tpu_torch/csrc/threefry.cu",
            "replaces": "runmat_tpu/ops/pallas/threefry.py:51",
            "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}


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


def phase_histogram_kernel() -> dict:
    import torch

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
    worst = 0
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
                worst = max(worst, err)
                cases += 1
        print(f"kernel histcounts n={n}: {cases} cases (B in {bins}, "
              f"{len(modes)} modes) equal plain"
              + (" and np.histogram" if n <= HIST_NUMPY_UP_TO else ""))

    # the main path's three calls, at its size: 2^26 values each
    n = 1 << 26
    u = torch.rand(n, dtype=torch.float32, device=dev, generator=gen)
    z = torch.randn(n, dtype=torch.float32, device=dev, generator=gen)
    ez = torch.tensor(np.arange(-40, 41) / 10, dtype=torch.float32,
                      device=dev)
    timed = {
        "direct f32 (cu, 128 bins)": (
            u, torch.tensor(HIST_EDGES["cu"], dtype=torch.float32,
                            device=dev), (7, 0)),
        "search f32 (cz, 80 bins)": (z, ez, None),
        "search f64 (cq, 7 bins)": (
            (z * z).double(), torch.tensor(HIST_EDGES["cq"],
                                           dtype=torch.float64, device=dev),
            None)}
    times = {}
    for label, (x, e, affine) in timed.items():
        nb = e.numel() - 1
        k_ms = _time_ms(lambda: histogram.histcounts(x, e, affine))
        if affine is None:
            p_ms = _time_ms(lambda: histogram.plain_histcounts(x, e))
        else:
            p_ms = _time_ms(lambda: histogram.plain_histcounts_affine(
                x, nb, *affine))
        check(torch.equal(histogram.histcounts(x, e, affine),
                          histogram.plain_histcounts(x, e)),
              f"histcounts {label} n=2^26: kernel differs from plain")
        gbs = x.numel() * x.element_size() / (k_ms * 1e-3) / 1e9
        times[label] = (k_ms, p_ms)
        print(f"time histcounts {label} n=2^26: kernel {k_ms:.4f} ms "
              f"({gbs:.0f} GB/s of x), plain {p_ms:.4f} ms")
    for nb in HIST_MANY_BINS:
        e = torch.linspace(-4, 4, nb + 1, dtype=torch.float32, device=dev)
        k_ms = _time_ms(lambda: histogram.histcounts(z, e))
        print(f"time histcounts search f32 (normals, {nb} bins) n=2^26: "
              f"kernel {k_ms:.4f} ms")
    return {"name": "histcounts", "route": "cuda",
            "source": "runmat_tpu_torch/csrc/histogram.cu",
            "replaces": "runmat_tpu/ops/pallas/histogram.py:67,216",
            "max_abs_err": worst,
            "ms": sum(k for k, _ in times.values()),
            "plain_ms": sum(p for _, p in times.values()),
            "modes": {k: {"ms": a, "plain_ms": b}
                      for k, (a, b) in times.items()}}


def _host_reference(src: str) -> tuple:
    """The script under the jax-free host engine. run_source skips the
    workspace preview that formats every element of a host array."""
    from runmat_tpu import accel
    from runmat_tpu.session import Session
    check(accel.active_engine() is None, "an engine is active for the host run")
    buf = io.StringIO()
    s = Session(accelerate=False, stdout=buf)
    s.run_source(src)
    return buf.getvalue(), s


def _image_normalize_f64(imgs) -> float:
    """MSE of image_normalize.m evaluated in float64, frame by frame, on the
    frames the host engine drew (the same Threefry stream as the port's).
    The host engine's own single-precision means over dims [2 3] lose
    accuracy at 2160 x 3840 frames, so MSE is held to this evaluation."""
    import numpy as np
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


def phase_main_path() -> int:
    import torch

    import runmat_tpu_torch
    from runmat_tpu import accel
    from runmat_tpu.values import MatArray
    from runmat_tpu_torch.ops import threefry

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
            print(f"host {w}: float64 evaluation MSE={exact!r}; the host "
                  f"engine's single MSE is off by "
                  f"{abs(refs[w][1] - exact) / exact:.3g} (relative)")
            refs[w] = (exact, exact)
        del s

    runs = {}
    threefry.launches = 0
    for w in WORKLOADS:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        before = threefry.launches
        r = s.execute(sources[w])
        torch.cuda.synchronize()
        runs[w] = (s, eng, r, threefry.launches - before)
        runmat_tpu_torch.uninstall()
    total_launches = threefry.launches

    for w, (s, eng, r, launches) in runs.items():
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
            check(st["loop_folds"] == 1 and st["loop_bails"] == 0,
                  f"monte_carlo: loop_folds={st['loop_folds']} "
                  f"loop_bails={st['loop_bails']}")
            check(launches >= 256, f"monte_carlo: {launches} launches")
        if w == "image_normalize":
            check(launches >= 1, f"image_normalize: {launches} launches")
        print(f"port {w}: {r.output.strip()} (reference {ref_value!r}, rel err "
              f"{abs(value - ref_value) / abs(ref_value):.3g}); threefry "
              f"launches {launches}; cuda arrays {arrays}; stats "
              f"{json.dumps({k: v for k, v in st.items() if v})}")
    runs.clear()

    for w in WORKLOADS:
        _walls(sources[w], w)
    return total_launches


def _run_source(s, src: str) -> str:
    """Session.run_source with the session's output captured: unlike
    Session.execute it builds no workspace preview, which formats every
    element of each host array (histogram_stats leaves two of 2^26)."""
    s.stdout = io.StringIO()
    s.run_source(src)
    return s.stdout.getvalue()


def _walls(src: str, label: str, preview: bool = True) -> None:
    """First run, then the median of 3 warm runs, in one fresh session;
    through Session.execute, or Session.run_source without the preview."""
    import torch

    import runmat_tpu_torch
    s = runmat_tpu_torch.session("cuda")
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        if preview:
            r = s.execute(src)
            check(r.error is None, f"{label} (timed): {r.error}")
        else:
            _run_source(s, src)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runmat_tpu_torch.uninstall()
    print(f"wall {label}: first {walls[0] * 1e3:.1f} ms, warm median of 3 "
          f"{statistics.median(walls[1:]) * 1e3:.1f} ms "
          f"({', '.join(f'{x * 1e3:.1f}' for x in walls[1:])})")


def phase_statistics_path() -> int:
    import torch

    import runmat_tpu_torch
    from runmat_tpu import accel
    from runmat_tpu.errors import MatError
    from runmat_tpu_torch.ops import histogram, threefry

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
    threefry.launches = histogram.launches = 0
    t0 = time.perf_counter()
    try:
        output = _run_source(s, src)
    except MatError as e:
        raise SmokeFailure(f"histogram_stats: {e}") from e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, draws = histogram.launches, threefry.launches
    runmat_tpu_torch.uninstall()

    on_card = ("cu", "cz", "cq", "pz", "Fz", "sm", "dF")
    for k in on_card:
        v = s.get(k)
        check(v.on_device, f"histogram_stats: {k} is on the host")
        t = eng.materialize(v.dev)
        check(isinstance(t, torch.Tensor) and t.is_cuda,
              f"histogram_stats: {k} is not a CUDA tensor")
    on_host = [k for k in ("u", "z") if not s.get(k).on_device]
    print(f"port histogram_stats: CUDA tensors {list(on_card)}; on the host "
          f"after the run: {on_host} (histcounts gathers its input before "
          f"it routes, runmat_tpu/runtime/builtins/stats.py:115)")

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

    st = eng.stats
    check(launches == 3, f"histogram_stats: {launches} histogram launches")
    check(draws == 2, f"histogram_stats: {draws} threefry launches")
    check(st["host_fallbacks"] == 0,
          f"histogram_stats: {st['host_fallbacks']} host fallbacks")
    print(f"port histogram_stats: {output.strip()} (reference "
          f"{ref_value!r}, rel err {abs(value - ref_value) / abs(ref_value):.3g});"
          f" histcounts launches {launches}; threefry launches {draws}; stats "
          f"{json.dumps({k: v for k, v in st.items() if v})}; first run "
          f"{wall * 1e3:.1f} ms")
    del s
    _walls(src, "histogram_stats", preview=False)
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
        kernels = [phase(phase_kernel), phase(phase_histogram_kernel)]
        kernels[0]["launches"] = phase(phase_main_path)
        kernels[1]["launches"] = phase(phase_statistics_path)
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
