#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (runmat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits nonzero before the last
line is printed:
  1. device: a CUDA card, its name and power limit from nvidia-smi;
  2. build: csrc/*.cu with nvcc into build/runmat_tpu_torch/;
  3. kernel against plain: the Threefry kernel against its plain PyTorch
     version on the card and the host numpy stream, at the main path's
     shapes and more, with the time of both for 10^7 values of each kind;
  4. main path: benchmarks/{elementwise_math,monte_carlo,image_normalize}.m
     at their default sizes through runmat_tpu_torch.session("cuda"),
     against the jax-free host engine (Session(accelerate=False)) for
     CHECK and PRICE, and for MSE against a float64 evaluation of the
     script on the frames the host engine drew; with the kernel's launch
     count, the loop fold and the warm wall times;
  5. one JSON line of kernel results, then the result line
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
        s = runmat_tpu_torch.session("cuda")
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            r = s.execute(sources[w])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(r.error is None, f"{w} (timed): {r.error}")
        runmat_tpu_torch.uninstall()
        print(f"wall {w}: first {walls[0] * 1e3:.1f} ms, warm median of 3 "
              f"{statistics.median(walls[1:]) * 1e3:.1f} ms "
              f"({', '.join(f'{x * 1e3:.1f}' for x in walls[1:])})")
    return total_launches


def main() -> int:
    try:
        phase_device()
        phase_build()
        kernel = phase_kernel()
        kernel["launches"] = phase_main_path()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    import torch
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
