"""Time the histogram kernel at the main path's shapes.

    python3 runmat_tpu_torch/histbench.py [--tree DIR] [--reps 20]

`measure` holds the timed calls, and `chip_smoke.py` reports its results.
Run as a script, this file imports `runmat_tpu_torch` from DIR (default: the
checkout holding this file), so two checkouts can be timed in turns in one
process each on one card: unpack the other one with `git archive` under
`build/` and run parent, change, change, parent. On 2^26 values made on the
card from a seed, it times (CUDA events, mean of `--reps` after a warm-up)
the three calls of `runmat_tpu_torch/workloads/histogram_stats.m` (direct
f32 over 128 affine bins of uniforms, search f32 over 80 bins of normals,
search f64 over 7 bins of their squares), search f32 over normals at 257 to
65536 bins, and `torch.histc` over the direct call's inputs. Every kernel
result is held to the plain version, and `torch.histc`'s counts to the
kernel's. Prints the card's name and power limit, then one JSON line.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N = 1 << 26
MANY_BINS = (257, 1000, 4096, 30000, 65536)


def time_ms(fn, reps: int) -> float:
    """CUDA-event time of one call of `fn`, mean of `reps` after a warm-up."""
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


def main_path_calls(gen) -> dict:
    """histogram_stats.m's three calls at its size, on 2^26 values drawn on
    the card from `gen`: mode -> (x, edges, affine)."""
    import numpy as np
    import torch
    dev = gen.device
    u = torch.rand(N, dtype=torch.float32, device=dev, generator=gen)
    z = torch.randn(N, dtype=torch.float32, device=dev, generator=gen)
    return {
        "direct f32": (u, torch.arange(129, dtype=torch.float32,
                                       device=dev) / 128, (7, 0)),
        "search f32": (z, torch.tensor(np.arange(-40, 41) / 10,
                                       dtype=torch.float32, device=dev),
                       None),
        "search f64": ((z * z).double(),
                       torch.tensor([0, 0.25, 0.5, 1, 2, 4, 8, 16],
                                    dtype=torch.float64, device=dev), None)}


def measure(histogram, calls: dict, reps: int, plain_reps: int = 0) -> dict:
    """Times `histogram.histcounts` on each of `calls` (mode -> (x, edges,
    affine)), its plain version (`plain_reps` > 0) and, in direct mode,
    `torch.histc` over the same range and bins (the library yardstick,
    never called by the port); then search f32 over the normals of
    calls["search f32"] at MANY_BINS bins. Each kernel result is held to
    the plain version (`max_abs_err`, `equal`), torch.histc's counts to the
    kernel's (`library_equal`). Also records whether `torch.histogram`
    takes CUDA tensors."""
    import torch
    out = {"calls": {}, "many_bins": {}}
    for mode, (x, e, affine) in calls.items():
        nb = e.numel() - 1
        want = histogram.plain_histcounts(x, e)
        got = histogram.histcounts(x, e, affine)
        row = {"max_abs_err": float((got - want).abs().max()),
               "equal": bool(torch.equal(got, want)),
               "ms": time_ms(lambda: histogram.histcounts(x, e, affine), reps),
               "library_ms": None}
        if plain_reps:
            if affine is None:
                row["plain_ms"] = time_ms(
                    lambda: histogram.plain_histcounts(x, e), plain_reps)
            else:
                row["plain_ms"] = time_ms(
                    lambda: histogram.plain_histcounts_affine(x, nb, *affine),
                    plain_reps)
        if affine is not None:
            lo, hi = float(e[0]), float(e[-1])
            lib = torch.histc(x, bins=nb, min=lo, max=hi)
            row["library_equal"] = bool(torch.equal(lib.long(), got))
            row["library_ms"] = time_ms(
                lambda: torch.histc(x, bins=nb, min=lo, max=hi), reps)
        out["calls"][mode] = row
    z, ez, _ = calls["search f32"]
    for nb in MANY_BINS:
        e = torch.linspace(-4, 4, nb + 1, dtype=torch.float32, device=z.device)
        out["many_bins"][nb] = time_ms(lambda: histogram.histcounts(z, e),
                                       reps)
    try:
        torch.histogram(z, bins=ez)
        out["torch_histogram_cuda"] = True
    except (RuntimeError, NotImplementedError) as err:
        out["torch_histogram_cuda"] = f"{type(err).__name__}: {err}"[:200]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    # the tree replaces this file's directory, whose module names
    # (profile.py, ...) would shadow the standard library's
    sys.path[0] = os.path.abspath(args.tree)
    import torch

    from runmat_tpu_torch.ops import histogram
    if not torch.cuda.is_available():
        print("histbench: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    out = measure(histogram, main_path_calls(gen), args.reps)
    bad = [m for m, row in out["calls"].items()
           if not (row["equal"] and row.get("library_equal", True))]
    if bad:
        print(f"histbench: {bad} differ from plain or torch.histc",
              file=sys.stderr)
        return 1
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
