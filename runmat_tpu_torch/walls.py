"""Warm wall times of `.m` scripts on the card, for two checkouts in turns.

    python3 runmat_tpu_torch/walls.py [--tree DIR] [--runs 4] [SCRIPT ...]

With no SCRIPT, the eight scripts `chip_smoke.py` runs, at their default
sizes. Each runs `--runs` times in one fresh session of DIR's
`runmat_tpu_torch` (default: the checkout holding this file) through
`Session.run_source`, each run timed on the host clock and ended by
`torch.cuda.synchronize()`: the first run, then the median of the others.
For an A/B, unpack the other checkout with `git archive` under `build/` and
run parent, change, change, parent in one call. Every call of
`ops.fused.launch` (a generated kernel's launch) is timed on the host clock
as well. Prints the card's name and power limit, one line a script, then
one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time

SCRIPTS = ("benchmarks/elementwise_math.m", "benchmarks/monte_carlo.m",
           "benchmarks/image_normalize.m",
           "runmat_tpu_torch/workloads/histogram_stats.m",
           "runmat_tpu_torch/workloads/index_sets.m",
           "runmat_tpu_torch/workloads/dense_linalg.m",
           "runmat_tpu_torch/workloads/spectral.m",
           "runmat_tpu_torch/workloads/resample_pages.m")


def script_walls(src: str, runs: int) -> dict:
    """Host-clock seconds of each run of `src` in one session, the host
    time each run spends inside `ops.fused.launch` (the host's share of
    the generated kernels) and its calls, and the engine's counters after
    the last."""
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.ops import fused

    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    walls, spent, calls = [], [], []
    launch = fused.launch

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return launch(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    fused.launch = timed
    try:
        for _ in range(runs):
            s.stdout = io.StringIO()
            n = len(spent)
            t0 = time.perf_counter()
            s.run_source(src)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            calls.append(spent[n:])
    finally:
        fused.launch = launch
        runmat_tpu_torch.uninstall()
    return {"walls_ms": [w * 1e3 for w in walls],
            "warm_median_ms": statistics.median(walls[1:]) * 1e3,
            "launches": [len(c) for c in calls],
            "launch_host_us": [sum(c) * 1e6 for c in calls],
            "warm_launch_host_us": statistics.median(
                sum(c) for c in calls[1:]) * 1e6,
            "stats": {k: v for k, v in eng.stats.items() if v}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scripts", nargs="*", default=list(SCRIPTS))
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    # the tree replaces this file's directory, whose module names
    # (profile.py, ...) would shadow the standard library's
    sys.path[0] = os.path.abspath(args.tree)
    import torch
    if not torch.cuda.is_available():
        print("walls: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    rows = {}
    for path in args.scripts:
        with open(path) as f:
            r = script_walls(f.read(), args.runs)
        rows[path] = r
        print(f"{path}: first {r['walls_ms'][0]:.2f} ms, warm median "
              f"{r['warm_median_ms']:.2f} ms "
              f"({', '.join(f'{w:.2f}' for w in r['walls_ms'][1:])}); "
              f"{r['launches'][-1]} generated launches a run, warm median "
              f"{r['warm_launch_host_us']:.1f} us of host time in them")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      "scripts": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
