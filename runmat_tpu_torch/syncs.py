"""The stream syncs of `.m` scripts on the card, found by torch's sync debug
mode and held to what the engine counts.

    python3 runmat_tpu_torch/syncs.py [--tree DIR] [--where] [SCRIPT ...]

With no SCRIPT, the thirteen scripts `chip_smoke.py` runs, at their default
sizes. Each runs once to warm up and once more under
`torch.cuda.set_sync_debug_mode("warn")`, in one session, through
`Session.run_source`. Every call that waits for the card (a blocking copy
in either direction, an `item()`, a `synchronize`) raises one warning. The
engine counts what it reads back for the same run: `stats["syncs"]` (a
scalar that steers the host: unique's count, a `while` condition) plus
`stats["gathers"]` (copies to the host). `warnings == counted` means no
sync is hidden. With --where, each warning's innermost frame in the port is
printed with its count. `--tree DIR` runs another checkout's package with
this file's counter, so two trees are counted by one rule.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import os
import subprocess
import sys
import traceback
import warnings

SCRIPTS = ("benchmarks/elementwise_math.m", "benchmarks/monte_carlo.m",
           "benchmarks/image_normalize.m",
           "runmat_tpu_torch/workloads/histogram_stats.m",
           "runmat_tpu_torch/workloads/index_sets.m",
           "runmat_tpu_torch/workloads/dense_linalg.m",
           "runmat_tpu_torch/workloads/spectral.m",
           "runmat_tpu_torch/workloads/resample_pages.m",
           "runmat_tpu_torch/workloads/sparse_poisson.m",
           "runmat_tpu_torch/workloads/dl_digits.m",
           "runmat_tpu_torch/workloads/dl_vowels.m",
           "runmat_tpu_torch/workloads/sensor_log.m",
           "runmat_tpu_torch/workloads/field_plot.m")
_MESSAGE = "synchronizing CUDA operation"


def _site(stack) -> str:
    """The innermost frame of the port that led to the sync."""
    for fr in reversed(stack):
        path = fr.filename.replace(os.sep, "/")
        if "/runmat_tpu_torch/" in path and not path.endswith("/syncs.py"):
            rel = path[path.rindex("/runmat_tpu_torch/") + 1:]
            return f"{rel}:{fr.lineno} {fr.name}"
    return "outside the port"


def count_syncs(run) -> tuple[int, collections.Counter]:
    """Call `run()` under the sync debug mode. Returns the number of
    synchronizing calls and their sites in the port."""
    import torch
    sites: collections.Counter = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if _MESSAGE in str(message):
            sites[_site(traceback.extract_stack()[:-1])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(sites.values()), sites


def script_syncs(src: str) -> dict:
    """One warm run of `src` in a fresh session on the card: its warnings,
    what the engine counted, and the sites."""
    import torch

    import runmat_tpu_torch
    from runmat_tpu_torch import accel

    s = runmat_tpu_torch.session("cuda")
    eng = accel.active_engine()
    try:
        s.stdout = io.StringIO()
        s.run_source(src)
        torch.cuda.synchronize()
        before = dict(eng.stats)
        n, sites = count_syncs(lambda: s.run_source(src))
        torch.cuda.synchronize()
        moved = {k: eng.stats[k] - before[k] for k in ("syncs", "gathers")}
    finally:
        runmat_tpu_torch.uninstall()
    return {"warnings": n, "counted": moved["syncs"] + moved["gathers"],
            "syncs": moved["syncs"], "gathers": moved["gathers"],
            "sites": dict(sites)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scripts", nargs="*", default=list(SCRIPTS))
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--where", action="store_true")
    args = ap.parse_args()
    # the tree replaces this file's directory, whose module names
    # (profile.py, ...) would shadow the standard library's
    sys.path[0] = os.path.abspath(args.tree)
    import torch
    if not torch.cuda.is_available():
        print("syncs: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    rows = {}
    for path in args.scripts:
        with open(path) as f:
            r = script_syncs(f.read())
        rows[path] = r
        print(f"{path}: {r['warnings']} synchronizing calls, the engine "
              f"counted {r['counted']} ({r['syncs']} syncs, {r['gathers']} "
              f"gathers)")
        if args.where:
            for site, k in sorted(r["sites"].items(), key=lambda t: -t[1]):
                print(f"  {k:5d}  {site}")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      "scripts": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
