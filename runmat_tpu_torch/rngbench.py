"""Time the Threefry kernel at the main path's draw sizes.

    python3 runmat_tpu_torch/rngbench.py [--tree DIR] [--reps 20]

`measure` holds the timed draws, and `chip_smoke.py` reports its results.
Run as a script, this file imports `runmat_tpu_torch` from DIR (default: the
checkout holding this file), so two checkouts can be timed in turns in one
process each on one card: unpack the other one with `git archive` under
`build/` and run parent, change, change, parent. It times the draws of
`DRAWS` with `histbench.time_ms` (CUDA events, mean of `--reps` after a
warm-up, the card spinning first, so that a 10^6 draw is timed by the card
and not by the host): normals in float32 at 10^6 values
(`benchmarks/monte_carlo.m` draws one per step, 256 a run), 10^7 and 2^26
(`runmat_tpu_torch/workloads/histogram_stats.m`), float64 normals at 10^7,
2^22 (`spectral.m`) and 4096^2 (`dense_linalg.m`), and the uniforms as a
guard. Beside every draw it times `torch.rand` or
`torch.randn` of the same size and type as a yardstick: Philox, another
stream, which the port never calls. Each row has its bound, read with this file's `sass.py` from
the machine code of DIR's kernels, and the registers and local-memory
frame of its kernel.
Every draw is first held to the plain version (uniforms bit-exact, normals
within NORMAL_TOL). Prints the card's name and power limit, then one JSON
line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

DRAWS = (("randn", "float32", 10 ** 6), ("randn", "float32", 10 ** 7),
         ("randn", "float32", 1 << 26), ("randn", "float64", 10 ** 7),
         ("randn", "float64", 1 << 22), ("randn", "float64", 4096 * 4096),
         ("rand", "float32", 10 ** 7), ("rand", "float32", 1 << 26),
         ("rand", "float64", 10 ** 7))
# the draws' key and the normals' tolerance against the plain stream, here
# and in chip_smoke.py
KEY = (0x2C4A_9E11, 0x51D3_07BF)
NORMAL_TOL = {"float32": 2e-6, "float64": 1e-13}   # atol = rtol
# the kernel that serves each draw (kind, dtype)
LOOPS = {("rand", "float32"): "uniform_f32",
         ("rand", "float64"): "uniform_f64",
         ("randn", "float32"): "normal_f32",
         ("randn", "float64"): "normal_f64"}


def row_bound(sass, mixes: dict, kind: str, dtype: str, n: int) -> dict:
    """The draw's kernel (the even or odd variant its n takes), its loop
    mix and its bound: n values written once against the loop's warp
    cycles for them."""
    itemsize = 4 if dtype == "float32" else 8
    name, m = sass.find(mixes, LOOPS[(kind, dtype)],
                        even=((n + 1) // 2) % 2 == 0)
    ms, by = sass.bound(n * itemsize, sass.warp_cycles(m, n, itemsize))
    return {"kernel": name, "loop": m, "bound_ms": ms, "bound_by": by}


def measure(threefry, sass, draws=DRAWS, reps: int = 20,
            plain_reps: int = 0) -> list:
    """One row per draw (kind, dtype, n): the kernel's time, its bound and
    share of it, the plain version's time (`plain_reps` > 0), torch.rand's
    or torch.randn's, the kernel's registers and frame, and the largest
    difference from the plain version (0 for uniforms, which must be
    equal)."""
    import torch
    time_ms = _own("histbench").time_ms
    dev = torch.device("cuda")
    mixes = sass.loop_mixes()
    res = sass.resources()
    rows = []
    for kind, dtype, n in draws:
        dt = getattr(torch, dtype)
        got = threefry.rng_draw(kind, KEY, 0, n, dt, dev)
        want = threefry.plain_draw(kind, KEY, 0, n, dt, dev)
        err = float((got - want).abs().max())
        if kind == "rand":
            ok = bool(torch.equal(got, want))
        else:
            tol = NORMAL_TOL[dtype]
            ok = bool(torch.isfinite(got).all()) and bool(
                torch.allclose(got, want, rtol=tol, atol=tol))
        del got, want
        row = {"kind": kind, "dtype": dtype, "n": n, "ok": ok,
               "max_abs_err": err,
               **row_bound(sass, mixes, kind, dtype, n)}
        row["ms"] = time_ms(
            lambda: threefry.rng_draw(kind, KEY, 0, n, dt, dev), reps)
        row["share"] = row["bound_ms"] / row["ms"]
        if plain_reps:
            row["plain_ms"] = time_ms(
                lambda: threefry.plain_draw(kind, KEY, 0, n, dt, dev),
                plain_reps)
        philox = torch.rand if kind == "rand" else torch.randn
        row["philox_ms"] = time_ms(
            lambda: philox(n, dtype=dt, device=dev), reps)
        r = res.get(row["kernel"], {})
        row["registers"] = r.get("REG")
        row["stack_bytes"] = r.get("STACK")
        row["resident_warps"] = sass.resident_warps(r["REG"]) \
            if "REG" in r else None
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _own(name: str):
    """This checkout's module `name` (sass, histbench), whatever tree
    `runmat_tpu_torch` comes from, so two trees' kernels are counted by one
    rule and timed by one timer."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rngbench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sass = _own("sass")
    # the tree replaces this file's directory, whose module names
    # (profile.py, ...) would shadow the standard library's
    sys.path[0] = os.path.abspath(args.tree)
    import torch

    from runmat_tpu_torch.ops import threefry
    if not torch.cuda.is_available():
        print("rngbench: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    rows = measure(threefry, sass, DRAWS, args.reps)
    for r in rows:
        print(f"{r['kind']} {r['dtype']} n={r['n']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['share']:.3f}, {r['loop']['loop_cycles']} warp-cycles per "
              f"{r['loop']['store_bytes']} bytes, {r['registers']} registers"
              + f", torch.{r['kind']} (Philox, another stream) "
              f"{r['philox_ms']:.4f} ms")
    bad = [(r["kind"], r["dtype"], r["n"]) for r in rows if not r["ok"]]
    if bad:
        print(f"rngbench: {bad} differ from plain", file=sys.stderr)
        return 1
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
