"""Check and time the generated Triton kernels (`ops/fused.py`) on the card.

    python3 runmat_tpu_torch/fusebench.py [--tree DIR] [--reps 20]

`table_cases` are programs in the engine's format that hold each template
against its plain version (`accel/fuse.py` `run_group_plain`, the eager
executor): every op of the table in float32 and float64 over NaN, +-Inf,
+-0, subnormals and the `pow` identities, logical operands, broadcast and
strided inputs, `linspace` and casts, a chain at sizes 1 to 10^7, and
`sum`/`mean` over 'all' and trailing blocks (1, 16 and 4096 segments) with
a prologue, an epilogue and written prologue values. `check` runs one
case; tolerances in `TOL`: logical values, NaN patterns, infinities,
`linspace` and casts exactly; other float32 values rtol=atol=1e-6 and
float64 rtol=atol=1e-12 (`tests/test_torch_engine.py`'s); sums and means,
and what a group computes from them, within 1e-5 (a float32 sum) or 1e-12
(float64) of the largest magnitude of their output, the sum being taken in
another order.

`record` runs the three benchmark scripts at their default sizes on the
card and keeps each group the main path launches with its inputs;
`measure` times each (CUDA events, mean of `reps`, the card spinning first:
`histbench.time_ms`) against its plain version, its bound (bytes moved at
3.35 TB/s, or operations at 67 TFLOP/s float32, 34 float64, whichever is
larger) and, where one PyTorch call computes the same function (a `sum` or
`mean` with no prologue: `torch.sum`/`torch.mean`), that call. Run as a
script, it imports `runmat_tpu_torch` from DIR (default: the checkout
holding this file), checks every case, times the main path's groups, and
prints the card's name and power limit, then one JSON line. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

F32, F64, BOOL = (np.dtype(t) for t in ("float32", "float64", "bool"))
TOL = {"float32": 1e-6, "float64": 1e-12}
REDUCE_TOL = {"float32": 1e-5, "float64": 1e-12}
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 67e12, "float64": 34e12}
SIZES = (1, 2, 3, 1023, (1 << 20) + 1, 10 ** 7)
WORKLOADS = ("elementwise_math", "monte_carlo", "image_normalize")
SPECIAL = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1.0, -1.0,
           0.5, -0.5, 2.5, -2.5, 2.0, 3.0, -3.0, 1e30, -1e30, 1e-30, 1e-40,
           88.5, -88.5, 710.0, 0.7)


class _Prog:
    """A program in the engine's format, built entry by entry."""

    def __init__(self):
        self.entries = []
        self.values = []

    def leaf(self, value, shape, dtype) -> int:
        kind = "scalar" if value.dim() == 0 else "__leaf__"
        self.entries.append((kind, (), np.dtype(dtype), (), (), tuple(shape)))
        self.values.append(value)
        return len(self.entries) - 1

    def op(self, op, static, dtype, ins, shape) -> int:
        self.entries.append((op, static, np.dtype(dtype), tuple(ins),
                             tuple(self.entries[j][5] for j in ins),
                             tuple(shape)))
        self.values.append(None)
        return len(self.entries) - 1


def _special(n: int, dtype, device, seed: int, shift: int = 0):
    """n values uniform in [-3, 3) from a seed, the SPECIAL values at the
    front (shifted by `shift`, so two operands meet in every pair when
    n >= len(SPECIAL)^2), each also scaled."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, n)
    sp = np.array(SPECIAL)
    k = len(sp)
    if n >= k * k:
        idx = np.arange(k * k)
        x[:k * k] = sp[idx // k] if shift == 0 else sp[idx % k]
    else:
        m = min(n, k)
        x[:m] = np.roll(sp, shift)[:m]
    return torch.from_numpy(x.astype(dtype)).to(device)


def table_cases() -> list:
    """(name, build) pairs; build(device) -> (_Prog, out_idx, exact) where
    `exact` holds the program indices held exactly."""
    from .ops import fused
    cases = []

    def unary(dt):
        def build(dev):
            p = _Prog()
            n = (1 << 20) + 1
            a = p.leaf(_special(n, dt, dev, 1), (1, n), dt)
            v = p.op("u:uplus", (), dt, [a], (1, n))
            outs, exact = [v], []
            for name in sorted(fused.UNARY):
                odt = BOOL if name in fused.UNTYPED_UNARY else dt
                outs.append(p.op("u:" + name, (), odt, [v], (1, n)))
                if odt == BOOL:
                    exact.append(outs[-1])
            return p, outs, exact
        return build

    def unary_bool(dev):
        import torch
        p = _Prog()
        n = 1023
        x = torch.from_numpy(np.random.default_rng(2).random(n) < 0.5)
        a = p.leaf(x.to(dev), (n, 1), BOOL)
        v = p.op("u:logical_not", (), BOOL, [a], (n, 1))
        outs = [v] + [p.op("u:" + name, (), BOOL, [v], (n, 1))
                      for name in fused.UNTYPED_UNARY]
        outs.append(p.op("cast", ("float64",), F64, [v], (n, 1)))
        return p, outs, outs

    def binary(dt, bshape):
        def build(dev):
            p = _Prog()
            n = len(SPECIAL) ** 2 * 4 + 3
            shape = (1, n) if bshape == "same" else (23, n)
            a = p.leaf(_special(fused.numel(shape), dt, dev, 3).reshape(
                shape[1:] if shape[0] == 1 else shape), shape, dt)
            bs = {"same": (1, n), "row": (1, n), "column": (23, 1),
                  "scalar": (1, 1)}[bshape]
            bv = _special(fused.numel(bs), dt, dev, 4, shift=1)
            b = p.leaf(bv.reshape(()) if bs == (1, 1) else bv.reshape(
                [s for s in bs if s != 1] or [1]), bs, dt)
            v = p.op("u:uplus", (), dt, [a], shape)
            outs, exact = [v], []
            for name in sorted(fused.BINARY):
                odt = BOOL if name in fused._BOOL_BINARY else dt
                outs.append(p.op("b:" + name, (str(dt),), odt, [v, b],
                                 shape))
                if odt == BOOL:
                    exact.append(outs[-1])
            # the operands the other way round
            outs.append(p.op("b:pow", (str(dt),), dt, [b, v], shape))
            outs.append(p.op("b:mod", (str(dt),), dt, [b, v], shape))
            return p, outs, exact
        return build

    def strided(dt):
        def build(dev):
            # the F-order view `rand` returns for a B x H x W draw
            p = _Prog()
            B, H, W = 3, 33, 65
            x = _special(B * H * W, dt, dev, 5).reshape(W, H, B).permute(
                2, 1, 0)
            a = p.leaf(x, (B, H, W), dt)
            mu = p.op("r:mean", ((1, 2), "", str(dt)), dt, [a], (B, 1))
            d = p.op("b:sub", (str(dt),), dt, [a, mu], (B, H, W))
            q = p.op("b:mul", (str(dt),), dt, [d, d], (B, H, W))
            return p, [mu, d, q], []
        return build

    def linspace(dt):
        def build(dev):
            import torch
            p = _Prog()
            n = 10 ** 7
            s0 = p.leaf(torch.full((), 0.0, dtype=_tdt(dt), device=dev),
                        (1, 1), dt)
            s1 = p.leaf(torch.full((), 4 * np.pi, dtype=_tdt(dt),
                                   device=dev), (1, 1), dt)
            x = p.op("c:linspace", (n,), dt, [s0, s1], (1, n))
            c = p.op("cast", ("float32",), F32, [x], (1, n))
            b = p.op("cast", ("bool",), BOOL, [c], (1, n))
            d = p.op("cast", ("float64",), F64, [b], (1, n))
            f = p.op("c:full", ((1, n),), dt, [s1], (1, n))
            return p, [x, c, b, d, f], [x, c, b, d, f]
        return build

    def chain(dt, n):
        def build(dev):
            import torch
            p = _Prog()
            a = p.leaf(_special(n, dt, dev, 6), (n, 1), dt)
            ten = p.leaf(torch.full((), 10.0, dtype=_tdt(dt), device=dev),
                         (1, 1), dt)
            q = p.leaf(torch.full((), 0.25, dtype=_tdt(dt), device=dev),
                       (1, 1), dt)
            e = p.op("u:exp", (), dt, [p.op("b:div", (str(dt),), dt,
                                           [p.op("u:neg", (), dt, [a],
                                                 (n, 1)), ten], (n, 1))],
                     (n, 1))
            y0 = p.op("b:mul", (str(dt),), dt, [p.op("u:sin", (), dt, [a],
                                                    (n, 1)), e], (n, 1))
            y1 = p.op("b:add", (str(dt),), dt, [y0, p.op(
                "b:mul", (str(dt),), dt, [q, p.op("b:mul", (str(dt),), dt,
                                                  [y0, y0], (n, 1))],
                (n, 1))], (n, 1))
            fin = p.op("b:max2", (str(dt),), dt, [y1, q], (n, 1))
            s = p.op("r:sum", ((0, 1), "", str(dt)), dt, [fin], (1, 1))
            return p, [s, y1], []
        return build

    def reduce(dt, name, shape, axes, prologue, epilogue):
        def build(dev):
            import torch
            p = _Prog()
            a = p.leaf(_special(fused.numel(shape), dt, dev, 7).reshape(
                [s for s in shape if s != 1]), shape, dt)
            eps = p.leaf(torch.full((), 1e-6, dtype=_tdt(dt), device=dev),
                         (1, 1), dt)
            rshape = tuple(1 if d in axes else s for d, s in enumerate(shape))
            src, outs = a, []
            if prologue:
                src = p.op("b:mul", (str(dt),), dt, [a, a], shape)
                outs.append(src)
            r = p.op(f"r:{name}", (axes, "", str(dt)), dt, [src], rshape)
            outs.append(r)
            if epilogue:
                outs.append(p.op("u:sqrt", (), dt, [p.op(
                    "b:add", (str(dt),), dt, [r, eps], rshape)], rshape))
            return p, outs, []
        return build

    def reduce_bool(dev):
        import torch
        p = _Prog()
        n = 4096 * 257
        a = p.leaf(_special(n, F32, dev, 8).reshape(4096, 257), (4096, 257),
                   F32)
        zero = p.leaf(torch.zeros((), device=dev), (1, 1), F32)
        g = p.op("b:gt", ("float32",), BOOL, [a, zero], (4096, 257))
        r = p.op("r:sum", ((1,), "", "float64"), F64, [g], (4096, 1))
        return p, [g, r], [g, r]

    for dt in (F32, F64):
        cases.append((f"unary {dt}", unary(dt)))
        for bs in ("same", "row", "column", "scalar"):
            cases.append((f"binary {dt} {bs}", binary(dt, bs)))
        cases.append((f"strided {dt}", strided(dt)))
        cases.append((f"linspace {dt}", linspace(dt)))
    cases.append(("unary logical", unary_bool))
    for n in SIZES:
        cases.append((f"chain float32 n={n}", chain(F32, n)))
    cases.append(("chain float64 n=1023", chain(F64, 1023)))
    for dt in (F32, F64):
        for name in ("sum", "mean"):
            cases.append((f"{name} {dt} all", reduce(
                dt, name, (1, (1 << 20) + 1), (0, 1), False, False)))
            cases.append((f"{name} {dt} 16 segments", reduce(
                dt, name, (16, 135, 240), (1, 2), True, True)))
            cases.append((f"{name} {dt} 4096 segments", reduce(
                dt, name, (4096, 1000), (1,), True, False)))
    cases.append(("sum of a logical array, 4096 segments", reduce_bool))
    return cases


def _tdt(dt):
    import torch
    return {F32: torch.float32, F64: torch.float64, BOOL: torch.bool}[
        np.dtype(dt)]


def run_plain(eng, program: list, values: list, out_idx: list, plan) -> list:
    """The program with every group through its plain version."""
    from .accel import fuse
    env = list(values)
    for kind, unit in plan.steps:
        if kind == "group":
            outs = fuse.run_group_plain(eng, unit, program,
                                        [env[j] for j in unit.inputs])
            for j, t in zip(unit.outputs, outs):
                env[j] = t
        else:
            op, static, dt, ins, in_shapes, out_shape = program[unit]
            env[unit] = eng._exec(op, static, dt, [env[j] for j in ins],
                                  in_shapes, out_shape)
    return [env[j] for j in out_idx]


def reduced(program: list, g) -> dict:
    """The outputs of group g computed from its sum or mean (the reduction
    and its epilogue), with the reduction's dtype: they carry its error."""
    if g.reduce is None:
        return {}
    return {i: str(program[g.reduce][2]) for i in g.outputs if i >= g.reduce}


def compare(got, want, exact: bool, reduce_dt=None) -> float:
    """max |got - want| over values both finite; raises AssertionError
    where the results differ beyond the tolerance (see the module doc);
    `reduce_dt`: the value comes from a sum or mean in that dtype."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (tuple(got.shape), tuple(want.shape), got.dtype, want.dtype)
    if got.dtype == torch.bool or exact:
        same = (got == want) | (torch.isnan(got) & torch.isnan(want)) \
            if got.is_floating_point() else got == want
        assert bool(same.all()), f"{int((~same).sum())} values differ"
        if not got.is_floating_point():
            return 0.0
    g, w = got.double(), want.double()
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan), "NaN patterns differ"
    inf = torch.isinf(w)
    assert torch.equal(g[inf], w[inf]), "infinities differ"
    fin = ~(nan | inf)
    if not bool(fin.any()):
        return 0.0
    err = (g[fin] - w[fin]).abs()
    name = str(got.dtype).split(".")[-1]
    if reduce_dt is not None:
        bound = REDUCE_TOL[reduce_dt] * float(w[fin].abs().max()) + 1e-30
    else:
        bound = TOL[name] + TOL[name] * w[fin].abs()
    bad = err > bound
    assert not bool(bad.any()), (f"{int(bad.sum())} values beyond the "
                                 f"tolerance, max err {float(err.max()):g}")
    return float(err.max())


def check(eng, name: str, build) -> dict:
    """One case on `eng`'s device: the kernel path against the plain
    version. Returns {name, groups, max_abs_err}; raises AssertionError
    when they differ."""
    import torch

    from .accel import fuse
    p, outs, exact = build(eng.device)
    plan = fuse.plan(p.entries, outs)
    assert plan.groups and not plan.eager, (name, plan.eager)
    got = eng.run_program(p.entries, p.values, outs, plan)
    want = run_plain(eng, p.entries, p.values, outs, plan)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    red = {}
    for g in plan.groups:
        red.update(reduced(p.entries, g))
    err = 0.0
    bad = []
    for j, g, w in zip(outs, got, want):
        try:
            err = max(err, compare(g, w, j in exact, red.get(j)))
        except AssertionError as e:
            bad.append(f"entry {j} {p.entries[j][0]}: {e}")
    if bad:
        raise AssertionError(f"{name}: {'; '.join(bad)}")
    return {"name": name, "groups": len(plan.groups), "max_abs_err": err}


def record(device="cuda") -> list:
    """The groups the three benchmark scripts launch at their default
    sizes: (script, Group, program, args) each, args kept alive."""
    import runmat_tpu_torch
    from .accel import fuse
    seen = []
    real = fuse.run_group

    def keep(eng, g, program, args):
        if all(g is not h for _, h, _, _ in seen):
            seen.append((script, g, program, list(args)))
        return real(eng, g, program, args)

    fuse.run_group = keep
    try:
        for script in WORKLOADS:
            s = runmat_tpu_torch.session(device)
            r = s.execute(open(os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "benchmarks", f"{script}.m")).read())
            runmat_tpu_torch.uninstall()
            if r.error is not None:
                raise RuntimeError(f"{script}: {r.error}")
    finally:
        fuse.run_group = real
    return seen


def work(g, program, args) -> dict:
    """Bytes the group must move (each input read once, each output
    written once) and the operations it does."""
    spec = g.spec
    nbytes = sum(int(a.numel()) * a.element_size() for a in args)
    for i in g.outputs:
        nbytes += int(np.prod(program[i][5])) * np.dtype(
            program[i][2]).itemsize
    n = int(np.prod(spec.shape))
    ops = 0
    for m, (op, _, _, _) in enumerate(spec.body):
        if spec.reduce is not None and m > spec.reduce:
            ops += int(np.prod(spec.rshape))
        else:
            ops += n
    kind = "float64" if spec.label.endswith("f64") else "float32"
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S[kind] * 1e3
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library(g, args):
    """One PyTorch call computing the same function, where there is one: a
    `sum` or `mean` of an input with no prologue, followed at most by casts
    to its own class (mean(imgs, [2 3]) under single())."""
    import torch
    spec = g.spec
    if spec.reduce != 0 or spec.body[0][3] != (("x", 0),) or any(
            b[0] != "cast" or b[1][0] != spec.body[0][2]
            for b in spec.body[1:]):
        return None
    op, static, _, _ = spec.body[0]
    x = args[0].reshape(spec.inputs[0][0])
    fn = torch.sum if op == "r:sum" else torch.mean
    return lambda: fn(x, dim=tuple(static[0]), keepdim=True)


def measure(eng, seen: list, reps: int) -> list:
    """Each recorded group: kernel, plain and library times, its bound and
    the kernel's error against the plain version."""
    from . import histbench
    from .accel import fuse
    rows = []
    for script, g, program, args in seen:
        got = fuse.run_group(eng, g, program, args)
        want = fuse.run_group_plain(eng, g, program, args)
        err = 0.0
        red = reduced(program, g)
        for i, a, b in zip(g.outputs, got, want):
            try:
                err = max(err, compare(a, b, False, red.get(i)))
            except AssertionError as e:
                raise AssertionError(f"{script} {g.label} entry {i} "
                                     f"{program[i][0]}: {e}") from e
        lib = library(g, args)
        row = {"script": script, "label": g.label,
               "shape": list(g.shape), "ops": [program[i][0]
                                               for i in g.members],
               "outputs": len(g.outputs), "max_abs_err": err,
               "ms": histbench.time_ms(
                   lambda: fuse.run_group(eng, g, program, args), reps),
               "plain_ms": histbench.time_ms(
                   lambda: fuse.run_group_plain(eng, g, program, args),
                   reps),
               "library_ms": None if lib is None else histbench.time_ms(
                   lib, reps),
               **work(g, program, args)}
        row["share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
    return rows


def main_path_rows(rows: list) -> dict:
    """The row reported for each kernel label: the group with a library
    call if one has one, else the one that moves the most bytes."""
    best = {}
    for r in rows:
        key = (r["library_ms"] is not None, r["bytes"])
        if r["label"] not in best or key > best[r["label"]][0]:
            best[r["label"]] = (key, r)
    return {label: r for label, (_, r) in best.items()}


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

    from runmat_tpu_torch import fusebench
    from runmat_tpu_torch.accel.engine import TorchEngine
    if not torch.cuda.is_available():
        print("fusebench: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    eng = TorchEngine("cuda")
    checked = [fusebench.check(eng, name, build)
               for name, build in fusebench.table_cases()]
    rows = fusebench.measure(eng, fusebench.record(), args.reps)
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        print(f"{r['script']} {r['label']} {r['shape']}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), share "
              f"{r['share']:.2f}, ops {r['ops']}")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      "checked": checked, "groups": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
