"""Check and time the generated Triton kernels (`ops/fused.py`) on the card.

    python3 runmat_tpu_torch/fusebench.py [--tree DIR] [--reps 20]

`table_cases` are programs in the engine's format that hold each template
against its plain version (`accel/fuse.py` `run_group_plain`, the eager
executor): every op of the table in float32 and float64 over NaN, +-Inf,
+-0, subnormals and the `pow` identities, logical operands, broadcast and
strided inputs, `linspace` and casts, a chain at sizes 1 to 10^7,
`sum`/`mean` over 'all' and trailing blocks (1, 16 and 4096 segments) with
a prologue, an epilogue and written prologue values, and `pow` with a
scalar exponent of exactly 2 (the kernels' square arm) and of
nextafter(2, 3) (the general arm) in a map, a reduction's prologue and its
epilogue, over the special values and the edges of the square's range.
`square_sweep` runs every float32 bit pattern through the square arm and
holds it to the correctly rounded square bit for bit; `square_arm` reads a
compiled module's Triton IR for the branch and counts its machine code.
`check` runs one case; tolerances in `TOL`: logical values, NaN patterns, infinities,
`linspace` and casts exactly; other float32 values rtol=atol=1e-6 and
float64 rtol=atol=1e-12 (`tests/test_torch_engine.py`'s); sums and means,
and what a group computes from them, within 1e-5 (a float32 sum) or 1e-12
(float64) of the largest magnitude of their output, the sum being taken in
another order.

`record` runs the three benchmark scripts and the port's slice scripts
(`runmat_tpu_torch/workloads/dense_linalg.m`, `spectral.m` and
`resample_pages.m`) at their default sizes on the card and keeps each
group the main path launches with its inputs;
`measure` times each (CUDA events, mean of `reps`, the card spinning first:
`histbench.time_ms`) against its plain version, its bound (bytes moved at
3.35 TB/s, or operations at 67 TFLOP/s float32, 34 float64, whichever is
larger) and, where one PyTorch call computes the same function (`library`:
a `sum` or `mean` with no prologue, a lone `linspace`, a `full` times a
scalar, a lone add, subtract, multiply or divide, a lone `abs`, a `.^`
by a scalar), that call; `spread`
times each group that has such a call against it in turns, ten rounds,
for the run-to-run spread of both; `layout_sweep` (`--layouts`) tries the
large maps' layouts against `torch.sub` on dense_linalg's 4096^2 float64
subtraction and holds the kept one against the old on every large map,
in turns. Run as a
script, it imports `runmat_tpu_torch` from DIR (default: the checkout
holding this file), checks every case, times the main path's groups, and
prints the card's name and power limit, the machine-code reading of each
group with a `pow`, then one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import re
import statistics
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
# run through Session.run_source, as chip_smoke.py's phase 7 runs them
SLICE_SCRIPTS = ("dense_linalg", "spectral", "resample_pages")
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


def _square_edges(dt) -> np.ndarray:
    """Bases at the edges of x^2's range in `dt`, with both signs: the
    largest value and the square root of it and its neighbour above (the
    square overflows there), the smallest normal and subnormal values and
    the square root of the smallest normal (subnormal or zero squares), and
    the neighbours of 1."""
    t = np.dtype(dt).type
    f = np.finfo(t)
    r = np.sqrt(f.max).astype(t)
    e = np.array([f.max, r, np.nextafter(r, t(np.inf)), f.tiny,
                  f.smallest_subnormal, np.sqrt(f.tiny).astype(t),
                  np.nextafter(t(1), t(2)), np.nextafter(t(1), t(0))],
                 dtype=t)
    return np.concatenate([e, -e])


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

    def pow_scalar(dt, exponent):
        def build(dev):
            import torch
            p = _Prog()
            n = (1 << 20) + 1
            x = _special(n, dt, dev, 9)
            edges = _square_edges(dt)
            x[-len(edges):] = torch.from_numpy(edges).to(dev)
            a = p.leaf(x, (1, n), dt)
            e = p.leaf(torch.full((), exponent, dtype=_tdt(dt), device=dev),
                       (1, 1), dt)
            b = p.leaf(_special(16 * 4097, dt, dev, 10).reshape(16, 4097),
                       (16, 4097), dt)
            m = p.op("b:pow", (str(dt),), dt, [a, e], (1, n))
            q = p.op("b:pow", (str(dt),), dt, [b, e], (16, 4097))
            r = p.op("r:mean", ((1,), "", str(dt)), dt, [q], (16, 1))
            t = p.op("b:pow", (str(dt),), dt, [r, e], (16, 1))
            return p, [m, q, r, t], []
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
    for dt in (F32, F64):
        cases.append((f"pow scalar 2 {dt}", pow_scalar(dt, 2.0)))
        cases.append((f"pow scalar nextafter(2, 3) {dt}", pow_scalar(
            dt, float(np.nextafter(dt.type(2), dt.type(3))))))
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


def square_sweep(eng) -> dict:
    """Every float32 bit pattern through the generated kernel of `x .^ e`,
    e a 0-d tensor holding 2 (its square arm), 2^28 values a launch,
    against float32(float64(x)^2): exact, since x^2 has at most 48
    significant bits and fits a double, so the cast rounds once. Counts
    the values where the kernel differs from it bit for bit (a NaN counts
    as equal to a NaN), and those where the plain version (torch.pow with
    a 0-d tensor exponent, the eager executor's) does, by their distance
    in ulp."""
    import torch

    from .accel import fuse
    dev = eng.device
    chunk = 1 << 28             # divides 2^32: each pattern runs once
    p = _Prog()
    a = p.leaf(torch.empty(chunk, device=dev), (1, chunk), F32)
    e = p.leaf(torch.full((), 2.0, device=dev), (1, 1), F32)
    m = p.op("b:pow", ("float32",), F32, [a, e], (1, chunk))
    plan = fuse.plan(p.entries, [m])
    kernel = plain = plain_nan = 0
    ulps: dict = {}
    for lo in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int64,
                         device=dev).to(torch.int32).view(torch.float32)
        values = [x, p.values[e], None]
        want = (x.double() * x.double()).float()
        nan = torch.isnan(want)
        wi = want.view(torch.int32).long()
        (got,) = eng.run_program(p.entries, values, [m], plan)
        kernel += int(((got.view(torch.int32).long() != wi) & ~nan).sum()) \
            + int((torch.isnan(got) != nan).sum())
        del got
        (ref,) = run_plain(eng, p.entries, values, [m], plan)
        plain_nan += int((torch.isnan(ref) != nan).sum())
        d = (ref.view(torch.int32).long() - wi).abs()[~nan]
        d = d[d != 0]
        plain += int(d.numel())
        for u, c in zip(*torch.unique(d, return_counts=True)):
            ulps[int(u)] = ulps.get(int(u), 0) + int(c)
    return {"values": 1 << 32, "kernel_differ": kernel,
            "plain_differ": plain, "plain_nan_differ": plain_nan,
            "plain_ulps": dict(sorted(ulps.items()))}


def _compiled(fn) -> list:
    """What Triton compiled for a `@triton.jit` function, from its own JIT
    cache: `device_caches` maps a device to (kernels by key, ...)."""
    return [k for c in fn.device_caches.values() for k in c[0].values()]


def square_arm(module: str) -> dict:
    """The kernels of a generated module (`launches_by`'s second key),
    launched already, by kernel, one entry a compiled variant: `ifs`, the
    `scf.if`s in its Triton IR;
    `ir_ok`, whether in each the arm for 2 multiplies a value by itself and
    calls no libdevice `pow` while the other arm calls it
    (`ir_arms_ok`); and from its machine code (`cuobjdump -sass`), its
    instruction, MUFU and CALL counts."""
    from . import sass
    from .ops import fused
    mod = sys.modules[module]
    out = {}
    for kernel in ("map_kernel", "part_kernel", "fin_kernel", "one_kernel"):
        fn = getattr(mod, kernel, None)
        for k in [] if fn is None else _compiled(fn):
            arms = _if_arms(k.asm["ttir"])
            path = fused.GEN_DIR / f"{kernel}_{id(k)}.cubin"
            path.write_bytes(k.asm["cubin"])
            text = subprocess.run([sass.cuobjdump(), "-sass", str(path)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            path.unlink()
            insns = [i for v in sass.kernels(text).values() for i in v]
            out.setdefault(kernel, []).append({
                "ifs": len(arms), "ir_ok": ir_arms_ok(arms),
                "instructions": len(insns),
                "mufu": sum(i[1] == "MUFU" for i in insns),
                "calls": sum(i[1] == "CALL" for i in insns)})
    return out


def ir_arms_ok(arms: list) -> bool:
    """Whether there are `_if_arms` and in each the arm taken where the
    exponent is 2 multiplies a value by itself and calls no libdevice
    `pow` (`__nv_powf`, `__nv_pow`), while the other arm calls it."""
    return bool(arms) and all(
        re.search(r"arith\.mulf (%[\w#]+), \1\b", then) is not None
        and "__nv_pow" not in then and "__nv_pow" in other
        for then, other in arms)


def _if_arms(ir: str) -> list:
    """(then, else) region texts of each `scf.if` with an else region in
    Triton IR text."""
    lines = ir.splitlines()
    arms = []
    for i, line in enumerate(lines):
        if "scf.if" not in line or not line.rstrip().endswith("{"):
            continue
        depth, then, other = 1, [], []
        cur = then
        for nxt in lines[i + 1:]:
            s = nxt.strip()
            if s.startswith("} else {") and depth == 1:
                cur = other
                continue
            depth += nxt.count("{") - nxt.count("}")
            if depth <= 0:
                break
            cur.append(nxt)
        if other:
            arms.append(("\n".join(then), "\n".join(other)))
    return arms


def record(device="cuda") -> list:
    """The groups the scripts launch at their default sizes: (script,
    Group, program, args) each, args kept alive."""
    import runmat_tpu_torch
    from .accel import fuse
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = []
    real = fuse.run_group

    def keep(eng, g, program, args):
        if all(g is not h for _, h, _, _ in seen):
            seen.append((script, g, program, list(args)))
        return real(eng, g, program, args)

    fuse.run_group = keep
    try:
        for script in WORKLOADS + SLICE_SCRIPTS:
            s = runmat_tpu_torch.session(device)
            try:
                if script in WORKLOADS:
                    r = s.execute(open(os.path.join(
                        root, "benchmarks", f"{script}.m")).read())
                    if r.error is not None:
                        raise RuntimeError(f"{script}: {r.error}")
                else:
                    s.stdout = io.StringIO()
                    s.run_source(open(os.path.join(
                        root, "runmat_tpu_torch", "workloads",
                        f"{script}.m")).read())
            finally:
                runmat_tpu_torch.uninstall()
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


LIBRARY_BINARY = ("add", "sub", "mul", "div")


def library(g, args):
    """One PyTorch call computing the same function, where there is one: a
    `sum` or `mean` of an input with no prologue, followed at most by casts
    to its own class (mean(imgs, [2 3]) under single()), `torch.sum`/
    `torch.mean`; a lone `linspace`, `torch.linspace`; a `full` times a
    scalar, `torch.full` (its value read back once, before the timing); a
    lone add, subtract, multiply or divide of two inputs of one rank in
    their own type, `torch.add`/`sub`/`mul`/`div` (MATLAB lines up the
    dims of two ranks from the first, torch from the last); a lone `abs`,
    `torch.abs`; a lone `.^` of an input by a one-element input in one
    type, `torch.pow`."""
    import torch
    spec = g.spec
    ins = [a.reshape(ls) for a, (ls, _) in zip(args, spec.inputs)]
    ops = [b[0] for b in spec.body]
    if ops == ["c:linspace"] and spec.body[0][3] == (("x", 0), ("x", 1)):
        n, dt = spec.body[0][1][0], ins[0].dtype
        lo, hi = float(ins[0].reshape(())), float(ins[1].reshape(()))
        return lambda: torch.linspace(lo, hi, n, dtype=dt,
                                      device=ins[0].device)
    if ops == ["c:full", "b:mul"] and spec.body[1][3] in (
            (("v", 0), ("x", 1)), (("x", 1), ("v", 0))) and \
            spec.body[0][3] == (("x", 0),) and \
            len({b[2] for b in spec.body} | {b[1][0] for b in spec.body[1:]}
                | {d for _, d in spec.inputs}) == 1:
        value = float((ins[0] * ins[1]).reshape(()))
        shape, dt = spec.body[0][1][0], ins[0].dtype
        return lambda: torch.full(shape, value, dtype=dt,
                                  device=ins[0].device)
    if len(ops) == 1 and ops[0][2:] in LIBRARY_BINARY and \
            ops[0].startswith("b:") and \
            spec.body[0][3] == (("x", 0), ("x", 1)) and \
            ins[0].ndim == ins[1].ndim and \
            spec.body[0][2] == spec.body[0][1][0] == spec.inputs[0][1] == \
            spec.inputs[1][1]:
        fn = getattr(torch, ops[0][2:])
        return lambda: fn(ins[0], ins[1])
    if ops == ["u:abs"] and spec.body[0][3] == (("x", 0),) and \
            spec.body[0][2] == spec.inputs[0][1]:
        return lambda: torch.abs(ins[0])
    if ops == ["b:pow"] and spec.body[0][3] == (("x", 0), ("x", 1)) and \
            ins[1].numel() == 1 and spec.body[0][2] == spec.body[0][1][0] \
            == spec.inputs[0][1] == spec.inputs[1][1]:
        return lambda: torch.pow(ins[0], ins[1])
    if spec.reduce != 0 or spec.body[0][3] != (("x", 0),) or any(
            b[0] != "cast" or b[1][0] != spec.body[0][2]
            for b in spec.body[1:]):
        return None
    op, static, _, _ = spec.body[0]
    fn = torch.sum if op == "r:sum" else torch.mean
    return lambda: fn(ins[0], dim=tuple(static[0]), keepdim=True)


def measure(eng, seen: list, reps: int) -> list:
    """Each recorded group: kernel, plain and library times, its bound and
    the kernel's error against the plain version."""
    from . import histbench
    from .accel import fuse
    from .ops import fused
    rows = []
    for script, g, program, args in seen:
        before = collections.Counter(fused.launches_by)
        got = fuse.run_group(eng, g, program, args)
        (key,) = fused.launches_by - before
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
        ops = [program[i][0] for i in g.members]
        row = {"name": f"{g.label} ({script}, {'x'.join(map(str, g.shape))}"
                       f": {' '.join(ops)})",
               "key": key, "script": script, "label": g.label,
               "shape": list(g.shape), "ops": ops,
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


@contextlib.contextmanager
def map_variant(block=None, warps=None, unmasked=False, evict=False):
    """Inside: every map of more than fused.WIDE_MAP elements generated
    with BLOCK `block` and `warps` warps (None: fused.layout's), without
    its masks where BLOCK divides its size (`unmasked`), and its strided
    loads marked eviction_policy="evict_first" (`evict`); the cache of
    prepared kernels emptied on the way in and out."""
    from .ops import fused
    real_layout, real_map = fused.layout, fused._Gen.map_kernel

    def layout(spec, sms=fused.SMS_DEFAULT):
        lay = real_layout(spec, sms)
        if spec.reduce is None and lay["N"] > fused.WIDE_MAP:
            b = block or lay["BLOCK"]
            lay = dict(lay, BLOCK=b, grid=(-(-lay["N"] // b),),
                       num_warps=warps or lay["num_warps"])
        return lay

    def map_kernel(self):
        lines = real_map(self)
        if self.lay["N"] > fused.WIDE_MAP:
            if unmasked and self.lay["N"] % self.lay["BLOCK"] == 0:
                lines = [ln.replace(", mask=mask)", ")") for ln in lines]
            if evict:
                lines = [ln[:-1] + ', eviction_policy="evict_first")'
                         if "= tl.load(x" in ln and " + " in ln else ln
                         for ln in lines]
        return lines

    fused.layout, fused._Gen.map_kernel = layout, map_kernel
    fused._kernels.clear()
    try:
        yield
    finally:
        fused.layout, fused._Gen.map_kernel = real_layout, real_map
        fused._kernels.clear()


def _turns(fns: list, rounds: int, reps: int) -> list:
    """Each of `fns` timed `rounds` times in turns (the order reversed
    every other round), each time the mean of `reps` calls."""
    from . import histbench
    times = [[] for _ in fns]
    for i in range(rounds):
        order = list(range(len(fns)))
        for k in (order if i % 2 == 0 else order[::-1]):
            times[k].append(histbench.time_ms(fns[k], reps))
    return times


def _summary(times: list) -> dict:
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}


OLD_MAP = {"block": 1024, "warps": 4}   # every large map's layout before the sweep


def layout_sweep(eng, seen: list, rounds: int, reps: int) -> dict:
    """The map layouts tried on dense_linalg's 4096^2 float64 `R' * R - S`:
    BLOCK 1024-8192, 4 or 8 warps, masked or not, plain or evict_first
    loads, each timed once (the mean of `reps` calls) and its output held
    equal to the kept layout's bit for bit; then, on every recorded map of
    more than fused.WIDE_MAP elements, the layout fused.layout keeps
    against OLD_MAP in turns over `rounds` rounds (a float32 map also at 8
    warps, which fused.layout does not take); and the kept and the old
    layout each against torch.sub in turns."""
    import torch

    from .accel import fuse
    from .ops import fused
    big = [e for e in seen if e[1].spec.reduce is None and
           fused.numel(e[1].spec.shape) > fused.WIDE_MAP]
    (sub,) = [e for e in big if e[0] == "dense_linalg" and
              tuple(e[1].shape) == (4096, 4096) and
              [e[2][i][0] for i in e[1].members] == ["b:sub"]]

    def runner(entry):
        return lambda: fuse.run_group(eng, entry[1], entry[2], entry[3])
    run = runner(sub)
    want = [t.clone() for t in run()]
    grid = []
    for block in (1024, 2048, 4096, 8192):
        for warps in (4, 8):
            for unmasked in (False, True):
                for evict in (False, True):
                    with map_variant(block, warps, unmasked, evict):
                        equal = all(torch.equal(a, b)
                                    for a, b in zip(run(), want))
                        ms = _turns([run], 1, reps)[0][0]
                    grid.append({"block": block, "warps": warps,
                                 "unmasked": unmasked, "evict_first": evict,
                                 "ms": ms, "equal": equal})
    groups = []
    for entry in big:
        label, fn = entry[1].label, runner(entry)
        variants = {"old": OLD_MAP, "kept": {}}
        if label == "fused_map_f32":
            variants["8 warps"] = {"block": 1024, "warps": 8}
        times = {}
        for name, var in variants.items():
            with map_variant(**var):
                fn()
                times[name] = _turns([fn], rounds, reps)[0]
        groups.append({"script": entry[0], "label": label,
                       "shape": list(entry[1].shape),
                       "ops": [entry[2][i][0] for i in entry[1].members],
                       "layout": fused.layout(entry[1].spec),
                       **{k: _summary(v) for k, v in times.items()}})
    lib = library(sub[1], sub[3])
    with map_variant(**OLD_MAP):
        run()
        old = _turns([run, lib], rounds, reps)
    run()
    kept = _turns([run, lib], rounds, reps)
    return {"grid": grid, "groups": groups,
            "against_sub": {"old": _summary(old[0]),
                            "sub_beside_old": _summary(old[1]),
                            "kept": _summary(kept[0]),
                            "sub_beside_kept": _summary(kept[1])}}


def spread(eng, seen: list, rounds: int, reps: int) -> list:
    """Each recorded group that one PyTorch call computes too: the kernel
    and that call timed in turns (kernel first in even rounds, the call
    first in odd ones), `rounds` times each, each time the mean of `reps`
    (`histbench.time_ms`). `within` holds where the gap between their
    medians is no larger than the wider of their two spreads (largest less
    smallest)."""
    from .accel import fuse
    rows = []
    for script, g, program, args in seen:
        lib = library(g, args)
        if lib is None:
            continue

        def run(g=g, program=program, args=args):
            return fuse.run_group(eng, g, program, args)
        ks, ls = _turns([run, lib], rounds, reps)
        gap = statistics.median(ks) - statistics.median(ls)
        width = max(max(ks) - min(ks), max(ls) - min(ls))
        rows.append({"script": script, "label": g.label,
                     "shape": list(g.shape),
                     "ops": [program[i][0] for i in g.members],
                     "kernel_ms": ks, "library_ms": ls, "gap_ms": gap,
                     "spread_ms": width, "within": gap <= width})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--layouts", action="store_true",
                    help="sweep the large maps' layouts (layout_sweep) "
                         "instead of checking and timing every group")
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
    if args.layouts:
        out = fusebench.layout_sweep(eng, fusebench.record(), 10, args.reps)
        for r in out["grid"]:
            print(f"R' * R - S, BLOCK {r['block']}, {r['warps']} warps, "
                  f"{'unmasked' if r['unmasked'] else 'masked'}, "
                  f"{'evict_first' if r['evict_first'] else 'plain'} "
                  f"loads: {r['ms']:.4f} ms, equal {r['equal']}")
        for r in out["groups"]:
            print(f"{r['script']} {r['label']} {r['shape']} {r['ops']}: " +
                  ", ".join(f"{k} {v['median_ms']:.4f} ms ({v['min_ms']:.4f}"
                            f"-{v['max_ms']:.4f})" for k, v in r.items()
                            if isinstance(v, dict) and "median_ms" in v) +
                  f"; kept {r['layout']}")
        print("R' * R - S against torch.sub, ten rounds in turns: " +
              ", ".join(f"{k} {v['median_ms']:.5f} ms ({v['min_ms']:.5f}-"
                        f"{v['max_ms']:.5f})"
                        for k, v in out["against_sub"].items()))
        print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                          "layouts": out}))
        return 0
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
        if "b:pow" in r["ops"] and "key" in r:  # older trees' rows have none
            print(f"  machine code: "
                  f"{json.dumps(fusebench.square_arm(r['key'][1]))}")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      "checked": checked,
                      "groups": [{k: v for k, v in r.items() if k != "key"}
                                 for r in rows]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
