"""The fusion plan (`runmat_tpu_torch/accel/fuse.py`) and the code generator
(`runmat_tpu_torch/ops/fused.py`) on the CPU, where each group runs through
its plain version (the eager executor), held against the JAX package's
`JaxEngine("cpu")`, whose `materialize` runs the same DAG as one `jax.jit`
executable.

* The three benchmark scripts at small size and map, map-reduce, broadcast
  and strided DAGs give the JAX package's results; tolerances as
  `tests/test_torch_engine.py`'s for the same ops (float32 rtol 1e-6,
  float64 1e-12; the scripts' printed results 1e-5, float32 sums in
  another order).
* The plan of each script's DAGs, exactly: which ops go in which group,
  each group's outputs, and the reason for each eager op.
* `compiles`, `cache_hits` and `fusion_snapshot` (kind, ops, n_ops,
  n_outputs) equal JaxEngine's, for `tests/test_gpu_semantics.py:37-71`
  and the three scripts.
* The generated source is deterministic, parses, and names every op of its
  group; `ops/fused.py` imports and generates without triton, and asking it
  for a kernel without triton raises.
* A `pow` whose exponent is a one-element input branches on its value in
  the source (the exponent loaded once, outside any loop; `a * a` where it
  is 2, `_pow` elsewhere); an array exponent, a scalar base and an exponent
  computed in the group do not. The plain version of `.^` with a scalar
  exponent (2, nextafter(2, 3), 0, 1, -2) over NaN, +-Inf, +-0, subnormal
  and +-1 bases, and a folded loop whose exponent switches between 2 and 3,
  give the JAX package's results (float32 rtol=atol=1e-6, float64 1e-12).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_both import run_both, same

import runmat_tpu_torch
from runmat_tpu_torch import accel
from runmat_tpu_torch.accel import fuse
from runmat_tpu_torch.ops import fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"elementwise_math": "points = 4096;",
         "monte_carlo": "M = 4096; T = 16;",
         "image_normalize": "B = 2; H = 32; W = 48;"}
RESULT = {"elementwise_math": "checksum", "monte_carlo": "price",
          "image_normalize": "mse"}
SNAP_KEYS = ("kind", "ops", "n_ops", "n_outputs")


def _script(name: str) -> str:
    return open(os.path.join(REPO, "benchmarks", f"{name}.m")).read()


def _snap(snaps) -> list:
    return [{k: s.get(k) for k in SNAP_KEYS} for s in snaps]


# ------------------------------------------------ results against JaxEngine

@pytest.mark.parametrize("name", sorted(SMALL))
def test_script_matches_the_jax_package(name):
    b = run_both(SMALL[name], _script(name))
    assert b.jr.error is None and b.tr.error is None
    got, want = (float(s.get(RESULT[name]).host().reshape(-1)[0])
                 for s in (b.ts, b.js))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the same compiles, cache hits and plans as the JAX package
    assert (b.td["compiles"], b.td["cache_hits"]) == \
        (b.jd["compiles"], b.jd["cache_hits"])
    assert _snap(b.tsnap) == _snap(b.jsnap)
    assert b.td["host_fallbacks"] == 0


@pytest.mark.parametrize("name", ["elementwise_math", "image_normalize"])
def test_no_elementwise_op_runs_eagerly(name):
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    eng = accel.active_engine()
    try:
        res = s.execute(SMALL[name] + "\n" + _script(name))
        assert res.error is None, res.error
        assert eng.stats["eager_ops"] == 1
        assert not [op for op in eng.eager_by_op
                    if op.startswith(("b:", "u:", "r:", "c:"))]
    finally:
        runmat_tpu_torch.uninstall()


DAGS = {
    "map": ("x = single(linspace(0, 1, 1000));",
            "y = sin(x) .* exp(-x ./ single(10)) + single(0.25) .* x.^2;"
            " z = (y > 0.1) & ~(x < 0.5); w = double(z) + abs(y);",
            ["y", "z", "w"]),
    "map-reduce": ("x = reshape(single(1:6400), 64, 100) / 6400;",
                   "m = mean(x .* x, 'all'); s = sum(x, 2);"
                   " r = sqrt(mean((x - 0.5).^2, 2) + single(1e-6));",
                   ["m", "s", "r"]),
    "broadcast": ("x = reshape(0:599, 20, 30) / 7; c = (1:20)';"
                  " q = 1:30;",
                  "z = (x - mean(x, 2)) ./ c + q; w = max(z, 0.5) .^ 1.5;"
                  " v = mod(x, c) - rem(-x, q);",
                  ["z", "w", "v"]),
    "strided": ("rng(3); imgs = rand(3, 16, 24, 'single');",
                "mu = mean(imgs, [2 3], 'native');"
                " d = imgs - mu; e = mean(d .* d, 'all');",
                ["mu", "d", "e"]),
}


@pytest.mark.parametrize("case", sorted(DAGS))
def test_dag_matches_the_jax_package(case):
    setup, src, names = DAGS[case]
    b = run_both(setup, src)
    same(b, [n for n in names if b.ts.get(n).mclass == "logical"])
    for n in names:
        got, want = b.ts.get(n), b.js.get(n)
        if got.mclass != "logical":
            # values near 0 after a subtraction: atol scales with the array
            tol = 1e-6 if got.mclass == "single" else 1e-12
            w = np.asarray(want.host())
            assert got.mclass == want.mclass and got.on_device
            np.testing.assert_allclose(got.host(), w, rtol=tol,
                                       atol=tol * np.abs(w).max(), err_msg=n)
    assert (b.td["compiles"], b.td["cache_hits"]) == \
        (b.jd["compiles"], b.jd["cache_hits"])
    assert _snap(b.tsnap) == _snap(b.jsnap)
    # every op of these DAGs is in the code generator's table
    assert b.td["eager_ops"] == 0


# ------------------------------------------- the ported gpuArray tests

def test_fusion_single_compile():
    # tests/test_gpu_semantics.py:test_fusion_single_compile on both
    b = run_both("", """
g = gpuArray(single(linspace(0, 1, 1000)));
y0 = sin(g) .* exp(-g / single(10));
y1 = y0 .* cos(g / 4) + single(0.25) .* (y0 .^ 2);
y2 = tanh(y1) + single(0.1) .* y1;
h = gather(y2);
""")
    assert b.jd["compiles"] == b.td["compiles"] == 1
    same(b, ["h"], rtol=1e-6)
    assert _snap(b.tsnap) == _snap(b.jsnap)
    (snap,) = b.tsnap
    assert snap["kernels"] == ["fused_map_f32"] and snap["eager"] == []


def test_jit_cache_hits_across_iterations():
    # tests/test_gpu_semantics.py:test_jit_cache_hits_across_iterations
    b = run_both("", """
g = gpuArray(single(ones(100, 1)));
for t = 1:5
  g = gpuArray(gather(g));
  g = g .* single(1.01) + single(0.5);
  h = gather(g);
end
""")
    # ones() is a program of its own here (every array goes to the
    # device), the chain the other, reused in four iterations
    assert b.jd["compiles"] == b.td["compiles"] == 2
    assert b.jd["cache_hits"] == b.td["cache_hits"] >= 4
    same(b, ["h"], rtol=1e-6)
    assert _snap(b.tsnap) == _snap(b.jsnap)


# --------------------------------------------------- the plans, exactly

def _plans(src: str, monkeypatch) -> list:
    """(program, plan) of every plan the port makes running `src`."""
    made = []
    real = fuse.plan

    def keep(program, out_idx, **kw):
        p = real(program, out_idx, **kw)
        made.append((program, p))
        return p

    monkeypatch.setattr(fuse, "plan", keep)
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    try:
        r = s.execute(src)
        assert r.error is None, r.error
    finally:
        runmat_tpu_torch.uninstall()
    return made


def _describe(program, p) -> tuple:
    groups = [(g.label, [program[i][0] for i in g.members],
               [g.members.index(i) for i in g.outputs]) for g in p.groups]
    return groups, [(op, why) for _, op, why in p.eager]


MAIN_PLANS = {
    "elementwise_math": (
        [("fused_map_f32",
          ["c:linspace", "cast", "u:neg", "b:div", "u:exp", "u:sin",
           "b:mul", "b:pow", "b:mul", "b:div", "u:cos", "b:mul", "b:add",
           "b:mul", "u:tanh", "b:add"], [1, 6, 12, 15]),
         ("fused_reduce_f32", ["r:sum"], [0])],
        [("slice1", "not elementwise")]),
    "image_normalize": (
        [("fused_map_f32", ["u:neg", "cast"], [1]),
         ("fused_reduce_f32", ["r:mean", "cast"], [1]),
         ("fused_reduce_f32",
          ["b:sub", "b:pow", "r:mean", "b:add", "u:sqrt", "cast"], [5]),
         ("fused_reduce_f32",
          ["b:sub", "b:div", "b:mul", "b:add", "cast", "b:max2", "b:pow",
           "cast", "b:sub", "b:mul", "r:mean"], [4, 5, 7, 8, 10])],
        [("rng:rand", "not elementwise")]),
}


@pytest.mark.parametrize("name", sorted(MAIN_PLANS))
def test_the_main_plan_of_a_script(name, monkeypatch):
    made = _plans(SMALL[name] + "\n" + _script(name), monkeypatch)
    program, p = max(made, key=lambda m: len(m[0]))
    assert _describe(program, p) == MAIN_PLANS[name]


def test_the_plans_of_monte_carlo(monkeypatch):
    made = _plans(SMALL["monte_carlo"] + "\n" + _script("monte_carlo"),
                  monkeypatch)
    described = [_describe(program, p) for program, p in made
                 if p.groups or p.eager]
    # the step of the folded loop: the draw, then one kernel for
    # S .* exp(drift + scale .* Z)
    assert ([("fused_map_f32", ["b:mul", "b:add", "u:exp", "b:mul"], [3])],
            [("rng:randn", "not elementwise")]) in described
    # the payoff: max(S - K, 0) and its mean, then the discount in the
    # reduction's epilogue; payoff, price and its double are written
    assert ([("fused_map_f32", ["u:neg", "b:mul", "b:mul", "u:exp"], [3]),
             ("fused_reduce_f32",
              ["b:sub", "b:max2", "r:mean", "b:mul", "cast"], [1, 3, 4])],
            []) in described


def test_eager_reasons():
    f32, i32 = np.dtype("float32"), np.dtype("int32")
    program = [("__leaf__", (), f32, (), (), (4, 5)),
               ("__leaf__", (), i32, (), (), (4, 5)),
               ("b:add", ("int32",), i32, (1, 1), ((4, 5), (4, 5)), (4, 5)),
               ("r:sum", ((0,), "", "float32"), f32, (0,), ((4, 5),),
                (1, 5)),
               ("r:sum", ((1,), "omitnan", "float32"), f32, (0,), ((4, 5),),
                (4, 1)),
               ("r:max", ((1,), "", "float32"), f32, (0,), ((4, 5),),
                (4, 1)),
               ("s:cumsum", (0, False, False, "float32"), f32, (0,),
                ((4, 5),), (4, 5)),
               ("u:exp", (), f32, (0,), ((4, 5),), (4, 5))]
    p = fuse.plan(program, [2, 3, 4, 5, 6, 7])
    assert [(op, why) for _, op, why in p.eager] == [
        ("b:add", "int32 operand (integer classes saturate)"),
        ("r:sum", "reduction over non-trailing axes"),
        ("r:sum", "NaN mode 'omitnan'"),
        ("r:max", "reduction not in the code generator's table"),
        ("s:cumsum", "not elementwise")]
    assert [[program[i][0] for i in g.members] for g in p.groups] == \
        [["u:exp"]]


def test_a_complex_node_declines_as_complex():
    # Triton has no complex type: complex entries stay eager with their own
    # reason, checked before the integer one; a real op fed by abs(X)
    # still fuses
    c128, f64 = np.dtype("complex128"), np.dtype("float64")
    i32 = np.dtype("int32")
    program = [("__leaf__", (), c128, (), (), (4, 5)),
               ("__leaf__", (), i32, (), (), (4, 5)),
               ("u:abs", (), f64, (0,), ((4, 5),), (4, 5)),
               ("b:mul", ("complex128",), c128, (0, 0), ((4, 5), (4, 5)),
                (4, 5)),
               ("r:sum", (("all",), "", "complex128"), c128, (0,),
                ((4, 5),), (1, 1)),
               ("cast", ("complex128",), c128, (1,), ((4, 5),), (4, 5)),
               ("b:add", ("int32",), i32, (1, 1), ((4, 5), (4, 5)), (4, 5)),
               ("u:exp", (), f64, (2,), ((4, 5),), (4, 5)),
               ("b:mul", ("float64",), f64, (7, 2), ((4, 5), (4, 5)),
                (4, 5))]
    p = fuse.plan(program, [3, 4, 5, 6, 8])
    assert [(op, why) for _, op, why in p.eager] == [
        ("u:abs", "complex operand"), ("b:mul", "complex operand"),
        ("r:sum", "complex operand"), ("cast", "complex operand"),
        ("b:add", "int32 operand (integer classes saturate)")]
    assert [[program[i][0] for i in g.members] for g in p.groups] == \
        [["u:exp", "b:mul"]]


def test_a_complex_script_fuses_its_real_ops_against_jaxengine():
    b = run_both("x = gpuArray(sin(1:64));",
                 "f = fft(x); g = abs(f) .^ 2 / 64 + 1; h = sum(g);")
    same(b, ["g", "h"], rtol=1e-12)
    for k in ("compiles", "cache_hits"):
        assert b.td[k] == b.jd[k], k
    eager = [x for e in b.teng.launch_log for x in e.get("eager", [])]
    assert "u:abs: complex operand" in eager
    kernels = [k for e in b.teng.launch_log for k in e.get("kernels", [])]
    assert kernels and all(k.endswith("f64") for k in kernels)


def test_a_cycle_is_not_fused():
    # exp(x) feeds an eager op whose result comes back: the add cannot join
    # exp's group, or the group would wait for itself
    f32 = np.dtype("float32")
    program = [("__leaf__", (), f32, (), (), (1, 8)),
               ("u:exp", (), f32, (0,), ((1, 8),), (1, 8)),
               ("flipL", (1,), f32, (1,), ((1, 8),), (1, 8)),
               ("b:add", ("float32",), f32, (1, 2), ((1, 8), (1, 8)),
                (1, 8))]
    p = fuse.plan(program, [3])
    assert [[program[i][0] for i in g.members] for g in p.groups] == \
        [["u:exp"], ["b:add"]]
    assert [k for k, _ in p.steps] == ["group", "eager", "group"]


# ------------------------------------------------- the generated source

@pytest.mark.parametrize("name", sorted(SMALL))
def test_generated_source_is_deterministic(name, monkeypatch):
    for program, p in _plans(SMALL[name] + "\n" + _script(name),
                             monkeypatch):
        for g in p.groups:
            text = fused.source(g.spec)
            assert text == fused.source(g.spec)
            tree = ast.parse(text)
            assert _kernels(text) == _expected(g.spec)
            first = text.splitlines()[0]
            for i in g.members:
                assert program[i][0] in first
            assert ast.parse(fused.source(g.spec, big=True))
            if g.reduce is not None and fused.layout(g.spec)["SPLITS"] == 1:
                # the same group over segments that programs share
                wide = _widened(g.spec)
                assert fused.layout(wide)["SPLITS"] > 1
                assert _kernels(fused.source(wide)) == {"part_kernel",
                                                        "fin_kernel"}


def _kernels(text: str) -> set:
    return {n.name for n in ast.parse(text).body
            if isinstance(n, ast.FunctionDef) and n.name.endswith("_kernel")}


def _expected(spec) -> set:
    """The kernels a Spec generates: a map's, a map-reduce's pair, or its
    one kernel where one program covers each segment (SPLITS == 1)."""
    if spec.reduce is None:
        return {"map_kernel"}
    if fused.layout(spec)["SPLITS"] == 1:
        return {"one_kernel"}
    return {"part_kernel", "fin_kernel"}


def _widened(spec, factor: int = 64):
    """`spec` with each reduced dimension `factor` times longer (in the
    iteration shape and in every input that spans it)."""
    import dataclasses
    axes = spec.body[spec.reduce][1][0]
    red = [d for d in fused.nonsingleton(spec.shape) if d in axes]

    def widen(shape):
        return tuple(s * factor if d in red and s == spec.shape[d] else s
                     for d, s in enumerate(shape))
    return dataclasses.replace(
        spec, shape=widen(spec.shape),
        inputs=tuple((widen(ls), dt) for ls, dt in spec.inputs))


def test_a_one_program_reduction_generates_one_kernel():
    # sum of 1024 values (elementwise_math's checksum): one program
    one = fused.Spec(shape=(1, 1024), inputs=(((1, 1024), F32),),
                     body=(("r:sum", ((0, 1), "", F32), F32, (("x", 0),)),),
                     reduce=0, outputs=(0,), rshape=(1, 1))
    assert fused.layout(one)["SPLITS"] == 1
    text = fused.source(one)
    assert _kernels(text) == {"one_kernel"}
    assert "part" not in [a.arg for a in
                          _kernel(text, "one_kernel").args.args]
    assert "tl.sum(acc, axis=1)" in text and "tl.store(y0 + ko" in text
    # 10^6 values: programs share the segment, two kernels as before
    many = fused.Spec(shape=(1, 10 ** 6), inputs=(((1, 10 ** 6), F32),),
                      body=one.body, reduce=0, outputs=(0,), rshape=(1, 1))
    assert fused.layout(many)["SPLITS"] > 1
    assert _kernels(fused.source(many)) == {"part_kernel", "fin_kernel"}


# (shape, dtype, op, warps): a float64 map of more than fused.WIDE_MAP
# (2^20) elements takes 8 warps a block of 1024 (dense_linalg's 4096^2
# maps, spectral's and resample_pages' 2^22 ones, the 32 x 32 x 8192
# pages), unless it is one unary op (resample_pages' abs); every float32
# map keeps the layout it had (4 warps from a block of 512, 1 below), as
# does a float64 map of 2^20 elements or fewer
@pytest.mark.parametrize("shape,dt,op,warps", [
    ((4096, 4096), "float64", "b:sub", 8),
    ((4194304, 1), "float64", "b:sub", 8),
    ((32, 32, 8192), "float64", "b:add", 8),
    ((1, (1 << 20) + 1), "float64", "b:sub", 8),
    ((4194304, 1), "float64", "u:abs", 4),
    ((1, 1 << 20), "float64", "b:sub", 4),
    ((2048, 2048), "float32", "b:sub", 4),
    ((1, 10 ** 7), "float32", "b:mul", 4),
    ((1, 10 ** 7), "float32", "u:abs", 4),
    ((1, 10 ** 6), "float32", "b:sub", 4),
    ((1, 1000), "float32", "b:sub", 4), ((1, 100), "float32", "b:sub", 1),
    ((1, 100), "float64", "b:sub", 1)])
def test_map_layout_gives_large_float64_maps_eight_warps(shape, dt, op,
                                                         warps):
    args = (("x", 0),) if op.startswith("u:") else (("x", 0), ("x", 1))
    spec = fused.Spec(shape=shape, inputs=((shape, dt),) * len(args),
                      body=((op, (dt,), dt, args),),
                      reduce=None, outputs=(0,))
    n = int(np.prod(shape))
    block = min(1024, max(16, 1 << (n - 1).bit_length()))
    assert fused.layout(spec) == {"N": n, "BLOCK": block,
                                  "grid": (-(-n // block),),
                                  "num_warps": warps}


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_an_epilogue_exponent_branches_in_the_one_kernel(dt):
    # mean over rows of 16 x 1000, then .^ e with e a one-element input:
    # one program a segment, the exponent loaded before the loop, the
    # branch after it
    spec = fused.Spec(
        shape=(16, 1000), inputs=(((16, 1000), dt), ((1, 1), dt)),
        body=(("b:mul", (dt,), dt, (("x", 0), ("x", 0))),
              ("r:mean", ((1,), "", dt), dt, (("v", 0),)),
              ("b:pow", (dt,), dt, (("v", 1), ("x", 1)))),
        reduce=1, outputs=(2,), rshape=(16, 1))
    assert fused.layout(spec)["SPLITS"] == 1
    text = fused.source(spec)
    assert _kernels(text) == {"one_kernel"}
    assert _branches(text, "one_kernel") == [(2, 1, False)]
    div = "tl.div_rn(v1, tl.full([BK], 1000, tl.float32))" \
        if dt == "float32" else "v1 = v1 / 1000.0"
    assert div in text
    # the same group over longer rows keeps its finishing kernel's branch
    wide = _widened(spec)
    text = fused.source(wide)
    assert _kernels(text) == {"part_kernel", "fin_kernel"}
    assert _branches(text, "fin_kernel") == [(2, 1, False)]
    assert _branches(text, "part_kernel") == []


def test_every_table_op_generates():
    from runmat_tpu_torch import fusebench
    from runmat_tpu_torch.accel.engine import TorchEngine
    eng = TorchEngine("cpu")
    for name, build in fusebench.table_cases():
        p, outs, _ = build(eng.device)
        plan = fuse.plan(p.entries, outs)
        assert plan.groups and not plan.eager, name
        for g in plan.groups:
            ast.parse(fused.source(g.spec))


def test_without_triton():
    code = r"""
import sys
sys.modules["triton"] = None
from runmat_tpu_torch.ops import fused
from runmat_tpu_torch.errors import MatError
spec = fused.Spec(shape=(1, 8), inputs=(((1, 8), "float32"),),
                  body=(("u:exp", (), "float32", (("x", 0),)),),
                  reduce=None, outputs=(0,))
text = fused.source(spec)
try:
    fused.module(text)
except MatError as e:
    print("raised", e.identifier)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "raised RunMat:fusedKernel" in p.stdout


# ------------------------------------------------ the library yardsticks

LIBRARY_SCRIPTS = {
    "elementwise_math": ("benchmarks/elementwise_math.m", "points = 4096;"),
    "monte_carlo": ("benchmarks/monte_carlo.m", "M = 4096; T = 16;"),
    "image_normalize": ("benchmarks/image_normalize.m",
                        "B = 2; H = 32; W = 48;"),
    "dense_linalg": ("runmat_tpu_torch/workloads/dense_linalg.m", "N = 64;"),
    "spectral": ("runmat_tpu_torch/workloads/spectral.m", "N = 2^12;"),
    "resample_pages": ("runmat_tpu_torch/workloads/resample_pages.m",
                       "N = 2^12; P = 16;")}


@pytest.mark.parametrize("name", sorted(LIBRARY_SCRIPTS))
def test_library_calls_compute_their_group(name, monkeypatch):
    """Each group the script launches that one PyTorch call computes
    (`fusebench.library`): that call gives the group's result on the same
    inputs, float32 within 1e-6 and float64 within 1e-12 of its largest
    magnitude (torch.linspace and the engine's linspace round apart)."""
    import io

    import torch

    from runmat_tpu_torch import fusebench
    seen = []
    real = fuse.run_group

    def keep(eng, g, program, args):
        outs = real(eng, g, program, args)
        seen.append((g, list(args), outs))
        return outs

    monkeypatch.setattr(fuse, "run_group", keep)
    path, pre = LIBRARY_SCRIPTS[name]
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    s.stdout = io.StringIO()
    try:
        s.run_source(pre + "\n" + open(os.path.join(REPO, path)).read())
    finally:
        runmat_tpu_torch.uninstall()
    kinds = set()
    for g, args, outs in seen:
        lib = fusebench.library(g, args)
        ops = tuple(g.spec.body[m][0] for m in range(len(g.spec.body)))
        if lib is None:
            continue
        kinds.add(ops)
        got, want = lib().double().reshape(-1), outs[-1].double().reshape(-1)
        tol = 1e-6 if outs[-1].dtype == torch.float32 else 1e-12
        assert got.shape == want.shape, ops
        assert float((got - want).abs().max()) <= tol * max(
            1.0, float(want.abs().max())), ops
    expected = {"elementwise_math": {("r:sum",), ("b:mul",)},
                "monte_carlo": {("c:full", "b:mul")},
                "image_normalize": {("r:mean", "cast")},
                "dense_linalg": {("b:div",), ("b:sub",), ("b:add",)},
                # ("b:pow",): a `.^` by a scalar, torch.pow
                "spectral": {("c:linspace",), ("r:mean",), ("b:div",),
                             ("b:mul",), ("b:pow",)},
                # no ("b:add",): the pages' `randn(32, 32, P) + 32*eye(32)`
                # lines up its operands from the first dim, torch.add from
                # the last; `abs(y)` is torch.abs, `t .^ 1.5` torch.pow
                "resample_pages": {("c:linspace",), ("r:mean",), ("b:mul",),
                                   ("c:full", "b:mul"), ("u:abs",),
                                   ("b:pow",)}}[name]
    assert kinds == expected, kinds


# ------------------------------------------------------- the walking order

def _strided_group():
    from runmat_tpu_torch import fusebench
    p, outs, _ = dict(fusebench.table_cases())["strided float32"]("cpu")
    plan = fuse.plan(p.entries, outs)
    return p, plan.groups[0]


def test_a_group_walks_its_input_in_memory_order():
    import torch
    p, g = _strided_group()
    # the F-order view of a draw, aligned as torch allocates
    x = torch.zeros(65, 33, 3).permute(2, 1, 0)
    walked = fuse._walk(g.spec, [fuse._operand(x, (3, 33, 65))], False)
    assert walked.perm == (2, 1, 0) and walked.dense == 0
    # in a folded loop's body the input is read through its strides
    assert fuse._walk(g.spec, [fuse._operand(x, (3, 33, 65))],
                      True).dense is None
    # row-major is walked row-major, and read densely; a view that is not
    # dense is walked row-major through its strides
    row = fuse._walk(g.spec, [fuse._operand(x.contiguous(), (3, 33, 65))],
                     False)
    assert row.perm is None and row.dense == 0
    view = torch.zeros(3, 33, 130)[:, :, ::2]
    assert fuse._walk(g.spec, [fuse._operand(view, (3, 33, 65))],
                      False) == g.spec
    # mean(x, [2 3]) of an F-order array reduces its leading dims in
    # memory: a column reduction, tiles of reduced rows by kept columns
    assert walked.blocks() == ([0], [2, 1], True)
    text = fused.source(walked)
    ast.parse(text)
    assert "lin = rr * 3 + kk" in text and "tl.sum(acc, axis=0)" in text
    assert "a0 = tl.load(x0 + lin, mask=mask)" in text
    assert '"x0"' not in text.splitlines()[
        [i for i, line in enumerate(text.splitlines())
         if "def part_kernel" in line][0] - 1]
    lay = fused.layout(walked)
    assert (lay["K"], lay["R"]) == (3, 33 * 65)


def test_outputs_take_the_walking_order():
    import torch
    t = fuse._empty((3, 33, 65), [2, 1, 0], torch.float32, "cpu")
    assert tuple(t.shape) == (3, 33, 65) and t.stride() == (1, 3, 99)
    t = fuse._empty((3, 1, 65), [2, 0], torch.float32, "cpu")
    assert tuple(t.shape) == (3, 1, 65) and (t.stride(0), t.stride(2)) == \
        (1, 3)
    t = fuse._empty((3, 1), [0], torch.float64, "cpu")
    assert tuple(t.shape) == (3,) and t.is_contiguous()


# ------------------------------------------- pow with a scalar exponent

def _kernel(text: str, name: str) -> ast.FunctionDef:
    (fn,) = [n for n in ast.parse(text).body
             if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


def _loads_of(node, k: int) -> int:
    """`tl.load(x{k})` calls under `node`."""
    return sum(isinstance(c, ast.Call) and ast.unparse(c.func) == "tl.load"
               and ast.unparse(c.args[0]) == f"x{k}" for c in ast.walk(node))


def _branches(text: str, kernel: str) -> list:
    """(body index, exponent input, inside a loop) of each branch on an
    exponent in `kernel`, checked: the exponent loaded once, before any
    loop, compared with 2, and the arms `a * a` and `_pow(a, e)`."""
    fn = _kernel(text, kernel)
    found = []
    loops = [n for n in ast.walk(fn) if isinstance(n, ast.For)]
    for node in ast.walk(fn):
        if not (isinstance(node, ast.If) and isinstance(node.test, ast.Name)
                and node.test.id.startswith("sq")):
            continue
        m = node.test.id[2:]
        (then,), (other,) = node.body, node.orelse
        assert ast.unparse(then.targets[0]) == f"v{m}"
        assert ast.unparse(other.targets[0]) == f"v{m}"
        sq = then.value
        assert isinstance(sq, ast.BinOp) and isinstance(sq.op, ast.Mult)
        assert ast.unparse(sq.left) == ast.unparse(sq.right)
        call = other.value
        assert ast.unparse(call.func) == "_pow"
        assert [ast.unparse(a) for a in call.args] == \
            [ast.unparse(sq.left), f"e{m}"]
        # the exponent and the test: top-level statements before any loop
        top = [ast.unparse(x) for x in fn.body]
        (load,) = [x for x in fn.body if isinstance(x, ast.Assign)
                   and ast.unparse(x.targets[0]) == f"e{m}"]
        k = int(ast.unparse(load.value).split("tl.load(x")[1].split(")")[0])
        assert f"sq{m} = e{m} == 2" in top
        first_loop = min([fn.body.index(x) for x in fn.body
                          if isinstance(x, ast.For)], default=len(fn.body))
        assert fn.body.index(load) < first_loop
        assert _loads_of(fn, k) == 1
        found.append((int(m), k, any(node in ast.walk(lp) for lp in loops)))
    return found


def _main_groups(monkeypatch) -> dict:
    """{(script, label, ops): Group} of the two scripts with a pow."""
    out = {}
    for name in ("elementwise_math", "image_normalize"):
        for program, p in _plans(SMALL[name] + "\n" + _script(name),
                                 monkeypatch):
            for g in p.groups:
                out[(name, g.label, tuple(program[i][0]
                                          for i in g.members))] = g
    return out


@pytest.mark.parametrize("which,kernel,in_loop", [
    ("elementwise_math", "map_kernel", False),
    ("sigma", "part_kernel", True),
    ("gamma", "part_kernel", True)])
def test_a_scalar_exponent_branches_on_its_value(which, kernel, in_loop,
                                                 monkeypatch):
    groups = _main_groups(monkeypatch)
    ops = {"elementwise_math": MAIN_PLANS["elementwise_math"][0][0][1],
           "sigma": MAIN_PLANS["image_normalize"][0][2][1],
           "gamma": MAIN_PLANS["image_normalize"][0][3][1]}[which]
    (g,) = [g for (_, _, o), g in groups.items() if list(o) == ops]
    specs = [g.spec]
    if g.reduce is not None and fused.layout(g.spec)["SPLITS"] == 1:
        # one program a segment at this size: the branch is in one_kernel,
        # and the group at a width that splits its segments keeps it in
        # `kernel`
        specs.append(_widened(g.spec))
    for spec in specs:
        text = fused.source(spec)
        name = "one_kernel" if _expected(spec) == {"one_kernel"} else kernel
        (m, k, looped), = _branches(text, name)
        assert spec.body[m][0] == "b:pow" and spec.body[m][3][1] == ("x", k)
        assert spec.inputs[k][0] == (1, 1) and looped == in_loop
        # the exponent stays a pointer that is not specialised on
        lines = text.splitlines()
        (i,) = [i for i, line in enumerate(lines)
                if line.startswith(f"def {name}(")]
        assert f'"x{k}"' in lines[i - 1]
        assert text == fused.source(spec)
        assert ast.parse(fused.source(spec, big=True))
    assert _expected(specs[-1]) == ({"map_kernel"} if g.reduce is None
                                    else {"part_kernel", "fin_kernel"})


def test_an_epilogue_exponent_branches_in_the_finishing_kernel():
    from runmat_tpu_torch import fusebench
    from runmat_tpu_torch.accel.engine import TorchEngine
    eng = TorchEngine("cpu")
    p, outs, _ = dict(fusebench.table_cases())["pow scalar 2 float32"](
        eng.device)
    plan = fuse.plan(p.entries, outs)
    found = {}
    for g in plan.groups:
        text = fused.source(g.spec)
        for kernel in ("map_kernel", "part_kernel", "fin_kernel"):
            if f"def {kernel}(" in text:
                found[kernel] = [looped for _, _, looped in
                                 _branches(text, kernel)]
    assert found == {"map_kernel": [False], "part_kernel": [True],
                     "fin_kernel": [False]}


F32 = "float32"


@pytest.mark.parametrize("name,spec", [
    ("array exponent", fused.Spec(
        shape=(1, 8), inputs=(((1, 8), F32), ((1, 8), F32)),
        body=(("b:pow", (F32,), F32, (("x", 0), ("x", 1))),),
        reduce=None, outputs=(0,))),
    ("scalar base", fused.Spec(
        shape=(1, 8), inputs=(((1, 1), F32), ((1, 8), F32)),
        body=(("b:pow", (F32,), F32, (("x", 0), ("x", 1))),),
        reduce=None, outputs=(0,))),
    ("exponent computed in the group", fused.Spec(
        shape=(1, 8), inputs=(((1, 8), F32), ((1, 1), F32)),
        body=(("b:add", (F32,), F32, (("x", 0), ("x", 1))),
              ("b:pow", (F32,), F32, (("x", 0), ("v", 0)))),
        reduce=None, outputs=(1,))),
    ("array exponent in a reduction", fused.Spec(
        shape=(4, 8), inputs=(((4, 8), F32), ((4, 8), F32)),
        body=(("b:pow", (F32,), F32, (("x", 0), ("x", 1))),
              ("r:sum", ((1,), "", F32), F32, (("v", 0),))),
        reduce=1, outputs=(1,), rshape=(4, 1)))])
def test_no_branch_without_a_scalar_exponent(name, spec):
    text = fused.source(spec)
    tree = ast.parse(text)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.If)], name
    assert "_pow(" in text and " * x" not in text


def _matlab(values: np.ndarray) -> str:
    return "[" + " ".join(repr(float(v)) for v in values) + "]"


POW_BASES = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0]


@pytest.mark.parametrize("mclass", ["single", "double"])
@pytest.mark.parametrize("exponent", ["2", "nextafter(2, 3)", "0", "1", "-2"])
def test_scalar_exponent_matches_the_jax_package(exponent, mclass):
    dt = np.float32 if mclass == "single" else np.float64
    tiny = np.finfo(dt).smallest_subnormal
    rng = np.random.default_rng(12)
    x = np.concatenate([POW_BASES, [tiny, -tiny, 3 * tiny, np.finfo(dt).tiny,
                                    np.sqrt(np.finfo(dt).max) * 2],
                        rng.uniform(-3.0, 3.0, 40)]).astype(dt)
    e = repr(float(np.nextafter(dt(2), dt(3)))) \
        if exponent.startswith("nextafter") else exponent
    b = run_both(f"x = gpuArray({mclass}({_matlab(x)})); "
                 f"e = {mclass}({e});", "y = x .^ e;")
    same(b, [])
    tol = 1e-6 if mclass == "single" else 1e-12
    got, want = b.ts.get("y"), b.js.get("y")
    assert got.mclass == want.mclass == mclass and got.on_device
    np.testing.assert_allclose(got.host(), want.host(), rtol=tol, atol=tol)
    # MATLAB's x^0 = 1 (NaN included) and x^1 = x, exactly
    if exponent in ("0", "1"):
        ref = np.ones_like(x) if exponent == "0" else x
        np.testing.assert_array_equal(np.asarray(got.host()).reshape(-1),
                                      ref)
    assert (b.td["compiles"], b.td["cache_hits"]) == \
        (b.jd["compiles"], b.jd["cache_hits"])
    assert _snap(b.tsnap) == _snap(b.jsnap)


LOOP_POW = ("x = gpuArray(single(linspace(0.5, 1.5, 4096)'));"
            " y = gpuArray(zeros(4096, 1, 'single'));",
            "for t = 1:24\n  e = 2 + mod(t, 2);\n"
            "  y = y * single(0.5) + x .^ e;\nend\n")


def test_a_folded_loop_with_a_changing_exponent():
    b = run_both(*LOOP_POW)
    assert b.td["loop_folds"] == 1 and b.td["loop_bails"] == 0, b.td
    assert b.jd["loop_trace_attempts"] == 1
    assert any(k[0] == "device_loop" for k in b.jeng._jit_cache)
    same(b, ["e"])
    np.testing.assert_allclose(b.ts.get("y").host(), b.js.get("y").host(),
                               rtol=1e-6, atol=1e-6)
    assert _snap(b.tsnap) == _snap(b.jsnap)


# a branch on the exponent as Triton's IR prints it (trimmed from the sigma
# group's part_kernel on an H100)
TTIR_BRANCH = """\
      %6 = scf.if %sq1_12 -> (tensor<128x16xf32>) {
        %v1 = arith.mulf %v0, %v0 : tensor<128x16xf32> loc(#loc94)
        scf.yield %v1 : tensor<128x16xf32> loc(#loc94)
      } else {
        %r = tt.splat %e1 : f32 -> tensor<128x16xf32> loc(#loc97)
        %r_35 = tt.extern_elementwise %v0, %r {libname = "", libpath = "", \
pure = true, symbol = "__nv_powf"} : (tensor<128x16xf32>, \
tensor<128x16xf32>) -> tensor<128x16xf32> loc(#loc97)
        scf.yield %r_35 : tensor<128x16xf32> loc(#loc88)
      } loc(#loc29)
"""


@pytest.mark.parametrize("case", ["as compiled", "pow in the square arm",
                                  "no pow in the other arm",
                                  "a product of two"])
def test_the_square_arm_in_ir(case):
    from runmat_tpu_torch import fusebench
    ir = TTIR_BRANCH
    if case == "pow in the square arm":
        ir = ir.replace("arith.mulf %v0, %v0", "tt.extern_elementwise %v0, "
                        '%e1 {symbol = "__nv_powf"}')
    elif case == "no pow in the other arm":
        ir = ir.replace("__nv_powf", "__nv_expf")
    elif case == "a product of two":
        ir = ir.replace("arith.mulf %v0, %v0", "arith.mulf %v0, %v00")
    arms = fusebench._if_arms(ir)
    (then, other), = arms
    assert "scf.yield %v1" in then and "tt.splat" in other
    assert fusebench.ir_arms_ok(arms) == (case == "as compiled")
    assert not fusebench.ir_arms_ok([])
    assert fusebench._if_arms(ir.replace("} else {", "} {")) == []


def test_launches_summed_by_label():
    from runmat_tpu_torch.ops import fused
    counts = {("fused_map_f32", "runmat_fused_a"): 3,
              ("fused_reduce_f32", "runmat_fused_b"): 1,
              ("fused_map_f32", "runmat_fused_c"): 2}
    assert fused.by_label(counts) == {"fused_map_f32": 5,
                                      "fused_reduce_f32": 1}
    assert fused.by_label({}) == {}
