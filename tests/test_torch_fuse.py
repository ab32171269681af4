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
            kernels = {n.name for n in tree.body
                       if isinstance(n, ast.FunctionDef)}
            assert kernels >= ({"map_kernel"} if g.reduce is None
                               else {"part_kernel", "fin_kernel"})
            first = text.splitlines()[0]
            for i in g.members:
                assert program[i][0] in first
            assert ast.parse(fused.source(g.spec, big=True))


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
