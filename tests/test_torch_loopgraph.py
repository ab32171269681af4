"""The port's folded `for` loop with its state on the device, against the
JAX package's `lax.fori_loop` fold on the same `.m` source
(`tests/torch_both.py`).

The port's fold keeps the step index, the loop variable and each draw's
RNG counter in device memory (`accel/loops.py`, `_Step`); on a card one
iteration is captured as a CUDA graph and replayed, on the CPU (here) the
same step runs eagerly T times. Held here: uniform draws and the counter's
advance equal the JAX package's exactly, across the 2^32 carry of the
counter too; normals within a few ulp (f64 rtol = atol = 1e-12 over sums of
up to 16 draws; f32 1e-5); a body that reads the loop variable and a column
write equal exactly. Also: the plain Threefry stream takes a tensor counter;
no host scalar becomes a tensor through `torch.tensor` inside
`run_program` while the five scripts run; and the repairs of the port's
accumarray subscripts, single means and sums on its host engine, and its
matmul precision policy.
"""

import traceback

import numpy as np
import pytest
import torch

import runmat_tpu_torch
from runmat_tpu_torch import accel
from runmat_tpu_torch.accel.engine import TorchEngine
from runmat_tpu_torch.ops import ctrng, threefry
from runmat_tpu_torch.values import MatArray
from torch_both import run_both, same

TWO_DRAWS = ("X = zeros(64, 1, 'single'); Y = zeros(32, 1);\n",
             "for t = 1:8\n"
             "  U = rand(64, 1, 'single');\n"
             "  V = randn(32, 1);\n"
             "  X = X + U;\n"
             "  Y = Y + V;\n"
             "end\n")
# blocks one iteration draws: 64 single uniforms take 32, 32 double normals
# take 2 * 16
BPI = 32 + 32


def _folded(b, T: int) -> None:
    """One fold in each package; the port's ran its step T times eagerly."""
    assert b.td["loop_folds"] == 1 and b.td["loop_bails"] == 0, b.td
    assert b.jd["loop_trace_attempts"] == 1
    assert any(k[0] == "device_loop" for k in b.jeng._jit_cache)
    (e,) = [e for e in b.teng.launch_log if e["cat"] == "device_loop"]
    assert e["iterations"] == T and e["graph"] == "eager"
    assert e["replays"] == 0
    assert b.td["graph_captures"] == b.td["graph_replays"] == 0


def _normals(b, names, rtol) -> None:
    for n in names:
        g, w = b.ts.get(n).host(), b.js.get(n).host()
        assert g.shape == w.shape and g.dtype == w.dtype, n
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol, err_msg=n)


@pytest.mark.parametrize("start", [0, (1 << 32) - 5])
def test_two_draws_an_iteration(start):
    def prepare(s):
        s.rng.counter = start

    b = run_both(*TWO_DRAWS, prepare=prepare)
    _folded(b, 8)
    same(b, ["X", "U"])                       # uniforms: bit for bit
    _normals(b, ["Y", "V"], 1e-12)
    assert b.ts.rng.counter == b.js.rng.counter == start + 8 * BPI


def test_single_normals_across_the_carry():
    # 2^32 - 5 + 8 iterations of 16 blocks: the low word wraps in the
    # first iteration
    def prepare(s):
        s.rng.counter = (1 << 32) - 5

    b = run_both("Z = zeros(32, 1, 'single'); W = zeros(16, 1, 'single');",
                 "for k = 1:8\n  Z = Z + randn(32, 1, 'single');\n"
                 "  W = W + rand(16, 1, 'single');\nend\n", prepare)
    _folded(b, 8)
    same(b, ["W"])
    _normals(b, ["Z"], 1e-5)
    assert b.ts.rng.counter == b.js.rng.counter == (1 << 32) - 5 + 8 * 24


def test_body_reads_the_loop_variable():
    b = run_both("x = gpuArray((1:12)' .^ 2); s = gpuArray(0);"
                 " acc = gpuArray(zeros(4, 1));",
                 "for k = 1:12\n  acc = acc * 0.5 + k;\n  s = s + x(k);\nend\n"
                 "r = gather(s);")
    _folded(b, 12)
    same(b, ["acc", "s", "r", "k"])
    assert b.ts.get("r").host()[0, 0] == sum(k * k for k in range(1, 13))
    # the iterable went up once, 12 doubles
    assert b.td["uploads"] == 1 and b.td["upload_bytes"] == 12 * 8


def test_column_write_by_the_loop_variable():
    b = run_both("B = gpuArray(reshape(single(1:64*16), 64, 16));",
                 "for k = 1:16\n  B(:, k) = B(:, k) * k;\nend\n")
    _folded(b, 16)
    same(b, ["B"])
    want = np.arange(1, 64 * 16 + 1, dtype=np.float32).reshape(
        64, 16, order="F") * np.arange(1, 17, dtype=np.float32)
    assert np.array_equal(b.ts.get("B").host(), want)


def test_monte_carlo_fold_keeps_its_draws():
    # the counter of each step is computed on the device; the stream is
    # the one the JAX package's fold draws
    src = "M = 4096; T = 16;\n" + open("benchmarks/monte_carlo.m").read()
    b = run_both("", src)
    _folded(b, 16)
    _normals(b, ["Z"], 1e-5)
    np.testing.assert_allclose(b.ts.get("S").host(), b.js.get("S").host(),
                               rtol=1e-4)
    assert b.ts.rng.counter == b.js.rng.counter == 16 * 4096 // 2


# ------------------------------------------------- the plain Threefry stream

@pytest.mark.parametrize("ctr", [0, 12345, (1 << 32) - 3, (5 << 32) + 7,
                                 (1 << 63) + 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_plain_draw_takes_a_tensor_counter(kind, dtype, ctr):
    from runmat_tpu_torch.accel.engine import counter_value
    t = torch.tensor(counter_value(ctr), dtype=torch.int64)
    got = threefry.rng_draw(kind, (7, 9), t, 1001, dtype, "cpu")
    want = threefry.rng_draw(kind, (7, 9), ctr, 1001, dtype, "cpu")
    assert torch.equal(got, want)
    lo, hi = ctrng.split_counter(t)
    assert (int(lo), int(hi)) == ctrng.split_counter(ctr)


def test_rng_draw_refuses_a_counter_of_another_kind():
    with pytest.raises(ValueError):
        threefry.rng_draw("rand", (7, 9), torch.tensor([1, 2]), 4,
                          torch.float32, "cpu")
    with pytest.raises(ValueError):
        threefry.rng_draw("rand", (7, 9), torch.tensor(1.0), 4,
                          torch.float32, "cpu")


# ----------------------------------------------- no torch.tensor in a program

SMALL = {"benchmarks/elementwise_math.m": "points = 4096;",
         "benchmarks/monte_carlo.m": "M = 4096; T = 16;",
         "benchmarks/image_normalize.m": "B = 2; H = 32; W = 48;",
         "runmat_tpu_torch/workloads/histogram_stats.m": "N = 65536;",
         "runmat_tpu_torch/workloads/index_sets.m": "N = 65536;"}


def test_run_program_makes_no_tensor_from_a_host_scalar(monkeypatch):
    """Scalars reach a program as tensors filled on the device
    (`TorchEngine._scalar`); `torch.tensor` (on a card, a blocking copy) is
    called from no frame under `run_program` while the five scripts run."""
    calls = []
    real = torch.tensor

    def spy(*args, **kw):
        names = [f.name for f in traceback.extract_stack()]
        if "run_program" in names:
            calls.append(traceback.format_stack(limit=6))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "tensor", spy)
    for path, pre in SMALL.items():
        s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                     offload_threshold=1)
        eng = accel.active_engine()
        try:
            r = s.execute(pre + "\n" + open(path).read())
        finally:
            runmat_tpu_torch.uninstall()
        assert r.error is None, (path, r.error)
        assert eng.stats["host_fallbacks"] == 0, path
    assert calls == [], calls[0]


def test_a_program_fills_each_scalar_once():
    eng = TorchEngine("cpu", auto_offload=True, offload_threshold=1)
    filled = []
    real = eng._scalar
    eng._scalar = lambda v, dt: filled.append(v) or real(v, dt)
    x = eng.upload(MatArray(np.arange(6.0).reshape(2, 3), "double"))
    node = eng._scalar_node(np.float64(2.5), np.dtype(np.float64))
    s = MatArray.from_device(node, "double")
    y = eng.binary("mul", eng.binary("add", x, s, "double"), s, "double")
    got = eng.materialize(y.dev)
    assert filled == [2.5]                  # one node read by two ops
    assert torch.equal(got, (torch.arange(6.0).reshape(2, 3) + 2.5) * 2.5)


# ------------------------------------------- accumarray subscripts (Queue C)

def _port(src: str, device: bool):
    if device:
        s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                     offload_threshold=1)
        try:
            return s.execute(src)
        finally:
            runmat_tpu_torch.uninstall()
    return runmat_tpu_torch.Session(accelerate=False).execute(src)


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("subs,message", [
    ("[0; 1; 2; 3]", "First input SUBS must contain positive integer"),
    ("[1; 2; 4]", "ALL(MAX(SUBS)<=SZ)")])
def test_accumarray_subscript_outside_1_to_n_raises(device, subs, message):
    v = "gpuArray(ones(numel(s), 1))" if device else "ones(numel(s), 1)"
    r = _port(f"s = {subs}; a = accumarray(s, {v}, [3 1]);", device)
    assert r.error is not None and message in r.error.message, r.error


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_accumarray_in_range_still_sums(device):
    v = "gpuArray([1; 2; 3; 4])" if device else "[1; 2; 3; 4]"
    r = _port(f"a = accumarray([3; 1; 3; 2], {v}, [4 1]);"
              " fprintf('%g ', a);", device)
    assert r.error is None and r.output.split() == ["2", "4", "4", "0"]


# -------------------------------- single means and sums on the host (Queue C)

def test_single_means_and_sums_over_dims_round_once():
    """Two 2160 x 3840 single frames: mean and sum over [2 3] on the
    port's host engine are the float64 values rounded once to single."""
    s = runmat_tpu_torch.Session(accelerate=False)
    r = s.execute("rng(0); imgs = rand(2, 2160, 3840, 'single');"
                  " m = mean(imgs, [2 3], 'native'); t = sum(imgs, [2 3]);")
    assert r.error is None, r.error
    imgs = s.get("imgs").host().astype(np.float64)
    for name, want in (("m", imgs.mean(axis=(1, 2))),
                       ("t", imgs.sum(axis=(1, 2)))):
        got = s.get(name).host()
        assert got.dtype == np.float32
        assert np.array_equal(got.reshape(-1), want.astype(np.float32)), name


# -------------------------------------------- matmul precision (Queue C)

@pytest.mark.parametrize("policy", ["highest", "native", "high", "bf16",
                                    "default"])
def test_matmul_stamps_the_policy(policy, monkeypatch):
    monkeypatch.delenv("RUNMAT_TPU_MATMUL_PRECISION", raising=False)
    eng = TorchEngine("cpu", matmul_precision=policy)
    a = eng.upload(MatArray(np.ones((4, 3), np.float32), "single"))
    b = eng.upload(MatArray(np.ones((3, 5), np.float32), "single"))
    node = eng.matmul(a, b, "single").dev
    assert node.op == "matmul" and node.static == ("float32", policy)


def test_matmul_policy_follows_the_environment(monkeypatch):
    monkeypatch.setenv("RUNMAT_TPU_MATMUL_PRECISION", "HIGH")
    assert TorchEngine("cpu", matmul_precision="bf16").matmul_precision \
        == "high"
    monkeypatch.delenv("RUNMAT_TPU_MATMUL_PRECISION")
    monkeypatch.setenv("RUNMAT_TPU_ALLOW_PRECISION_DOWNCAST", "1")
    assert TorchEngine("cpu").matmul_precision == "bf16"
    monkeypatch.delenv("RUNMAT_TPU_ALLOW_PRECISION_DOWNCAST")
    assert TorchEngine("cpu").matmul_precision == "highest"


def test_init_engine_passes_the_policy_on(monkeypatch):
    from runmat_tpu_torch.accel import engine as engine_mod
    made = {}

    class Fake:
        def __init__(self, device, **kw):
            made.update(kw, device=device)

    prev = accel.active_engine()
    monkeypatch.setattr(engine_mod, "TorchEngine", Fake)
    accel.set_engine(None)
    try:
        accel.init_engine(matmul_precision="bf16")
    finally:
        accel.set_engine(prev)
    assert made["device"] == "cuda" and made["matmul_precision"] == "bf16"


@pytest.mark.parametrize("policy", ["bf16", "highest"])
def test_bf16_policy_rounds_the_operands(policy, monkeypatch):
    monkeypatch.delenv("RUNMAT_TPU_MATMUL_PRECISION", raising=False)
    rng = np.random.default_rng(3)
    ha = rng.standard_normal((16, 24)).astype(np.float32)
    hb = rng.standard_normal((24, 8)).astype(np.float32)
    eng = TorchEngine("cpu", matmul_precision=policy)
    a = eng.upload(MatArray(ha, "single"))
    b = eng.upload(MatArray(hb, "single"))
    got = eng.materialize(eng.matmul(a, b, "single").dev)
    ta, tb = torch.from_numpy(ha), torch.from_numpy(hb)
    rounded = ta.bfloat16().float() @ tb.bfloat16().float()
    if policy == "bf16":
        assert torch.equal(got, rounded)
    else:
        assert torch.equal(got, ta @ tb)
        assert not torch.equal(got, rounded)
