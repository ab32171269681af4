"""The statistics builtins on device arrays: TorchEngine (CPU) against
JaxEngine (CPU) on the same `.m` source, both engines taking every array
(`auto_offload=True, offload_threshold=1`). Inputs come from a numpy seed
and go to the device with `gpuArray`.

Each builtin here reached the port's `linalg`, `scan` or `dense` before
they existed (diff/trapz/cumsum raised, imagesc had no `dense`, histcounts
and movmean came back as host doubles); the tests hold the port to the JAX
package's value, class and residency. Tolerances: float32 rtol=1e-5 and
float64 rtol=1e-12 (scans and window sums add in another order), each with
an absolute floor of rtol times the result's largest magnitude; counts
exact.
"""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session
from runmat_tpu.values import MatArray
from runmat_tpu_torch import accel as port_accel
from runmat_tpu_torch.ops import histogram
from runmat_tpu_torch.values import MatArray as PortMatArray

OFFLOAD = dict(auto_offload=True, offload_threshold=1)
RTOL = {"single": 1e-5, "double": 1e-12}


@pytest.fixture
def restore_engine():
    prev, port_prev = accel.active_engine(), port_accel.active_engine()
    yield
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)
    port_accel.set_engine(port_prev)


def _inputs(mclass, seed=0):
    """A column with NaN (first element included), sample points, and a
    6 x 7 matrix with an all-NaN row."""
    rng = np.random.default_rng(seed)
    dt = np.float32 if mclass == "single" else np.float64
    x = rng.uniform(-2.0, 2.0, (257, 1))
    x[[0, 3, 100, 101]] = np.nan
    t = np.cumsum(rng.uniform(0.1, 1.0, (257, 1)), axis=0)
    m = rng.uniform(-2.0, 2.0, (6, 7))
    m[2, :] = np.nan
    m[4, 0] = np.nan
    return {"x": MatArray(x.astype(dt), mclass),
            "t": MatArray(t.astype(dt), mclass),
            "M": MatArray(m.astype(dt), mclass)}


def _run(make_session, src, inputs):
    s, eng = make_session()
    cls = PortMatArray if isinstance(eng, runmat_tpu_torch.TorchEngine) \
        else MatArray
    for k, v in inputs.items():
        s.set(k, cls(v.host().copy(), v.mclass))
    r = s.execute("xd = gpuArray(x); td = gpuArray(t); Md = gpuArray(M);\n"
                  + src)
    assert r.error is None, r.error
    return s, eng


def _jax():
    eng = JaxEngine(platform="cpu", **OFFLOAD)
    accel.set_engine(eng)
    return Session(accelerate=True), eng


def _torch():
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    return s, port_accel.active_engine()


def _both(src, inputs):
    js, _ = _run(_jax, src, inputs)
    ts, teng = _run(_torch, src, inputs)
    return js, ts, teng


EXPRS = ["diff(xd)", "diff(xd, 2)", "diff(Md, 1, 2)", "diff(Md)",
         "trapz(xd)", "trapz(td, xd)", "trapz(Md)",
         "cumsum(xd)", "cumsum(xd, 'omitnan')", "cumsum(xd, 'reverse')",
         "cumsum(Md, 2, 'omitnan')", "cumprod(xd)", "cumprod(xd, 'omitnan')",
         "cumprod(Md)", "cummax(xd)", "cummin(xd)", "cummax(Md, 2)",
         "cummin(Md)",
         "movmean(xd, 5)", "movmean(xd, 4)", "movsum(xd, 3)",
         "movmax(xd, 6)", "movmin(xd, 5)", "movmean(td', 7)"]


@pytest.mark.parametrize("mclass", ["single", "double"])
@pytest.mark.parametrize("expr", EXPRS)
def test_builtin_on_device_matches_jax_engine(restore_engine, expr, mclass):
    js, ts, teng = _both(f"y = {expr};", _inputs(mclass))
    want, got = js.get("y"), ts.get("y")
    assert got.on_device and want.on_device
    assert got.mclass == want.mclass
    w, g = want.host(), got.host()
    assert g.shape == w.shape and g.dtype == w.dtype
    scale = float(np.nanmax(np.abs(w), initial=0.0))
    rtol = RTOL[mclass]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale)
    assert teng.stats["host_fallbacks"] == 0


@pytest.mark.parametrize("mclass", ["single", "double"])
def test_histcounts_returns_device_counts_of_the_data_class(restore_engine,
                                                          monkeypatch,
                                                          mclass):
    # single(...) edges keep a single x in f32 (affine edges: direct index)
    # and make the counts single; double edges promote the work to f64 and
    # the counts keep x's class
    src = ("c1 = histcounts(xd, single(-2:0.25:2));\n"
           "c2 = histcounts(xd, [-2 -0.3 0.1 0.1 1 2]);\n"
           "c3 = histcounts(Md, linspace(-2, 2, 300));\n")
    js, _ = _run(_jax, src, _inputs(mclass))
    wrapped, bins = histogram.histcounts, []

    def spy(x, edges, affine=None):
        bins.append((edges.numel() - 1, affine))
        return wrapped(x, edges, affine)
    monkeypatch.setattr(histogram, "histcounts", spy)
    ts, teng = _run(_torch, src, _inputs(mclass))
    for k, cls in (("c1", "single"), ("c2", mclass), ("c3", mclass)):
        want, got = js.get(k), ts.get(k)
        assert got.on_device and got.mclass == want.mclass == cls, k
        w, g = want.host(), got.host()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k
    # every call goes through the kernel's wrapper, 299 bins included
    affine = (2, -8) if mclass == "single" else None
    assert bins == [(16, affine), (5, None), (299, None)]
    assert teng.stats["host_fallbacks"] == 0


def test_imagesc_of_a_device_array_runs(restore_engine):
    # imagesc's builtin module (plotting) is not copied into the port yet
    # (ROADMAP A16); the colormap call it makes on a device array declines
    # in the engine, counted because the operand is on the device, so
    # imagesc will take its host path once it is copied
    s, eng = _run(_torch, "", _inputs("double"))
    r = s.execute("imagesc(Md);")
    assert r.error.identifier == "MATLAB:UndefinedFunction"
    d = s.get("Md")
    assert eng.dense.call("cmap", [d], ("parula",)) is None
    assert eng.stats["host_fallbacks"] == 1
    assert any(e["cat"] == "host_fallback" and e["ops"] == ["cmap"]
               for e in eng.launch_log)


def test_inv_of_a_device_matrix_declines_with_one_fallback(restore_engine):
    s, eng = _run(_torch, "", _inputs("double"))
    d = s.get("Md")
    assert d.on_device
    before = eng.stats["host_fallbacks"]
    assert eng.route_linalg(d) is True
    # inv has a builder since the linalg slice (tests/test_torch_linalg.py),
    # topk since breadth4 was copied; cmap (ROADMAP: plotting.py) has none
    # yet and declines
    assert eng.linalg("cmap", [d], ("parula",)) is None
    assert eng.stats["host_fallbacks"] == before + 1
