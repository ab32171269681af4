"""The slice end to end: the three reference workloads at small sizes under
JaxEngine (CPU) and under the port's TorchEngine (CPU), same `.m` source,
both engines taking every array (`auto_offload=True, offload_threshold=1`).

The port runs its own host layers (a package of its own); the JAX package's
`Session` runs on JaxEngine. Tolerances: CHECK and MSE rtol=1e-5 (f32 sums
in another order); PRICE rtol=1e-4, because the f32 `exp` step compounds
over T iterations. Workspace arrays are held to their workload's rtol,
element by element and also scaled by the array's largest magnitude (payoff
= max(S - K, 0) cancels S ~ 100 down to small values, which keep S's
absolute error).

The statistics slice, `runmat_tpu_torch/workloads/histogram_stats.m` at N =
65536: HIST rtol=1e-5 (f32 sums in another order). Counts are exact: `cu`
(of uniforms, which both engines draw bit for bit) equals JaxEngine's, and
`cz`, `cq` equal `np.histogram` of each engine's own draws. Between the
engines `cz` and `cq` may differ by 1 per bin, because normals agree across
backends only to a few ulp and a draw within an ulp of an edge may land on
either side.

The indexing slice, `runmat_tpu_torch/workloads/index_sets.m` at N = 65536:
RANK rtol=1e-5; one `for` fold and one `while` fold, no host fallback;
sort, unique, counts, membership and the column writes equal numpy of each
package's own data exactly, and each other's where the data are equal.
"""

import re

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session
from runmat_tpu.values import MatArray as JaxMatArray
from runmat_tpu_torch import accel as port_accel
from runmat_tpu_torch.values import MatArray as PortMatArray

SMALL = {"elementwise_math": "points = 4096;",
         "monte_carlo": "M = 4096; T = 16;",
         "image_normalize": "B = 2; H = 32; W = 48;"}
RESULT = {"elementwise_math": ("CHECK", "checksum", 1e-5),
          "monte_carlo": ("PRICE", "price", 1e-4),
          "image_normalize": ("MSE", "mse", 1e-5)}
OFFLOAD = dict(auto_offload=True, offload_threshold=1)


@pytest.fixture
def restore_engine():
    prev, port_prev = accel.active_engine(), port_accel.active_engine()
    yield
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)
    port_accel.set_engine(port_prev)


def _source(workload: str) -> str:
    with open(f"benchmarks/{workload}.m") as f:
        return SMALL[workload] + "\n" + f.read()


def _printed(output: str, label: str) -> float:
    m = re.search(rf"RESULT_ok {label}=(\S+)", output)
    assert m, output
    return float(m.group(1))


def _run_both(workload: str):
    src = _source(workload)
    jeng = JaxEngine(platform="cpu", **OFFLOAD)
    accel.set_engine(jeng)
    js = Session(accelerate=True)
    jr = js.execute(src)
    ts = runmat_tpu_torch.session("cpu", **OFFLOAD)
    teng = port_accel.active_engine()
    tr = ts.execute(src)
    runmat_tpu_torch.uninstall()
    assert jr.error is None and tr.error is None, (jr.error, tr.error)
    return (js, jr, jeng), (ts, tr, teng)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_workload_matches_jax_engine(restore_engine, workload):
    (js, jr, _), (ts, tr, teng) = _run_both(workload)
    label, var, rtol = RESULT[workload]
    np.testing.assert_allclose(_printed(tr.output, label),
                               _printed(jr.output, label), rtol=rtol)
    np.testing.assert_allclose(ts.get(var).host(), js.get(var).host(),
                               rtol=rtol)
    assert teng.stats["host_fallbacks"] == 0
    assert isinstance(teng, runmat_tpu_torch.TorchEngine)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_workspace_arrays_match_and_stay_on_device(restore_engine, workload):
    (js, _, _), (ts, _, _) = _run_both(workload)
    rtol = RESULT[workload][2]
    names = [k for k, v in ts.base_frame.vars.items()
             if isinstance(v, PortMatArray) and v.size > 1]
    assert names
    for k in names:
        v = ts.get(k)
        assert v.on_device, k
        want = js.get(k).host()
        got = v.host()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        scale = float(np.nanmax(np.abs(want[np.isfinite(want)]), initial=0))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


def test_monte_carlo_loop_folds_in_both(restore_engine):
    (js, _, jeng), (ts, _, teng) = _run_both("monte_carlo")
    assert teng.stats["loop_folds"] == 1
    assert teng.stats["loop_bails"] == 0
    assert jeng.stats["loop_trace_attempts"] == 1
    assert any(k[0] == "device_loop" for k in jeng._jit_cache)
    # the stream advanced by T draws of M/2 blocks in both
    assert ts.rng.counter == js.rng.counter == 16 * 4096 // 2


HIST_SRC = "N = 65536;\n" + open(
    "runmat_tpu_torch/workloads/histogram_stats.m").read()
HIST_DATA = {"cu": ("u", np.arange(129) / 128),
             "cz": ("z", np.arange(-40, 41) / 10),
             "cq": ("z .* z", [0, 0.25, 0.5, 1, 2, 4, 8, 16])}


def _run_hist():
    jeng = JaxEngine(platform="cpu", **OFFLOAD)
    accel.set_engine(jeng)
    js = Session(accelerate=True)
    jr = js.execute(HIST_SRC)
    ts = runmat_tpu_torch.session("cpu", **OFFLOAD)
    teng = port_accel.active_engine()
    tr = ts.execute(HIST_SRC)
    runmat_tpu_torch.uninstall()
    assert jr.error is None and tr.error is None, (jr.error, tr.error)
    return (js, jr, jeng), (ts, tr, teng)


def _own_histogram(s, name):
    """np.histogram of the session's own data over the script's edges, in
    the edges' f32 or f64 values as the script gives them."""
    expr, edges = HIST_DATA[name]
    z = s.get("z").host().astype(np.float64).reshape(-1)
    data = {"u": s.get("u").host().astype(np.float64).reshape(-1), "z": z,
            "z .* z": (s.get("z").host() * s.get("z").host()).astype(
                np.float64).reshape(-1)}[expr]
    e = np.asarray(edges, np.float64)
    if name != "cq":
        e = e.astype(np.float32).astype(np.float64)
    return np.histogram(data, bins=e)[0]


def test_histogram_stats_matches_jax_engine(restore_engine):
    (js, jr, _), (ts, tr, teng) = _run_hist()
    np.testing.assert_allclose(_printed(tr.output, "HIST"),
                               _printed(jr.output, "HIST"), rtol=1e-5)
    np.testing.assert_allclose(ts.get("res").host(), js.get("res").host(),
                               rtol=1e-5)
    assert np.array_equal(ts.get("cu").host(), js.get("cu").host())
    for name in ("cu", "cz", "cq"):
        for s in (js, ts):
            c = s.get(name)
            assert c.mclass == "single", name
            h = c.host()
            assert h.dtype == (np.float64 if name == "cq" else np.float32)
            assert np.array_equal(h.reshape(-1),
                                  _own_histogram(s, name).astype(h.dtype))
        assert np.abs(ts.get(name).host() - js.get(name).host()).max() <= 1
    st = teng.stats
    assert st["host_fallbacks"] == 0


def test_histogram_stats_device_arrays(restore_engine):
    (js, _, _), (ts, _, teng) = _run_hist()
    # the JAX package's histcounts gathers its input before it routes, so u
    # and z come back to the host there; the port's routes first and keeps
    # them on the device, copying only scalars and edges
    assert not js.get("u").on_device and not js.get("z").on_device
    assert ts.get("u").on_device and ts.get("z").on_device
    assert teng.stats["gather_bytes"] < 1024
    assert teng.stats["upload_bytes"] < 4096
    for s in (js, ts):
        for k in ("cu", "cz", "cq", "pz", "Fz", "sm", "dF"):
            assert s.get(k).on_device, k
    for k in ("pz", "Fz", "sm", "dF", "area", "chi2"):
        want, got = js.get(k).host(), ts.get(k).host()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        scale = float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)


INDEX_SRC = "N = 65536;\n" + open(
    "runmat_tpu_torch/workloads/index_sets.m").read()


def _stable_descend(x):
    """numpy's stable descending sort: the ascending sort of the reversed
    vector, mapped back (NaN first, ties in order)."""
    n = x.size
    ia = np.argsort(x[::-1], kind="stable")
    return ((n - 1) - ia)[::-1]


def test_index_sets_matches_jax_engine(restore_engine):
    """index_sets.m at N = 65536: RANK within rtol 1e-5; the normals agree
    across the packages to an ulp, so s and B are held to rtol 1e-5 between
    them and exactly to numpy of each package's own x; the integer results
    (q's levels, their counts, the membership mask) are equal exactly."""
    jeng = JaxEngine(platform="cpu", **OFFLOAD)
    accel.set_engine(jeng)
    js = Session(accelerate=True)
    jr = js.execute(INDEX_SRC)
    ts = runmat_tpu_torch.session("cpu", **OFFLOAD)
    teng = port_accel.active_engine()
    tr = ts.execute(INDEX_SRC)
    runmat_tpu_torch.uninstall()
    assert jr.error is None and tr.error is None, (jr.error, tr.error)
    st = teng.stats
    assert st["loop_folds"] == 1 and st["while_folds"] == 1
    assert st["loop_bails"] == 0 and st["host_fallbacks"] == 0
    assert jeng.stats["host_fallbacks"] == 0
    assert any(k[0] == "device_loop" for k in jeng._jit_cache)
    assert any(k[0] == "device_while" for k in jeng._jit_cache)
    (w,) = [e for e in teng.launch_log if e["cat"] == "device_while"]
    assert w["iterations"] > 0
    names = [k for k, v in js.base_frame.vars.items()
             if isinstance(v, JaxMatArray) and v.size > 1]
    assert {"s", "i", "u", "ic", "cnt", "tf", "B", "P", "L", "R"} <= set(names)
    for k in names:
        assert ts.get(k).on_device == js.get(k).on_device, k
    np.testing.assert_allclose(_printed(tr.output, "RANK"),
                               _printed(jr.output, "RANK"), rtol=1e-5)
    np.testing.assert_allclose(ts.get("res").host(), js.get("res").host(),
                               rtol=1e-5)
    for s in (js, ts):
        x = s.get("x").host().reshape(-1)
        i = _stable_descend(x)
        assert np.array_equal(s.get("i").host().reshape(-1), i + 1)
        assert np.array_equal(s.get("s").host().reshape(-1), x[i])
        q = s.get("q").host().reshape(-1)
        u, ia, ic, cnt = np.unique(q, return_index=True, return_inverse=True,
                                   return_counts=True)
        assert np.array_equal(s.get("u").host().reshape(-1), u)
        assert np.array_equal(s.get("ia").host().reshape(-1), ia + 1)
        assert np.array_equal(s.get("ic").host().reshape(-1),
                              ic.reshape(-1) + 1)
        assert np.array_equal(s.get("cnt").host().reshape(-1), cnt)
        lv = np.arange(-8, 9, 2, dtype=np.float32)
        assert np.array_equal(s.get("tf").host().reshape(-1), np.isin(q, lv))
        A = x.reshape(4096, -1, order="F").copy()
        A[:, 1::2] = -A[:, 1::2]
        B = np.roll(np.flip(A, 0), 7, axis=1)[:, :16]
        B = B * np.arange(1, 17, dtype=np.float32)
        assert np.array_equal(s.get("B").host()[:, :16], B)
    np.testing.assert_allclose(ts.get("s").host(), js.get("s").host(),
                               rtol=1e-5, atol=1e-6)
    for k in ("u", "ia", "ic", "cnt", "tf", "both", "only", "un", "med",
              "mo", "q"):
        g, w = ts.get(k).host(), js.get(k).host()
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    scale = float(np.max(np.abs(js.get("B").host())))
    np.testing.assert_allclose(ts.get("B").host(), js.get("B").host(),
                               rtol=1e-5, atol=1e-5 * scale)
