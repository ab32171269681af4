"""The slice end to end: the three reference workloads at small sizes under
JaxEngine (CPU) and under the port's TorchEngine (CPU), same `.m` source,
both engines taking every array (`auto_offload=True, offload_threshold=1`).

Tolerances: CHECK and MSE rtol=1e-5 (f32 sums in another order); PRICE
rtol=1e-4, because the f32 `exp` step compounds over T iterations. Workspace
arrays are held to their workload's rtol, element by element and also
scaled by the array's largest magnitude (payoff = max(S - K, 0) cancels
S ~ 100 down to small values, which keep S's absolute error).
"""

import re

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session
from runmat_tpu.values import MatArray

SMALL = {"elementwise_math": "points = 4096;",
         "monte_carlo": "M = 4096; T = 16;",
         "image_normalize": "B = 2; H = 32; W = 48;"}
RESULT = {"elementwise_math": ("CHECK", "checksum", 1e-5),
          "monte_carlo": ("PRICE", "price", 1e-4),
          "image_normalize": ("MSE", "mse", 1e-5)}
OFFLOAD = dict(auto_offload=True, offload_threshold=1)


@pytest.fixture
def restore_engine():
    prev = accel.active_engine()
    yield
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)


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
    teng = accel.active_engine()
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
             if isinstance(v, MatArray) and v.size > 1]
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
