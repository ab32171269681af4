"""The loop seam: `runmat_tpu_torch.install` rebinds
`runmat_tpu.accel.loops.try_device_loop`/`try_device_while`; under any other
engine the rebound functions delegate to the originals, and `uninstall`
restores the originals and the previous engine."""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel
from runmat_tpu.accel import loops as jloops
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session

OFFLOAD = dict(auto_offload=True, offload_threshold=1)
MONTE_CARLO = "M = 4096; T = 16;\n" + open("benchmarks/monte_carlo.m").read()
WHILE = "x = ones(64, 1); k = 0; while sum(x) > 1, x = x / 2; k = k + 1; end"


@pytest.fixture
def restore_engine():
    prev = accel.active_engine()
    orig = (jloops.try_device_loop, jloops.try_device_while)
    yield orig
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)


def test_jax_engine_folds_through_the_original(restore_engine):
    orig_for, orig_while = restore_engine
    runmat_tpu_torch.install("cpu")
    assert jloops.try_device_loop is not orig_for
    jeng = JaxEngine(platform="cpu", **OFFLOAD)
    accel.set_engine(jeng)
    r = Session(accelerate=True).execute(MONTE_CARLO)
    assert r.error is None and "RESULT_ok PRICE=" in r.output
    assert jeng.stats["loop_trace_attempts"] == 1
    assert any(k[0] == "device_loop" for k in jeng._jit_cache)
    runmat_tpu_torch.uninstall()
    assert jloops.try_device_loop is orig_for
    assert jloops.try_device_while is orig_while


def test_uninstall_restores_the_previous_engine(restore_engine):
    before = accel.active_engine()
    eng = runmat_tpu_torch.install("cpu")
    assert accel.active_engine() is eng
    runmat_tpu_torch.uninstall()
    assert accel.active_engine() is before


def test_while_loop_is_left_to_the_interpreter(restore_engine):
    host = Session(accelerate=False)
    prev = accel.active_engine()
    accel.set_engine(None)
    try:
        assert host.execute(WHILE).error is None
    finally:
        accel.set_engine(prev)
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    eng = accel.active_engine()
    r = s.execute(WHILE)
    assert r.error is None
    assert eng.stats["while_not_ported"] == 1
    assert eng.stats["loop_bails"] == 0
    assert np.array_equal(s.get("x").host(), host.get("x").host())
    assert s.get("k").host().item() == host.get("k").host().item() == 6


def test_a_failed_fold_is_counted_with_its_reason(restore_engine):
    # an indexed write into a device array needs index_write, not ported
    # yet: the fold bails on record, and the interpreter's own write raises
    # rather than computing on the host
    src = "x = zeros(1, 16); for t = 1:16, x(t) = t * 2; end"
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    eng = accel.active_engine()
    with pytest.raises(NotImplementedError, match="index_write"):
        s.execute(src)
    assert eng.stats["loop_bails"] == 1
    assert eng.stats["loop_folds"] == 0
    reasons = [e["reason"] for e in eng.launch_log if e["cat"] == "loop_bail"]
    assert reasons and "not ported yet" in reasons[0]
