"""carry_session: a session started under JaxEngine and continued in the port
draws the same continuation of the RNG stream.

Tolerances: carried arrays exact; the f32 normals of the continuation
atol=rtol=2e-6 (libm); RNG counters equal."""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session
from runmat_tpu_torch.state import carry_session

OFFLOAD = dict(auto_offload=True, offload_threshold=1)


@pytest.fixture
def restore_engine():
    prev = accel.active_engine()
    yield
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)


def test_port_continues_the_jax_sessions_stream(restore_engine):
    jeng = JaxEngine(platform="cpu", **OFFLOAD)
    accel.set_engine(jeng)
    js = Session(accelerate=True)
    assert js.execute("rng(7); a = rand(300,1); b = randn(5,5);").error is None

    ts = runmat_tpu_torch.session("cpu", **OFFLOAD)
    carry_session(js, ts)
    assert ts.rng.state_tuple() == js.rng.state_tuple()
    for k in ("a", "b"):
        assert np.array_equal(ts.get(k).host(), js.get(k).host())
    nxt = "c = randn(4096,1,'single');"
    assert ts.execute(nxt).error is None
    assert ts.get("c").on_device
    runmat_tpu_torch.uninstall()

    assert accel.active_engine() is jeng
    assert js.execute(nxt).error is None
    assert ts.rng.counter == js.rng.counter
    np.testing.assert_allclose(ts.get("c").host(), js.get("c").host(),
                               rtol=2e-6, atol=2e-6)
