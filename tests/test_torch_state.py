"""carry_session: a session of the JAX package started under JaxEngine and
continued in the port draws the same continuation of the RNG stream; the
port's state module converts values of either package and numpy arrays
without importing the JAX package.

Tolerances: carried arrays exact; the f32 normals of the continuation
atol=rtol=2e-6 (libm); RNG counters equal."""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session
from runmat_tpu.values import MatArray as JaxMatArray
from runmat_tpu_torch import accel as port_accel
from runmat_tpu_torch.state import carry_session, to_matarray, to_numpy
from runmat_tpu_torch.values import MatArray

OFFLOAD = dict(auto_offload=True, offload_threshold=1)


@pytest.fixture
def restore_engine():
    prev, port_prev = accel.active_engine(), port_accel.active_engine()
    yield
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)
    port_accel.set_engine(port_prev)


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
    assert port_accel.active_engine() is None
    assert js.execute(nxt).error is None
    assert ts.rng.counter == js.rng.counter
    np.testing.assert_allclose(ts.get("c").host(), js.get("c").host(),
                               rtol=2e-6, atol=2e-6)


def test_values_cross_as_the_ports_own():
    h = np.arange(6, dtype=np.float32).reshape(2, 3)
    for src in (h, JaxMatArray(h.copy(), "single"), MatArray(h.copy(),
                                                               "single")):
        v = to_matarray(src)
        assert type(v) is MatArray and v.mclass == "single"
        assert np.array_equal(to_numpy(v), h)
    # a copy: writing the carried array leaves the source alone
    out = to_numpy(to_matarray(h))
    out[0, 0] = 99
    assert h[0, 0] == 0
    assert to_matarray(np.array([[True]])).mclass == "logical"


def test_sparse_matrices_and_meshes_cross_as_the_ports_own(restore_engine):
    from runmat_tpu_torch.fea.mesh import TetMesh
    from runmat_tpu_torch.sparse import SparseMatrix
    accel.set_engine(None)
    js = Session(accelerate=False)
    assert js.execute("A = sparse([1 2 3 3], [1 2 3 1], [4 5 6 1], 3, 3);"
                      " m = femesh([2 1 1], [2 1 1]);").error is None
    ts = runmat_tpu_torch.session("cpu")
    carry_session(js, ts)
    A, m = ts.get("A"), ts.get("m")
    assert type(A) is SparseMatrix and type(m) is TetMesh
    jA, jm = js.get("A"), js.get("m")
    assert (A.m, A.n, A.mclass) == (jA.m, jA.n, jA.mclass)
    for name in ("indptr", "rowind", "data"):
        assert np.array_equal(getattr(A, name), getattr(jA, name))
        assert getattr(A, name) is not getattr(jA, name)
    assert np.array_equal(m.nodes, jm.nodes) and m.nodes is not jm.nodes
    assert np.array_equal(m.tets, jm.tets) and tuple(m.dims) == \
        tuple(jm.dims) and tuple(m.shape) == tuple(jm.shape)
    # the port's own builtins take them: its isinstance checks see its class
    r = ts.execute("B = A' * 2; z = issparse(B); f = full(A \\ [1; 2; 3]);"
                   " i = femesh_info(m); n = i.elements;")
    assert r.error is None, r.error
    assert bool(np.asarray(ts.get("z").host()).reshape(-1)[0])
    assert float(np.asarray(ts.get("n").host()).reshape(-1)[0]) == 12.0
