"""carry_session: a session of the JAX package started under JaxEngine and
continued in the port draws the same continuation of the RNG stream; the
port's state module converts values of either package and numpy arrays
without importing the JAX package. Each kind of workspace value (datetime,
duration, calendarDuration, categorical, dictionary, table, timetable,
value and handle objects with their classes, cells, structs, strings and
function handles) crosses as the port's own: no object of a JAX-package
class is left under it, its values equal the JAX package's exactly, a
script continued in the port prints and computes what the JAX session
does, a shared handle stays shared, and a value the port cannot carry
raises.

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


# (id, the JAX session's source, a source that uses the carried values)
KINDS = [
    ("datetime", "d = datetime(2026, 1, 1) + days(0:2)';",
     "d2 = d + hours(6); y = year(d2); s = datestr(d2(2)); b = isbusday(d);"),
    ("duration", "du = hours([1 2.5]); dm = minutes(90);",
     "t = du + dm; h = hours(t);"),
    ("calendarDuration", "cm = calmonths(2); cdd = caldays(3);",
     "d = datetime(2026, 1, 31) + cm + cdd; v = datevec(d);"),
    ("categorical", "c = categorical({'red', 'blue', 'red'});",
     "m = c == 'red'; k = categories(c); n = countcats(c);"),
    ("dictionary", "k = dictionary([\"a\" \"b\"], [1 2]);",
     "x = k(\"b\"); k(\"c\") = 9; n = k.numEntries;"),
    ("table", "T = array2table([3 1; 1 2; 2 3], 'VariableNames', {'a', 'b'});",
     "S = sortrows(T, 'a'); h = height(S); b = S.b; A = table2array(T);"),
    ("timetable", "tt = timetable(datetime(2024,1,1) + hours([1 2 25])',"
                  " [2; 4; 10]);",
     "w = retime(tt, 'daily', 'mean'); v = w.Var1; q = istimetable(w);"),
    ("value-object",
     "classdef Pt\nproperties\nx = 0\nend\nmethods\nfunction obj = Pt(a)\n"
     "obj.x = a;\nend\nfunction d = twice(obj)\nd = 2 * obj.x;\nend\nend\n"
     "end\n|p = Pt(4);",
     "q = p; q.x = 7; a = p.twice(); b = q.twice(); k = class(p);"),
    ("handle-object",
     "classdef Acc < handle\nproperties\ntotal = 0\nend\nmethods\n"
     "function add(obj, x)\nobj.total = obj.total + sum(x(:));\nend\nend\n"
     "end\n|a = Acc(); a.add([1 2]); b = a;",
     "b.add(5); t = a.total; h = isa(a, 'handle');"),
    ("cell-struct-string",
     "c = {1, 'two', {datetime(2026, 2, 3)}}; s.a = [1 2]; s.t = \"txt\";"
     " st = [\"x\" \"y\"]; f = @(z) z + s.a;",
     "c2 = c{3}{1} + days(1); w = f(1); u = upper(st); n = numel(c);"),
]


def _carried(setup: str):
    accel.set_engine(None)
    js = Session(accelerate=False)
    for part in setup.split("|"):
        assert js.execute(part).error is None, part
    from runmat_tpu_torch.session import Session as PortSession
    port_accel.set_engine(None)
    ts = PortSession(accelerate=False)
    carry_session(js, ts)
    return js, ts


def _jax_objects(v, path, seen, found):
    """Every object under `v` whose class lives in the JAX package."""
    if id(v) in seen:
        return
    seen.add(id(v))
    mod = type(v).__module__
    if mod == "runmat_tpu" or mod.startswith("runmat_tpu."):
        found.append((path, type(v)))
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            for i, x in np.ndenumerate(v):
                _jax_objects(x, f"{path}{list(i)}", seen, found)
        return
    if isinstance(v, (list, tuple, set, frozenset)):
        for i, x in enumerate(v):
            _jax_objects(x, f"{path}[{i}]", seen, found)
        return
    if isinstance(v, dict):
        for k, x in v.items():
            _jax_objects(k, f"{path}.key", seen, found)
            _jax_objects(x, f"{path}[{k!r}]", seen, found)
        return
    for k in type(v).__mro__:
        sl = k.__dict__.get("__slots__", ())
        for n in ((sl,) if isinstance(sl, str) else sl):
            if hasattr(v, n) and n not in ("__dict__", "__weakref__"):
                _jax_objects(getattr(v, n), f"{path}.{n}", seen, found)
    for n, x in getattr(v, "__dict__", {}).items():
        _jax_objects(x, f"{path}.{n}", seen, found)


@pytest.mark.parametrize("kind,setup,use", KINDS, ids=[k for k, _, _ in KINDS])
def test_each_kind_of_value_crosses_as_the_ports_own(restore_engine, kind,
                                                     setup, use):
    """A workspace of the JAX package carried into the port holds no object
    of a JAX-package class, the values equal the JAX package's, and a script
    continued in the port computes what the JAX session computes."""
    from torch_paired import same_value
    js, ts = _carried(setup)
    found = []
    for n, v in ts.base_frame.vars.items():
        _jax_objects(v, n, set(), found)
    for n, c in ts.classes.items():
        _jax_objects(c, "class " + n, set(), found)
    assert found == [], found
    assert sorted(ts.workspace_names()) == sorted(js.workspace_names())
    for n in js.workspace_names():
        same_value(js.get(n), ts.get(n), n)
    assert sorted(ts.classes) == sorted(js.classes)
    rj, rt = js.execute(use), ts.execute(use)
    assert rj.error is None and rt.error is None, (rj.error, rt.error)
    assert rt.output == rj.output
    for n in js.workspace_names():
        same_value(js.get(n), ts.get(n), n)


def test_a_shared_handle_stays_shared(restore_engine):
    js, ts = _carried(KINDS[8][1])
    assert ts.get("a") is ts.get("b")
    assert ts.get("a").cls is ts.classes["Acc"]


def test_a_value_the_port_cannot_carry_raises(restore_engine):
    accel.set_engine(None)
    js = Session(accelerate=False)
    assert js.execute("g = onCleanup(@() disp(1));").error is None
    from runmat_tpu_torch.session import Session as PortSession
    with pytest.raises(TypeError, match="cannot be carried"):
        carry_session(js, PortSession(accelerate=False))
    js.base_frame.vars.clear()   # no cleanup output at exit


def test_an_fea_study_and_run_cross_as_the_ports_own(restore_engine,
                                                     monkeypatch, tmp_path):
    """A study, its model and a thermal run result made by the JAX package
    (structs tagged by `_fea`, holding a material, conditions, a mesh and
    the fields) carry into the port, and fea.validate, fea.plan, fea.field
    and fea.plot there give the JAX package's answers on them."""
    from torch_paired import fresh_state, same_value
    monkeypatch.setenv("HOME", str(tmp_path))
    fresh_state()
    try:
        js, ts = _carried(
            "geom.box = [1 0.5 0.5]; geom.resolution = 4;"
            " mat = fea.material('k', 45);"
            " bc = fea.boundaryCondition('temperature', 'x=min', 300);"
            " model = fea.model(geom, mat, bc);"
            " study = fea.study(model, 'thermal'); r = fea.run(study);")
        found = []
        for n, v in ts.base_frame.vars.items():
            _jax_objects(v, n, set(), found)
        assert found == [], found
        use = ("val = fea.validate(study); ok = val.valid; p = fea.plan(study);"
               " ne = p.numElements; nd = p.dofs;"
               " T = fea.field(r, 'temperature'); q = fea.field(r, 'flux');"
               " m = fea.plot(r, 'temperature'); close all;")
        rj, rt = js.execute(use), ts.execute(use)
        assert rj.error is None and rt.error is None, (rj.error, rt.error)
        assert rt.output == rj.output
        assert sorted(ts.workspace_names()) == sorted(js.workspace_names())
        for n in js.workspace_names():
            same_value(js.get(n), ts.get(n), n)
        assert bool(ts.get("ok").host()[0, 0])
        assert ts.get("m").host().shape == (ts.get("T").host().size, 1)
    finally:
        fresh_state()
