"""The records path (`runmat_tpu_torch/workloads/sensor_log.m`) and the
values of the datetime, classdef, file and table modules on an engine,
held to the JAX package on the CPU.

sensor_log.m at D = 3 days, F = 1024 samples a day, C = 4 channels runs
through both packages' host sessions and through both engines
(`torch_both.run_both`: JaxEngine("cpu") and TorchEngine("cpu") taking
every array), each printing SENSOR, a checksum of the daily statistics,
the histograms, the weekly means and the file round trips; every SENSOR
is held within 1e-9 relative of the JAX host session's (the tolerance
for double sums in another order), the daily statistics within
1e-12 of their largest magnitude, and the counts, the flags and the
report exactly. A handle class accumulating `sum(x(:))` of an engine
array, a table of engine arrays and a MAT file of engine arrays are held
to the JAX package the same way.
"""

import re

import numpy as np
import pytest

from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch.session import Session as PortSession
from torch_both import close, no_engine, run_both, same  # noqa: F401
from torch_paired import same_value

SMALL = "D = 3; F = 1024; C = 4;"
SENSOR_RTOL = 1e-9
STATS_TOL = 1e-12

with open("runmat_tpu_torch/workloads/sensor_log.m") as f:
    SENSOR = f.read()

ACC = ("classdef Acc < handle\nproperties\ntotal = 0\nn = 0\nend\nmethods\n"
       "function add(obj, x)\nobj.total = obj.total + sum(x(:));\n"
       "obj.n = obj.n + numel(x);\nend\nend\nend\n")


def _sensor(output: str) -> float:
    (v,) = re.findall(r"RESULT_ok SENSOR=(\S+)", output)
    return float(v)


def _near(want, got, tol=STATS_TOL):
    w, g = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
    assert float(np.abs(g - w).max(initial=0.0)) <= tol * scale


def _table_values(t) -> np.ndarray:
    return np.hstack([np.asarray(c.host(), np.float64) for c in t.cols])


def test_sensor_log_host_sessions_agree(no_engine):
    """The port's host session against the JAX package's: SENSOR within
    1e-9, the day statistics within 1e-12 of their largest magnitude (the
    port's host reshape returns a copy, the JAX package's a view, and numpy
    sums the two layouts in another order), everything else exact."""
    outs = []
    for S in (JaxSession, PortSession):
        s = S(accelerate=False)
        r = s.execute(SMALL + "\n" + SENSOR)
        assert r.error is None, r.error
        outs.append((s, r.output))
    (js, jo), (ts, to) = outs
    want = _sensor(jo)
    assert abs(_sensor(to) - want) <= SENSOR_RTOL * abs(want)
    for n in ("mu", "sd"):
        _near(js.get(n).host(), ts.get(n).host())
    for n in ("Ts", "W"):
        _near(_table_values(js.get(n)), _table_values(ts.get(n)))
        assert ts.get(n).varnames == js.get(n).varnames
    for n in ("mx", "n64", "n32", "csv_ok", "mat_ok", "day", "bus", "txt"):
        same_value(js.get(n), ts.get(n), n)
    assert ts.get("csv_ok").host()[0, 0] and ts.get("mat_ok").host()[0, 0]


def test_sensor_log_engines_agree_with_the_host():
    b = run_both(SMALL, SENSOR)
    host = JaxSession(accelerate=False).execute(SMALL + "\n" + SENSOR)
    want = _sensor(host.output)
    for r in (b.jr, b.tr):
        assert abs(_sensor(r.output) - want) <= SENSOR_RTOL * abs(want)
    close(b, ["mu", "sd", "mx"], STATS_TOL)
    same(b, ["n64", "n32", "csv_ok", "mat_ok"])
    assert b.ts.get("x").on_device and b.ts.get("x").mclass == "double"
    assert b.td["host_fallbacks"] == 0
    # the weekly means and the report of the engine run
    _near(_table_values(b.js.get("W")), _table_values(b.ts.get("W")))
    assert b.ts.get("txt").to_str() == b.js.get("txt").to_str()


def test_sensor_log_writes_nothing_it_keeps(tmp_path, monkeypatch):
    """The script's files go under tempname and are deleted."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    s = PortSession(accelerate=False)
    assert s.execute(SMALL + "\n" + SENSOR).error is None
    assert list(tmp_path.iterdir()) == []


def test_a_handle_class_sums_engine_arrays():
    src = ("rng(2); a = Acc(); x = randn(64, 8); a.add(x); a.add(x * 2);"
           " t = a.total; n = a.n;")
    b = run_both(ACC, src)
    close(b, ["t"], STATS_TOL)
    same(b, ["n"])
    assert b.ts.get("x").on_device
    host = JaxSession(accelerate=False)
    host.execute(ACC)
    host.execute(src)
    t = float(host.get("t").host()[0, 0])
    assert abs(float(b.ts.get("t").host()[0, 0]) - t) <= 1e-12 * abs(t)


def test_a_table_of_engine_arrays():
    b = run_both("rng(1); x = randn(6, 3); y = x .^ 2;",
                 "T = array2table([x y]); S = sortrows(T, 'Var4');"
                 " A = table2array(S); h = height(T);")
    same(b, ["A", "h"])
    same_value(b.js.get("S"), b.ts.get("S"), "S")


def test_save_and_load_of_engine_arrays(tmp_path):
    p = str(tmp_path / "e.mat")
    b = run_both("rng(4); x = randn(128, 4); s = single(x); i = int32(x * 100);",
                 f"save('{p}', 'x', 's', 'i'); L = load('{p}');"
                 " lx = L.x; ls = L.s; li = L.i;")
    # the engines' normals agree to a few ULPs (ROADMAP Queue C, RNG)
    close(b, ["lx", "ls"], STATS_TOL)
    same(b, ["li"])
    # what the port saved from its engine loads in the JAX package
    js = JaxSession(accelerate=False)
    assert js.execute(f"W = load('{p}');").error is None
    for n in ("x", "s", "i"):
        want = b.ts.get("l" + n)
        got = js.get("W").get_scalar_field(n)
        assert got.mclass == want.mclass
        assert np.array_equal(got.host(), want.host())
