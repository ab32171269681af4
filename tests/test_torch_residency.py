"""Residency under a budget in the port, held to the JAX package.

The port's `accel/residency.py` is a copy; the port's engine registers
every device tensor it makes with the ledger, and `Session` installs the
workspace spiller when `RUNMAT_TPU_HBM_BUDGET_MB` (or `budget_bytes`) sets
a budget.

* Every test of `tests/test_residency.py` runs a second time with the port
  in the JAX package's place (`runmat_tpu` names its test module reads:
  `init_engine(platform="cpu")` installs `TorchEngine("cpu")`, and the
  `Session`, `make_workspace_spiller`, `cli` and `telemetry` are the
  port's), so the port meets each of its assertions: the ledger's bytes
  and counts, pressure spilling the workspace and function frames,
  `collect`, the gc CLI commands and gpuDevice's memory fields.
* The same scenarios on `JaxEngine("cpu")` and `TorchEngine("cpu")`: the
  ledger's live and peak bytes and its counts equal, the same variables
  spilled under the same budget, and the spilled values equal.
"""

import gc
import io
import os

import numpy as np
import pytest

import runmat_tpu
import runmat_tpu.accel.residency as jax_residency
import runmat_tpu_torch
import test_residency
from runmat_tpu import accel as jaccel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch import accel as taccel
from runmat_tpu_torch import cli as port_cli
from runmat_tpu_torch import telemetry as port_telemetry
from runmat_tpu_torch.accel.engine import TorchEngine
from runmat_tpu_torch.accel.residency import make_workspace_spiller
from runmat_tpu_torch.session import Session as PortSession
from torch_both import no_engine  # noqa: F401
from torch_paired import session_tests


def _port_init_engine(platform=None, **kw):
    """The JAX tests' `init_engine(platform="cpu")`: the port's engine on
    the CPU, the one a test asks for (the port's own `init_engine` takes
    the card)."""
    if taccel.active_engine() is None:
        taccel.set_engine(TorchEngine("cpu", **kw))
    return taccel.active_engine()


@pytest.fixture()
def port_in_place(monkeypatch, no_engine):
    m = test_residency
    monkeypatch.setattr(m, "active_engine", taccel.active_engine)
    monkeypatch.setattr(m, "reset_engine", taccel.reset_engine)
    monkeypatch.setattr(m, "set_engine", taccel.set_engine)
    monkeypatch.setattr(m, "init_engine", _port_init_engine)
    monkeypatch.setattr(m, "Session", PortSession)
    # what the tests import inside their bodies
    monkeypatch.setattr(jax_residency, "make_workspace_spiller",
                        make_workspace_spiller)
    monkeypatch.setattr(runmat_tpu, "cli", port_cli, raising=False)
    monkeypatch.setattr(runmat_tpu, "telemetry", port_telemetry,
                        raising=False)
    # the gc CLI commands make a session in the mode a user gets, which in
    # the port is the card: a test asks for the CPU engine instead
    monkeypatch.setattr(taccel, "init_engine", _port_init_engine)


@pytest.mark.parametrize("name", session_tests(test_residency))
def test_the_jax_tests_hold_for_the_port(request, port_in_place, name):
    fn = getattr(test_residency, name)
    kw = {n: request.getfixturevalue(n)
          for n in fn.__code__.co_varnames[:fn.__code__.co_argcount]}
    fn(**kw)


# ------------------------------------------------ both packages, compared

def _engines(budget=0):
    jeng = JaxEngine(platform="cpu")
    teng = TorchEngine("cpu")
    for eng in (jeng, teng):
        eng.residency.budget_bytes = budget
    return jeng, teng


def _run(pkg: str, eng, src: list, spill: bool) -> tuple:
    """`src` through a session of `pkg` on `eng`, one run_source each;
    the ledger's snapshot after each."""
    acc, sess, spiller = (
        (jaccel, JaxSession, jax_residency.make_workspace_spiller)
        if pkg == "jax" else (taccel, PortSession, make_workspace_spiller))
    prev = acc.active_engine()
    acc.set_engine(eng)
    try:
        s = sess(accelerate=True, stdout=io.StringIO())
        if spill:
            eng.residency.pressure_hooks.append(spiller(s))
        snaps = []
        for line in src:
            s.run_source(line, "t")
            gc.collect()
            snaps.append(eng.residency.snapshot())
        return s, snaps
    finally:
        acc.set_engine(prev)


LEDGER_KEYS = ("live_bytes", "peak_bytes", "n_live", "allocs", "frees",
               "pressure_events", "budget_bytes")

SCENARIOS = {
    "upload_and_free": (0, ["x = gpuArray(ones(1000, 1)); "
                            "y = gather(sum(x));", "clear x",
                            "z = gpuArray(rand(300, 7)) * 2; "
                            "w = gather(z(3, :));"]),
    "spill_workspace": (200_000,
                        ["a = gpuArray(ones(10000,1)); b = gather(sum(a));",
                         "c = gpuArray(2*ones(10000,1)); d = gather(sum(c));",
                         "e = gpuArray(3*ones(10000,1)); f = gather(sum(e));",
                         "chk = gather(sum(a * 2) + sum(c) + sum(e));"]),
    "spill_frames": (200_000,
                     ["function r = burst()\n"
                      "  u = gpuArray(ones(10000,1)); us = gather(sum(u));\n"
                      "  v = gpuArray(2*ones(10000,1)); vs = gather(sum(v));\n"
                      "  w = gpuArray(3*ones(10000,1)); ws = gather(sum(w));\n"
                      "  r = gather(sum(u + v + w));\nend\n",
                      "out = burst();"]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_the_ledger_agrees_in_both(no_engine, scenario):
    budget, src = SCENARIOS[scenario]
    jeng, teng = _engines(budget)
    js, jsnaps = _run("jax", jeng, src, spill=bool(budget))
    ts, tsnaps = _run("port", teng, src, spill=bool(budget))
    for i, (j, t) in enumerate(zip(jsnaps, tsnaps)):
        assert {k: t[k] for k in LEDGER_KEYS} == \
            {k: j[k] for k in LEDGER_KEYS}, (scenario, i, t, j)
    assert getattr(ts, "_spill_count", 0) == getattr(js, "_spill_count", 0)
    for name in js.workspace_names():
        want, got = js.get(name), ts.get(name)
        if hasattr(want, "on_device"):
            assert got.on_device == want.on_device, name   # spilled alike
            assert np.array_equal(np.asarray(got.host()),
                                  np.asarray(want.host())), name


def test_a_session_installs_the_spiller_from_the_environment(no_engine,
                                                             monkeypatch):
    """RUNMAT_TPU_HBM_BUDGET_MB sets the budget of a new engine, and the
    session made on it spills (session.py installs the spiller)."""
    monkeypatch.setenv("RUNMAT_TPU_HBM_BUDGET_MB", "0.2")
    runmat_tpu_torch.install("cpu")
    try:
        eng = taccel.active_engine()
        assert eng.residency.budget_bytes == 200_000
        s = PortSession(accelerate=True, stdout=io.StringIO())
        assert len(eng.residency.pressure_hooks) == 1
        s.run_source("a = gpuArray(ones(10000,1)); c = gpuArray(ones(10000,"
                     "1)); e = gpuArray(ones(10000,1)); t = gather(sum(a));",
                     "t")
        gc.collect()
        assert eng.residency.pressure_events >= 1
        assert s._spill_count >= 1
        assert not s.get("a").on_device
        assert float(s.get("t").host()[0, 0]) == 10000.0
    finally:
        runmat_tpu_torch.uninstall()
        monkeypatch.delenv("RUNMAT_TPU_HBM_BUDGET_MB")
    assert os.environ.get("RUNMAT_TPU_HBM_BUDGET_MB") is None
