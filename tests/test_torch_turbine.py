"""The port's native tier-2 loop executor, held to the JAX package's.

Every test of `tests/test_turbine.py` runs through `torch_paired.run_paired`:
each source through both packages' host sessions, workspaces held equal
bit for bit. The JAX test's `both_paths` turns the JAX package's tier off
for its second run; the port's tier follows it (on exactly when the JAX
package's is), so each run pairs tier with tier and interpreter with
interpreter, and the JAX test's own assertions hold the tier bit-equal to
the interpreter.

Each package's loop and while entries are recorded in order with whether
the tier took the loop: the port's decisions equal the JAX package's, and
the port's own counters (`turbine_loop.taken`, `turbine_loop.bails`) add
up to them.
"""

import inspect

import pytest

import runmat_tpu.native as jnative
import runmat_tpu.session
import runmat_tpu_torch.native as tnative
import test_turbine
from runmat_tpu.native import turbine_loop as jloop
from runmat_tpu_torch.native import turbine_loop as tloop
from torch_both import no_engine  # noqa: F401
from torch_paired import PairedSession, run_paired, session_tests

NAMES = session_tests(test_turbine)
_SOURCES = {n: inspect.getsource(getattr(test_turbine, n)) for n in NAMES}
# test_turbine._path_session asks for accelerate=True: the port gets
# TorchEngine("cpu")
ENGINE = {n for n in NAMES if "_path_session(" in _SOURCES[n]}
# they import the JAX package's Session in their bodies (or through
# _path_session): runmat_tpu.session.Session is the paired one while they
# run
LOCAL = ENGINE | {n for n in NAMES if
                  "from runmat_tpu.session import Session" in _SOURCES[n]}


def _recording(mod, kind, log):
    real = getattr(mod, f"try_native_{kind}")

    def entry(*a, **kw):
        npc = real(*a, **kw)
        log.append((kind, npc is not None))
        return npc
    return entry


@pytest.mark.parametrize("name", NAMES)
def test_the_tier_agrees_through_both(request, monkeypatch, no_engine,
                                      name):
    assert tnative.turbine() is not None, tnative.build_error
    port_turbine = tnative.turbine

    def port_follows_jax():
        # on exactly when the JAX package's tier is (both_paths sets its
        # library to None for the interpreter's run)
        return port_turbine() if jnative.turbine() is not None else None

    monkeypatch.setattr(tnative, "turbine", port_follows_jax)
    jlog, tlog = [], []
    for kind in ("loop", "while"):
        monkeypatch.setattr(jloop, f"try_native_{kind}",
                            _recording(jloop, kind, jlog))
        monkeypatch.setattr(tloop, f"try_native_{kind}",
                            _recording(tloop, kind, tlog))
    if name in LOCAL:
        monkeypatch.setattr(runmat_tpu.session, "Session", PairedSession)
    tloop.reset_counts()
    run_paired(request, monkeypatch, test_turbine, name,
               engine=name in ENGINE)
    assert tlog == jlog
    took = sum(t for _, t in tlog)
    assert sum(tloop.taken.values()) == took
    assert sum(tloop.bails.values()) == len(tlog) - took


def test_a_failed_build_is_recorded(monkeypatch, tmp_path):
    """The port's tier does not fail quietly: a source g++ refuses leaves
    the compiler's message in `build_error`, and every loop then counts a
    bail "not built" (the interpreter runs it)."""
    bad = tmp_path / "turbine.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "build_error", None)
    assert tnative.turbine() is None
    assert "g++ exited" in tnative.build_error
    from runmat_tpu_torch.session import Session
    tloop.reset_counts()
    s = Session(accelerate=False)
    r = s.execute("s = 0; for i = 1:100, s = s + i; end")
    assert r.error is None and float(s.get("s").host()) == 5050.0
    assert tloop.bails == {"not built": 1} and not tloop.taken


# chip_smoke.py's tier loops: the VM steps each takes at N = 1000 and 2000
# (the least STEP_BUDGET that lets the tier finish it)
STEPS = {"sum of squares": (20997, 41997),
         "branches and transcendentals": (36405, 72646),
         "break and continue": (14049, 28024),
         "while": (15006, 30006)}


def _taken(src: str, n: int) -> bool:
    from runmat_tpu_torch.session import Session
    s = Session(accelerate=False)
    assert s.execute(f"N = {n};").error is None
    tloop.reset_counts()
    r = s.execute(src)
    assert r.error is None
    return bool(tloop.taken)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_the_card_loops_take_their_counted_steps(monkeypatch, no_engine,
                                                 name):
    import chip_smoke
    assert tnative.turbine() is not None, tnative.build_error
    src = chip_smoke.TIER_LOOPS[name][0]
    for n, steps in zip((1000, 2000), STEPS[name]):
        monkeypatch.setattr(tloop, "STEP_BUDGET", steps)
        assert _taken(src, n)
        monkeypatch.setattr(tloop, "STEP_BUDGET", steps - 1)
        assert not _taken(src, n)
        assert tloop.bails == {"status 2: step budget exceeded": 1}


class _HandedBack(Exception):
    pass


@pytest.mark.parametrize("name", sorted(STEPS))
def test_the_step_budget_at_ten_million_iterations(monkeypatch, no_engine,
                                                   name):
    """At 10^7 iterations the loops of more than 20 steps an iteration
    pass the budget: the VM returns status 2 and the tier hands the loop
    back (stopped here: the interpreter would take minutes). The others
    are taken, bit for bit the loop in Python floats."""
    import chip_smoke
    from runmat_tpu_torch.session import Session
    assert tnative.turbine() is not None, tnative.build_error
    src, names, kind, _ = chip_smoke.TIER_LOOPS[name]
    real = {k: getattr(tloop, f"try_native_{k}") for k in ("loop", "while")}

    def stopping(k):
        def entry(*a, **kw):
            npc = real[k](*a, **kw)
            if npc is None:
                raise _HandedBack
            return npc
        return entry
    for k in real:
        monkeypatch.setattr(tloop, f"try_native_{k}", stopping(k))
    n = 10 ** 7
    s = Session(accelerate=False)
    assert s.execute(f"N = {n};").error is None
    tloop.reset_counts()
    # the steps an iteration adds, times n
    over = (STEPS[name][1] - STEPS[name][0]) * n // 1000 > tloop.STEP_BUDGET
    if over:
        with pytest.raises(_HandedBack):
            s.execute(src)
        assert tloop.bails == {"status 2: step budget exceeded": 1}
        assert not tloop.taken
        return
    assert s.execute(src).error is None
    assert dict(tloop.taken) == {kind: 1} and not tloop.bails
    got = {k: v.hex() for k, v in chip_smoke._scalars(s, names).items()}
    want = {k: v.hex() for k, v in chip_smoke._tier_model(name, n).items()}
    assert got == want
