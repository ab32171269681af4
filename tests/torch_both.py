"""One MATLAB source through both packages, for the port's tests.

`run_both(setup, src)` runs `setup` and then `src` in the JAX package's
`Session(accelerate=True)` on `JaxEngine("cpu")` and in the port's session
on `TorchEngine("cpu")`, both taking every array (`auto_offload=True,
offload_threshold=1`), and keeps each engine's counters from just before
`src` to just after it and each engine's `fusion_snapshot()` at the end
(`jsnap`, `tsnap`); `prepare(session)`, where given, runs on each
session between the two (to set its RNG counter, say). `same(both, names)` holds each named workspace
value of the port to the JAX package's: class, residency, shape, dtype and
values, exactly unless a tolerance is given; `close(both, names, tol)`
holds floating values within `tol` of the JAX package's largest magnitude
(at least 1) instead, for results with entries near zero (FFTs,
factorizations).

`host_parity(sid, src, tol)` runs `src` through the JAX package's
`Session(accelerate=False)`, the port's `Session(accelerate=False)` and the
port's session on `TorchEngine("cpu")` (whose default policy offloads
nothing on the CPU, so the host layers do the work), and holds each port
run to the JAX one: printed output and error as text, workspace arrays
through numpy (class and shape exactly, values exactly where `tol` is
EXACT, else within that relative tolerance), other values by their display
text. The `no_engine` fixture runs a test with no engine active in either
package and the default display format.
"""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import accel as jaccel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session as JaxSession
from runmat_tpu.utils import display as jax_display
from runmat_tpu.utils.display import format_value as jax_format
from runmat_tpu_torch import accel as taccel
from runmat_tpu_torch.session import Session as PortSession
from runmat_tpu_torch.utils import display as port_display
from runmat_tpu_torch.utils.display import format_value as port_format

OFFLOAD = dict(auto_offload=True, offload_threshold=1)


class Both:
    """The two sessions, their engines, results and counter deltas."""

    def __init__(self, js, jeng, jr, ts, teng, tr, jd, td):
        self.js, self.jeng, self.jr = js, jeng, jr
        self.ts, self.teng, self.tr = ts, teng, tr
        self.jd, self.td = jd, td          # counters moved by `src`


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if isinstance(after[k], int)}


def run_both(setup: str, src: str = "", prepare=None) -> Both:
    jprev, tprev = jaccel.active_engine(), taccel.active_engine()
    try:
        jeng = JaxEngine(platform="cpu", **OFFLOAD)
        jaccel.set_engine(jeng)
        js = JaxSession(accelerate=True)
        ts = runmat_tpu_torch.session("cpu", **OFFLOAD)
        teng = taccel.active_engine()
        out = []
        for s, eng in ((js, jeng), (ts, teng)):
            r = s.execute(setup)
            assert r.error is None, r.error
            if prepare is not None:
                prepare(s)
            before = dict(eng.stats)
            r = s.execute(src) if src else r
            out += [r, _delta(before, eng.stats)]
        jr, jd, tr, td = out
        b = Both(js, jeng, jr, ts, teng, tr, jd, td)
        b.jsnap, b.tsnap = jeng.fusion_snapshot(), teng.fusion_snapshot()
        return b
    finally:
        runmat_tpu_torch.uninstall()
        jaccel.set_engine(jprev)
        taccel.set_engine(tprev)


def same(b: Both, names, rtol: float = 0.0) -> None:
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    for n in names:
        want, got = b.js.get(n), b.ts.get(n)
        assert got.mclass == want.mclass, n
        assert got.on_device == want.on_device, (n, got.on_device)
        w, g = np.asarray(want.host()), np.asarray(got.host())
        assert g.shape == w.shape and g.dtype == w.dtype, (n, g.shape,
                                                          w.shape, g.dtype)
        if rtol == 0.0 or w.dtype.kind not in "fc":
            assert np.array_equal(g, w, equal_nan=True), (n, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=n)


def close(b: Both, names, tol: float, device: bool = False) -> None:
    """As `same`, with floating values within `tol` of the largest magnitude
    of the JAX package's value (or of 1); `device` also asks that each value
    be on the port's device. NaNs must sit in the same places."""
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    for n in names:
        want, got = b.js.get(n), b.ts.get(n)
        assert got.mclass == want.mclass, n
        assert got.on_device == want.on_device, (n, got.on_device)
        assert got.on_device or not device, n
        w, g = np.asarray(want.host()), np.asarray(got.host())
        assert g.shape == w.shape and g.dtype == w.dtype, (n, g.shape,
                                                          w.shape, g.dtype)
        if w.dtype.kind not in "fc":
            assert np.array_equal(g, w), n
            continue
        assert np.array_equal(np.isnan(g), np.isnan(w)), n
        if not w.size:
            continue
        scale = max(float(np.nanmax(np.abs(w), initial=0.0)), 1.0)
        err = float(np.nanmax(np.abs(g - w), initial=0.0))
        assert err <= tol * scale, (n, err, scale)


EXACT = 0.0


@pytest.fixture
def no_engine():
    # both packages start from MATLAB's default display format: `format`
    # sets a module-wide mode, and another test file on the same worker may
    # have left the JAX package's at "long"
    jprev, tprev = jaccel.active_engine(), taccel.active_engine()
    jfmt, tfmt = jax_display._FORMAT["mode"], port_display._FORMAT["mode"]
    jaccel.set_engine(None)
    taccel.set_engine(None)
    jax_display.set_format("short")
    port_display.set_format("short")
    yield
    runmat_tpu_torch.uninstall()
    jaccel.set_engine(jprev)
    taccel.set_engine(tprev)
    jax_display.set_format(jfmt)
    port_display.set_format(tfmt)


def _run_all(src: str) -> list:
    runs = []
    for make in (lambda: JaxSession(accelerate=False),
                 lambda: PortSession(accelerate=False),
                 lambda: runmat_tpu_torch.session("cpu")):
        s = make()
        r = s.execute(src)
        runs.append((s, r))
    runmat_tpu_torch.uninstall()
    return runs


def host_parity(sid: str, src: str, tol: float) -> None:
    (js, jr), *ports = _run_all(src)
    for s, r in ports:
        assert r.output == jr.output, (sid, r.output, jr.output)
        assert (r.error is None) == (jr.error is None), (r.error, jr.error)
        if jr.error is not None:
            assert r.error.identifier == jr.error.identifier
            assert r.error.message == jr.error.message
        assert sorted(s.workspace_names()) == sorted(js.workspace_names())
        for name in js.workspace_names():
            want, got = js.get(name), s.get(name)
            if hasattr(want, "host") and hasattr(want, "mclass"):
                assert got.mclass == want.mclass, name
                w, g = np.asarray(want.host()), np.asarray(got.host())
                assert g.shape == w.shape and g.dtype == w.dtype, name
                if tol == EXACT or w.dtype.kind not in "fc":
                    assert np.array_equal(g, w, equal_nan=True), name
                else:
                    np.testing.assert_allclose(g, w, rtol=tol, err_msg=name)
            else:
                assert type(got).__name__ == type(want).__name__, name
                assert port_format(name, got) == jax_format(name, want), name
