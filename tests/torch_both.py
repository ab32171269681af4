"""One MATLAB source through both packages, for the port's tests.

`run_both(setup, src)` runs `setup` and then `src` in the JAX package's
`Session(accelerate=True)` on `JaxEngine("cpu")` and in the port's session
on `TorchEngine("cpu")`, both taking every array (`auto_offload=True,
offload_threshold=1`), and keeps each engine's counters from just before
`src` to just after it and each engine's `fusion_snapshot()` at the end
(`jsnap`, `tsnap`); `prepare(session)`, where given, runs on each
session between the two (to set its RNG counter, say). `same(both, names)` holds each named workspace
value of the port to the JAX package's: class, residency, shape, dtype and
values, exactly unless a tolerance is given.
"""

import numpy as np

import runmat_tpu_torch
from runmat_tpu import accel as jaccel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch import accel as taccel

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
