"""The port's CUDA conformance battery (`runmat_tpu_torch/cuda_smoke.py`).

* Its `CASES` are the JAX package's `tpu_smoke.CASES` as data (the same
  names, MATLAB programs, variables, pinned literals and tolerances) and
  its `_cmp` gives the same verdicts.
* It passes on the port's CPU engine with the JAX CPU test's bar
  (`tests/test_tpu_smoke.py`): no failure, at least 120 checks passed.
* It has no retry, skip or "degraded" class: each error is a failure,
  whatever its message, and an unrelated failure between two errors that
  look like a lost backend is counted like them (the JAX runner's streak
  would have reclassified the first as a skip).
"""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu import tpu_smoke
from runmat_tpu_torch import cuda_smoke
from torch_both import no_engine  # noqa: F401


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return type(a) is type(b) and a == b


def test_the_cases_are_the_jax_batterys():
    assert len(cuda_smoke.CASES) == len(tpu_smoke.CASES)
    for mine, theirs in zip(cuda_smoke.CASES, tpu_smoke.CASES):
        assert _same(mine, theirs), theirs[0]
    assert sum(len(c[2]) for c in cuda_smoke.CASES) >= 120


@pytest.mark.parametrize("got,want,tol", [
    ([1.0, np.nan], [1.0, np.nan], 0), ([1.0, 2.0], [1.0, 2.0 + 1e-9], 0),
    ([1.0, 2.0], [1.0, 2.0 + 1e-9], 1e-6), ([1 + 0j], [1.0], 0),
    ([1 + 1j], [1.0], 0), ([], [], 0), ([1.0], [1.0, 2.0], 0)])
def test_cmp_gives_the_jax_verdicts(got, want, tol):
    assert cuda_smoke._cmp(np.asarray(got), want, tol) == \
        tpu_smoke._cmp(np.asarray(got), want, tol)


def test_the_battery_passes_on_the_cpu_engine(no_engine):
    s = runmat_tpu_torch.session("cpu")
    res = cuda_smoke.run(s)
    assert res["failed"] == 0, res["failures"]
    assert res["passed"] >= 120, res["passed"]
    assert res["cases"] == len(cuda_smoke.CASES) and res["seconds"] > 0


class _Result:
    def __init__(self, error=None):
        self.error = error


class _Scripted:
    """A session whose programs succeed, raise an error that reads like a
    lost backend ('lost'), or fail plainly ('wrong'), by source; a check
    that consults it finds no variable."""

    def __init__(self, by_src):
        self.by_src = by_src
        self.runs = []

    def execute(self, src):
        self.runs.append(src)
        mode = self.by_src.get(src, "ok")
        if mode == "lost":
            return _Result(RuntimeError("UNAVAILABLE: Socket closed"))
        if mode == "wrong":
            return _Result(RuntimeError("assert failed: wrong answer"))
        return _Result(None)

    def get(self, var):
        raise KeyError(var)


def test_every_error_is_a_failure(monkeypatch):
    cases = [("c0", "s0", (("v", 1.0, 0),)),
             ("c1", "s1", (("v", 1.0, 0), ("w", 2.0, 0))),
             ("c2", "s2", (("v", 1.0, 0),)),
             ("c3", "s3", (("v", 1.0, 0),)),
             ("c4", "s4", ())]
    monkeypatch.setattr(cuda_smoke, "CASES", cases)
    sess = _Scripted({"s0": "lost", "s1": "wrong", "s2": "lost",
                      "s3": "lost"})
    out = cuda_smoke.run(sess)
    # the first lost backend, the wrong answer between and the two lost
    # after it: every check of each counted, nothing skipped or retried
    assert out["failed"] == 5 and out["passed"] == 0, out
    assert sess.runs == ["s0", "s1", "s2", "s3", "s4"]
    assert set(out) == {"passed", "failed", "cases", "seconds", "failures"}
    assert [f.split(":")[0] for f in out["failures"]] == \
        ["c0", "c1", "c2", "c3"]
