"""DenseOps: the eager dispatcher behind `TorchEngine.linalg` and
`TorchEngine.dense.call`.

Port of `runmat_tpu/accel/dense.py:43-225` on torch tensors. A call looks up
the builder of its kind, brings every operand to the device in its logical
MATLAB shape and the work dtype, runs the builder eagerly and returns its
tensors; `TorchEngine.linalg` wraps them as leaf nodes. There is no jit
cache, no warmup record and no failure memo: a device error propagates.

A kind without a builder here returns None before it touches an operand, so
the builtin takes its host path; that is counted as a host fallback when an
operand is on the device. Complex work returns None the same way (A8).

Builders (kind -> (engine, opts) -> fn(*tensors)): `diff`, `trapz` and
`movwin` are plain torch, as the JAX package leaves them to XLA;
`histcounts` runs on the hand-written kernel of `ops/histogram.py`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops import histogram
from ..values import MatArray, normalize_shape
from .lazy import LazyNode

_WORK = {np.dtype(np.float32): torch.float32,
         np.dtype(np.float64): torch.float64}
_NUMPY = {v: k for k, v in _WORK.items()}


class DenseOps:
    def __init__(self, eng):
        self.eng = eng

    def work_dtype(self, *xs: MatArray) -> np.dtype:
        """double->f64, single->f32; complex rides the numpy dtype."""
        dts = []
        for x in xs:
            base = np.float32 if x.mclass == "single" else np.float64
            if x.is_complex:
                base = np.complex64 if x.mclass == "single" else np.complex128
            dts.append(np.dtype(base))
        return np.result_type(*dts) if dts else np.dtype(np.float64)

    def _mat(self, x: MatArray, dt: np.dtype) -> torch.Tensor:
        """A MatArray as a device tensor of `dt` in its logical shape."""
        if x.on_device:
            arr = self.eng.materialize(x.dev)
            lshape = tuple(x.dev.shape)
        else:
            h = x.host()
            if x.mclass in ("logical", "char") or h.dtype.kind in "iu":
                h = h.astype(np.float64)
            arr = self.eng.to_device(h)
            lshape = tuple(h.shape)
        if tuple(arr.shape) != lshape:
            arr = arr.reshape(lshape)
        return arr.to(_WORK[dt])

    def _leaf(self, arr: torch.Tensor, mclass: str, lshape=None) -> MatArray:
        eng = self.eng
        shape = normalize_shape(lshape if lshape is not None else arr.shape)
        from .engine import phys_shape
        ps = phys_shape(shape)
        if tuple(arr.shape) != ps:
            arr = arr.reshape(ps)
        node = LazyNode(eng, "leaf", [], (), shape, _NUMPY[arr.dtype],
                             value=arr)
        node.dispatch_id = eng.dispatch_seq
        return MatArray.from_device(node, mclass)

    def call(self, kind: str, xs: list, opts: tuple = ()) -> Optional[list]:
        """Run `kind` on the device. Returns tensors in logical shapes, or
        None when the port has no builder for it (the caller's host path)."""
        eng = self.eng
        build = _BUILDERS.get(kind)
        if build is None:
            eng._declines(kind, f"{kind} not ported (A7)", *xs)
            return None
        dt = self.work_dtype(*xs)
        if dt.kind == "c":
            eng._declines(kind, "complex not ported (A8)", *xs)
            return None
        args = [self._mat(x, dt) for x in xs]
        t0 = time.perf_counter()
        out = build(eng, opts)(*args)
        ms = (time.perf_counter() - t0) * 1e3
        if not isinstance(out, tuple):
            out = (out,)
        eng.record_launch("linalg", [kind], ms, sum(int(o.nbytes) for o in out))
        eng.stats["dispatches"] += 1
        eng.dispatch_seq += 1
        return list(out)


# --------------------------------------------------------------------------- #
# builders: kind -> (engine, opts) -> fn(*tensors in logical shapes)
# --------------------------------------------------------------------------- #

def _b_diff(eng, opts):
    """diff of order n along an axis (`dense.py:868`)."""
    n, axis = opts

    def f(a):
        return torch.diff(a, n=n, dim=axis)
    return f


def _b_trapz(eng, opts):
    """Trapezoidal integration along an axis, optional sample points, in
    jnp.trapezoid's form: 0.5 * sum(dx * (y[1:] + y[:-1])) over the axis
    moved last (`dense.py:879`)."""
    axis, with_x = opts

    def integrate(y, dx):
        y = torch.movedim(y, axis, -1)
        return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1)

    if with_x:
        def f(x, y):
            return integrate(y, torch.diff(x.reshape(-1)))
        return f

    def f(y):
        return integrate(y, 1.0)
    return f


def _b_movwin(eng, opts):
    """Moving-window sum/mean/max/min of a vector (`dense.py:1035`). MATLAB
    centring: window [i - floor(k/2), i + ceil(k/2) - 1], shrinking at the
    ends; mean divides by the valid count."""
    kind, w = opts
    pad = (w // 2, (w - 1) // 2)

    def windows(v, fill):
        return torch.nn.functional.pad(v, pad, value=fill).unfold(0, w, 1)

    def f(x):
        xv = x.reshape(-1)
        if kind in ("sum", "mean"):
            s = windows(xv, 0.0).sum(-1)
            if kind == "mean":
                s = s / windows(torch.ones_like(xv), 0.0).sum(-1)
            return s.reshape(x.shape)
        if kind == "max":
            return windows(xv, float("-inf")).amax(-1).reshape(x.shape)
        return windows(xv, float("inf")).amin(-1).reshape(x.shape)
    return f


def _b_histcounts(eng, opts):
    """histcounts over explicit edges (`dense.py:946`). Every call goes to
    the histogram kernel, whatever the bin count: search mode in the work
    dtype, or the direct index when the builtin stamped affine edges and the
    work dtype is f32. Counts come back in the work dtype, as the JAX
    builder's `.astype(x.dtype)`."""
    affine = opts[0] if opts else None

    def f(x, edges):
        counts = histogram.histcounts(
            x.reshape(-1), edges.reshape(-1),
            affine if x.dtype == torch.float32 else None)
        return counts.to(x.dtype)
    return f


_BUILDERS = {"diff": _b_diff, "trapz": _b_trapz, "movwin": _b_movwin,
             "histcounts": _b_histcounts}
