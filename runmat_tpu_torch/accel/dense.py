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

Builders (kind -> (engine, opts) -> fn(*tensors)): `diff`, `trapz`,
`movwin`, `sort`, `unique`, `setop`, `mode`, `accumarray` and `ismember` are
plain torch, as the JAX package leaves them to XLA; `histcounts` runs on the
hand-written kernel of `ops/histogram.py`.

The sort family keeps the JAX builders' semantics (`dense.py:534-559`,
755-943), not their padded static shapes: each NaN is its own value and
sorts last ascending, -0 equals 0, ties keep their order, indices come back
1-based in double. The one value read back is a result's length
(`TorchEngine.read_scalar`; accumarray reads its smallest and largest
subscript together, `count_sync`, and raises MATLAB's error for one
outside 1..n); the keys are made canonical (one NaN, +0) first, because a
card's radix sort orders by bit pattern. No builder calls a torch op that
reads a device value back inside torch (`torch.bincount` reads the min and
max of its input, `torch.isin` runs `unique` on a large test set), so every
wait for the card is one the engine counts.
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
_NUMPY = {torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64),
          torch.int64: np.dtype(np.int64), torch.bool: np.dtype(np.bool_)}


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


def _key(v):
    """Sort and membership key: one NaN (it sorts last) and +0 for -0,
    so that a radix sort and `torch.isin` see MATLAB's equalities."""
    return torch.where(torch.isnan(v), torch.full_like(v, float("nan")),
                       v + 0.0)


def _fvec(a):
    """F-order sequence of a logical-shape tensor."""
    return a.permute(*reversed(range(a.ndim))).reshape(-1) if a.ndim > 1 \
        else a.reshape(-1)


def _compact(eng, keep, *vals):
    """The entries of each of `vals` where `keep` holds, in order. Their
    count is read back once; the gather itself needs no further sync."""
    n = int(eng.read_scalar(keep.sum()))
    pos = torch.cumsum(keep, 0) - 1
    dest = torch.where(keep, pos, torch.full_like(pos, n))
    src = torch.arange(keep.numel(), device=keep.device)
    at = torch.empty(n + 1, dtype=torch.int64, device=keep.device)
    at = at.scatter(0, dest, src)[:n]
    return [v[at] for v in vals]


def _isin(a, b):
    """torch.isin(a, b) without a read-back: b sorted, a looked up by a
    binary search. The search runs over b with its NaNs (sorted last) read
    as +Inf, since a NaN in the sequence misleads it; the match is then
    tested against b itself, so NaN finds nothing (NaN != NaN) and +Inf
    finds only +Inf, as in isin."""
    sb = torch.sort(b.reshape(-1)).values
    if sb.numel() == 0:
        return torch.zeros_like(a, dtype=torch.bool)
    keys = torch.where(torch.isnan(sb), torch.full_like(sb, float("inf")),
                       sb)
    pos = torch.searchsorted(keys, a.contiguous()).clamp_(
        max=sb.numel() - 1)
    return sb[pos] == a


def _groups(v):
    """Stable sort of v by key: (sorted order, first-of-group mask, group
    id per sorted element)."""
    sk, si = torch.sort(_key(v), stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]          # NaN != NaN: each its own group
    return si, first, torch.cumsum(first, 0) - 1


def _unique_core(eng, v, stable: bool):
    """(u, ia, ic) of a flat vector, 0-based: u sorted (or by first
    appearance), ia first occurrences, ic with v == u[ic]."""
    si, first, g = _groups(v)
    (ia,) = _compact(eng, first, si)
    ic = torch.empty_like(si).scatter(0, si, g)
    if stable:
        order = torch.argsort(ia)
        ia = ia[order]
        rank = torch.empty_like(order).scatter(
            0, order, torch.arange(order.numel(), device=order.device))
        ic = rank[ic]
    return v[ia], ia, ic


def _b_sort(eng, opts):
    """Stable sort along an axis (`dense.py:534`): descending is the
    ascending sort of the axis-reversed array, mapped back, so NaN comes
    first and ties keep their order."""
    axis, descend, want_idx = opts

    def f(a):
        n = a.shape[axis]
        b = torch.flip(a, (axis,)) if descend else a
        _, idx = torch.sort(_key(b), dim=axis, stable=True)
        if descend:
            idx = torch.flip((n - 1) - idx, (axis,))
        vals = torch.take_along_dim(a, idx, dim=axis)
        if want_idx:
            return vals, (idx + 1).to(torch.float64)
        return vals
    return f


def _b_unique(eng, opts):
    """unique with [U, ia, ic], 1-based indices in double (`dense.py:789`)."""
    (stable,) = opts

    def f(a):
        u, ia, ic = _unique_core(eng, _fvec(a), stable)
        return u, (ia + 1).to(torch.float64), (ic + 1).to(torch.float64)
    return f


def _b_setop(eng, opts):
    """union/intersect/setdiff/setxor (`dense.py:803`): unique passes and
    membership. NaN is never a member of anything, so it stays in setdiff
    and setxor and leaves intersect. Returns (values,) or (values, ia)."""
    op, stable = opts

    def f(a, b):
        va, vb = _fvec(a), _fvec(b)
        if op in ("union", "setxor"):
            u, _, _ = _unique_core(eng, torch.cat([va, vb]),
                                   stable and op == "union")
            if op == "union":
                return (u,)
            ku = _key(u)
            keep = torch.isnan(u) | (_isin(ku, _key(va)) ^ _isin(ku, _key(vb)))
            return tuple(_compact(eng, keep, u))
        ua, ia, _ = _unique_core(eng, va, stable)
        member = _isin(_key(ua), _key(vb))
        keep = member if op == "intersect" else ~member
        return tuple(_compact(eng, keep, ua, (ia + 1).to(torch.float64)))
    return f


def _b_mode(eng, opts):
    """Vector mode (`dense.py:895`): the most frequent non-NaN value, the
    smallest of a tie (the first group in sorted order); NaN when there is
    none. A group's count is found by a binary search for its end among the
    sorted group ids: a scatter-add puts every atomic on one of a few
    addresses when there are few groups, and a running minimum over 2^26
    values is one slow sequential scan on a card."""
    def f(a):
        v = _fvec(a)
        si, first, g = _groups(v)
        pos = torch.arange(v.numel(), device=v.device)
        count = torch.searchsorted(g, g, right=True) - pos
        sv = v[si]
        score = torch.where(first & ~torch.isnan(sv), count,
                            torch.full_like(pos, -1))
        # a one-element index: torch reads a 0-d index tensor back
        return sv[torch.argmax(score).reshape(1)].reshape(())
    return f


# accumarray's partial sums: at most this many (copies x bins) cells
_ACCUM_CELLS = 1 << 24


def _b_accumarray(eng, opts):
    """accumarray(subs, vals, [n 1]) with @sum (`dense.py:917`). The
    smallest and largest subscript are read back together, once (counted),
    and one outside 1..n raises MATLAB's error (the JAX scatter drops or
    wraps it; a card would fault on it). The sums are a scatter-add into
    up to 4096 interleaved copies of the n bins, element i into copy
    i mod copies, then summed over the copies: a scatter-add into n
    addresses alone queues its atomics when n is small (26.3 ms for 2^26
    values into 49 bins on an H100 80GB HBM3), and `torch.bincount` reads
    its input's min and max back inside torch. Sums in float64, as
    bincount's."""
    (out_n,) = opts

    def f(subs, vals):
        idx = subs.reshape(-1).to(torch.int64) - 1
        v = vals.reshape(-1)
        if v.shape[0] == 1:
            v = v.expand(idx.shape)
        if idx.numel():
            ends = torch.stack([idx.min(), idx.max()])
            eng.count_sync(int(ends.nbytes))
            lo, hi = ends.tolist()
            _check_subs(lo, hi, out_n)
        copies = max(1, min(4096, _ACCUM_CELLS // max(out_n, 1)))
        lane = torch.arange(idx.numel(), device=idx.device) % copies
        acc = torch.zeros(copies * out_n, dtype=torch.float64,
                          device=idx.device)
        acc.index_add_(0, lane * out_n + idx, v.to(torch.float64))
        return acc.view(copies, out_n).sum(0).to(v.dtype)
    return f


def _check_subs(lo: int, hi: int, n: int) -> None:
    """MATLAB's accumarray errors for 0-based subscripts lo..hi into n."""
    from ..errors import MatError
    if lo < 0:
        raise MatError("MATLAB:accumarray:nonPosSubs",
                       "First input SUBS must contain positive integer "
                       "subscripts.")
    if hi >= n:
        raise MatError("MATLAB:accumarray:subsExceedSz",
                       "First input SUBS and third input SZ must satisfy "
                       "ALL(MAX(SUBS)<=SZ).")


def _b_ismember(eng, opts):
    """The membership mask of a in b (`dense.py:932`), in a's shape."""
    def f(a, b):
        return _isin(_key(a), _key(b.reshape(-1)))
    return f


_BUILDERS = {"diff": _b_diff, "trapz": _b_trapz, "movwin": _b_movwin,
             "histcounts": _b_histcounts, "sort": _b_sort,
             "unique": _b_unique, "setop": _b_setop, "mode": _b_mode,
             "accumarray": _b_accumarray, "ismember": _b_ismember}
