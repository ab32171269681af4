"""Copy of runmat_tpu/runtime/builtins/sets_sort.py in the PyTorch port.

Sorting & set builtins: sort/unique/union/intersect/setdiff/ismember/...

Reference parity: runmat-runtime/src/builtins/array/sorting_sets + provider
hooks sort/unique/union/setdiff/ismember (runmat-accelerate-api/src/lib.rs).
MATLAB NaN rule: NaNs sort to the end (ascending).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, fortran_ravel, is_text,
                       text_of)
from ..registry import builtin


def _norm(r: np.ndarray, mclass: str) -> MatArray:
    if r.ndim < 2:
        r = r.reshape(-1, 1) if r.ndim == 1 else r.reshape(1, 1)
    return MatArray(r, mclass)


def _sort_strings(x: StringArray, direction: str, dim, nargout: int):
    """doc sort for string arrays: by code point; missing strings sort as
    the LARGEST value (last ascending, first descending — NaN-like)."""
    d = x.data
    ax = (dim - 1) if dim else (0 if d.shape[0] != 1 else 1)
    miss = np.array([[s is None for s in row] for row in d]) \
        if d.ndim == 2 else np.vectorize(lambda s: s is None)(d)
    txt = np.where(miss, "", d).astype(str)   # <U dtype: lexsort-able
    # lexsort: missing-flag is the primary key so missing always lands at
    # the "largest" end; stable within ties
    if direction == "descend":
        n = d.shape[ax]
        ia = np.lexsort((np.flip(txt, axis=ax), np.flip(miss, axis=ax)),
                        axis=ax)
        idx = np.flip((n - 1) - ia, axis=ax)
    else:
        idx = np.lexsort((txt, miss), axis=ax)
    vals = np.take_along_axis(d, idx, axis=ax)
    out = StringArray(vals)
    if nargout <= 1:
        return out
    return [out, _norm((idx + 1).astype(np.float64), "double")]


@builtin("sort", category="array/sorting", min_in=1, pass_nargout=True)
def m_sort(x, *rest, nargout=1):
    direction = "ascend"
    dim = None
    for a in rest:
        if is_text(a):
            t = text_of(a).lower()
            if t in ("ascend", "descend"):
                direction = t
            elif t == "ComparisonMethod".lower():
                pass
        elif isinstance(a, MatArray):
            dim = int(a.scalar_double())
    if isinstance(x, CellArray):
        strs = [text_of(e) for e in x.data.reshape(-1, order="F")]
        order = np.argsort(np.array(strs, dtype=object), kind="stable")
        if direction == "descend":
            order = order[::-1]
        data = np.empty(x.shape, dtype=object)
        df = data.reshape(-1, order="F")
        src = x.data.reshape(-1, order="F")
        for i, o in enumerate(order):
            df[i] = src[o]
        out = CellArray(data)
        if nargout <= 1:
            return out
        return [out, _norm(order.astype(np.float64) + 1, "double")]
    if isinstance(x, MatArray) and x.on_device:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            shape = x.shape
            ax = (dim - 1) if dim else (0 if shape[0] != 1 else 1)
            if ax < len(shape):
                out = eng.sort(x, ax, direction == "descend", nargout >= 2)
                if out is not None:
                    return out[0] if nargout <= 1 else out
    if isinstance(x, StringArray):
        return _sort_strings(x, direction, dim, nargout)
    h = x.host()
    ax = (dim - 1) if dim else (0 if h.shape[0] != 1 else 1)
    if h.dtype.kind == "c":
        # doc sort: complex sorts by abs(), TIES broken by angle() in
        # (-pi, pi]; np.lexsort is stable and puts the NaN-abs keys last
        kabs, kang = np.abs(h), np.angle(h)
        if direction == "descend":
            n = h.shape[ax]
            ia = np.lexsort((np.flip(kang, axis=ax), np.flip(kabs, axis=ax)),
                            axis=ax)
            idx = np.flip((n - 1) - ia, axis=ax)
        else:
            idx = np.lexsort((kang, kabs), axis=ax)
    elif direction == "descend":
        # Stable descending with MATLAB's NaN-FIRST rule (reference
        # comparator: sorting_sets/sort.rs compare_real_values): stable
        # ascending argsort of the axis-reversed key, mapped back. NaN sorts
        # last ascending, hence first descending; equal elements keep their
        # original order in both directions.
        n = h.shape[ax]
        ia = np.argsort(np.flip(h, axis=ax), axis=ax, kind="stable")
        idx = np.flip((n - 1) - ia, axis=ax)
    else:
        idx = np.argsort(h, axis=ax, kind="stable")
    vals = np.take_along_axis(h, idx, axis=ax)
    out = MatArray(vals, x.mclass)
    if nargout <= 1:
        return out
    return [out, _norm((idx + 1).astype(np.float64), "double")]


@builtin("sortrows", category="array/sorting", min_in=1, max_in=2, pass_nargout=True)
def m_sortrows(x, col=None, nargout=1):
    h = x.host()
    cols = [int(v) for v in col.host().reshape(-1)] if col is not None else \
        list(range(1, h.shape[1] + 1))
    keys = []
    for c in reversed(cols):
        k = h[:, abs(c) - 1]
        keys.append(-k if c < 0 else k)
    order = np.lexsort(keys)
    out = MatArray(h[order], x.mclass)
    if nargout <= 1:
        return out
    return [out, _norm(order.astype(np.float64) + 1, "double")]


@builtin("unique", category="array/sets", min_in=1, pass_nargout=True)
def m_unique(x, *rest, nargout=1):
    stable = any(is_text(a) and text_of(a) == "stable" for a in rest)
    if isinstance(x, CellArray):
        strs = [text_of(e) for e in x.data.reshape(-1, order="F")]
        if stable:
            seen = {}
            for i, s in enumerate(strs):
                if s not in seen:
                    seen[s] = i
            uniq = list(seen)
        else:
            uniq = sorted(set(strs))
        data = np.empty((len(uniq), 1), dtype=object)
        for i, s in enumerate(uniq):
            data[i, 0] = MatArray.char_from_str(s)
        return CellArray(data)
    if isinstance(x, MatArray) and x.on_device and nargout <= 3:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            # device sort+mask+compact; only the count gathers (8 bytes)
            out = eng.unique(x, stable, nargout >= 2)
            if out is not None:
                return out[0] if nargout <= 1 else out[:nargout]
    h = x.host()
    flat = fortran_ravel(h)
    is_row = h.ndim == 2 and h.shape[0] == 1 and h.shape[1] > 1
    if stable:
        _, first_idx = np.unique(flat, return_index=True)
        order = np.sort(first_idx)
        vals = flat[order]
        ia = order
    else:
        vals, ia = np.unique(flat, return_index=True)
    # MATLAB: NaNs are each unique
    if flat.dtype.kind == "f":
        nan_idx = np.nonzero(np.isnan(flat))[0]
        if nan_idx.size:
            keep = ~np.isnan(vals)
            vals = np.concatenate([vals[keep], flat[nan_idx]])
            ia = np.concatenate([ia[keep], nan_idx])
    def orient(v, dtype=None):
        a = np.asarray(v)
        return a.reshape(1, -1) if is_row else a.reshape(-1, 1)
    out = MatArray(orient(vals), x.mclass)
    if nargout <= 1:
        return out
    ic = np.zeros(flat.size, dtype=np.float64)
    lookup = {v: i for i, v in enumerate(vals[~np.isnan(vals)] if flat.dtype.kind == "f" else vals)}
    for i, v in enumerate(flat):
        if flat.dtype.kind == "f" and np.isnan(v):
            ic[i] = 0
        else:
            ic[i] = lookup.get(v, 0) + 1
    res = [out, MatArray(orient(ia.astype(np.float64) + 1), "double"),
           MatArray(ic.reshape(-1, 1), "double")]
    return res[:nargout]


@builtin("ismember", category="array/sets", min_in=2, max_in=2, pass_nargout=True)
def m_ismember(a, b, nargout=1):
    if isinstance(a, CellArray) or isinstance(b, CellArray) or \
            isinstance(a, StringArray) or isinstance(b, StringArray):
        def to_list(v):
            if isinstance(v, CellArray):
                return [text_of(e) for e in v.data.reshape(-1, order="F")]
            if isinstance(v, StringArray):
                return [(e or "") for e in v.data.reshape(-1, order="F")]
            return [text_of(v)]
        la = to_list(a)
        sb = to_list(b)
        mask = np.array([s in sb for s in la], dtype=np.bool_)
        shape = a.shape if isinstance(a, (CellArray, StringArray)) else (1, 1)
        return MatArray(mask.reshape(shape, order="F") if mask.size == np.prod(shape)
                        else mask.reshape(1, -1), "logical")
    if nargout <= 1 and isinstance(a, MatArray) and \
            isinstance(b, MatArray) and not a.is_complex and \
            not b.is_complex and 0 < b.size <= 4096:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(a, b):
            # device sort + searchsorted: static-shape membership mask
            out = eng.linalg("ismember", [a, b], out_class="logical")
            if out is not None:
                return out[0]
    ha = a.host()
    hb = fortran_ravel(b.host())
    mask = np.isin(ha, hb)
    out = MatArray(mask, "logical")
    if nargout <= 1:
        return out
    loc = np.zeros(ha.shape, dtype=np.float64)
    sort_b = np.sort(hb)
    flat_loc = loc.reshape(-1)
    flat_a = ha.reshape(-1)
    for i, v in enumerate(flat_a):
        w = np.nonzero(hb == v)[0]
        flat_loc[i] = (w[0] + 1) if w.size else 0
    return [out, MatArray(loc, "double")]


def _setop(a, b, op):
    if isinstance(a, MatArray) and isinstance(b, MatArray) and \
            (a.on_device or b.on_device):
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            out = eng.setop(op, a, b)
            if out is not None:
                return out[0]
    fa = fortran_ravel(a.host())
    fb = fortran_ravel(b.host())
    if op == "union":
        vals = np.union1d(fa, fb)
    elif op == "intersect":
        vals = np.intersect1d(fa, fb)
    else:
        vals = np.setdiff1d(fa, fb)
    is_row = not (a.host().ndim == 2 and a.host().shape[1] == 1 and a.host().shape[0] > 1)
    out = vals.reshape(1, -1) if is_row else vals.reshape(-1, 1)
    return MatArray(out, a.mclass if a.mclass == b.mclass else "double")


@builtin("union", category="array/sets", min_in=2, max_in=2)
def m_union(a, b):
    return _setop(a, b, "union")


@builtin("intersect", category="array/sets", min_in=2, max_in=2)
def m_intersect(a, b):
    return _setop(a, b, "intersect")


@builtin("setdiff", category="array/sets", min_in=2, max_in=2)
def m_setdiff(a, b):
    return _setop(a, b, "setdiff")


@builtin("setxor", category="array/sets", min_in=2, max_in=2)
def m_setxor(a, b):
    if isinstance(a, MatArray) and isinstance(b, MatArray) and \
            (a.on_device or b.on_device):
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            out = eng.setop("setxor", a, b)
            if out is not None:
                return out[0]
    fa = fortran_ravel(a.host())
    fb = fortran_ravel(b.host())
    return MatArray(np.setxor1d(fa, fb).reshape(1, -1), a.mclass if a.mclass == b.mclass else "double")
