"""Copy of runmat_tpu/runtime/builtins/breadth4.py in the PyTorch port.

Breadth batch 4: missing-data family, moving-window stats, relational
function forms, elementwise extras, integer<->binary codecs, sorted-set tests.

Reference parity: runmat-runtime/src/builtins/{missing, math/reduction,
logical/rel, math/elementwise, comms, array/sorting_sets, image/filters,
array/{shape,creation}}.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, fortran_ravel,
                       is_text, text_of)
from ..dispatch import binary
from ..registry import builtin
from .common import scalar_int, scalar_num
from .stats import _movwin


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


# ----------------------------------------------------------- relational forms #
# Function forms of the comparison operators (≙ builtins/logical/rel/*.rs).

def _rel(op):
    def fn(a, b):
        return binary(op, a, b)
    return fn


for _name in ("eq", "ne", "lt", "gt", "le", "ge"):
    builtin(_name, category="logical/rel", min_in=2, max_in=2,
            accel_op=_name)(_rel(_name))


# -------------------------------------------------------------- missing family #

def _missing_mask(v) -> np.ndarray:
    """Elementwise is-missing mask with MATLAB per-type rules: NaN for floats,
    <missing> for strings, NaT for datetime, '' never (char arrays have no
    missing), integers never."""
    if isinstance(v, StringArray):
        return np.array([s is None for s in v.data.reshape(-1, order="F")],
                        dtype=bool).reshape(v.data.shape, order="F")
    if isinstance(v, CellArray):
        out = np.zeros(v.data.shape, dtype=bool)
        flat = v.data.reshape(-1)
        res = out.reshape(-1)
        for i, e in enumerate(flat):
            if isinstance(e, MatArray) and e.mclass == "char" and e.size == 0:
                res[i] = True
        return out
    if isinstance(v, MatArray):
        h = v.host()
        if v.mclass == "datetime" or v.mclass == "duration":
            return np.isnan(h.astype(np.float64))
        if h.dtype.kind in ("f", "c"):
            return np.isnan(h) if h.dtype.kind == "f" else np.isnan(h.real) | np.isnan(h.imag)
        return np.zeros(h.shape, dtype=bool)
    return np.zeros((1, 1), dtype=bool)


@builtin("missing", category="missing", min_in=0, max_in=0)
def m_missing():
    """The missing value (host representation: NaN double scalar)."""
    return MatArray.scalar(float("nan"))


@builtin("ismissing", category="missing", min_in=1, max_in=2)
def m_ismissing(a, indicators=None):
    if indicators is not None and isinstance(a, MatArray):
        ind = fortran_ravel(indicators.host().astype(np.float64))
        h = a.host().astype(np.float64)
        mask = np.isin(h, ind[~np.isnan(ind)])
        if np.isnan(ind).any():
            mask |= np.isnan(h)
        return MatArray(mask, "logical")
    return MatArray(_missing_mask(a), "logical")


@builtin("anymissing", category="missing", min_in=1, max_in=1)
def m_anymissing(a):
    return MatArray.logical_scalar(bool(_missing_mask(a).any()))


@builtin("allfinite", category="logical", min_in=1, max_in=1)
def m_allfinite(a):
    h = a.host()
    if h.dtype.kind == "c":
        return MatArray.logical_scalar(bool(np.isfinite(h.real).all() and np.isfinite(h.imag).all()))
    if h.dtype.kind != "f":
        return MatArray.logical_scalar(True)
    return MatArray.logical_scalar(bool(np.isfinite(h).all()))


@builtin("rmmissing", category="missing", min_in=1, pass_nargout=True)
def m_rmmissing(a, *opts, nargout=1):
    mask = _missing_mask(a)
    if isinstance(a, MatArray) and a.ndim == 2 and 1 in a.shape or isinstance(a, StringArray) and 1 in a.shape:
        keep = ~mask.reshape(-1, order="F")
        if isinstance(a, StringArray):
            kept = a.data.reshape(-1, order="F")[keep]
            out = StringArray(kept.reshape(1, -1) if a.shape[0] == 1 else kept.reshape(-1, 1))
        else:
            h = a.host().reshape(-1, order="F")[keep]
            out = MatArray((h.reshape(1, -1) if a.shape[0] == 1 else h.reshape(-1, 1)), a.mclass)
        removed = ~keep
    else:
        rows_bad = mask.any(axis=1)
        if isinstance(a, StringArray):
            out = StringArray(a.data[~rows_bad, :])
        else:
            out = MatArray(a.host()[~rows_bad, :], a.mclass)
        removed = rows_bad
    if nargout <= 1:
        return out
    return [out, MatArray(removed.reshape(-1, 1), "logical")]


@builtin("standardizeMissing", category="missing", min_in=2, max_in=2)
def m_standardize_missing(a, indicators):
    h = a.host().astype(np.float64).copy()
    ind = fortran_ravel(indicators.host().astype(np.float64))
    h[np.isin(h, ind)] = np.nan
    return MatArray(h, "double" if a.mclass not in ("double", "single") else a.mclass)


@builtin("fillmissing", category="missing", min_in=2, pass_nargout=True)
def m_fillmissing(a, method, *rest, nargout=1):
    h = a.host().astype(np.float64).copy()
    vec = h.ndim == 2 and 1 in h.shape
    meth = text_of(method).lower() if is_text(method) else None
    if meth is None:
        raise bad_arg("fillmissing", "Second argument must be a fill method.")

    def fill_1d(v: np.ndarray) -> np.ndarray:
        miss = np.isnan(v)
        if not miss.any():
            return v
        idx = np.arange(v.size)
        good = ~miss
        if meth == "constant":
            v[miss] = scalar_num(rest[0], "fill value")
        elif meth == "previous":
            last = np.maximum.accumulate(np.where(good, idx, -1))
            src = last[miss]
            v[miss] = np.where(src >= 0, v[np.maximum(src, 0)], np.nan)
        elif meth == "next":
            nxt = np.minimum.accumulate(np.where(good, idx, v.size)[::-1])[::-1]
            src = nxt[miss]
            v[miss] = np.where(src < v.size, v[np.minimum(src, v.size - 1)], np.nan)
        elif meth in ("linear", "spline", "pchip", "makima", "nearest"):
            if good.sum() >= 2:
                if meth == "nearest":
                    gi = idx[good]
                    pos = np.searchsorted(gi, idx[miss])
                    pos = np.clip(pos, 1, gi.size - 1)
                    lo, hi = gi[pos - 1], gi[pos]
                    pick = np.where(idx[miss] - lo <= hi - idx[miss], lo, hi)
                    v[miss] = v[pick]
                else:
                    v[miss] = np.interp(idx[miss], idx[good], v[good])
            elif good.sum() == 1:
                v[miss] = v[good][0]
        elif meth in ("movmean", "movmedian"):
            w = scalar_int(rest[0], "window")
            fn = np.nanmean if meth == "movmean" else np.nanmedian
            half_lo, half_hi = (w - 1) // 2, w // 2
            for i in idx[miss]:
                seg = v[max(0, i - half_lo):min(v.size, i + half_hi + 1)]
                if np.isfinite(seg).any():
                    v[i] = fn(seg)
        else:
            raise bad_arg("fillmissing", f"Unknown method '{meth}'.")
        return v

    if vec:
        flat = fill_1d(h.reshape(-1, order="F"))
        out = MatArray(flat.reshape(h.shape, order="F"), "double")
    else:
        for j in range(h.shape[1]):
            h[:, j] = fill_1d(h[:, j])
        out = MatArray(h, "double")
    if nargout <= 1:
        return out
    return [out, MatArray(_missing_mask(a), "logical")]


# ------------------------------------------------------- nan-ignoring reducers #
# Legacy nan* family (≙ builtins/missing/nan*.rs): 'omitnan' reductions.

def _nan_reduce(x, dim, fn):
    h = x.host().astype(np.float64)
    if dim is None:
        ax = 0 if h.shape[0] != 1 else 1
    else:
        ax = scalar_int(dim, "dim") - 1
    with np.errstate(all="ignore"):
        r = fn(h, axis=ax)
    r = np.asarray(r)
    return MatArray(np.expand_dims(r, ax), "double")


@builtin("nansum", category="missing", min_in=1, max_in=2)
def m_nansum(x, dim=None):
    return _nan_reduce(x, dim, np.nansum)


@builtin("nanmean", category="missing", min_in=1, max_in=2)
def m_nanmean(x, dim=None):
    return _nan_reduce(x, dim, np.nanmean)


@builtin("nanmedian", category="missing", min_in=1, max_in=2)
def m_nanmedian(x, dim=None):
    return _nan_reduce(x, dim, np.nanmedian)


@builtin("nanmin", category="missing", min_in=1, max_in=2)
def m_nanmin(x, dim=None):
    return _nan_reduce(x, dim, np.nanmin)


@builtin("nanmax", category="missing", min_in=1, max_in=2)
def m_nanmax(x, dim=None):
    return _nan_reduce(x, dim, np.nanmax)


@builtin("nanstd", category="missing", min_in=1, max_in=2)
def m_nanstd(x, dim=None):
    return _nan_reduce(x, dim, lambda h, axis: np.nanstd(h, axis=axis, ddof=1))


@builtin("nanvar", category="missing", min_in=1, max_in=2)
def m_nanvar(x, dim=None):
    return _nan_reduce(x, dim, lambda h, axis: np.nanvar(h, axis=axis, ddof=1))


# -------------------------------------------------------- moving-window extras #

@builtin("movmedian", category="stats", min_in=2, max_in=2)
def m_movmedian(x, k):
    return _movwin(x, k, np.median, "movmedian")


@builtin("movprod", category="stats", min_in=2, max_in=2)
def m_movprod(x, k):
    return _movwin(x, k, np.prod, "movprod")


@builtin("movvar", category="stats", min_in=2, max_in=2)
def m_movvar(x, k):
    return _movwin(x, k, lambda v, axis: np.var(v, axis=axis, ddof=1 if v.shape[axis] > 1 else 0),
                   "movvar")


@builtin("movmad", category="stats", min_in=2, max_in=2)
def m_movmad(x, k):
    def mad(v, axis):
        med = np.median(v, axis=axis, keepdims=True)
        return np.median(np.abs(v - med), axis=axis)
    return _movwin(x, k, mad, "movmad")


# --------------------------------------------------------------- maxk / bounds #

def _topk(x, k, dim, largest: bool, nargout: int):
    # device selection for resident vectors, values-only form (lax.top_k)
    if nargout <= 1 and dim is None and isinstance(x, MatArray) and \
            not x.is_complex and (x.shape[0] == 1 or x.shape[1] == 1) and \
            x.size > 1:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            kk = min(scalar_int(k, "k"), x.size)
            out = eng.linalg("topk", [x], (kk, largest))
            if out is not None:
                r = out[0]
                if x.shape[0] == 1 and r.shape[0] > 1:
                    r = eng.reshape(r, (1, r.size))
                return r
    h = x.host().astype(np.float64)
    kk = scalar_int(k, "k")
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    v = np.moveaxis(h, ax, -1)
    key = -v if largest else v
    # NaNs sort last either way (MATLAB maxk/mink ignore NaN to the tail)
    key = np.where(np.isnan(key), np.inf, key)
    kk = min(kk, v.shape[-1])
    idx = np.argsort(key, axis=-1, kind="stable")[..., :kk]
    vals = np.take_along_axis(v, idx, axis=-1)
    out = MatArray(np.moveaxis(vals, -1, ax), "double")
    if nargout <= 1:
        return out
    return [out, MatArray(np.moveaxis(idx + 1.0, -1, ax), "double")]


@builtin("maxk", category="math/reduction", min_in=2, max_in=3, pass_nargout=True)
def m_maxk(x, k, dim=None, nargout=1):
    return _topk(x, k, dim, True, nargout)


@builtin("mink", category="math/reduction", min_in=2, max_in=3, pass_nargout=True)
def m_mink(x, k, dim=None, nargout=1):
    return _topk(x, k, dim, False, nargout)


@builtin("bounds", category="math/reduction", min_in=1, max_in=2, max_out=2,
         pass_nargout=True)
def m_bounds(x, dim=None, nargout=1):
    h = x.host().astype(np.float64)
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    with np.errstate(all="ignore"):
        mn = np.nanmin(h, axis=ax, keepdims=True)
        mx = np.nanmax(h, axis=ax, keepdims=True)
    if nargout <= 1:
        return MatArray(mn, "double")
    return [MatArray(mn, "double"), MatArray(mx, "double")]


# ------------------------------------------------------------ elementwise extras #

@builtin("heaviside", category="math/elementwise", min_in=1, max_in=1)
def m_heaviside(x):
    h = x.host().astype(np.float64)
    r = np.where(h > 0, 1.0, np.where(h < 0, 0.0, 0.5))
    r = np.where(np.isnan(h), np.nan, r)
    return MatArray(r, "double")


@builtin("realsqrt", category="math/elementwise", min_in=1, max_in=1)
def m_realsqrt(x):
    h = x.host().astype(np.float64)
    if (h < 0).any():
        raise MatError("MATLAB:realsqrt:complexResult",
                       "Realsqrt produced complex result.")
    return MatArray(np.sqrt(h), "single" if x.mclass == "single" else "double")


@builtin("rescale", category="math/elementwise", min_in=1, max_in=3)
def m_rescale(x, lo=None, hi=None):
    h = x.host().astype(np.float64)
    a = scalar_num(lo, "lower") if lo is not None else 0.0
    b = scalar_num(hi, "upper") if hi is not None else 1.0
    mn, mx = np.nanmin(h), np.nanmax(h)
    if mx == mn:
        r = np.full_like(h, a)
    else:
        r = a + (h - mn) * (b - a) / (mx - mn)
    return MatArray(r, "double")


@builtin("sinpi", category="math/trigonometry", min_in=1, max_in=1)
def m_sinpi(x):
    h = x.host().astype(np.float64)
    # exact at integers / half-integers (the reason sinpi exists)
    r = np.sin(np.pi * h)
    r[np.equal(np.mod(h, 1.0), 0.0)] = 0.0
    return MatArray(r, "single" if x.mclass == "single" else "double")


@builtin("cospi", category="math/trigonometry", min_in=1, max_in=1)
def m_cospi(x):
    h = x.host().astype(np.float64)
    r = np.cos(np.pi * h)
    r[np.equal(np.mod(h - 0.5, 1.0), 0.0)] = 0.0
    return MatArray(r, "single" if x.mclass == "single" else "double")


@builtin("bsxfun", category="math/elementwise", min_in=3, max_in=3,
         pass_ctx=True)
def m_bsxfun(f, a, b, ctx=None):
    """bsxfun(fun, A, B): binary singleton expansion — modern broadcasting
    makes this an alias for fun(A, B) (all our binaries broadcast)."""
    from ...values import FunctionHandle
    args = [a, b]
    if isinstance(f, FunctionHandle):
        r = ctx.interp.call_value(f, args, 1, ctx.frame)
    else:
        r = ctx.interp.call_named(text_of(f), args, 1, ctx.frame)
    return r[0] if isinstance(r, list) else r


@builtin("repelem", category="array/shape", min_in=2)
def m_repelem(x, *reps):
    h = x.host()
    if len(reps) == 1 and h.ndim == 2 and 1 in h.shape:
        r = reps[0].host().astype(np.int64)
        flat = h.reshape(-1, order="F")
        out = np.repeat(flat, r.reshape(-1, order="F") if r.size > 1 else int(r.reshape(-1)[0]))
        out = out.reshape(1, -1) if h.shape[0] == 1 else out.reshape(-1, 1)
        return MatArray(out, x.mclass)
    rs = [int(r.host().reshape(-1)[0]) for r in reps]
    while len(rs) < h.ndim:
        rs.append(1)
    out = h
    for ax, r in enumerate(rs[:h.ndim]):
        out = np.repeat(out, r, axis=ax)
    return MatArray(out, x.mclass)


@builtin("peaks", category="array/creation", min_in=0, max_in=1, pass_nargout=True)
def m_peaks(n=None, nargout=1):
    k = scalar_int(n, "n") if n is not None else 49
    v = np.linspace(-3.0, 3.0, k)
    X, Y = np.meshgrid(v, v)
    Z = (3 * (1 - X) ** 2 * np.exp(-X ** 2 - (Y + 1) ** 2)
         - 10 * (X / 5 - X ** 3 - Y ** 5) * np.exp(-X ** 2 - Y ** 2)
         - 1.0 / 3 * np.exp(-(X + 1) ** 2 - Y ** 2))
    if nargout <= 1:
        return MatArray(Z, "double")
    return [MatArray(X, "double"), MatArray(Y, "double"), MatArray(Z, "double")]


@builtin("filter2", category="image/filters", min_in=2, max_in=3)
def m_filter2(h, x, shape=None):
    """2-D correlation filter (filter2(h,X) == conv2(X, rot90(h,2)))."""
    hk = np.rot90(h.host().astype(np.float64), 2)
    hx = x.host().astype(np.float64)
    mode = text_of(shape).lower() if shape is not None and is_text(shape) else "same"
    from scipy.signal import convolve2d
    r = convolve2d(hx, hk, mode={"same": "same", "full": "full", "valid": "valid"}[mode])
    return MatArray(r, "double")


# -------------------------------------------------------------- comms codecs #

@builtin("de2bi", category="comms", min_in=1, max_in=3)
def m_de2bi(d, n=None, order=None):
    """Decimal to binary matrix, LSB-first per row (MATLAB 'right-msb'
    default)."""
    vals = d.host().astype(np.int64).reshape(-1, order="F")
    flip = is_text(n) or (order is not None and is_text(order) and
                          text_of(order).lower() == "left-msb")
    if is_text(n):
        width = int(np.max(vals)).bit_length() if vals.size and vals.max() > 0 else 1
        flip = text_of(n).lower() == "left-msb"
    else:
        width = scalar_int(n, "n") if n is not None else \
            max(int(vals.max()).bit_length() if vals.size and vals.max() > 0 else 1, 1)
    bits = ((vals[:, None] >> np.arange(width)[None, :]) & 1).astype(np.float64)
    if flip:
        bits = bits[:, ::-1]
    return MatArray(bits, "double")


@builtin("bi2de", category="comms", min_in=1, max_in=2)
def m_bi2de(b, order=None):
    bits = b.host().astype(np.int64)
    if bits.ndim == 1:
        bits = bits.reshape(1, -1)
    if order is not None and is_text(order) and text_of(order).lower() == "left-msb":
        bits = bits[:, ::-1]
    w = (1 << np.arange(bits.shape[1], dtype=np.int64))
    return MatArray((bits * w).sum(axis=1).astype(np.float64).reshape(-1, 1), "double")


# -------------------------------------------------------- sorted-set utilities #

@builtin("argsort", category="array/sorting", min_in=1, max_in=2)
def m_argsort(x, dim=None):
    """RunMat extension: sort indices only (1-based)."""
    h = x.host()
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    key = np.abs(h) if h.dtype.kind == "c" else h
    return MatArray(np.argsort(key, axis=ax, kind="stable").astype(np.float64) + 1, "double")


@builtin("issortedrows", category="array/sorting", min_in=1, max_in=2)
def m_issortedrows(x, col=None):
    h = x.host().astype(np.float64)
    cols = ([int(c) for c in col.host().reshape(-1)] if col is not None
            else list(range(1, h.shape[1] + 1)))
    n = h.shape[0]
    for i in range(n - 1):
        for c in cols:
            a, b = h[i, abs(c) - 1], h[i + 1, abs(c) - 1]
            if c < 0:
                a, b = b, a
            if a < b:
                break
            if a > b:
                return MatArray.logical_scalar(False)
    return MatArray.logical_scalar(True)


@builtin("ismembertol", category="array/sets", min_in=2, max_in=3, pass_nargout=True)
def m_ismembertol(a, b, tol=None, nargout=1):
    ha = a.host().astype(np.float64)
    hb = fortran_ravel(b.host().astype(np.float64))
    scale = max(np.max(np.abs(ha), initial=0.0), np.max(np.abs(hb), initial=0.0))
    t = (scalar_num(tol, "tol") if tol is not None else 1e-6) * max(scale, 1.0)
    flat = ha.reshape(-1, order="F")
    if hb.size == 0:
        mask = np.zeros(flat.shape, dtype=bool)
        loc = np.zeros(flat.shape)
    else:
        d = np.abs(flat[:, None] - hb[None, :])
        mask = (d <= t).any(axis=1)
        loc = np.where(mask, d.argmin(axis=1) + 1.0, 0.0)
    out = MatArray(mask.reshape(ha.shape, order="F"), "logical")
    if nargout <= 1:
        return out
    return [out, MatArray(loc.reshape(ha.shape, order="F"), "double")]


@builtin("wrapToPi", category="math/elementwise", min_in=1, max_in=1)
def m_wrap_to_pi(x):
    h = x.host().astype(np.float64)
    r = np.mod(h + np.pi, 2 * np.pi) - np.pi
    # MATLAB maps odd multiples of pi to +pi, not -pi
    r[(r == -np.pi) & (h > 0)] = np.pi
    return MatArray(r, "double")


@builtin("wrapTo2Pi", category="math/elementwise", min_in=1, max_in=1)
def m_wrap_to_2pi(x):
    h = x.host().astype(np.float64)
    r = np.mod(h, 2 * np.pi)
    r[(r == 0) & (h > 0)] = 2 * np.pi
    return MatArray(r, "double")


@builtin("wrapTo180", category="math/elementwise", min_in=1, max_in=1)
def m_wrap_to_180(x):
    h = x.host().astype(np.float64)
    r = np.mod(h + 180.0, 360.0) - 180.0
    r[(r == -180.0) & (h > 0)] = 180.0
    return MatArray(r, "double")


@builtin("wrapTo360", category="math/elementwise", min_in=1, max_in=1)
def m_wrap_to_360(x):
    h = x.host().astype(np.float64)
    r = np.mod(h, 360.0)
    r[(r == 0) & (h > 0)] = 360.0
    return MatArray(r, "double")


@builtin("shiftdim", category="array/shape", min_in=1, max_in=2,
         pass_nargout=True)
def m_shiftdim(x, n=None, nargout=1):
    h = x.host()
    if n is None:
        # remove leading singleton dims
        k = 0
        shape = h.shape
        while k < len(shape) - 1 and shape[k] == 1:
            k += 1
        out = h.reshape(shape[k:] if len(shape[k:]) >= 2 else shape[k:] + (1,))
        if nargout <= 1:
            return MatArray(out, x.mclass)
        return [MatArray(out, x.mclass), MatArray.scalar(float(k))]
    kk = scalar_int(n, "n")
    nd = h.ndim
    if kk >= 0:
        order = list(range(kk % nd, nd)) + list(range(kk % nd))
        out = np.transpose(h, order)
    else:
        out = h.reshape((1,) * (-kk) + h.shape)
    return MatArray(out, x.mclass)
