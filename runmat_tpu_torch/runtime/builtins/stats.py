"""Copy of runmat_tpu/runtime/builtins/stats.py in the PyTorch port, with
one repair: `histcounts` takes its device route before it copies x to the
host (the JAX package's copy gathers x first, at its line 115), so a device
x with explicit edges stays on the device. The counts are the same.

Statistics builtins: histc/histcounts, corrcoef, cov, movmean family,
normalize, prctile.

Reference parity: runmat-runtime/src/builtins/stats/ (63k LoC category);
moving-window provider hook (runmat-accelerate-api/src/lib.rs:2852).
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import MatArray, fortran_ravel, is_text, text_of
from ..registry import builtin
from .common import scalar_int


def _f(x: MatArray) -> np.ndarray:
    return x.host().astype(np.float64)


@builtin("cov", category="stats", min_in=1, max_in=3)
def m_cov(x, y=None, w=None):
    """cov(X), cov(X, Y), cov(X, w) / cov(X, Y, w): w = 0 (default, N-1
    normalization) or 1 (population, N)."""
    hx = _f(x)
    ddof = 1
    if y is not None and isinstance(y, MatArray) and y.size == 1 and \
            w is None:
        # cov(X, w) form: second arg is the normalization flag
        flag = float(y.host().reshape(-1)[0])
        if flag in (0.0, 1.0):
            ddof = 0 if flag == 1.0 else 1
            y = None
    if w is not None and isinstance(w, MatArray) and w.size == 1:
        ddof = 0 if float(w.host().reshape(-1)[0]) == 1.0 else 1
    if y is not None and isinstance(y, MatArray) and y.size > 1:
        hy = _f(y)
        m = np.cov(hx.reshape(-1), hy.reshape(-1), ddof=ddof)
        return MatArray(m, "double")
    if hx.ndim == 2 and 1 in hx.shape:
        return MatArray.scalar(float(np.var(hx, ddof=ddof)))
    return MatArray(np.cov(hx, rowvar=False, ddof=ddof), "double")


@builtin("corrcoef", category="stats", min_in=1, max_in=2)
def m_corrcoef(x, y=None):
    hx = _f(x)
    if y is not None:
        hy = _f(y)
        r = np.corrcoef(hx.reshape(-1), hy.reshape(-1))
        return MatArray(r, "double")
    if hx.ndim == 2 and 1 in hx.shape:
        return MatArray(np.ones((1, 1)), "double")
    return MatArray(np.corrcoef(hx, rowvar=False), "double")


@builtin("histc", category="stats", min_in=2, max_in=2)
def m_histc(x, edges):
    hx = fortran_ravel(_f(x))
    e = fortran_ravel(_f(edges))
    counts = np.zeros(e.size, dtype=np.float64)
    idx = np.searchsorted(e, hx, side="right") - 1
    exact_last = hx == e[-1]
    idx = np.where(exact_last, e.size - 1, idx)
    valid = (idx >= 0) & ((hx >= e[0]) & (hx <= e[-1]))
    np.add.at(counts, idx[valid], 1)
    eh = edges.host()
    out = counts.reshape(1, -1) if eh.ndim == 2 and eh.shape[0] == 1 else counts.reshape(-1, 1)
    return MatArray(out, "double")


@builtin("histcounts", category="stats", min_in=1, max_in=None,
         pass_nargout=True)
def m_histcounts(x, bins=None, *opts, nargout=1):
    # trailing options: 'Normalization', mode ('count' default,
    # 'probability', 'pdf', 'cumcount', 'cdf'); 'BinWidth', w
    norm = "count"
    binwidth = None
    rest = list(opts)
    if bins is not None and is_text(bins):
        rest = [bins] + rest
        bins = None
    i = 0
    while i < len(rest):
        if is_text(rest[i]) and i + 1 < len(rest):
            key = text_of(rest[i]).lower()
            if key == "normalization":
                norm = text_of(rest[i + 1]).lower()
                i += 2
                continue
            if key == "binwidth":
                binwidth = float(rest[i + 1].host().reshape(-1)[0])
                i += 2
                continue
        i += 1

    def _apply_norm(counts, edges):
        c = counts.astype(np.float64)
        n = c.sum() or 1.0
        if norm == "probability":
            return c / n
        if norm == "pdf":
            w = np.diff(edges)
            return c / (n * np.where(w == 0, 1.0, w))
        if norm == "cumcount":
            return np.cumsum(c)
        if norm == "cdf":
            return np.cumsum(c) / n
        if norm == "countdensity":
            w = np.diff(edges)
            return c / np.where(w == 0, 1.0, w)
        return c

    def _finite_host():
        # the finite values of x on the host: only the host branches below
        # need them, so a device x with explicit edges is never gathered
        hx = fortran_ravel(_f(x))
        return hx[np.isfinite(hx)]

    if binwidth is not None and bins is None:
        hx = _finite_host()
        lo = hx.min() if hx.size else 0.0
        hi = hx.max() if hx.size else 1.0
        nb = max(int(np.ceil((hi - lo) / binwidth)), 1)
        edges = lo + binwidth * np.arange(nb + 1)
        counts, edges = np.histogram(hx, bins=edges)
    elif bins is None:
        hx = _finite_host()
        nb = max(int(np.ceil(np.sqrt(hx.size))), 1)
        counts, edges = np.histogram(hx, bins=nb)
    elif bins.size == 1:
        counts, edges = np.histogram(_finite_host(),
                                     bins=int(bins.scalar_double()))
    else:
        if norm == "count" and isinstance(x, MatArray) and not x.is_complex:
            from ...accel import active_engine
            eng = active_engine()
            if eng is not None and eng.route_linalg(x):
                # exact-affine power-of-two edges (linspace over a binary
                # range) unlock the two-level MXU kernel — detected host-
                # side and stamped into the op's static opts. Only valid
                # when the f64 edges are exactly f32-representable (the
                # kernel compares in f32; single x promotes losslessly).
                affine = None
                if not bins.on_device and x.mclass == "single":
                    e64 = _f(bins).reshape(-1)
                    if np.array_equal(e64, e64.astype(np.float32)):
                        from ...ops.histogram import affine_edge_params
                        affine = affine_edge_params(
                            e64.astype(np.float32))
                # explicit edges: bin count is static -> one device kernel
                out = eng.linalg("histcounts", [x, bins],
                                 (affine,) if affine else ())
                if out is not None:
                    c = out[0]
                    if c.shape[0] > 1:
                        c = eng.reshape(c, (1, c.size))
                    res = [c, MatArray(_f(bins).reshape(1, -1), "double")]
                    return res[:max(1, nargout)]
        counts, edges = np.histogram(_finite_host(),
                                     bins=fortran_ravel(_f(bins)))
    out = [MatArray(_apply_norm(counts, edges).reshape(1, -1), "double"),
           MatArray(np.asarray(edges, np.float64).reshape(1, -1), "double")]
    return out[:max(1, nargout)]


_MOV_DEVICE = {"movmean": "mean", "movsum": "sum", "movmax": "max",
               "movmin": "min"}
_MOV_VEC = {"movmean", "movsum", "movmax", "movmin"}


def _movwin(x, k, fn, name):
    w = scalar_int(k, "window")
    kind = _MOV_DEVICE.get(name)
    # device path: one lax.reduce_window kernel (≙ provider moving_window,
    # api lib.rs:2852); vectors only (the hot case)
    if kind is not None and isinstance(x, MatArray) and not x.is_complex \
            and (x.shape[0] == 1 or x.shape[1] == 1):
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            out = eng.linalg("movwin", [x], (kind, w))
            if out is not None:
                r = out[0]
                if tuple(r.shape) != tuple(x.shape):
                    r = eng.reshape(r, tuple(x.shape))
                return r
    h = _f(x)
    ax = 0 if h.shape[0] != 1 else 1
    v = np.moveaxis(h, ax, -1)
    n = v.shape[-1]
    # even windows center on (current, previous): k/2 back, k/2-1 forward
    half_lo = w // 2
    half_hi = (w - 1) // 2
    if name in _MOV_VEC and n:
        # vectorized: prefix sums for mean/sum, padded sliding windows for
        # max/min (the old per-index Python loop was O(n) interpreter time)
        idx = np.arange(n)
        lo_i = np.maximum(idx - half_lo, 0)
        hi_i = np.minimum(idx + half_hi + 1, n)
        if name in ("movmean", "movsum"):
            c = np.concatenate([np.zeros(v.shape[:-1] + (1,)),
                                np.cumsum(v, axis=-1)], axis=-1)
            s = c[..., hi_i] - c[..., lo_i]
            out = s / (hi_i - lo_i) if name == "movmean" else s
        else:
            fill = -np.inf if name == "movmax" else np.inf
            pad_width = [(0, 0)] * (v.ndim - 1) + [(half_lo, half_hi)]
            pv = np.pad(v, pad_width, constant_values=fill)
            win = np.lib.stride_tricks.sliding_window_view(pv, w, axis=-1)
            out = win.max(-1) if name == "movmax" else win.min(-1)
    else:
        out = np.empty_like(v)
        for i in range(n):
            lo = max(0, i - half_lo)
            hi = min(n, i + half_hi + 1)
            out[..., i] = fn(v[..., lo:hi], axis=-1)
    r = np.moveaxis(out, -1, ax)
    out_class = "single" if x.mclass == "single" else "double"
    from ... import dtypes
    return MatArray(dtypes.cast_to_class(r, out_class), out_class)


def _mov_endpoints(opts):
    """Trailing ('Endpoints', mode): 'shrink' (default) | 'discard'."""
    mode = "shrink"
    i = 0
    opts = list(opts)
    while i < len(opts):
        if is_text(opts[i]) and text_of(opts[i]).lower() == "endpoints" \
                and i + 1 < len(opts):
            mode = text_of(opts[i + 1]).lower()
            i += 2
        else:
            i += 1
    if mode not in ("shrink", "discard"):
        raise bad_arg("movwindow", f"Unsupported Endpoints mode '{mode}'.")
    return mode


def _mov_discard(r, x, w):
    """Keep only full windows along the moving axis."""
    h = r.host()
    ax = 0 if x.shape[0] != 1 else 1
    half_lo = w // 2
    half_hi = (w - 1) // 2
    n = h.shape[ax]
    sl = [slice(None)] * h.ndim
    sl[ax] = slice(half_lo, n - half_hi)
    return MatArray(np.ascontiguousarray(h[tuple(sl)]), r.mclass)


def _mov_entry(x, k, fn, name, opts):
    mode = _mov_endpoints(opts)
    r = _movwin(x, k, fn, name)
    if mode == "discard":
        from ...values import MatArray as _MA
        return _mov_discard(r, x, scalar_int(k, "window"))
    return r


@builtin("movmean", category="stats", min_in=2, max_in=4)
def m_movmean(x, k, *opts):
    return _mov_entry(x, k, np.mean, "movmean", opts)


@builtin("movsum", category="stats", min_in=2, max_in=4)
def m_movsum(x, k, *opts):
    return _mov_entry(x, k, np.sum, "movsum", opts)


@builtin("movmax", category="stats", min_in=2, max_in=4)
def m_movmax(x, k, *opts):
    return _mov_entry(x, k, np.max, "movmax", opts)


@builtin("movmin", category="stats", min_in=2, max_in=4)
def m_movmin(x, k, *opts):
    return _mov_entry(x, k, np.min, "movmin", opts)


@builtin("movstd", category="stats", min_in=2, max_in=4)
def m_movstd(x, k, *opts):
    return _mov_entry(x, k, lambda v, axis: np.std(v, axis=axis, ddof=1 if v.shape[axis] > 1 else 0),
                      "movstd", opts)


@builtin("prctile", category="stats", min_in=2, max_in=2)
def m_prctile(x, p):
    hx = fortran_ravel(_f(x))
    hx = hx[~np.isnan(hx)]
    pv = _f(p).reshape(-1)
    if hx.size == 0:
        return MatArray(np.full((1, pv.size), np.nan), "double")
    # MATLAB interpolates order statistics at (k - 0.5)/n
    n = hx.size
    s = np.sort(hx)
    q = (np.arange(1, n + 1) - 0.5) / n * 100.0
    r = np.interp(pv, q, s, left=s[0], right=s[-1])
    return MatArray(np.asarray(r).reshape(1, -1), "double")


@builtin("quantile", category="stats", min_in=2, max_in=2)
def m_quantile(x, p):
    pv = p.host().astype(np.float64) * 100.0
    return m_prctile(x, MatArray(pv, "double"))


@builtin("normalize", category="stats", min_in=1, max_in=3)
def m_normalize(x, *opts):
    h = _f(x)
    method = "zscore"
    for o in opts:
        if is_text(o):
            method = text_of(o)
    ax = 0 if h.shape[0] != 1 else 1
    if method == "zscore":
        mu = np.mean(h, axis=ax, keepdims=True)
        sd = np.std(h, axis=ax, keepdims=True, ddof=1)
        r = (h - mu) / np.where(sd == 0, 1, sd)
    elif method == "range":
        lo = np.min(h, axis=ax, keepdims=True)
        hi = np.max(h, axis=ax, keepdims=True)
        r = (h - lo) / np.where(hi - lo == 0, 1, hi - lo)
    elif method == "norm":
        nrm = np.linalg.norm(h, axis=ax, keepdims=True)
        r = h / np.where(nrm == 0, 1, nrm)
    elif method == "center":
        r = h - np.mean(h, axis=ax, keepdims=True)
    else:
        raise bad_arg("normalize", f"Unknown method '{method}'.")
    out_class = "single" if x.mclass == "single" else "double"
    from ... import dtypes
    return MatArray(dtypes.cast_to_class(r, out_class), out_class)
