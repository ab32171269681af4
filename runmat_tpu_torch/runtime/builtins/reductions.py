"""Copy of runmat_tpu/runtime/builtins/reductions.py in the PyTorch port.

Reduction builtins: sum/prod/mean/median/std/var/min/max/any/all/cumsum/...

Reference parity: runmat-runtime/src/builtins/math/reduction + provider
reduction hooks (runmat-accelerate-api/src/lib.rs sum/mean/std/... + _dim/_nd
variants, two-pass thresholds :3048-3058). MATLAB semantics: default dim =
first non-singleton; 'all' / vecdim; 'omitnan'; 'native'/'double' accumulation
classes; min/max ignore NaN and support the elementwise two-arg form.
"""

from __future__ import annotations

import numpy as np

from ... import dtypes
from ...errors import MatError, bad_arg
from ...values import MatArray, is_text, normalize_shape, text_of
from ..dispatch import binary
from ..registry import builtin

_TYPE_OPTS = ("double", "native", "default", "extremes")
_NAN_OPTS = ("omitnan", "includenan")


def _parse_opts(args: list, allow_vecdim: bool = True):
    """Trailing args -> (dims, type_mode, nan_mode). dims: None | 'all' | tuple
    of 1-based dims."""
    dims = None
    type_mode = "default"
    nan_mode = None
    for a in args:
        if is_text(a):
            t = text_of(a).lower()
            if t == "all":
                dims = "all"
            elif t in _TYPE_OPTS:
                type_mode = t
            elif t in _NAN_OPTS:
                nan_mode = t
            else:
                raise bad_arg("reduction", f"Unknown option '{t}'.")
        elif isinstance(a, MatArray):
            if a.size == 1:
                dims = (int(a.scalar_double()),)
            else:
                if not allow_vecdim:
                    raise bad_arg("reduction", "Vector dims not supported here.")
                dims = tuple(int(x) for x in a.host().reshape(-1))
        else:
            raise bad_arg("reduction", "Invalid option.")
    return dims, type_mode, nan_mode


def _axes_for(x_shape: tuple, dims) -> tuple:
    if dims == "all":
        return tuple(range(len(x_shape)))
    if dims is None:
        for i, d in enumerate(x_shape):
            if d != 1:
                return (i,)
        return (0,)
    axes = tuple(d - 1 for d in dims)
    for a in axes:
        if a < 0:
            raise bad_arg("reduction", "Dimension must be positive.")
    return tuple(a for a in axes if a < len(x_shape))


def _norm_result(r: np.ndarray, mclass: str) -> MatArray:
    r = np.asarray(r)
    if r.ndim < 2:
        r = r.reshape(normalize_shape(r.shape))
    else:
        r = r.reshape(normalize_shape(r.shape))
    return MatArray(r, mclass)


def _acc_class(x: MatArray, type_mode: str, default_native: bool) -> str:
    if type_mode == "native":
        if x.mclass == "char":
            raise bad_arg("sum", "'native' is not supported for char input.")
        return "logical" if x.mclass == "logical" else x.mclass
    if type_mode == "double":
        return "double"
    # 'default': single stays single; integers stay native; logical/char -> double
    if x.mclass == "single":
        return "single"
    if dtypes.is_integer_class(x.mclass) and default_native:
        return x.mclass
    return "double"


# single sums and means accumulate in double and round once (the port's
# repair: numpy's float32 accumulation over several axes drifts, 3.9e-5
# relative for the mean of a 2160 x 3840 frame); the JAX host engine keeps
# float32 accumulation
_WIDE = {np.dtype(np.float32): np.float64, np.dtype(np.complex64): np.complex128}


def _engine():
    from ...accel import active_engine
    return active_engine()


def _device_reduce(op, x, axes, keep_class, nan_mode):
    eng = _engine()
    if eng is None or not isinstance(x, MatArray) or not x.on_device:
        return None
    return eng.reduce(op, x, axes, keep_class, nan_mode)


def _host_data(x: MatArray, acc: str) -> np.ndarray:
    h = x.host()
    if acc in ("double",):
        return h.real.astype(np.float64) if (h.dtype.kind == "c" and False) else h.astype(
            np.complex128 if h.dtype.kind == "c" else np.float64)
    if acc == "single":
        return h.astype(np.complex64 if h.dtype.kind == "c" else np.float32)
    if dtypes.is_integer_class(acc):
        return h.astype(np.float64)  # accumulate wide, saturate at the end
    return h


@builtin("sum", category="math/reduction", min_in=1, accel_op="reduce_sum")
def m_sum(x, *rest):
    dims, type_mode, nan_mode = _parse_opts(list(rest))
    if x.size == 0 and x.shape == (0, 0) and dims is None:
        return MatArray.scalar(0.0)   # MATLAB: sum([]) == 0
    acc = _acc_class(x, type_mode, default_native=True)
    if acc == "logical":
        acc = x.mclass if x.mclass != "logical" else "double"
    axes = _axes_for(x.shape, dims)
    dv = _device_reduce("sum", x, axes, acc, nan_mode)
    if dv is not None:
        return dv
    h = _host_data(x, acc)
    wide = _WIDE.get(h.dtype)
    with np.errstate(all="ignore"):
        r = (np.nansum(h, axis=axes, keepdims=True, dtype=wide)
             if nan_mode == "omitnan"
             else np.sum(h, axis=axes, keepdims=True, dtype=wide))
    if dtypes.is_integer_class(acc):
        return _norm_result(dtypes.saturate_cast(r, acc), acc)
    return _norm_result(r.astype(h.dtype) if wide else r, acc)


@builtin("prod", category="math/reduction", min_in=1, accel_op="reduce_prod")
def m_prod(x, *rest):
    dims, type_mode, nan_mode = _parse_opts(list(rest))
    if x.size == 0 and x.shape == (0, 0) and dims is None:
        return MatArray.scalar(1.0)   # MATLAB: prod([]) == 1
    acc = _acc_class(x, type_mode, default_native=True)
    if acc == "logical":
        acc = "double"
    axes = _axes_for(x.shape, dims)
    h = _host_data(x, acc)
    with np.errstate(all="ignore"):
        r = (np.nanprod(h, axis=axes, keepdims=True) if nan_mode == "omitnan"
             else np.prod(h, axis=axes, keepdims=True))
    if dtypes.is_integer_class(acc):
        return _norm_result(dtypes.saturate_cast(r, acc), acc)
    return _norm_result(r, acc)


@builtin("mean", category="math/reduction", min_in=1, accel_op="reduce_mean")
def m_mean(x, *rest):
    dims, type_mode, nan_mode = _parse_opts(list(rest))
    if x.size == 0 and x.shape == (0, 0) and dims is None:
        return MatArray.scalar(float("nan"))   # MATLAB: mean([]) == NaN
    acc = _acc_class(x, type_mode, default_native=False)
    if acc == "logical":
        acc = "double"
    axes = _axes_for(x.shape, dims)
    dv = _device_reduce("mean", x, axes, acc, nan_mode)
    if dv is not None:
        return dv
    h = _host_data(x, acc if not dtypes.is_integer_class(acc) else "double")
    wide = _WIDE.get(h.dtype)
    with np.errstate(all="ignore"):
        r = (np.nanmean(h, axis=axes, keepdims=True, dtype=wide)
             if nan_mode == "omitnan"
             else np.mean(h, axis=axes, keepdims=True, dtype=wide))
    if dtypes.is_integer_class(acc):
        return _norm_result(dtypes.saturate_cast(r, acc), acc)
    return _norm_result(r.astype(h.dtype) if acc == "single" else r, acc)


@builtin("median", category="math/reduction", min_in=1)
def m_median(x, *rest):
    dims, type_mode, nan_mode = _parse_opts(list(rest))
    axes = _axes_for(x.shape, dims)
    acc = "single" if x.mclass == "single" else "double"
    if isinstance(x, MatArray) and all(s == 0 for s in x.shape):
        # doc median: median([]) is NaN (np.median of a 0x0 gives a 0-size
        # result instead)
        return MatArray(np.full((1, 1), np.nan), acc)
    if isinstance(x, MatArray) and x.on_device and not x.is_complex:
        dv = _device_reduce("median", x, axes, acc, nan_mode)
        if dv is not None:
            return dv
    h = _host_data(x, acc)
    if len(axes) != 1:
        h2 = h
        # collapse vecdim axes into one
        order = [i for i in range(h.ndim) if i not in axes] + list(axes)
        h2 = np.transpose(h, order)
        lead = h2.shape[:h.ndim - len(axes)]
        h2 = h2.reshape(lead + (-1,))
        with np.errstate(all="ignore"):
            r = (np.nanmedian(h2, axis=-1, keepdims=True) if nan_mode == "omitnan"
                 else np.median(h2, axis=-1, keepdims=True))
        r = r.reshape(lead + (1,) * len(axes))
        inv = np.argsort(order)
        r = np.transpose(r, inv)
    else:
        with np.errstate(all="ignore"):
            r = (np.nanmedian(h, axis=axes[0], keepdims=True) if nan_mode == "omitnan"
                 else np.median(h, axis=axes[0], keepdims=True))
    return _norm_result(r.astype(h.dtype, copy=False), acc)


def _spread(x, rest, fn_biased, fn_unbiased, op_name):
    rest = list(rest)
    w = 0
    dims = None
    nan_mode = None
    type_mode = "default"
    # std(X), std(X,w), std(X,w,dim), std(X,w,'all'), + nanflag
    pos = []
    for a in rest:
        if is_text(a):
            t = text_of(a).lower()
            if t == "all":
                dims = "all"
            elif t in _NAN_OPTS:
                nan_mode = t
            else:
                raise bad_arg(op_name, f"Unknown option '{t}'.")
        else:
            pos.append(a)
    if len(pos) >= 1 and isinstance(pos[0], MatArray) and pos[0].size:
        w = int(pos[0].scalar_double())
    if len(pos) >= 2:
        if pos[1].size == 1:
            dims = (int(pos[1].scalar_double()),)
        else:
            dims = tuple(int(v) for v in pos[1].host().reshape(-1))
    acc = "single" if x.mclass == "single" else "double"
    if isinstance(x, MatArray) and all(s == 0 for s in x.shape):
        # doc std/var: std([]) is NaN (numpy returns a 0-size result)
        return MatArray(np.full((1, 1), np.nan), acc)
    axes = _axes_for(x.shape, dims)
    dv = _device_reduce(op_name + str(w), x, axes, acc, nan_mode)
    if dv is not None:
        return dv
    h = _host_data(x, acc)
    ddof = 0 if w == 1 else 1
    with np.errstate(all="ignore"):
        if nan_mode == "omitnan":
            r = (np.nanstd if op_name == "std" else np.nanvar)(h, axis=axes, keepdims=True, ddof=ddof)
        else:
            r = (np.std if op_name == "std" else np.var)(h, axis=axes, keepdims=True, ddof=ddof)
    return _norm_result(r.astype(np.float32) if acc == "single" else r, acc)


@builtin("std", category="stats", min_in=1)
def m_std(x, *rest):
    return _spread(x, rest, None, None, "std")


@builtin("var", category="stats", min_in=1)
def m_var(x, *rest):
    return _spread(x, rest, None, None, "var")


def _complex_minmax(hf, axes, which, include_nan):
    """Complex max/min per doc: ordered by abs(), ties by angle(); NaN
    entries ignored unless include_nan. Returns (keepdims values, picked
    index along the collapsed axis)."""
    perm = [i for i in range(hf.ndim) if i not in axes] + list(axes)
    ht = np.transpose(hf, perm)
    lead = ht.shape[:hf.ndim - len(axes)]
    ht2 = ht.reshape(lead + (-1,))
    kabs, kang = np.abs(ht2), np.angle(ht2)
    nanm = np.isnan(ht2.real) | np.isnan(ht2.imag)
    fill = -np.inf if which == "max" else np.inf
    kabs = np.where(nanm, fill, kabs)
    kang = np.where(nanm, fill, kang)
    order = np.lexsort((kang, kabs), axis=-1)
    pick = order[..., -1] if which == "max" else order[..., 0]
    vals = np.take_along_axis(ht2, pick[..., None], axis=-1)[..., 0]
    bad = nanm.any(axis=-1) if include_nan else nanm.all(axis=-1)
    vals = np.where(bad, complex(np.nan, np.nan), vals)
    vals_kd = vals.reshape(lead + (1,) * len(axes))
    return np.transpose(vals_kd, np.argsort(perm)), pick


def _minmax(x, args, nargout, which: str):
    args = list(args)
    # elementwise two-arg form: max(X, Y) (Y nonempty)
    if args and isinstance(args[0], MatArray) and args[0].size > 0:
        if nargout > 1:
            raise MatError("MATLAB:max:twoInOneOut",
                           "MAX with two matrices to compare and two output arguments "
                           "is not supported.")
        return [binary("min2" if which == "min" else "max2", x, args[0])]
    dims = None
    nan_mode = None
    rest = args[1:] if args else []
    for a in rest:
        if is_text(a):
            t = text_of(a).lower()
            if t == "all":
                dims = "all"
            elif t in _NAN_OPTS:
                nan_mode = t
            elif t == "linear":
                pass
            else:
                raise bad_arg(which, f"Unknown option '{t}'.")
        elif isinstance(a, MatArray):
            if a.size == 1:
                dims = (int(a.scalar_double()),)
            else:
                dims = tuple(int(v) for v in a.host().reshape(-1))
    axes = _axes_for(x.shape, dims)
    acc = x.mclass if x.mclass != "logical" else "logical"
    if x.size == 0:
        # MATLAB: max([]) == []; a zero-length reduced axis stays empty
        # (no identity element, unlike sum/prod)
        h = x.host()
        shp = [0 if (i in axes and d == 0) else (1 if i in axes else d)
               for i, d in enumerate(h.shape)]
        empty = np.zeros(shp, dtype=h.dtype)
        outs = [_norm_result(empty, x.mclass),
                _norm_result(empty.astype(np.float64), "double")]
        return outs[:max(1, nargout)]
    if nargout <= 1:
        dv = _device_reduce(which, x, axes, acc, nan_mode)
        if dv is not None:
            return [dv]
    h = x.host()
    hf = h.astype(np.float64) if h.dtype.kind == "b" else h
    include_nan = nan_mode == "includenan"
    fn = (np.nanmin if which == "min" else np.nanmax) if not include_nan else \
        (np.min if which == "min" else np.max)
    if hf.size == 0:
        empty = np.zeros([1 if i in axes else d for i, d in enumerate(hf.shape)],
                         dtype=hf.dtype)
        if 0 in empty.shape:
            return [_norm_result(empty, x.mclass), _norm_result(empty.astype(np.float64), "double")][:max(1, nargout)]
    if np.iscomplexobj(hf):
        # doc max/min of complex: by abs(), ties broken by angle() — numpy
        # compares complex lexicographically by (real, imag), which is wrong
        vals, pick = _complex_minmax(hf, axes, which, include_nan)
        out = _norm_result(vals.astype(h.dtype, copy=False), x.mclass)
        if nargout <= 1:
            return [out]
        if len(axes) != 1:
            raise bad_arg(which,
                          "Index output requires a single reduction dimension.")
        idx = np.expand_dims(pick, axes[0]).astype(np.float64) + 1.0
        return [out, _norm_result(idx, "double")]
    with np.errstate(all="ignore"):
        vals = fn(hf, axis=axes if len(axes) > 1 else axes[0], keepdims=True)
    out = _norm_result(np.asarray(vals).astype(h.dtype, copy=False), x.mclass)
    if nargout <= 1:
        return [out]
    if len(axes) > 1:
        if dims == "all":
            # [m, i] = max(A, [], 'all', 'linear'): linear F-order index
            flat = hf.reshape(-1, order="F")
            if not include_nan and hf.dtype.kind == "f":
                fill = np.inf if which == "min" else -np.inf
                flat = np.where(np.isnan(flat), fill, flat)
            li = (np.argmin(flat) if which == "min" else np.argmax(flat))
            return [out, _norm_result(np.array([[float(li) + 1.0]]),
                                      "double")]
        raise bad_arg(which, "Index output requires a single reduction dimension.")
    ax = axes[0]
    if not include_nan and hf.dtype.kind == "f":
        allnan = np.all(np.isnan(hf), axis=ax, keepdims=True)
        if allnan.any():
            fill = np.inf if which == "min" else -np.inf
            safe = np.where(np.isnan(hf), fill, hf)
            idx = (np.argmin(safe, axis=ax) if which == "min" else np.argmax(safe, axis=ax))
        else:
            with np.errstate(all="ignore"):
                idx = (np.nanargmin(hf, axis=ax) if which == "min" else np.nanargmax(hf, axis=ax))
    else:
        idx = (np.argmin(hf, axis=ax) if which == "min" else np.argmax(hf, axis=ax))
    idx = np.expand_dims(idx, ax).astype(np.float64) + 1.0
    return [out, _norm_result(idx, "double")]


@builtin("max", category="math/reduction", min_in=1, max_out=2, pass_nargout=True,
         accel_op="reduce_max")
def m_max(x, *rest, nargout=1):
    return _minmax(x, rest, nargout, "max")


@builtin("min", category="math/reduction", min_in=1, max_out=2, pass_nargout=True,
         accel_op="reduce_min")
def m_min(x, *rest, nargout=1):
    return _minmax(x, rest, nargout, "min")


@builtin("any", category="math/reduction", min_in=1, accel_op="reduce_any")
def m_any(x, *rest):
    dims, _, _ = _parse_opts(list(rest))
    if x.size == 0 and x.shape == (0, 0) and dims is None:
        return MatArray.logical_scalar(False)   # MATLAB: any([]) == false
    axes = _axes_for(x.shape, dims)
    dv = _device_reduce("any", x, axes, "logical", None)
    if dv is not None:
        return dv
    h = x.host()
    # NaN counts as nonzero in MATLAB any()
    r = np.any(h != 0, axis=axes, keepdims=True)
    return _norm_result(r, "logical")


@builtin("all", category="math/reduction", min_in=1, accel_op="reduce_all")
def m_all(x, *rest):
    dims, _, _ = _parse_opts(list(rest))
    if x.size == 0 and x.shape == (0, 0) and dims is None:
        return MatArray.logical_scalar(True)   # MATLAB: all([]) == true
    axes = _axes_for(x.shape, dims)
    dv = _device_reduce("all", x, axes, "logical", None)
    if dv is not None:
        return dv
    r = np.all(x.host() != 0, axis=axes, keepdims=True)
    return _norm_result(r, "logical")


@builtin("nnz", category="math/reduction", min_in=1, max_in=1)
def m_nnz(x):
    if type(x).__name__ == "SparseMatrix":
        from ...values import MatArray as _MA
        return _MA.scalar(float(x.prune().nnz))
    if isinstance(x, MatArray) and x.on_device:
        dv = _device_reduce("nnz", x, tuple(range(len(x.shape))), "double",
                            None)
        if dv is not None:
            return dv
    return MatArray.scalar(float(np.count_nonzero(x.host())))


def _cum(x, rest, npfn, nanfn, name):
    rest = list(rest)
    dim = None
    reverse = False
    nan_mode = None
    for a in rest:
        if is_text(a):
            t = text_of(a).lower()
            if t == "reverse":
                reverse = True
            elif t in _NAN_OPTS:
                nan_mode = t
            elif t == "forward":
                pass
            else:
                raise bad_arg(name, f"Unknown option '{t}'.")
        elif isinstance(a, MatArray):
            dim = int(a.scalar_double())
    ax = (dim - 1) if dim else _axes_for(x.shape, None)[0]
    acc = "single" if x.mclass == "single" else ("double" if x.mclass in ("logical", "char") else x.mclass)
    if isinstance(x, MatArray) and x.on_device and \
            not dtypes.is_integer_class(acc) and not x.is_complex:
        eng = _engine()
        if eng is not None:
            dv = eng.scan(name, x, ax, reverse, nan_mode == "omitnan", acc)
            if dv is not None:
                return dv
    h = _host_data(x, acc if not dtypes.is_integer_class(acc) else "double")
    if reverse:
        h = np.flip(h, axis=ax)
    fn = nanfn if nan_mode == "omitnan" else npfn
    with np.errstate(all="ignore"):
        r = fn(h, axis=ax)
    if reverse:
        r = np.flip(r, axis=ax)
    if dtypes.is_integer_class(acc):
        return _norm_result(dtypes.saturate_cast(r, acc), acc)
    return _norm_result(r, acc)


@builtin("cumsum", category="math/reduction", min_in=1)
def m_cumsum(x, *rest):
    return _cum(x, rest, np.cumsum, np.nancumsum, "cumsum")


@builtin("cumprod", category="math/reduction", min_in=1)
def m_cumprod(x, *rest):
    return _cum(x, rest, np.cumprod, np.nancumprod, "cumprod")


def _cum_minmax_dev(x, rest, name):
    if not (isinstance(x, MatArray) and x.on_device) or x.is_complex or \
            x.mclass not in ("double", "single"):
        return None
    eng = _engine()
    if eng is None:
        return None
    dim = int(rest[0].scalar_double()) - 1 if rest and isinstance(rest[0], MatArray) else \
        _axes_for(x.shape, None)[0]
    acc = "single" if x.mclass == "single" else "double"
    return eng.scan(name, x, dim, False, False, acc)


@builtin("cummax", category="math/reduction", min_in=1)
def m_cummax(x, *rest):
    dv = _cum_minmax_dev(x, rest, "cummax")
    if dv is not None:
        return dv
    h = x.host()
    dim = int(rest[0].scalar_double()) - 1 if rest and isinstance(rest[0], MatArray) else \
        _axes_for(x.shape, None)[0]
    r = np.fmax.accumulate(h, axis=dim)
    return _norm_result(r, x.mclass)


@builtin("cummin", category="math/reduction", min_in=1)
def m_cummin(x, *rest):
    dv = _cum_minmax_dev(x, rest, "cummin")
    if dv is not None:
        return dv
    h = x.host()
    dim = int(rest[0].scalar_double()) - 1 if rest and isinstance(rest[0], MatArray) else \
        _axes_for(x.shape, None)[0]
    r = np.fmin.accumulate(h, axis=dim)
    return _norm_result(r, x.mclass)


@builtin("trapz", category="math/reduction", min_in=1, max_in=3)
def m_trapz(a, b=None, c=None):
    from ...accel import active_engine
    eng = active_engine()
    if b is None:
        if a.on_device and not a.is_complex and eng is not None:
            ax = _axes_for(a.shape, None)[0]
            out = eng.linalg("trapz", [a], (ax, False))
            if out is not None:
                return out[0]
        y = a.host().astype(np.float64)
        ax = _axes_for(a.shape, None)[0]
        return _norm_result(np.trapezoid(y, axis=ax), "double")
    if c is None and isinstance(b, MatArray) and b.size > 1:
        if (a.on_device or b.on_device) and not a.is_complex and \
                not b.is_complex and eng is not None:
            ax = _axes_for(b.shape, None)[0]
            out = eng.linalg("trapz", [a, b], (ax, True))
            if out is not None:
                return out[0]
        xh = a.host().astype(np.float64).reshape(-1)
        y = b.host().astype(np.float64)
        ax = _axes_for(b.shape, None)[0]
        return _norm_result(np.trapezoid(y, x=xh, axis=ax), "double")
    y = a.host().astype(np.float64)
    ax = int(b.scalar_double()) - 1 if c is None else int(c.scalar_double()) - 1
    xh = None if c is None else a.host().astype(np.float64).reshape(-1)
    if c is not None:
        y = b.host().astype(np.float64)
    return _norm_result(np.trapezoid(y, x=xh, axis=ax), "double")


@builtin("mode", category="stats", min_in=1, max_in=2)
def m_mode(x, dim=None):
    if isinstance(x, MatArray) and x.on_device and dim is None and \
            not x.is_complex and x.mclass in ("double", "single") and \
            len([s for s in x.shape if s > 1]) <= 1:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            out = eng.linalg("mode", [x], (), out_class=x.mclass)
            if out is not None:
                return out[0]
    h = x.host().astype(np.float64)
    ax = int(dim.scalar_double()) - 1 if dim is not None else _axes_for(x.shape, None)[0]

    def col_mode(v):
        v = v[~np.isnan(v)] if v.dtype.kind == "f" else v
        if v.size == 0:
            return np.nan
        vals, counts = np.unique(v, return_counts=True)
        return vals[np.argmax(counts)]

    r = np.apply_along_axis(col_mode, ax, h)
    r = np.expand_dims(r, ax)
    return _norm_result(dtypes.cast_to_class(r, x.mclass if x.mclass != "logical" else "double"),
                        x.mclass if x.mclass != "logical" else "double")
