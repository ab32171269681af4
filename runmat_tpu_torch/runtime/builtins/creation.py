"""Copy of runmat_tpu/runtime/builtins/creation.py in the PyTorch port.

Array creation & conversion builtins: zeros/ones/eye/linspace/..., class
conversions, constants.

Reference parity: runmat-runtime/src/builtins/array + constants; provider
creation hooks (runmat-accelerate-api/src/lib.rs zeros/ones/eye/linspace).
'like' residency propagation: a device prototype yields a device result
(≙ builtins/acceleration 'like' semantics)."""

from __future__ import annotations

import numpy as np

from ... import dtypes
from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, StructArray, is_text,
                       normalize_shape, text_of)
from ..registry import builtin, register_alias
from .common import parse_size_args, scalar_int, scalar_num


def _engine():
    from ...accel import active_engine
    return active_engine()


def _fill(dims, value, mclass, like):
    on_device = False
    if like is not None:
        lcls, ldev, _ = _proto_info(like)
        if mclass is None:
            mclass = lcls
        on_device = ldev
    if mclass is None:
        mclass = "double"
    eng = _engine()
    n = 1
    for d in normalize_shape(dims):
        n *= d
    if eng is not None and (on_device or (eng.offload_creation(n)
                                          and mclass in ("double", "single"))):
        return eng.full(dims, value, mclass)
    dt = dtypes.np_dtype(mclass)
    return MatArray(np.full(normalize_shape(dims), value, dtype=dt), mclass)


def _proto_info(proto):
    if isinstance(proto, MatArray):
        return proto.mclass, proto.on_device, proto.is_complex
    raise bad_arg("like", "Prototype for 'like' must be numeric.")


@builtin("zeros", category="array/creation", pass_nargout=False)
def m_zeros(*args):
    dims, mclass, like = parse_size_args(list(args))
    return _fill(dims, 0, mclass, like)


@builtin("ones", category="array/creation")
def m_ones(*args):
    dims, mclass, like = parse_size_args(list(args))
    return _fill(dims, 1, mclass, like)


@builtin("nan", category="array/creation")
def m_nan(*args):
    dims, mclass, like = parse_size_args(list(args))
    return _fill(dims, np.nan, mclass or "double", like)


register_alias("NaN", "nan")


@builtin("inf", category="array/creation")
def m_inf(*args):
    dims, mclass, like = parse_size_args(list(args))
    return _fill(dims, np.inf, mclass or "double", like)


register_alias("Inf", "inf")


@builtin("eye", category="array/creation")
def m_eye(*args):
    dims, mclass, like = parse_size_args(list(args))
    if like is not None and mclass is None:
        mclass = _proto_info(like)[0]
    mclass = mclass or "double"
    m = dims[0]
    n = dims[1] if len(dims) > 1 else m
    return MatArray(np.eye(m, n, dtype=dtypes.np_dtype(mclass)), mclass)


@builtin("true", category="array/creation")
def m_true(*args):
    dims, _, like = parse_size_args(list(args))
    return _fill(dims, True, "logical", like)


@builtin("false", category="array/creation")
def m_false(*args):
    dims, _, like = parse_size_args(list(args))
    return _fill(dims, False, "logical", like)


@builtin("linspace", category="array/creation", min_in=2, max_in=3)
def m_linspace(a, b, n=None):
    start = scalar_num(a, "start")
    stop = scalar_num(b, "stop")
    npts = 100 if n is None else scalar_int(n, "n")
    out_class = "single" if (isinstance(a, MatArray) and a.mclass == "single") or \
        (isinstance(b, MatArray) and b.mclass == "single") else "double"
    if npts <= 0:
        return MatArray(np.zeros((1, 0)), "double")
    if npts == 1:
        # doc linspace: "linspace(x1, x2, 1) returns x2" (the ENDPOINT,
        # not the start — np.linspace returns x1 here)
        return MatArray(dtypes.cast_to_class(
            np.array([[stop]], dtype=np.float64), out_class), out_class)
    eng = _engine()
    if eng is not None and eng.offload_creation(npts):
        return eng.linspace(start, stop, npts, out_class)
    vals = np.linspace(start, stop, npts, dtype=np.float64).reshape(1, -1)
    return MatArray(dtypes.cast_to_class(vals, out_class), out_class)


@builtin("logspace", category="array/creation", min_in=2, max_in=3)
def m_logspace(a, b, n=None):
    start = scalar_num(a)
    stop = scalar_num(b)
    npts = 50 if n is None else scalar_int(n)
    vals = np.logspace(start, stop, npts).reshape(1, -1)
    return MatArray(vals, "double")


@builtin("colon", category="array/creation", min_in=2, max_in=3)
def m_colon(a, b, c=None):
    from ...vm.interp import _make_range
    if c is None:
        return _make_range(a, None, b)
    return _make_range(a, b, c)


@builtin("cell", category="cells")
def m_cell(*args):
    dims, _, _ = parse_size_args(list(args))
    return CellArray.filled(dims)


@builtin("struct", category="structs")
def m_struct(*args):
    if len(args) == 0:
        return StructArray.scalar({})
    if len(args) % 2 != 0:
        raise bad_arg("struct", "Field names and values must come in pairs.")
    # cell values create struct arrays
    shapes = [a.shape for a in args[1::2] if isinstance(a, CellArray)]
    shape = shapes[0] if shapes else (1, 1)
    for s in shapes:
        if s != shape and int(np.prod(s)) != 1:
            raise bad_arg("struct", "Field value cell arrays must be the same size.")
    fields = {}
    for i in range(0, len(args), 2):
        name = text_of(args[i])
        val = args[i + 1]
        arr = np.empty(shape, dtype=object)
        flat = arr.reshape(-1)
        if isinstance(val, CellArray):
            vflat = val.data.reshape(-1, order="F")
            for j in range(flat.size):
                flat[j] = vflat[j if val.size > 1 else 0]
        else:
            for j in range(flat.size):
                flat[j] = val
        fields[name] = arr
    return StructArray(fields, shape)


# ------------------------------ constants ------------------------------------ #

@builtin("pi", category="constants", max_in=0)
def m_pi():
    return MatArray.scalar(np.pi)


@builtin("e", category="constants", max_in=0)
def m_e():
    return MatArray.scalar(np.e)


@builtin("eps", category="constants", max_in=1)
def m_eps(x=None):
    if x is None:
        return MatArray.scalar(np.finfo(np.float64).eps)
    if is_text(x):
        t = text_of(x)
        if t == "single":
            return MatArray(np.full((1, 1), np.finfo(np.float32).eps, dtype=np.float32), "single")
        return MatArray.scalar(np.finfo(np.float64).eps)
    h = x.host()
    dt = np.float32 if x.mclass == "single" else np.float64
    return MatArray(np.spacing(np.abs(h.astype(dt))), x.mclass)


@builtin("i", category="constants", max_in=0)
def m_i():
    return MatArray(np.full((1, 1), 1j, dtype=np.complex128), "double")


register_alias("j", "i")


@builtin("intmax", category="constants", max_in=1)
def m_intmax(cls=None):
    c = text_of(cls) if cls is not None else "int32"
    if not dtypes.is_integer_class(c):
        raise bad_arg("intmax", f"Invalid integer class '{c}'.")
    return MatArray(np.full((1, 1), dtypes.int_range(c)[1], dtype=dtypes.np_dtype(c)), c)


@builtin("intmin", category="constants", max_in=1)
def m_intmin(cls=None):
    c = text_of(cls) if cls is not None else "int32"
    if not dtypes.is_integer_class(c):
        raise bad_arg("intmin", f"Invalid integer class '{c}'.")
    return MatArray(np.full((1, 1), dtypes.int_range(c)[0], dtype=dtypes.np_dtype(c)), c)


@builtin("realmax", category="constants", max_in=1)
def m_realmax(cls=None):
    if cls is not None and text_of(cls) == "single":
        return MatArray(np.full((1, 1), np.finfo(np.float32).max, dtype=np.float32), "single")
    return MatArray.scalar(np.finfo(np.float64).max)


@builtin("realmin", category="constants", max_in=1)
def m_realmin(cls=None):
    if cls is not None and text_of(cls) == "single":
        return MatArray(np.full((1, 1), np.finfo(np.float32).tiny, dtype=np.float32), "single")
    return MatArray.scalar(np.finfo(np.float64).tiny)


# ------------------------------ conversions ---------------------------------- #

def _convert(x, mclass: str):
    if type(x).__name__ == "SymValue" and mclass == "double":
        from .symbolic import sym_to_double
        return sym_to_double(x)
    if isinstance(x, StringArray):
        if mclass == "char":
            return MatArray.char_from_str(x.item() or "")
        if mclass == "double":
            vals = np.empty(x.shape, dtype=np.float64)
            flat_in = x.data.reshape(-1)
            flat_out = vals.reshape(-1)
            for k in range(flat_in.size):
                try:
                    flat_out[k] = float(flat_in[k])
                except (TypeError, ValueError):
                    flat_out[k] = np.nan
            return MatArray(vals, "double")
        raise bad_arg(mclass, "Cannot convert string to this class.")
    if not isinstance(x, MatArray):
        raise bad_arg(mclass, f"Cannot convert {type(x).__name__} to {mclass}.")
    if x.on_device and mclass in ("double", "single"):
        eng = _engine()
        if eng is not None:
            return eng.convert(x, mclass)
    h = x.host()
    if x.mclass == mclass:
        return x
    return MatArray(dtypes.cast_to_class(h, mclass), mclass)


for _cls in ("double", "single", "int8", "int16", "int32", "int64",
             "uint8", "uint16", "uint32", "uint64", "logical"):
    def _mk(c):
        @builtin(c, category="conversion", min_in=1, max_in=1)
        def _conv(x, _c=c):
            return _convert(x, _c)
        return _conv
    _mk(_cls)


@builtin("char", category="conversion", min_in=1)
def m_char(*args):
    parts = []
    for x in args:
        if isinstance(x, StringArray):
            flat = x.data.reshape(-1, order="F")
            for s in flat:
                parts.append(MatArray.char_from_str(s or ""))
        elif isinstance(x, MatArray):
            if x.mclass == "char":
                parts.append(x)
            else:
                parts.append(MatArray(dtypes.cast_to_class(x.host(), "char"), "char"))
        else:
            raise bad_arg("char", "Invalid input.")
    if len(parts) == 1:
        return parts[0]
    # vertical concat with space padding
    width = max(p.shape[1] if p.ndim >= 2 else 0 for p in parts)
    rows = []
    for p in parts:
        h = p.host()
        if h.ndim < 2:
            h = h.reshape(1, -1)
        pad = width - h.shape[1]
        if pad > 0:
            h = np.concatenate([h, np.full((h.shape[0], pad), ord(" "), dtype=np.uint32)], axis=1)
        rows.append(h)
    return MatArray(np.concatenate(rows, axis=0), "char")


@builtin("string", category="conversion", min_in=0)
def m_string(x=None):
    if x is None:
        return StringArray.scalar("")
    if isinstance(x, StringArray):
        return x
    if isinstance(x, MatArray):
        if x.mclass == "char":
            h = x.host()
            if h.size == 0:
                return StringArray.scalar("")
            if h.shape[0] == 1:
                return StringArray.scalar(x.to_str())
            col = np.empty((h.shape[0], 1), dtype=object)
            for r in range(h.shape[0]):
                col[r, 0] = "".join(chr(int(c)) for c in h[r])
            return StringArray(col)
        h = x.host()
        out = np.empty(h.shape, dtype=object)
        fi, fo = h.reshape(-1), out.reshape(-1)
        from ..dispatch import _fmt_num_short
        for k in range(fi.size):
            v = fi[k]
            fv = float(v.real) if np.iscomplexobj(h) else float(v)
            if np.isnan(fv):
                fo[k] = None          # doc: string(NaN) is the missing string
            elif np.isinf(fv):
                fo[k] = "Inf" if fv > 0 else "-Inf"
            else:
                fo[k] = _fmt_num_short(v)
        return StringArray(out)
    if isinstance(x, CellArray):
        out = np.empty(x.shape, dtype=object)
        fi = x.data.reshape(-1)
        fo = out.reshape(-1)
        for k in range(fi.size):
            v = fi[k]
            fo[k] = v.to_str() if isinstance(v, MatArray) and v.mclass == "char" else \
                (v.item() if isinstance(v, StringArray) else None)
        return StringArray(out)
    if type(x).__name__ == "MatDatetime":
        import datetime as _pydt
        out = np.empty(x.shape, dtype=object)
        fi = x.data.reshape(-1)
        fo = out.reshape(-1)
        for k in range(fi.size):
            if np.isnat(fi[k]):
                fo[k] = None                       # missing string for NaT
                continue
            t = fi[k].astype(_pydt.datetime)
            fmt = "%d-%b-%Y" if (t.hour, t.minute, t.second,
                                 t.microsecond) == (0, 0, 0, 0) \
                else "%d-%b-%Y %H:%M:%S"
            fo[k] = t.strftime(fmt)
        return StringArray(out)
    if type(x).__name__ == "MatDuration":
        out = np.empty(x.shape, dtype=object)
        secs = x.seconds_array().reshape(-1)
        fo = out.reshape(-1)
        for k in range(secs.size):
            v = secs[k]
            if np.isnan(v):
                fo[k] = None
                continue
            sign = "-" if v < 0 else ""
            v = abs(v)
            hh = int(v // 3600)
            mm = int((v % 3600) // 60)
            ss = v - hh * 3600 - mm * 60
            txt = f"{sign}{hh:02d}:{mm:02d}:{ss:02.0f}" if ss == int(ss) \
                else f"{sign}{hh:02d}:{mm:02d}:{ss:07.4f}"
            fo[k] = txt
        return StringArray(out)
    raise bad_arg("string", "Cannot convert input to string.")


@builtin("cast", category="conversion", min_in=2, max_in=3)
def m_cast(x, *rest):
    if len(rest) == 2 and is_text(rest[0]) and text_of(rest[0]) == "like":
        return _convert(x, rest[1].mclass)
    return _convert(x, text_of(rest[0]))


@builtin("complex", category="conversion", min_in=1, max_in=2)
def m_complex(a, b=None):
    ha = a.host().astype(np.float64)
    hb = b.host().astype(np.float64) if b is not None else np.zeros_like(ha)
    out_class = "single" if a.mclass == "single" or (b is not None and b.mclass == "single") else "double"
    r = ha + 1j * hb
    return MatArray(dtypes.cast_to_class(r, out_class), out_class)
