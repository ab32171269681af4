"""Copy of runmat_tpu/runtime/builtins/introspection.py in the PyTorch port.

Introspection builtins: class/isa/is*/exist/who/whos/fieldnames/isfield/...

Reference parity: runmat-runtime/src/builtins/introspection/ (17k LoC).
"""

from __future__ import annotations

import numpy as np

from ... import dtypes
from ...errors import MatError
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, class_name, is_char, is_text, numel,
                       shape_of, text_of)
from ..registry import builtin, register_alias


@builtin("class", category="introspection", min_in=1, max_in=1)
def m_class(x):
    return MatArray.char_from_str(class_name(x))


@builtin("isa", category="introspection", min_in=2, max_in=2, pass_ctx=True)
def m_isa(x, cls, ctx=None):
    # classdef objects: not yet ported (ROADMAP A16)
    c = text_of(cls)
    k = class_name(x)
    if c == "numeric":
        return MatArray.logical_scalar(dtypes.is_numeric_class(k))
    if c == "float":
        return MatArray.logical_scalar(k in ("double", "single"))
    if c == "integer":
        return MatArray.logical_scalar(dtypes.is_integer_class(k))
    return MatArray.logical_scalar(k == c)


def _pred(name, fn):
    @builtin(name, category="introspection", min_in=1, max_in=1)
    def _f(x, _fn=fn):
        return MatArray.logical_scalar(bool(_fn(x)))
    return _f


_pred("isnumeric", lambda x: isinstance(x, MatArray) and dtypes.is_numeric_class(x.mclass))
_pred("isfloat", lambda x: isinstance(x, MatArray) and x.mclass in ("double", "single"))
_pred("isinteger", lambda x: isinstance(x, MatArray) and dtypes.is_integer_class(x.mclass))
_pred("islogical", lambda x: isinstance(x, MatArray) and x.mclass == "logical")
_pred("ischar", lambda x: is_char(x))
_pred("isstring", lambda x: isinstance(x, StringArray))
_pred("iscell", lambda x: isinstance(x, CellArray))
_pred("isstruct", lambda x: isinstance(x, StructArray))
_pred("isreal", lambda x: isinstance(x, MatArray) and not x.is_complex)
_pred("isempty", lambda x: numel(x) == 0)
_pred("isscalar", lambda x: numel(x) == 1)
_pred("iscomplex", lambda x: isinstance(x, MatArray) and x.is_complex)
_pred("isvector", lambda x: len(shape_of(x)) == 2 and (shape_of(x)[0] == 1 or shape_of(x)[1] == 1)
      and numel(x) >= 1)
_pred("isrow", lambda x: len(shape_of(x)) == 2 and shape_of(x)[0] == 1)
_pred("iscolumn", lambda x: len(shape_of(x)) == 2 and shape_of(x)[1] == 1)
_pred("ismatrix", lambda x: len(shape_of(x)) == 2)
@builtin("issorted", category="introspection", min_in=1, max_in=2)
def m_issorted(x, direction=None):
    """issorted(A[, direction]): doc — NaN (and missing strings) are
    treated as GREATER than all other elements, so [1 2 NaN] is sorted
    ascending and [NaN 3 2] is sorted descending."""
    mode = "ascend"
    if direction is not None:
        mode = direction.to_str().lower() if hasattr(direction, "to_str") \
            else str(direction).lower()
    if isinstance(x, StringArray):
        items = [s for s in np.asarray(x.data).reshape(-1)]
        keys = [(s is None, s if s is not None else "") for s in items]
        ordered = sorted(keys) if mode == "ascend" else \
            sorted(keys, key=lambda k: (not k[0], k[1]), reverse=True)
        return MatArray.logical_scalar(keys == ordered)
    h = np.asarray(x.host()).reshape(-1).astype(np.float64, copy=True)
    h[np.isnan(h)] = np.inf          # NaN sorts as the largest value
    d = np.diff(h)
    if mode == "descend":
        return MatArray.logical_scalar(bool(np.all(d <= 0)))
    if mode == "monotonic":
        return MatArray.logical_scalar(
            bool(np.all(d >= 0)) or bool(np.all(d <= 0)))
    if mode in ("strictascend",):
        return MatArray.logical_scalar(bool(np.all(d > 0)))
    if mode in ("strictdescend",):
        return MatArray.logical_scalar(bool(np.all(d < 0)))
    if mode == "strictmonotonic":
        return MatArray.logical_scalar(
            bool(np.all(d > 0)) or bool(np.all(d < 0)))
    return MatArray.logical_scalar(bool(np.all(d >= 0)))
_pred("iscellstr", lambda x: isinstance(x, CellArray)
      and all(is_char(e) for e in x.data.reshape(-1)))
_pred("isobject", lambda x: False)


@builtin("ishandle", category="introspection", min_in=1, max_in=1)
def m_ishandle(x):
    return MatArray.logical_scalar(isinstance(x, FunctionHandle))


@builtin("isvarname", category="introspection", min_in=1, max_in=1)
def m_isvarname(x):
    try:
        t = text_of(x)
    except MatError:
        return MatArray.logical_scalar(False)
    ok = bool(t) and (t[0].isalpha()) and all(c.isalnum() or c == "_" for c in t)
    return MatArray.logical_scalar(ok)


@builtin("isfield", category="structs", min_in=2, max_in=2)
def m_isfield(s, f):
    if not isinstance(s, StructArray):
        return MatArray.logical_scalar(False)
    if isinstance(f, CellArray):
        out = np.zeros(f.shape, dtype=np.bool_)
        fo, fi = out.reshape(-1), f.data.reshape(-1, order="F")
        for k in range(fi.size):
            try:
                fo[k] = text_of(fi[k]) in s.fields
            except MatError:
                fo[k] = False
        return MatArray(out, "logical")
    return MatArray.logical_scalar(text_of(f) in s.fields)


@builtin("fieldnames", category="structs", min_in=1, max_in=1)
def m_fieldnames(s):
    if not isinstance(s, StructArray):
        raise MatError("MATLAB:fieldnames:InvalidInput", "Input must be a structure.")
    names = list(s.fields)
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        data[i, 0] = MatArray.char_from_str(n)
    return CellArray(data)


@builtin("exist", category="introspection", min_in=1, max_in=2, pass_ctx=True)
def m_exist(name, kind=None, ctx=None):
    n = text_of(name)
    k = text_of(kind) if kind is not None else None
    in_ws = n in ctx.frame.vars or n in ctx.frame.globals
    if k == "var":
        return MatArray.scalar(1.0 if in_ws else 0.0)
    if in_ws and k is None:
        return MatArray.scalar(1.0)
    r = ctx.interp.resolve_function(n)
    if r is not None:
        if k in (None, "builtin") and r[0] == "builtin":
            return MatArray.scalar(5.0)
        if k in (None, "file", "function") and r[0] == "user":
            return MatArray.scalar(2.0)
        if k is None:
            return MatArray.scalar(2.0 if r[0] == "user" else 5.0)
        if k == "builtin" and r[0] == "user":
            return MatArray.scalar(0.0)
        if k in ("file", "function"):
            return MatArray.scalar(0.0)
    import os
    if k in (None, "file") and os.path.exists(n):
        return MatArray.scalar(2.0)
    return MatArray.scalar(0.0)


@builtin("who", category="introspection", min_in=0, pass_ctx=True)
def m_who(*args, ctx=None):
    names = sorted(n for n in ctx.frame.vars if not n.startswith("@") and n != "ans")
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        data[i, 0] = MatArray.char_from_str(n)
    return CellArray(data)


@builtin("whos", category="introspection", min_in=0, pass_ctx=True)
def m_whos(*args, ctx=None):
    names = sorted(n for n in ctx.frame.vars if not n.startswith("@"))
    fields = {"name": [], "size": [], "bytes": [], "class": []}
    items = []
    for n in names:
        v = ctx.frame.vars[n]
        items.append({
            "name": MatArray.char_from_str(n),
            "size": MatArray(np.array(shape_of(v), dtype=np.float64).reshape(1, -1), "double"),
            "bytes": MatArray.scalar(float(getattr(getattr(v, "host", lambda: np.empty(0))(), "nbytes", 0))
                                     if isinstance(v, MatArray) else 0.0),
            "class": MatArray.char_from_str(class_name(v)),
        })
    shape = (len(items), 1)
    out_fields = {}
    for f in ("name", "size", "bytes", "class"):
        arr = np.empty(shape, dtype=object)
        for i, it in enumerate(items):
            arr[i, 0] = it[f]
        out_fields[f] = arr
    return StructArray(out_fields, shape)


@builtin("validateattributes", category="introspection", min_in=3)
def m_validateattributes(x, classes, attrs, *rest):
    return None


@builtin("inputname", category="introspection", min_in=1, max_in=1)
def m_inputname(k):
    return MatArray.char_from_str("")


@builtin("builtin", category="introspection", min_in=1, pass_ctx=True, pass_nargout=True)
def m_builtin(name, *args, ctx=None, nargout=1):
    from ..registry import lookup
    b = lookup(text_of(name))
    if b is None:
        raise MatError("MATLAB:UndefinedFunction", f"Undefined builtin '{text_of(name)}'.")
    return ctx.interp.call_builtin(b, list(args), nargout, ctx.frame)
