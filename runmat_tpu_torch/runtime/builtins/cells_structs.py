"""Copy of runmat_tpu/runtime/builtins/cells_structs.py in the PyTorch port.

Cell & struct builtins: cellfun, num2cell, cell2mat, struct utilities.

Reference parity: runmat-runtime/src/builtins/{cells,structs}/.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, is_text, text_of)
from ..concat import cat as concat_cat
from ..registry import builtin


@builtin("cellfun", category="cells", min_in=2, pass_ctx=True, pass_nargout=True)
def m_cellfun(f, *rest, ctx=None, nargout=1):
    uniform = True
    cells = []
    i = 0
    rest = list(rest)
    while i < len(rest):
        a = rest[i]
        if is_text(a) and text_of(a) == "UniformOutput":
            uniform = bool(rest[i + 1].is_true()) if i + 1 < len(rest) else True
            i += 2
            continue
        if is_text(a) and text_of(a) == "ErrorHandler":
            i += 2
            continue
        cells.append(a)
        i += 1
    for c in cells:
        if not isinstance(c, CellArray):
            raise bad_arg("cellfun", "Inputs must be cell arrays.")
    shape = cells[0].shape
    n = cells[0].size
    flats = [c.data.reshape(-1, order="F") for c in cells]
    nout = max(1, nargout)
    results = [[] for _ in range(nout)]
    for k in range(n):
        args = [fl[k] for fl in flats]
        if isinstance(f, FunctionHandle):
            r = ctx.interp.call_value(f, args, nout, ctx.frame)
        else:
            r = ctx.interp.call_named(text_of(f), args, nout, ctx.frame)
        for j in range(nout):
            results[j].append(r[j] if j < len(r) else MatArray.empty())
    outs = []
    for j in range(nout):
        if uniform:
            vals = np.array([v.item() if isinstance(v, MatArray) else np.nan
                             for v in results[j]])
            out = np.reshape(vals, shape, order="F")
            mc = results[j][0].mclass if n and isinstance(results[j][0], MatArray) else "double"
            if mc == "logical":
                outs.append(MatArray(out.astype(np.bool_), "logical"))
            else:
                outs.append(MatArray.from_np(out))
        else:
            data = np.empty(shape, dtype=object)
            df = data.reshape(-1, order="F")
            for k in range(n):
                df[k] = results[j][k]
            outs.append(CellArray(data))
    return outs[:nout]


@builtin("structfun", category="structs", min_in=2, pass_ctx=True)
def m_structfun(f, s, *rest, ctx=None):
    if not isinstance(s, StructArray) or s.size != 1:
        raise bad_arg("structfun", "Input must be a scalar struct.")
    uniform = True
    rest = list(rest)
    i = 0
    while i < len(rest):
        if is_text(rest[i]) and text_of(rest[i]) == "UniformOutput":
            uniform = bool(rest[i + 1].is_true())
            i += 2
        else:
            i += 1
    vals = []
    for fname in s.fields:
        v = s.get_scalar_field(fname)
        r = ctx.interp.call_value(f, [v], 1, ctx.frame) if isinstance(f, FunctionHandle) \
            else ctx.interp.call_named(text_of(f), [v], 1, ctx.frame)
        vals.append(r[0] if r else MatArray.empty())
    if uniform:
        arr = np.array([v.scalar_double() for v in vals]).reshape(-1, 1)
        return MatArray(arr, "double")
    fields = {}
    for fname, v in zip(s.fields, vals):
        a = np.empty((1, 1), dtype=object)
        a[0, 0] = v
        fields[fname] = a
    return StructArray(fields, (1, 1))


@builtin("num2cell", category="cells", min_in=1, max_in=1)
def m_num2cell(x):
    h = x.host()
    data = np.empty(h.shape, dtype=object)
    df = data.reshape(-1, order="F")
    hf = h.reshape(-1, order="F")
    for k in range(hf.size):
        df[k] = MatArray.from_np(np.array([[hf[k]]]), x.mclass)
    return CellArray(data)


@builtin("cell2mat", category="cells", min_in=1, max_in=1)
def m_cell2mat(c):
    if not isinstance(c, CellArray):
        raise bad_arg("cell2mat", "Input must be a cell array.")
    if c.size == 0:
        return MatArray.empty()
    rows = []
    for r in range(c.data.shape[0]):
        row_parts = [c.data[r, j] for j in range(c.data.shape[1])]
        rows.append(concat_cat(1, row_parts) if len(row_parts) > 1 else row_parts[0])
    return concat_cat(0, rows) if len(rows) > 1 else rows[0]


@builtin("cellstr", category="cells", min_in=1, max_in=1)
def m_cellstr(x):
    if isinstance(x, CellArray):
        return x
    if isinstance(x, StringArray):
        data = np.empty(x.shape, dtype=object)
        df, xf = data.reshape(-1), x.data.reshape(-1)
        for k in range(xf.size):
            df[k] = MatArray.char_from_str(xf[k] or "")
        return CellArray(data)
    if isinstance(x, MatArray) and x.mclass == "char":
        h = x.host()
        nrows = h.shape[0] if h.ndim >= 2 else 1
        data = np.empty((max(nrows, 1), 1), dtype=object)
        if h.size == 0:
            data[0, 0] = MatArray.char_from_str("")
            return CellArray(data)
        for r in range(nrows):
            data[r, 0] = MatArray.char_from_str(
                "".join(chr(int(v)) for v in h[r]).rstrip())
        return CellArray(data)
    raise bad_arg("cellstr", "Input must be a string array or character array.")


@builtin("rmfield", category="structs", min_in=2, max_in=2)
def m_rmfield(s, f):
    if not isinstance(s, StructArray):
        raise bad_arg("rmfield", "First input must be a struct.")
    names = [text_of(f)] if not isinstance(f, CellArray) else \
        [text_of(e) for e in f.data.reshape(-1)]
    out = s.copy()
    for n in names:
        if n not in out.fields:
            raise MatError("MATLAB:rmfield:InvalidFieldname",
                           f"A field named '{n}' doesn't exist.")
        del out.fields[n]
    return out


@builtin("setfield", category="structs", min_in=3)
def m_setfield(s, f, v):
    out = s.copy() if isinstance(s, StructArray) else StructArray.scalar()
    out.set_scalar_field(text_of(f), v)
    return out


@builtin("getfield", category="structs", min_in=2)
def m_getfield(s, f):
    if not isinstance(s, StructArray):
        raise bad_arg("getfield", "First input must be a struct.")
    return s.get_scalar_field(text_of(f))


@builtin("orderfields", category="structs", min_in=1, max_in=1)
def m_orderfields(s):
    if not isinstance(s, StructArray):
        raise bad_arg("orderfields", "Input must be a struct.")
    return StructArray({k: s.fields[k] for k in sorted(s.fields)}, s.shape)


@builtin("struct2cell", category="structs", min_in=1, max_in=1)
def m_struct2cell(s):
    if not isinstance(s, StructArray) or s.size != 1:
        raise bad_arg("struct2cell", "Scalar struct required.")
    names = list(s.fields)
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        data[i, 0] = s.get_scalar_field(n)
    return CellArray(data)


@builtin("cell2struct", category="structs", min_in=3, max_in=3)
def m_cell2struct(c, f, dim):
    names = [text_of(e) for e in f.data.reshape(-1)] if isinstance(f, CellArray) else \
        [text_of(f)]
    fields = {}
    flat = c.data.reshape(-1, order="F")
    for i, n in enumerate(names):
        a = np.empty((1, 1), dtype=object)
        a[0, 0] = flat[i]
        fields[n] = a
    return StructArray(fields, (1, 1))
