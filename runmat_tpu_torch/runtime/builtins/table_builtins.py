"""Copy of runmat_tpu/runtime/builtins/table_builtins.py in the PyTorch port.

table builtins: construction, conversion, io, manipulation.

Reference parity: crates/runmat-runtime/src/builtins/table/ (~12k LoC family).
"""

from __future__ import annotations

import csv
import io as _io

import numpy as np

from ...errors import MatError, bad_arg
from ...tables import MatTable
from ...values import (CellArray, MatArray, StringArray, is_text,
                       normalize_shape, text_of)
from ..registry import builtin


@builtin("table", category="table", max_in=None, pass_ctx=True)
def m_table(*args, ctx=None):
    cols = []
    names = []
    i = 0
    args = list(args)
    while i < len(args):
        a = args[i]
        if is_text(a) and text_of(a) == "VariableNames" and i + 1 < len(args):
            nm = args[i + 1]
            names = []
            if isinstance(nm, CellArray):
                for k in range(nm.size):
                    names.append(text_of(nm.data.reshape(-1, order="F")[k]))
            elif isinstance(nm, StringArray):
                names = [nm.data.reshape(-1)[k] for k in range(nm.size)]
            i += 2
            continue
        cols.append(a)
        i += 1
    if not names:
        # MATLAB captures the caller's variable names (inputname magic);
        # non-identifier args fall back to VarK
        anames = ctx.arg_names if ctx is not None else ()
        names = [anames[k] if k < len(anames) and anames[k]
                 else f"Var{k+1}" for k in range(len(cols))]
    return MatTable(names[:len(cols)], cols)


@builtin("istable", category="table", min_in=1, max_in=1)
def m_istable(x):
    return MatArray.logical_scalar(isinstance(x, MatTable))


@builtin("height", category="table", min_in=1, max_in=1)
def m_height(t):
    if isinstance(t, MatTable):
        return MatArray.scalar(float(t.height))
    return MatArray.scalar(float(t.shape[0]))


@builtin("width", category="table", min_in=1, max_in=1)
def m_width(t):
    if isinstance(t, MatTable):
        return MatArray.scalar(float(t.width))
    return MatArray.scalar(float(t.shape[1] if len(t.shape) > 1 else 1))


@builtin("array2table", category="table", min_in=1, max_in=None)
def m_array2table(a, *kv):
    h = a.host()
    names = None
    for i in range(0, len(kv) - 1, 2):
        if text_of(kv[i]) == "VariableNames":
            nm = kv[i + 1]
            if isinstance(nm, CellArray):
                names = [text_of(nm.data.reshape(-1, order="F")[k])
                         for k in range(nm.size)]
            elif isinstance(nm, StringArray):
                names = [nm.data.reshape(-1)[k] for k in range(nm.size)]
    n = h.shape[1] if h.ndim > 1 else 1
    names = names or [f"Var{k+1}" for k in range(n)]
    cols = [MatArray(h[:, k:k + 1].copy(), a.mclass) for k in range(n)]
    return MatTable(names, cols)


@builtin("table2array", category="table", min_in=1, max_in=1)
def m_table2array(t):
    if not isinstance(t, MatTable):
        raise bad_arg("table2array", "Input must be a table.")
    from ..dispatch import _engine  # noqa: F401  (parity placeholder)
    parts = []
    for c in t.cols:
        if not isinstance(c, MatArray):
            raise MatError("MATLAB:table2array:MixedTypes",
                           "All table variables must be numeric.")
        parts.append(c.host().reshape(t.height, -1).astype(np.float64))
    return MatArray(np.hstack(parts) if parts else np.zeros((0, 0)), "double")


@builtin("struct2table", category="table", min_in=1, max_in=1)
def m_struct2table(s):
    from ...values import MatArray, StructArray
    if not isinstance(s, StructArray):
        raise bad_arg("struct2table", "Input must be a struct.")
    names = list(s.fields)
    if s.is_scalar:
        cols = [s.fields[k].reshape(-1)[0] for k in names]
        return MatTable(names, cols)
    # struct array: one row per element, scalar fields stack into columns
    import numpy as np
    cols = []
    for k in names:
        elems = list(s.fields[k].reshape(-1, order="F"))
        if all(isinstance(e, MatArray) and e.size == 1 and e.mclass != "char"
               for e in elems):
            vals = np.array([[float(e.host().reshape(-1)[0].real)]
                             for e in elems])
            cols.append(MatArray(vals, "double"))
        else:
            from ...values import CellArray
            data = np.empty((len(elems), 1), dtype=object)
            for i, e in enumerate(elems):
                data[i, 0] = e
            cols.append(CellArray(data))
    return MatTable(names, cols)


@builtin("table2struct", category="table", min_in=1, max_in=1)
def m_table2struct(t):
    from ...values import StructArray
    if not isinstance(t, MatTable):
        raise bad_arg("table2struct", "Input must be a table.")
    fields = {}
    for nm, c in zip(t.varnames, t.cols):
        data = np.empty((t.height, 1), dtype=object)
        for r in range(t.height):
            data[r, 0] = _take_row_scalar(c, r)
        fields[nm] = data
    return StructArray(fields, (t.height, 1))


def _take_row_scalar(c, r):
    if isinstance(c, MatArray):
        return MatArray(c.host()[r:r + 1, ...].copy(), c.mclass)
    if isinstance(c, StringArray):
        return StringArray(c.data[r:r + 1, ...].copy())
    if isinstance(c, CellArray):
        return c.data[r, 0]
    return c


@builtin("sortrows", category="table", min_in=1, max_in=3)
def m_sortrows(t, key=None, direction=None):
    descend = direction is not None and \
        text_of(direction).lower() == "descend"
    if isinstance(t, MatTable):
        if key is None:
            ci = 0
        else:
            ci = t.varnames.index(text_of(key)) if is_text(key) else \
                int(key.host().reshape(-1)[0]) - 1
        col = t.cols[ci]
        if isinstance(col, MatArray):
            keyv = col.host().reshape(-1)
        else:
            keyv = np.array([str(x) for x in col.data.reshape(-1)],
                            dtype=object)
        if descend:
            # stable descending: ascend the reversed rows, map back
            n = keyv.shape[0]
            ia = np.argsort(keyv[::-1], kind="stable")
            order = ((n - 1) - ia)[::-1]
        else:
            order = np.argsort(keyv, kind="stable")
        from ...tables import _take_rows
        return MatTable(t.varnames, [_take_rows(c, order) for c in t.cols])
    h = t.host()
    ci = int(key.host().reshape(-1)[0]) - 1 if key is not None else 0
    if descend:
        # stable descending (MATLAB keeps tied rows in original order):
        # ascend the reversed rows, map back — same flip trick as the
        # MatTable branch above.
        n = h.shape[0]
        ia = np.argsort(h[::-1, ci], kind="stable")
        order = ((n - 1) - ia)[::-1]
    else:
        order = np.argsort(h[:, ci], kind="stable")
    return MatArray(h[order, :].copy(), t.mclass)


@builtin("head", category="table", min_in=1, max_in=2)
def m_head(t, n=None):
    k = int(n.host().reshape(-1)[0]) if n is not None else 8
    if isinstance(t, MatTable):
        idx = np.arange(min(k, t.height))
        from ...tables import _take_rows
        return MatTable(t.varnames, [_take_rows(c, idx) for c in t.cols])
    h = t.host()
    return MatArray(h[:k, ...].copy(), t.mclass)


@builtin("tail", category="table", min_in=1, max_in=2)
def m_tail(t, n=None):
    k = int(n.host().reshape(-1)[0]) if n is not None else 8
    if isinstance(t, MatTable):
        idx = np.arange(max(0, t.height - k), t.height)
        from ...tables import _take_rows
        return MatTable(t.varnames, [_take_rows(c, idx) for c in t.cols])
    h = t.host()
    return MatArray(h[-k:, ...].copy(), t.mclass)


@builtin("addvars", category="table", min_in=2, max_in=None)
def m_addvars(t, *args):
    if not isinstance(t, MatTable):
        raise bad_arg("addvars", "First input must be a table.")
    out = t.copy()
    newnames = None
    vals = []
    i = 0
    args = list(args)
    while i < len(args):
        if is_text(args[i]) and text_of(args[i]) == "NewVariableNames":
            nm = args[i + 1]
            if isinstance(nm, CellArray):
                newnames = [text_of(nm.data.reshape(-1, order="F")[k])
                            for k in range(nm.size)]
            else:
                newnames = [text_of(nm)]
            i += 2
            continue
        vals.append(args[i])
        i += 1
    for k, v in enumerate(vals):
        nm = newnames[k] if newnames else f"Var{out.width + 1}"
        out = out.set_col(nm, v)
    return out


@builtin("removevars", category="table", min_in=2, max_in=2)
def m_removevars(t, names):
    if not isinstance(t, MatTable):
        raise bad_arg("removevars", "First input must be a table.")
    drop = set()
    if isinstance(names, CellArray):
        for k in range(names.size):
            drop.add(text_of(names.data.reshape(-1, order="F")[k]))
    else:
        drop.add(text_of(names))
    keep = [i for i, nm in enumerate(t.varnames) if nm not in drop]
    return MatTable([t.varnames[i] for i in keep], [t.cols[i] for i in keep])


@builtin("renamevars", category="table", min_in=3, max_in=3)
def m_renamevars(t, old, new):
    def to_list(x):
        if isinstance(x, CellArray):
            return [text_of(x.data.reshape(-1, order="F")[k]) for k in range(x.size)]
        if isinstance(x, StringArray):
            return [x.data.reshape(-1)[k] for k in range(x.size)]
        return [text_of(x)]
    olds, news = to_list(old), to_list(new)
    out = t.copy()
    for o, n in zip(olds, news):
        out.varnames[out.varnames.index(o)] = n
    return out


# ----------------------------------------------------------------- csv io ---- #


@builtin("readtable", category="table", min_in=1, max_in=1)
def m_readtable(path):
    p = text_of(path)
    with open(p, "r", newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return MatTable([], [])
    header = rows[0]
    body = rows[1:]
    ncol = len(header)
    cols = []
    for c in range(ncol):
        vals = [r[c] if c < len(r) else "" for r in body]
        try:
            arr = np.array([float(v) if v != "" else np.nan for v in vals],
                           dtype=np.float64).reshape(-1, 1)
            cols.append(MatArray(arr, "double"))
        except ValueError:
            data = np.empty((len(vals), 1), dtype=object)
            for i, v in enumerate(vals):
                data[i, 0] = v
            cols.append(StringArray(data))
    names = [h.strip() or f"Var{i+1}" for i, h in enumerate(header)]
    return MatTable(names, cols)


@builtin("writetable", category="table", min_in=2, max_in=2)
def m_writetable(t, path):
    if not isinstance(t, MatTable):
        raise bad_arg("writetable", "First input must be a table.")
    p = text_of(path)
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(t.varnames)
        for r in range(t.height):
            row = []
            for c in t.cols:
                if isinstance(c, MatArray):
                    v = c.host()[r, 0]
                    row.append(int(v) if float(v).is_integer() else float(v))
                elif isinstance(c, StringArray):
                    row.append(c.data[r, 0])
                else:
                    row.append(str(c.data[r, 0]))
            w.writerow(row)
    return None


@builtin("varfun", category="table", min_in=2, max_in=2, pass_ctx=True)
def m_varfun(f, t, ctx=None):
    if not isinstance(t, MatTable):
        raise bad_arg("varfun", "Second input must be a table.")
    cols = []
    for c in t.cols:
        r = ctx.interp.call_value(f, [c], 1, ctx.frame)
        cols.append(r[0])
    names = [f"fun_{nm}" for nm in t.varnames]
    return MatTable(names, cols)


# -------------------------------------------------------------- table joins --- #

def _key_names(a: MatTable, b: MatTable, opts) -> list:
    i = 0
    opts = list(opts)
    while i < len(opts):
        if is_text(opts[i]) and text_of(opts[i]).lower() == "keys" \
                and i + 1 < len(opts):
            k = opts[i + 1]
            if is_text(k):
                return [text_of(k)]
            if isinstance(k, CellArray):
                return [text_of(x) for x in k.data.reshape(-1, order="F")]
        i += 1
    keys = [nm for nm in a.varnames if nm in b.varnames]
    if not keys:
        raise MatError("MATLAB:table:join:CantInferKey",
                       "Cannot find a common key variable.")
    return keys


def _col_rows(col, idx, fill=False):
    """Select rows of a table variable; idx < 0 selects a missing fill."""
    import numpy as _np
    if isinstance(col, MatArray):
        h = col.host()
        out = h[_np.maximum(idx, 0)].astype(_np.float64) \
            if fill and h.dtype.kind in "iub" else h[_np.maximum(idx, 0)].copy()
        if fill:
            out = _np.asarray(out, dtype=_np.float64 if out.dtype.kind in
                              "iufb" else out.dtype)
            out[idx < 0] = _np.nan
        return MatArray(out, "double" if fill and col.mclass not in
                        ("double", "single") else col.mclass)
    if isinstance(col, (StringArray, CellArray)):
        data = col.data[_np.maximum(idx, 0)].copy()
        data[idx < 0] = None if isinstance(col, StringArray) else \
            MatArray.empty()
        return type(col)(data)
    raise bad_arg("join", "Unsupported table variable type for join.")


def _key_tuples(t: MatTable, keys: list) -> list:
    import numpy as _np
    cols = []
    for nm in keys:
        c = t.col(nm)
        if isinstance(c, MatArray):
            cols.append([float(v) for v in
                         _np.ravel(c.host(), order="F")])
        elif isinstance(c, (StringArray, CellArray)):
            cols.append([text_of(x) if not isinstance(x, str) else x
                         for x in c.data.reshape(-1, order="F")])
        else:
            raise bad_arg("join", "Unsupported key variable type.")
    return list(zip(*cols)) if cols else []


def _join_impl(a: MatTable, b: MatTable, keys: list, outer: bool) -> MatTable:
    import numpy as _np
    ka, kb = _key_tuples(a, keys), _key_tuples(b, keys)
    pairs = []
    matched_b = set()
    for i, key in enumerate(ka):
        hit = False
        for j, kB in enumerate(kb):
            if key == kB:
                pairs.append((i, j))
                matched_b.add(j)
                hit = True
        if outer and not hit:
            pairs.append((i, -1))
    if outer:
        for j in range(len(kb)):
            if j not in matched_b:
                pairs.append((-1, j))
        pairs.sort(key=lambda p: (p[0] < 0, p[0], p[1]))
    ia = _np.array([p[0] for p in pairs], dtype=_np.int64)
    ib = _np.array([p[1] for p in pairs], dtype=_np.int64)
    names, cols = [], []
    for nm in keys:
        # merged key: take from whichever side matched
        va = _col_rows(a.col(nm), ia, fill=outer)
        if outer:
            vb = _col_rows(b.col(nm), ib, fill=True)
            if isinstance(va, MatArray):
                h = va.host().copy()
                hb = vb.host()
                miss = ia < 0
                h[miss] = hb[miss]
                va = MatArray(h, va.mclass)
            else:
                d = va.data.copy()
                d[ia < 0] = vb.data[ia < 0]
                va = type(va)(d)
        names.append(nm)
        cols.append(va)
    for nm in a.varnames:
        if nm not in keys:
            names.append(nm)
            cols.append(_col_rows(a.col(nm), ia, fill=outer))
    for nm in b.varnames:
        if nm not in keys:
            names.append(nm if nm not in names else nm + "_right")
            cols.append(_col_rows(b.col(nm), ib, fill=outer))
    return MatTable(names, cols)


@builtin("innerjoin", category="data", min_in=2, max_in=6)
def m_innerjoin(a, b, *opts):
    """innerjoin(A, B[, 'Keys', k]): rows with matching key values; keys
    default to the common variable names."""
    if not isinstance(a, MatTable) or not isinstance(b, MatTable):
        raise bad_arg("innerjoin", "Inputs must be tables.")
    return _join_impl(a, b, _key_names(a, b, opts), outer=False)


@builtin("outerjoin", category="data", min_in=2, max_in=6)
def m_outerjoin(a, b, *opts):
    """outerjoin(A, B[, 'Keys', k]): all rows from both sides, unmatched
    variables filled with NaN/missing (keys merged)."""
    if not isinstance(a, MatTable) or not isinstance(b, MatTable):
        raise bad_arg("outerjoin", "Inputs must be tables.")
    return _join_impl(a, b, _key_names(a, b, opts), outer=True)


@builtin("rowfun", category="table", min_in=2, max_in=2, pass_ctx=True)
def m_rowfun(f, t, ctx=None):
    """rowfun(f, T): apply f to each row's variables; one output variable."""
    import numpy as _np
    if not isinstance(t, MatTable):
        raise bad_arg("rowfun", "Second input must be a table.")
    out = []
    for i in range(t.height):
        args = []
        for c in t.cols:
            if isinstance(c, MatArray):
                h = c.host()
                args.append(MatArray(_np.asarray(h[i]).reshape(1, -1),
                                     c.mclass))
            elif isinstance(c, (StringArray, CellArray)):
                args.append(c.data[i, 0] if isinstance(c, CellArray)
                            else StringArray.scalar(c.data.reshape(-1)[i]))
            else:
                raise bad_arg("rowfun", "Unsupported table variable type.")
        r = ctx.interp.call_value(f, args, 1, ctx.frame)
        v = r[0] if r else MatArray.empty()
        out.append(float(v.host().reshape(-1)[0]) if isinstance(v, MatArray)
                   and v.size else _np.nan)
    col = MatArray(_np.asarray(out, _np.float64).reshape(-1, 1), "double")
    return MatTable(["Var1"], [col])
