"""Copy of runmat_tpu/runtime/concat.py in the PyTorch port.

Concatenation ([ ... ] literals, horzcat/vertcat/cat) with MATLAB class rules.

Reference parity: matrix-literal construction in the VM compiler + the
horzcat/vertcat builtins (runmat-runtime/src/builtins/array/). Class combine for
concatenation differs from arithmetic: char dominates numerics ( ['a' 65] ==
'aA' ), string dominates everything, int classes must match, empties vanish.
"""

from __future__ import annotations

import numpy as np

from .. import dtypes
from ..errors import MatError, dim_mismatch
from ..values import (CellArray, MatArray, StringArray, StructArray,
                      normalize_shape)


def _concat_class(classes: list[str]) -> str:
    cls = None
    for c in classes:
        if cls is None:
            cls = c
            continue
        if cls == c:
            continue
        pair = {cls, c}
        if "char" in pair:
            other = (pair - {"char"}).pop()
            if other in ("double", "single", "logical") or dtypes.is_integer_class(other):
                cls = "char"
                continue
            raise MatError("MATLAB:concatenation:classMismatch",
                           f"Cannot concatenate char with {other}.")
        ints = [x for x in pair if dtypes.is_integer_class(x)]
        if len(ints) == 2:
            raise MatError("MATLAB:concatenation:integerInteraction",
                           "Integers can be concatenated only with integers of the "
                           "same class or scalar doubles.")
        if len(ints) == 1:
            other = (pair - set(ints)).pop()
            if other in ("double", "single", "logical"):
                cls = ints[0]
                continue
            raise MatError("MATLAB:concatenation:classMismatch",
                           f"Cannot concatenate {ints[0]} with {other}.")
        if "single" in pair:
            cls = "single"
            continue
        if "logical" in pair:
            cls = (pair - {"logical"}).pop()
            continue
        cls = "double"
    return cls or "double"


def _cat_arrays(parts: list, axis: int):
    """Concatenate MatArray/StringArray/CellArray parts along axis (0=vertical)."""
    parts = [p for p in parts if not (isinstance(p, MatArray) and p.size == 0 and
                                      p.shape in ((0, 0),))]
    if not parts:
        return MatArray.empty()
    if any(isinstance(p, StringArray) for p in parts):
        datas = [_as_string_data(p) for p in parts]
        return StringArray(_np_cat(datas, axis))
    if any(isinstance(p, CellArray) for p in parts):
        if not all(isinstance(p, CellArray) for p in parts):
            raise MatError("MATLAB:cellCat", "Cannot concatenate cell with non-cell arrays.")
        return CellArray(_np_cat([p.data for p in parts], axis))
    if any(isinstance(p, StructArray) for p in parts):
        return _cat_structs(parts, axis)
    if any(type(p).__name__ in ("MatDatetime", "MatDuration") for p in parts):
        # datetime64/timedelta64 arrays concatenate natively; classes must
        # match (≙ datetime horzcat/vertcat method builtins)
        kinds = {type(p).__name__ for p in parts}
        if len(kinds) != 1:
            raise MatError("MATLAB:concatenation:classMismatch",
                           "Cannot concatenate datetime/duration with "
                           "other classes.")
        return type(parts[0])(_np_cat([p.data for p in parts], axis))
    for p in parts:
        if not isinstance(p, MatArray):
            raise MatError("MATLAB:concatenation:classMismatch",
                           f"Cannot concatenate value of class {type(p).__name__}.")
    out_class = _concat_class([p.mclass for p in parts])
    is_cx = any(p.is_complex for p in parts)
    datas = []
    for p in parts:
        h = p.host()
        if p.mclass != out_class:
            if out_class == "char":
                h = dtypes.cast_to_class(h.astype(np.float64), "char")
            else:
                h = dtypes.cast_to_class(h, out_class)
        if is_cx and h.dtype.kind != "c":
            h = h.astype(np.complex64 if out_class == "single" else np.complex128)
        datas.append(h)
    return MatArray(_np_cat(datas, axis), out_class)


def _as_string_data(p) -> np.ndarray:
    if isinstance(p, StringArray):
        return p.data
    if isinstance(p, MatArray) and p.mclass == "char":
        a = np.empty((1, 1), dtype=object)
        a[0, 0] = p.to_str()
        return a
    if isinstance(p, MatArray):
        h = p.host()
        out = np.empty(h.shape, dtype=object)
        fo, fh = out.reshape(-1), h.reshape(-1)
        for i in range(fo.size):
            x = float(fh[i].real if np.iscomplexobj(h) else fh[i])
            fo[i] = str(int(x)) if x == int(x) else repr(x)
        return out
    raise MatError("MATLAB:string:conversion", "Cannot concatenate this value with strings.")


def _cat_structs(parts: list, axis: int) -> StructArray:
    parts2 = []
    for p in parts:
        if isinstance(p, StructArray):
            parts2.append(p)
        elif isinstance(p, MatArray) and p.size == 0:
            continue
        else:
            raise MatError("MATLAB:catenate:structFields",
                           "Cannot concatenate struct with non-struct values.")
    field_sets = [tuple(sorted(p.fields)) for p in parts2]
    if len(set(field_sets)) > 1:
        raise MatError("MATLAB:catenate:structFields",
                       "Concatenated structs must have the same field names.")
    keys = list(parts2[0].fields) if parts2 else []
    fields = {k: _np_cat([p.fields[k] for p in parts2], axis) for k in keys}
    shape = _np_cat([np.empty(p.shape, dtype=object) for p in parts2], axis).shape if parts2 else (0, 0)
    return StructArray(fields, shape)


def _np_cat(datas: list[np.ndarray], axis: int) -> np.ndarray:
    # align ndim; cat along a trailing new dim (cat(3, A, B)) expands inputs
    nd = max(2, max(d.ndim for d in datas), axis + 1)
    aligned = []
    for d in datas:
        while d.ndim < nd:
            d = d.reshape(d.shape + (1,))
        aligned.append(d)
    ref = aligned[0].shape
    for d in aligned[1:]:
        for ax in range(nd):
            if ax == axis:
                continue
            if d.shape[ax] != ref[ax]:
                raise dim_mismatch(
                    "Dimensions of arrays being concatenated are not consistent.")
    return np.concatenate(aligned, axis=axis)


def build_matrix(rows: list[list]):
    """[r1e1 r1e2 ; r2e1 ...] — horzcat each row, then vertcat rows.

    Device-resident rule: if any element is device-resident and everything is
    numeric, the result is assembled on device (residency propagation,
    ≙ 'like' semantics in the reference constructors)."""
    if not rows:
        return MatArray.empty()
    if any(type(el).__name__ == "SymValue" for r in rows for el in r):
        row_vals = [_cat_sym(list(r), 1) if len(r) > 1 else r[0] for r in rows]
        if len(row_vals) == 1:
            from .builtins.symbolic import _to_sym
            return _to_sym(row_vals[0])
        return _cat_sym(row_vals, 0)
    row_vals = []
    for r in rows:
        if len(r) == 1:
            row_vals.append(r[0])
        else:
            row_vals.append(_cat_arrays(list(r), axis=1))
    if len(row_vals) == 1:
        v = row_vals[0]
        if isinstance(v, (MatArray, StringArray, CellArray, StructArray)):
            return v
        return v
    return _cat_arrays(row_vals, axis=0)


def build_cell(rows: list[list]) -> CellArray:
    if not rows:
        return CellArray.empty()
    row_arrays = []
    ncols = None
    for r in rows:
        cells = []
        for el in r:
            if isinstance(el, CellArray):
                # nested cell literal stays a single element
                cells.append(el)
            else:
                cells.append(el)
        a = np.empty((1, len(cells)), dtype=object)
        for i, c in enumerate(cells):
            a[0, i] = c
        row_arrays.append(a)
        if ncols is None:
            ncols = len(cells)
        elif ncols != len(cells):
            raise dim_mismatch("Dimensions of arrays being concatenated are not consistent.")
    return CellArray(np.concatenate(row_arrays, axis=0))


def cat(axis: int, parts: list):
    if any(type(p).__name__ == "SymValue" for p in parts):
        return _cat_sym(parts, axis)
    return _cat_arrays(parts, axis)


def _cat_sym(parts: list, axis: int):
    """Concatenate symbolic values/arrays (sym dominates numerics)."""
    from .builtins.symbolic import SymValue, _to_sym
    mats = []
    for p in parts:
        s = _to_sym(p)
        mats.append(s.exprs.reshape(s.shape))
    data = np.concatenate(mats, axis=min(axis, 1))
    return SymValue(data, data.shape)

