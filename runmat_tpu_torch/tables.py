"""Copy of runmat_tpu/tables.py in the PyTorch port.

The MATLAB `table` type.

Reference parity: the table builtin family (crates/runmat-runtime/src/builtins/
table/, ~12k LoC). Columns are ordinary runtime values (numeric arrays, string
arrays, cell arrays) of equal height; subscripting follows MATLAB:
t.Var (column), t(rows, vars) -> table, t{rows, vars} -> extracted array.
"""

from __future__ import annotations

import numpy as np

from .errors import MatError
from .values import (CellArray, MatArray, StringArray, fortran_ravel,
                     normalize_shape)


def _height_of(v) -> int:
    return int(v.shape[0]) if hasattr(v, "shape") else 1


def _take_rows(v, idx: np.ndarray):
    """Row-subset a column value."""
    if isinstance(v, MatArray):
        h = v.host()
        return MatArray(h[idx, ...].copy(), v.mclass)
    if isinstance(v, (StringArray, CellArray)):
        d = v.data[idx, ...].copy()
        return type(v)(d)
    raise MatError("MATLAB:table:UnsupportedColumn",
                   f"Unsupported table column type {type(v).__name__}.")


class MatTable:
    __slots__ = ("varnames", "cols", "rownames", "shared")

    def __init__(self, varnames: list, cols: list, rownames=None):
        if len(varnames) != len(cols):
            raise MatError("MATLAB:table:internal", "varnames/cols mismatch")
        heights = {_height_of(c) for c in cols}
        if len(heights) > 1:
            raise MatError("MATLAB:table:UnequalVarLengths",
                           "All table variables must have the same number of rows.")
        self.varnames = list(varnames)
        self.cols = list(cols)
        self.rownames = rownames
        self.shared = False

    # -- shape ------------------------------------------------------------- #

    @property
    def height(self) -> int:
        return _height_of(self.cols[0]) if self.cols else 0

    @property
    def width(self) -> int:
        return len(self.cols)

    @property
    def shape(self) -> tuple:
        return (self.height, self.width)

    @property
    def size(self) -> int:
        return self.height * self.width

    def copy(self) -> "MatTable":
        return MatTable(list(self.varnames), list(self.cols),
                        list(self.rownames) if self.rownames else None)

    # -- access -------------------------------------------------------------- #

    def col(self, name: str):
        try:
            return self.cols[self.varnames.index(name)]
        except ValueError:
            raise MatError("MATLAB:table:UnrecognizedVarName",
                           f"Unrecognized table variable name '{name}'.")

    def set_col(self, name: str, value) -> "MatTable":
        t = self.copy() if self.shared else self
        if _height_of(value) != t.height and t.cols:
            raise MatError("MATLAB:table:RowDimensionMismatch",
                           "The new variable has a different number of rows.")
        if name in t.varnames:
            t.cols[t.varnames.index(name)] = value
        else:
            t.varnames.append(name)
            t.cols.append(value)
        return t

    def _var_indices(self, sel) -> list:
        from .values import is_text, text_of
        if sel is None or isinstance(sel, type(None)):
            return list(range(self.width))
        if hasattr(sel, "__class__") and sel.__class__.__name__ == "ColonMark":
            return list(range(self.width))
        if isinstance(sel, StringArray):
            return [self.varnames.index(sel.data.reshape(-1)[k])
                    for k in range(sel.size)]
        if isinstance(sel, CellArray):
            out = []
            for k in range(sel.size):
                out.append(self.varnames.index(
                    text_of(sel.data.reshape(-1, order="F")[k])))
            return out
        if isinstance(sel, MatArray):
            if sel.mclass == "char":
                return [self.varnames.index(sel.to_str())]
            if sel.mclass == "logical":
                return [i for i, b in enumerate(fortran_ravel(sel.host()))
                        if b and i < self.width]
            return [int(i) - 1 for i in fortran_ravel(sel.host())]
        raise MatError("MATLAB:table:badSubscript", "Invalid table subscript.")

    def _row_indices(self, sel) -> np.ndarray:
        if hasattr(sel, "__class__") and sel.__class__.__name__ == "ColonMark":
            return np.arange(self.height, dtype=np.int64)
        if isinstance(sel, MatArray):
            if sel.mclass == "logical":
                return np.nonzero(fortran_ravel(sel.host()))[0].astype(np.int64)
            return fortran_ravel(sel.host()).astype(np.int64) - 1
        raise MatError("MATLAB:table:badSubscript", "Invalid table row subscript.")

    def index_paren(self, rows, vars_) -> "MatTable":
        ri = self._row_indices(rows)
        vi = self._var_indices(vars_)
        return MatTable([self.varnames[i] for i in vi],
                        [_take_rows(self.cols[i], ri) for i in vi])

    def index_brace(self, rows, vars_):
        ri = self._row_indices(rows)
        vi = self._var_indices(vars_)
        parts = []
        for i in vi:
            c = self.cols[i]
            if not isinstance(c, MatArray):
                if len(vi) == 1:
                    return _take_rows(c, ri)
                raise MatError("MATLAB:table:ExtractMixed",
                               "Brace extraction requires homogeneous variables.")
            parts.append(c.host()[ri, ...].reshape(ri.size, -1))
        if not parts:
            return MatArray.empty()
        out = np.hstack([p.astype(np.float64) for p in parts])
        return MatArray(out, "double")
