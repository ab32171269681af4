"""Copy of runmat_tpu/utils/display.py in the PyTorch port.

Workspace echo formatting (MATLAB 'format short'/'format long').

Reference parity: runmat-core workspace emit + display formatting
(crates/runmat-core/src/workspace/emit.rs). Approximates MATLAB's default
display: name line, blank, indented values.
"""

from __future__ import annotations

import numpy as np

from ..values import (CellArray, FunctionHandle, MatArray, StringArray,
                      StructArray)

_FORMAT = {"mode": "short"}


def set_format(mode: str) -> None:
    _FORMAT["mode"] = mode


def _fmt_scalar(x, mclass: str) -> str:
    if mclass == "logical":
        return "1" if x else "0"
    if isinstance(x, (np.integer, int)) or mclass.startswith(("int", "uint")):
        return str(int(x))
    if isinstance(x, (complex, np.complexfloating)):
        re = _fmt_real(x.real)
        im = abs(x.imag)
        sign = "+" if x.imag >= 0 else "-"
        return f"{re} {sign} {_fmt_real(im)}i"
    return _fmt_real(float(x))


def _fmt_real(v: float) -> str:
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "Inf" if v > 0 else "-Inf"
    long = _FORMAT["mode"] == "long"
    if v == int(v) and abs(v) < 1e10:
        return str(int(v))
    if long:
        return f"{v:.15g}"
    a = abs(v)
    if a >= 1e5 or (a < 1e-3 and a > 0):
        return f"{v:.4e}"
    return f"{v:.4f}"


def format_value(name: str, v) -> str:
    body = _format_body(v)
    return f"{name} =\n\n{body}\n"


def _format_body(v, indent: str = "    ") -> str:
    tn = type(v).__name__
    if tn == "SymValue":
        from ..runtime.builtins.symbolic import sym_display
        return sym_display(v)
    # classdef objects and class references: not yet ported (ROADMAP
    # A16)
    if tn == "MatTable":
        widths = [max(len(nm), 8) for nm in v.varnames]
        lines = [indent + "    ".join(nm.rjust(w) for nm, w in
                                      zip(v.varnames, widths)),
                 indent + "    ".join("_" * w for w in widths)]
        import numpy as _np
        for r in range(min(v.height, 20)):
            cells = []
            for c, w in zip(v.cols, widths):
                if isinstance(c, MatArray):
                    cells.append(_fmt_scalar(c.host()[r, 0], c.mclass).rjust(w))
                else:
                    cells.append(str(c.data[r, 0]).rjust(w))
            lines.append(indent + "    ".join(cells))
        if v.height > 20:
            lines.append(indent + f"... ({v.height} rows)")
        return "\n".join(lines)
    if tn == "MatDatetime":
        flat = v.data.reshape(-1)
        txt = "   ".join(str(t).replace("T", " ") for t in flat[:6])
        return indent + txt
    if tn == "MatDuration":
        secs = v.seconds_array().reshape(-1)
        parts = []
        for s_ in secs[:6]:
            hh = int(s_ // 3600); mm = int((s_ % 3600) // 60); ss = s_ % 60
            parts.append(f"{hh:02d}:{mm:02d}:{ss:06.3f}")
        return indent + "   ".join(parts)
    if tn == "SparseMatrix":
        ii, jj, vv = v.triplets()
        import numpy as _np
        order = _np.lexsort((ii, jj))
        lines = [f"{indent}({ii[k]+1},{jj[k]+1})\t{vv[k]:g}"
                 for k in order[:25]]
        return "\n".join(lines) if lines else f"{indent}All zero sparse: {v.m}x{v.n}"
    if isinstance(v, MatArray):
        if v.mclass == "char":
            s = v.to_str()
            return f"{indent}'{s}'"
        h = v.host()
        if h.size == 0:
            return f"{indent}[]"
        if h.size == 1:
            return f"{indent}{_fmt_scalar(h.reshape(-1)[0], v.mclass)}"
        if h.ndim <= 2:
            lines = []
            for r in range(h.shape[0]):
                row = "   ".join(_fmt_scalar(h[r, c], v.mclass) for c in range(h.shape[1]))
                lines.append(indent + row)
            return "\n".join(lines)
        return f"{indent}[{'x'.join(map(str, h.shape))} {v.mclass}]"
    if isinstance(v, StringArray):
        if v.size == 1:
            s = v.item()
            return f'{indent}"{s}"' if s is not None else f"{indent}<missing>"
        flat = v.data.reshape(-1, order="F")
        items = ", ".join(f'"{s}"' if s is not None else "<missing>" for s in flat)
        return f"{indent}[{items}]"
    if isinstance(v, CellArray):
        if v.size == 0:
            return f"{indent}{{}}"
        rows = []
        for r in range(v.data.shape[0]):
            row = "    ".join(_cell_summary(v.data[r, c]) for c in range(v.data.shape[1]))
            rows.append(indent + "{" + row + "}")
        return "\n".join(rows)
    if isinstance(v, StructArray):
        if v.size == 1:
            lines = [f"{indent}struct with fields:", ""]
            for f in v.fields:
                val = v.fields[f].reshape(-1)[0]
                lines.append(f"{indent}    {f}: {_cell_summary(val)}")
            return "\n".join(lines)
        return (f"{indent}{'x'.join(map(str, v.shape))} struct array with fields: "
                + ", ".join(v.fields))
    if isinstance(v, FunctionHandle):
        if v.kind == "named":
            return f"{indent}@{v.name}"
        return f"{indent}@({', '.join(v.params)}) ..."
    return f"{indent}{v!r}"


def _cell_summary(v) -> str:
    if isinstance(v, MatArray):
        if v.mclass == "char":
            return f"'{v.to_str()}'"
        if v.size == 1:
            return _fmt_scalar(v.host().reshape(-1)[0], v.mclass)
        return f"[{'x'.join(map(str, v.shape))} {v.mclass}]"
    if isinstance(v, StringArray) and v.size == 1:
        return f'"{v.item()}"'
    if isinstance(v, CellArray):
        return f"{{{ 'x'.join(map(str, v.shape)) } cell}}"
    if isinstance(v, StructArray):
        return f"[{'x'.join(map(str, v.shape))} struct]"
    if isinstance(v, FunctionHandle):
        return repr(v)
    return repr(v)
