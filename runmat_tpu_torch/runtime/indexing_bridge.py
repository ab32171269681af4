"""Copy of runmat_tpu/runtime/indexing_bridge.py in the PyTorch port.

Function-form indexing bridge: subsref / subsasgn over substructs.

Reference parity: runmat-runtime/src/builtins/introspection/{subsref,
subsasgn}.rs — walk a substruct ('()' paren, '{}' brace, '.' field) against
a value using the same indexing engine the VM uses.
"""

from __future__ import annotations

from ..errors import MatError, bad_arg
from ..values import CellArray, MatArray, StructArray, text_of
from ..vm import indexing as IX


def _steps(s) -> list:
    if not isinstance(s, StructArray) or "type" not in s.fields or \
            "subs" not in s.fields:
        raise bad_arg("subsref", "S must be a substruct with type/subs fields.")
    types = s.fields["type"].reshape(-1)
    subs = s.fields["subs"].reshape(-1)
    out = []
    for t, sub in zip(types, subs):
        out.append((text_of(t), sub))
    return out


def _args_of(sub) -> list:
    if isinstance(sub, CellArray):
        return list(sub.data.reshape(-1, order="F"))
    return [sub]


def apply_subs(ctx, obj, s, value, read: bool):
    steps = _steps(s)
    if read:
        cur = obj
        for kind, sub in steps:
            if kind == "()":
                cur = IX.read_paren(cur, _args_of(sub))
            elif kind == "{}":
                cur = IX.read_brace(cur, _args_of(sub))
            elif kind == ".":
                cur = ctx.interp._field_read(cur, text_of(sub))
            else:
                raise bad_arg("subsref", f"Unknown subscript type '{kind}'.")
        return cur
    # write: recursive read-modify-write along the chain
    if len(steps) == 1:
        kind, sub = steps[0]
        if kind == "()":
            return IX.write_paren(obj, _args_of(sub), value)
        if kind == "{}":
            return IX.write_brace(obj, _args_of(sub), value)
        if kind == ".":
            fname = text_of(sub)
            if hasattr(obj, "_mat_set_field_"):
                if obj._mat_set_field_(fname, value) is not NotImplemented:
                    return obj
            if obj is None or (isinstance(obj, MatArray) and obj.size == 0):
                obj = StructArray.scalar()
            if not isinstance(obj, StructArray):
                raise MatError("MATLAB:structAssToNonStruct",
                               "Field assignment to a non-structure value.")
            out = obj.copy()
            out.set_scalar_field(fname, value)
            return out
        raise bad_arg("subsasgn", f"Unknown subscript type '{kind}'.")
    # multi-step: read down to the parent, assign, write back up
    head, tail = steps[0], steps[1:]
    kind, sub = head
    if kind == "()":
        inner = IX.read_paren(obj, _args_of(sub))
    elif kind == "{}":
        inner = IX.read_brace(obj, _args_of(sub))
    else:
        inner = ctx.interp._field_read(obj, text_of(sub))
    new_inner = apply_subs(ctx, inner, _make_substruct(tail), value, read=False)
    return apply_subs(ctx, obj, _make_substruct([head]), new_inner, read=False)


def _make_substruct(steps: list) -> StructArray:
    import numpy as np
    n = len(steps)
    types = np.empty((1, n), dtype=object)
    subs = np.empty((1, n), dtype=object)
    for i, (t, sub) in enumerate(steps):
        types[0, i] = MatArray.char_from_str(t)
        subs[0, i] = sub
    return StructArray({"type": types, "subs": subs}, (1, n))
