"""Copy of runmat_tpu/runtime/builtins/handles.py in the PyTorch port.

Function-handle utilities: func2str, str2func, functions.

Reference parity: runmat-runtime/src/builtins (function handle category);
Value::FunctionHandle/Closure (runmat-builtins/src/lib.rs:73-123).
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import FunctionHandle, MatArray, StructArray, text_of
from ..registry import builtin


@builtin("func2str", category="handles", min_in=1, max_in=1)
def m_func2str(f):
    if not isinstance(f, FunctionHandle):
        raise bad_arg("func2str", "Input must be a function handle.")
    if f.kind == "named":
        return MatArray.char_from_str(f"@{f.name}")
    if getattr(f, "src", ""):
        return MatArray.char_from_str(f.src)
    return MatArray.char_from_str(f"@({', '.join(f.params)}) ...")


@builtin("str2func", category="handles", min_in=1, max_in=1, pass_ctx=True)
def m_str2func(s, ctx=None):
    t = text_of(s)
    if t.startswith("@("):
        from ...frontend.parser import parse_expression
        from ...vm.compiler import Compiler
        e = parse_expression(t)
        c = Compiler()
        adef = c.compile_anon(e)
        return FunctionHandle("anon", params=adef.params, body=adef.code, captures={})
    name = t[1:] if t.startswith("@") else t
    return FunctionHandle("named", name=name)


@builtin("functions", category="handles", min_in=1, max_in=1)
def m_functions(f):
    if not isinstance(f, FunctionHandle):
        raise bad_arg("functions", "Input must be a function handle.")
    return StructArray.scalar({
        "function": MatArray.char_from_str(f.name if f.kind == "named" else "@anonymous"),
        "type": MatArray.char_from_str("simple" if f.kind == "named" else "anonymous"),
        "file": MatArray.char_from_str(""),
    })


@builtin("is_function_handle", category="handles", min_in=1, max_in=1)
def m_is_function_handle2(x):
    return MatArray.logical_scalar(isinstance(x, FunctionHandle))


from ..registry import register_alias  # noqa: E402

register_alias("isfunctionhandle", "is_function_handle")
