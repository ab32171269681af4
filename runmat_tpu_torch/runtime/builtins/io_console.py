"""Copy of runmat_tpu/runtime/builtins/io_console.py in the PyTorch port.

Console/diagnostics builtins: disp, fprintf, error, warning, format, display.

Reference parity: runmat-runtime/src/{console.rs,builtins/diagnostics} and the
warning store (warning_store.rs).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, StructArray, is_char,
                       is_text, text_of)
from ...unported import not_ported
from ..registry import builtin
from .strings import format_matlab

_WARN_STATE = {"enabled": True, "last": ("", "")}


@builtin("disp", category="io/console", min_in=1, max_in=1, pass_ctx=True, is_sink=True)
def m_disp(x, ctx=None):
    from ...utils.display import _format_body
    if isinstance(x, MatArray) and x.mclass == "char":
        ctx.session.write(x.to_str() + "\n")
        return None
    if isinstance(x, StringArray) and x.size == 1:
        ctx.session.write((x.item() or "") + "\n")
        return None
    ctx.session.write(_format_body(x) + "\n")
    return None


@builtin("display", category="io/console", min_in=1, max_in=2, pass_ctx=True, is_sink=True)
def m_display(x, name=None, ctx=None):
    nm = text_of(name) if name is not None else "ans"
    ctx.session.display_value(nm, x)
    return None


@builtin("fprintf", category="io/console", min_in=1, pass_ctx=True, is_sink=True)
def m_fprintf(*args, ctx=None):
    args = list(args)
    fid = 1
    if args and isinstance(args[0], MatArray) and args[0].mclass != "char" and args[0].size == 1 \
            and not is_text(args[0]):
        fid = int(args[0].scalar_double())
        args = args[1:]
    if not args:
        return None
    fmt = text_of(args[0])
    s = format_matlab(fmt, args[1:])
    if fid in (1, 2):
        ctx.session.write(s)
    else:
        not_ported("fprintf to a file", "A16")
    return None


@builtin("error", category="diagnostics", min_in=1, pass_ctx=True)
def m_error(*args, ctx=None):
    if len(args) == 1 and isinstance(args[0], StructArray):
        st = args[0]
        ident = st.get_scalar_field("identifier") if "identifier" in st.fields else None
        msg = st.get_scalar_field("message") if "message" in st.fields else None
        raise MatError(text_of(ident) if ident is not None else "",
                       text_of(msg) if msg is not None else "")
    first = text_of(args[0])
    rest = list(args[1:])
    if ":" in first and " " not in first and "%" not in first:
        ident = first
        msg = format_matlab(text_of(rest[0]), rest[1:]) if rest else ident
        raise MatError(ident, msg)
    raise MatError("", format_matlab(first, rest))


@builtin("warning", category="diagnostics", min_in=0, pass_ctx=True)
def m_warning(*args, ctx=None):
    if not args:
        return None
    first = text_of(args[0]) if is_text(args[0]) else ""
    if first in ("on", "off"):
        prev = StructArray.scalar({
            "identifier": MatArray.char_from_str("all"),
            "state": MatArray.char_from_str(
                "on" if _WARN_STATE["enabled"] else "off")})
        _WARN_STATE["enabled"] = first == "on"
        return prev
    rest = list(args[1:])
    if ":" in first and " " not in first and "%" not in first and rest:
        ident = first
        msg = format_matlab(text_of(rest[0]), rest[1:])
    else:
        ident = ""
        msg = format_matlab(first, rest)
    _WARN_STATE["last"] = (ident, msg)
    if _WARN_STATE["enabled"]:
        ctx.session.note_warning(ident, msg)
        ctx.session.write(f"Warning: {msg}\n", kind="stderr")
    return None


@builtin("lastwarn", category="diagnostics", min_in=0, max_in=0, pass_nargout=True)
def m_lastwarn(nargout=1):
    ident, msg = _WARN_STATE["last"]
    if nargout <= 1:
        return MatArray.char_from_str(msg)
    return [MatArray.char_from_str(msg), MatArray.char_from_str(ident)]


@builtin("format", category="io/console", min_in=0, max_in=2)
def m_format(*args):
    from ...utils.display import set_format
    mode = text_of(args[0]).lower() if args else "short"
    if mode in ("short", "long"):
        set_format(mode)
    return None


@builtin("rethrow", category="diagnostics", min_in=1, max_in=1)
def m_rethrow(err):
    if isinstance(err, StructArray):
        ident = err.get_scalar_field("identifier") if "identifier" in err.fields else None
        msg = err.get_scalar_field("message") if "message" in err.fields else None
        raise MatError(text_of(ident) if ident is not None else "",
                       text_of(msg) if msg is not None else "")
    raise bad_arg("rethrow", "Input must be an MException or error structure.")


@builtin("assert", category="diagnostics", min_in=1, pass_ctx=True)
def m_assert(cond, *args, ctx=None):
    ok = cond.is_true() if isinstance(cond, MatArray) else bool(cond)
    if not ok:
        if args:
            first = text_of(args[0])
            if ":" in first and " " not in first and len(args) > 1:
                raise MatError(first, format_matlab(text_of(args[1]), list(args[2:])))
            raise MatError("MATLAB:assertion:failed", format_matlab(first, list(args[1:])))
        raise MatError("MATLAB:assertion:failed", "Assertion failed.")
    return None


@builtin("input", category="io/console", min_in=1, max_in=2, pass_ctx=True)
def m_input(prompt, mode=None, ctx=None):
    p = text_of(prompt)
    ctx.session.write(p)
    line = ctx.session.read_line() if hasattr(ctx.session, "read_line") else input()
    if mode is not None and text_of(mode) == "s":
        return MatArray.char_from_str(line)
    from ...frontend.parser import parse_expression
    res = ctx.session.execute(f"ans = {line};")
    if res.error:
        raise res.error
    return ctx.session.get("ans")


@builtin("MException", category="diagnostics", min_in=2)
def m_mexception(ident, fmt, *args):
    """e = MException(identifier, message, ...) — the error-object
    constructor (≙ Value::MException in the reference)."""
    from ...values import CellArray as _CA
    msg = format_matlab(text_of(fmt), list(args))
    return StructArray.scalar({
        "identifier": MatArray.char_from_str(text_of(ident)),
        "message": MatArray.char_from_str(msg),
        "stack": StructArray({}, (0, 0)),
        "cause": _CA.empty(),
    })


def _require_mexc(e, name):
    if not isinstance(e, StructArray) or "identifier" not in e.fields:
        raise bad_arg(name, "Input must be an MException.")
    return e


@builtin("addCause", category="diagnostics", min_in=2, max_in=2)
def m_addcause(e, cause):
    import numpy as np
    from ...values import CellArray as _CA
    _require_mexc(e, "addCause")
    _require_mexc(cause, "addCause")
    old = e.get_scalar_field("cause") if "cause" in e.fields else _CA.empty()
    n = old.size if hasattr(old, "size") else 0
    data = np.empty((n + 1, 1), dtype=object)
    for i in range(n):
        data[i, 0] = old.data.reshape(-1)[i]
    data[n, 0] = cause
    return StructArray.scalar({
        "identifier": e.get_scalar_field("identifier"),
        "message": e.get_scalar_field("message"),
        "stack": e.get_scalar_field("stack") if "stack" in e.fields
        else StructArray({}, (0, 0)),
        "cause": _CA(data),
    })


@builtin("getReport", category="diagnostics", min_in=1, max_in=2)
def m_getreport(e, kind=None):
    _require_mexc(e, "getReport")
    ident = text_of(e.get_scalar_field("identifier"))
    msg = text_of(e.get_scalar_field("message"))
    head = f"Error using {ident}\n{msg}" if ident else f"Error: {msg}"
    return MatArray.char_from_str(head)


@builtin("throw", category="diagnostics", min_in=1, max_in=1)
def m_throw(e):
    _require_mexc(e, "throw")
    raise MatError(text_of(e.get_scalar_field("identifier")),
                   text_of(e.get_scalar_field("message")))


@builtin("throwAsCaller", category="diagnostics", min_in=1, max_in=1)
def m_throw_as_caller(e):
    _require_mexc(e, "throwAsCaller")
    raise MatError(text_of(e.get_scalar_field("identifier")),
                   text_of(e.get_scalar_field("message")))
