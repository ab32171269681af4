"""Copy of runmat_tpu/runtime/builtins/strings.py in the PyTorch port.

String/char builtins: sprintf, num2str, strcmp family, case/trim/split/...

Reference parity: runmat-runtime/src/builtins/strings/ (52k LoC category).
sprintf implements MATLAB's vectorized format recycling: array arguments are
flattened column-major into the conversion stream and the format is reapplied
until all arguments are consumed.
"""

from __future__ import annotations

import re

import numpy as np

from ... import dtypes
from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, fortran_ravel,
                       is_char, is_text, text_of)
from ..registry import builtin, register_alias

_SPEC_RE = re.compile(r"%(-?[#0\- +]*)(\d+|\*)?(?:\.(\d+|\*))?([diouxXeEfgGcs%])")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "f": "\f", "v": "\v",
            "a": "\a", "b": "\b", "0": "\0"}


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt == "x":
                m = re.match(r"[0-9a-fA-F]+", s[i + 2:])
                if m:
                    out.append(chr(int(m.group(0), 16)))
                    i += 2 + len(m.group(0))
                    continue
        out.append(c)
        i += 1
    return "".join(out)


def _flatten_args(args: list) -> list:
    """Flatten MATLAB sprintf args into a scalar stream (column-major).
    Char arrays used with %s stay whole; with numeric specs they stream."""
    stream = []
    for a in args:
        if isinstance(a, StringArray):
            for s in a.data.reshape(-1, order="F"):
                stream.append(("str", s if s is not None else ""))
        elif isinstance(a, MatArray):
            if a.mclass == "char":
                stream.append(("char", a.to_str()))
            else:
                h = fortran_ravel(a.host())
                for v in h:
                    stream.append(("num", v))
        else:
            stream.append(("other", a))
    return stream


def format_matlab(fmt: str, args: list) -> str:
    fmt = _unescape(fmt)
    stream = _flatten_args(args)
    pos = 0
    out = []
    specs = list(_SPEC_RE.finditer(fmt))
    if not specs or not stream:
        # no conversions or no args: emit once
        return _apply_once(fmt, stream, 0)[0]
    while True:
        chunk, consumed = _apply_once(fmt, stream, pos)
        out.append(chunk)
        pos += consumed
        if consumed == 0 or pos >= len(stream):
            break
    return "".join(out)


def _apply_once(fmt: str, stream: list, start: int) -> tuple[str, int]:
    out = []
    last = 0
    pos = start
    for m in _SPEC_RE.finditer(fmt):
        out.append(fmt[last:m.end(0) - len(m.group(0))] if False else fmt[last:m.start()])
        last = m.end()
        flags, width, prec, conv = m.groups()
        if conv == "%":
            out.append("%")
            continue
        if width == "*":
            if pos < len(stream):
                width = str(int(_as_num(stream[pos])))
                pos += 1
            else:
                width = ""
        if prec == "*":
            if pos < len(stream):
                prec = str(int(_as_num(stream[pos])))
                pos += 1
            else:
                prec = ""
        if pos >= len(stream):
            # MATLAB stops emitting when args run out mid-format
            return "".join(out), pos - start
        kind, val = stream[pos]
        pos += 1
        pyfmt = "%" + (flags or "") + (width or "") + (("." + prec) if prec else "") + conv
        try:
            if conv == "s":
                if kind in ("char", "str"):
                    out.append(pyfmt % val)
                else:
                    out.append(pyfmt % _num_to_str(val))
            elif conv == "c":
                if kind in ("char", "str") and isinstance(val, str) and len(val) >= 1:
                    out.append(pyfmt % val[0])
                else:
                    out.append(pyfmt % chr(int(_as_num((kind, val)))))
            elif conv in "diouxX":
                v = _as_num((kind, val))
                if conv in "di" and (np.isnan(v) or np.isinf(v)):
                    out.append("NaN" if np.isnan(v) else ("Inf" if v > 0 else "-Inf"))
                else:
                    out.append(("%" + (flags or "") + (width or "")
                                + (("." + prec) if prec else "") + ("d" if conv == "i" else conv))
                               % int(round(v)))
            else:
                out.append(pyfmt % _as_num((kind, val)))
        except (TypeError, ValueError, OverflowError):
            out.append(str(val))
    out.append(fmt[last:])
    return "".join(out), pos - start


def _as_num(item) -> float:
    kind, val = item
    if kind == "num":
        if isinstance(val, (np.complexfloating, complex)):
            return float(val.real)
        return float(val)
    if kind in ("char", "str"):
        return float(ord(val[0])) if val else 0.0
    raise MatError("MATLAB:sprintf:badArg", "Invalid numeric argument.")


def _num_to_str(v) -> str:
    x = float(v.real) if isinstance(v, (complex, np.complexfloating)) else float(v)
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "Inf" if x > 0 else "-Inf"
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.5g}" if abs(x) < 1e5 else f"{x:.4e}"


@builtin("sprintf", category="strings", min_in=1)
def m_sprintf(fmt, *args):
    return MatArray.char_from_str(format_matlab(text_of(fmt), list(args)))


@builtin("num2str", category="strings", min_in=1, max_in=2)
def m_num2str(x, fmt=None):
    if is_text(x):
        return x if is_char(x) else MatArray.char_from_str(text_of(x))
    h = x.host()
    if fmt is not None and is_text(fmt):
        return MatArray.char_from_str(format_matlab(text_of(fmt), [x]).rstrip("\n"))
    if fmt is not None:
        digits = int(fmt.scalar_double())
        if h.size == 1:
            return MatArray.char_from_str("%.*g" % (digits, h.reshape(-1)[0]))
    if h.size == 1:
        v = h.reshape(-1)[0]
        if np.iscomplexobj(h):
            re_s = _num_to_str(v.real)
            im = v.imag
            return MatArray.char_from_str(f"{re_s}{'+' if im >= 0 else '-'}{_num_to_str(abs(im))}i")
        if h.dtype.kind == "f" and v == int(v) and abs(v) < 1e15:
            return MatArray.char_from_str(str(int(v)))
        if h.dtype.kind in "iub":
            return MatArray.char_from_str(str(int(v)))
        return MatArray.char_from_str(f"{float(v):.4f}".rstrip("0").rstrip(".")
                                      if abs(v) < 1e5 else f"{float(v):.4e}")
    rows = []
    for r in range(h.shape[0]):
        rows.append("  ".join(_num_to_str(v) for v in h[r].reshape(-1)))
    width = max(len(r) for r in rows) if rows else 0
    return MatArray.char_from_str("\n".join(r.ljust(width) for r in rows))


@builtin("str2double", category="strings", min_in=1, max_in=1)
def m_str2double(x):
    def conv(s):
        if s is None:
            return np.nan
        s = s.strip()
        try:
            return float(s)
        except ValueError:
            ss = s.replace("i", "j").replace(" ", "")
            try:
                return complex(ss)
            except ValueError:
                return np.nan
    if isinstance(x, StringArray):
        out = np.empty(x.shape, dtype=np.complex128)
        fo, fi = out.reshape(-1), x.data.reshape(-1)
        for k in range(fi.size):
            fo[k] = conv(fi[k])
        if np.all(out.imag == 0):
            return MatArray(out.real, "double")
        return MatArray(out, "double")
    if is_char(x):
        v = conv(x.to_str())
        if isinstance(v, complex) and v.imag != 0:
            return MatArray(np.full((1, 1), v, dtype=np.complex128), "double")
        return MatArray.scalar(float(v.real) if isinstance(v, complex) else v)
    if isinstance(x, CellArray):
        out = np.empty(x.shape, dtype=np.float64)
        fo, fi = out.reshape(-1), x.data.reshape(-1, order="F")
        for k in range(fi.size):
            el = fi[k]
            out.reshape(-1)[k] = conv(el.to_str()) if is_char(el) else np.nan
        return MatArray(fortranish(out, x.shape), "double")
    return MatArray.scalar(np.nan)


def fortranish(flat_or_arr: np.ndarray, shape) -> np.ndarray:
    a = np.asarray(flat_or_arr)
    return a.reshape(shape) if a.shape != shape else a


@builtin("str2num", category="strings", min_in=1, max_in=1, pass_ctx=True)
def m_str2num(x, ctx=None):
    src = text_of(x)
    from ...frontend.parser import parse_expression
    from ...vm import bytecode as BC
    from ...vm.compiler import Compiler
    from ...vm.interp import Frame
    try:
        c = Compiler("<str2num>", is_script=False)
        c.expr(parse_expression(src))
        c.code.emit(BC.RET)
        f = Frame(c.code)
        stack = ctx.interp.run(c.code, f, keep_stack=True)
        return stack[-1] if stack else MatArray.empty()
    except MatError:
        return MatArray.empty()


def _cmp_text(a) -> str | None:
    try:
        return text_of(a)
    except MatError:
        return None


def _str_pair_compare(a, b, case: bool, n: int | None = None):
    # cellwise comparison support
    if isinstance(a, CellArray) or isinstance(b, CellArray):
        ca = a.data if isinstance(a, CellArray) else None
        cb = b.data if isinstance(b, CellArray) else None
        shape = ca.shape if ca is not None else cb.shape
        out = np.zeros(shape, dtype=np.bool_)
        fo = out.reshape(-1)
        fa = ca.reshape(-1, order="F") if ca is not None else None
        fb = cb.reshape(-1, order="F") if cb is not None else None
        out_flat = out.reshape(-1, order="F") if False else fo
        for k in range(out.size):
            xa = fa[k] if fa is not None else a
            xb = fb[k] if fb is not None else b
            sa, sb = _cmp_text(xa), _cmp_text(xb)
            ok = sa is not None and sb is not None
            if ok:
                if n is not None:
                    sa, sb = sa[:n], sb[:n]
                    ok = len(_cmp_text(xa)) >= n and len(_cmp_text(xb)) >= n
                if not case:
                    sa, sb = sa.lower(), sb.lower()
            out_flat[k] = ok and sa == sb
        return MatArray(out, "logical")
    sa, sb = _cmp_text(a), _cmp_text(b)
    if sa is None or sb is None:
        return MatArray.logical_scalar(False)
    if n is not None:
        if len(sa) < n or len(sb) < n:
            return MatArray.logical_scalar(False)
        sa, sb = sa[:n], sb[:n]
    if not case:
        sa, sb = sa.lower(), sb.lower()
    return MatArray.logical_scalar(sa == sb)


@builtin("strcmp", category="strings", min_in=2, max_in=2)
def m_strcmp(a, b):
    return _str_pair_compare(a, b, case=True)


@builtin("strcmpi", category="strings", min_in=2, max_in=2)
def m_strcmpi(a, b):
    return _str_pair_compare(a, b, case=False)


@builtin("strncmp", category="strings", min_in=3, max_in=3)
def m_strncmp(a, b, n):
    return _str_pair_compare(a, b, case=True, n=int(n.scalar_double()))


@builtin("strncmpi", category="strings", min_in=3, max_in=3)
def m_strncmpi(a, b, n):
    return _str_pair_compare(a, b, case=False, n=int(n.scalar_double()))


def _map_text(v, fn):
    if isinstance(v, StringArray):
        out = np.empty(v.shape, dtype=object)
        fo, fi = out.reshape(-1), v.data.reshape(-1)
        for k in range(fi.size):
            fo[k] = fn(fi[k]) if fi[k] is not None else None
        return StringArray(out)
    if isinstance(v, CellArray):
        out = np.empty(v.shape, dtype=object)
        fo, fi = out.reshape(-1), v.data.reshape(-1)
        for k in range(fi.size):
            el = fi[k]
            fo[k] = MatArray.char_from_str(fn(el.to_str())) if is_char(el) else el
        return CellArray(out)
    return MatArray.char_from_str(fn(text_of(v)))


@builtin("upper", category="strings", min_in=1, max_in=1)
def m_upper(x):
    return _map_text(x, str.upper)


@builtin("lower", category="strings", min_in=1, max_in=1)
def m_lower(x):
    return _map_text(x, str.lower)


@builtin("strtrim", category="strings", min_in=1, max_in=1)
def m_strtrim(x):
    return _map_text(x, str.strip)


@builtin("strrep", category="strings", min_in=3, max_in=3)
def m_strrep(s, old, new):
    o, nw = text_of(old), text_of(new)
    return _map_text(s, lambda t: t.replace(o, nw))


@builtin("strcat", category="strings", min_in=1)
def m_strcat(*args):
    if any(isinstance(a, StringArray) for a in args):
        parts = [text_of(a) if not isinstance(a, StringArray) else (a.item() or "") for a in args]
        return StringArray.scalar("".join(parts))
    # char rule: trailing whitespace of char args is removed
    return MatArray.char_from_str("".join(text_of(a).rstrip() for a in args))


@builtin("strsplit", category="strings", min_in=1, max_in=2)
def m_strsplit(s, delim=None):
    t = text_of(s)
    if delim is None:
        parts = t.split()
    else:
        if isinstance(delim, CellArray):
            ds = [text_of(d) for d in delim.data.reshape(-1)]
            pattern = "|".join(re.escape(d) for d in ds)
            parts = re.split(pattern, t)
        else:
            parts = t.split(text_of(delim))
    data = np.empty((1, len(parts)), dtype=object)
    for i, p in enumerate(parts):
        data[0, i] = MatArray.char_from_str(p)
    return CellArray(data)


@builtin("strjoin", category="strings", min_in=1, max_in=2)
def m_strjoin(c, delim=None):
    d = text_of(delim) if delim is not None else " "
    if isinstance(c, CellArray):
        parts = [text_of(e) for e in c.data.reshape(-1, order="F")]
    elif isinstance(c, StringArray):
        parts = [(e or "") for e in c.data.reshape(-1, order="F")]
    else:
        raise bad_arg("strjoin", "First input must be a cell of char or a string array.")
    return MatArray.char_from_str(d.join(parts)) if isinstance(c, CellArray) else \
        StringArray.scalar(d.join(parts))


def _ignore_case(opts) -> bool:
    """Parse the trailing 'IgnoreCase', tf name-value pair."""
    for i, o in enumerate(opts):
        if is_text(o) and text_of(o).lower() == "ignorecase":
            if i + 1 < len(opts):
                v = opts[i + 1]
                return bool(np.asarray(v.host()).reshape(-1)[0])
            return True
    return False


@builtin("contains", category="strings", min_in=2, max_in=4)
def m_contains(s, pat, *opts):
    p = text_of(pat)
    ic = _ignore_case(opts)
    if ic:
        p = p.lower()
    test = (lambda t: p in t.lower()) if ic else (lambda t: p in t)
    if isinstance(s, (StringArray, CellArray)):
        return _map_bool(s, test)
    return MatArray.logical_scalar(test(text_of(s)))


@builtin("startsWith", category="strings", min_in=2, max_in=4)
def m_startswith(s, pat, *opts):
    p = text_of(pat)
    ic = _ignore_case(opts)
    if ic:
        p = p.lower()
    test = (lambda t: t.lower().startswith(p)) if ic else \
        (lambda t: t.startswith(p))
    if isinstance(s, (StringArray, CellArray)):
        return _map_bool(s, test)
    return MatArray.logical_scalar(test(text_of(s)))


@builtin("endsWith", category="strings", min_in=2, max_in=4)
def m_endswith(s, pat, *opts):
    p = text_of(pat)
    ic = _ignore_case(opts)
    if ic:
        p = p.lower()
    test = (lambda t: t.lower().endswith(p)) if ic else \
        (lambda t: t.endswith(p))
    if isinstance(s, (StringArray, CellArray)):
        return _map_bool(s, test)
    return MatArray.logical_scalar(test(text_of(s)))


def _map_bool(v, fn):
    if isinstance(v, StringArray):
        out = np.zeros(v.shape, dtype=np.bool_)
        fo, fi = out.reshape(-1), v.data.reshape(-1)
        for k in range(fi.size):
            fo[k] = fn(fi[k]) if fi[k] is not None else False
        return MatArray(out, "logical")
    out = np.zeros(v.shape, dtype=np.bool_)
    fo, fi = out.reshape(-1), v.data.reshape(-1)
    for k in range(fi.size):
        el = fi[k]
        fo[k] = fn(el.to_str()) if is_char(el) else False
    return MatArray(out, "logical")


@builtin("strfind", category="strings", min_in=2, max_in=2)
def m_strfind(s, pat):
    t = text_of(s)
    p = text_of(pat)
    if not p:
        return MatArray(np.zeros((1, 0)), "double")
    idxs = []
    start = 0
    while True:
        i = t.find(p, start)
        if i < 0:
            break
        idxs.append(i + 1)
        start = i + 1
    return MatArray(np.array(idxs, dtype=np.float64).reshape(1, -1), "double")


@builtin("regexprep", category="strings", min_in=3)
def m_regexprep(s, pat, rep, *opts):
    p = _matlab_regex(text_of(pat))
    r = re.sub(r"\$(\d+)", r"\\\1", text_of(rep))
    count = 0
    flags = 0
    for o in opts:
        t = text_of(o).lower() if is_text(o) else ""
        if t == "once":
            count = 1
        elif t == "ignorecase":
            flags |= re.IGNORECASE
        elif t == "preservecase":
            pass
    return _map_text(s, lambda t: re.sub(p, r, t, count=count, flags=flags))


@builtin("regexp", category="strings", min_in=2, pass_nargout=True)
def m_regexp(s, pat, *opts, nargout=1):
    t = text_of(s)
    p = _matlab_regex(text_of(pat))
    mode = [text_of(o).lower() for o in opts if is_text(o)]
    flags = re.IGNORECASE if "ignorecase" in mode else 0
    matches = list(re.finditer(p, t, flags))
    once = "once" in mode
    results = {}
    results["start"] = [m.start() + 1 for m in matches]
    results["end"] = [m.end() for m in matches]
    results["match"] = [m.group(0) for m in matches]
    results["tokens"] = [[g if g is not None else "" for g in m.groups()] for m in matches]
    order = [m for m in mode if m in ("start", "end", "match", "tokens", "names", "split")]
    if not order:
        order = ["start"]
    out = []
    for key in order:
        if key == "split":
            parts = re.split(p, t)
            data = np.empty((1, len(parts)), dtype=object)
            for i, x in enumerate(parts):
                data[0, i] = MatArray.char_from_str(x)
            out.append(CellArray(data))
        elif key == "match":
            if once:
                out.append(MatArray.char_from_str(results["match"][0]) if matches else MatArray.char_from_str(""))
            else:
                data = np.empty((1, len(matches)), dtype=object)
                for i, x in enumerate(results["match"]):
                    data[0, i] = MatArray.char_from_str(x)
                out.append(CellArray(data))
        elif key in ("start", "end"):
            vals = results[key]
            if once:
                out.append(MatArray.scalar(float(vals[0])) if vals else MatArray.empty())
            else:
                out.append(MatArray(np.array(vals, dtype=np.float64).reshape(1, -1), "double"))
        elif key == "tokens":
            data = np.empty((1, len(matches)), dtype=object)
            for i, toks in enumerate(results["tokens"]):
                inner = np.empty((1, len(toks)), dtype=object)
                for j, tk in enumerate(toks):
                    inner[0, j] = MatArray.char_from_str(tk)
                data[0, i] = CellArray(inner)
            out.append(CellArray(data))
        elif key == "names":
            from ...values import StructArray
            if matches:
                gd = matches[0].groupdict()
                out.append(StructArray.scalar(
                    {k: MatArray.char_from_str(v or "") for k, v in gd.items()}))
            else:
                out.append(StructArray({}, (0, 0)))
    if not out:
        out = [MatArray.empty()]
    return out[:max(1, nargout)] if len(out) > 1 else out[0]


def _matlab_regex(p: str) -> str:
    """MATLAB (PCRE-flavored) regex -> Python re: named groups `(?<n>)` become
    `(?P<n>)`; lookbehind `(?<=`/`(?<!` stay untouched."""
    return re.sub(r"\(\?<(?![=!])", "(?P<", p)


@builtin("blanks", category="strings", min_in=1, max_in=1)
def m_blanks(n):
    return MatArray.char_from_str(" " * int(n.scalar_double()))


@builtin("isspace", category="strings", min_in=1, max_in=1)
def m_isspace(s):
    h = s.host()
    out = np.zeros(h.shape, dtype=np.bool_)
    fo, fi = out.reshape(-1), h.reshape(-1)
    for k in range(fi.size):
        fo[k] = chr(int(fi[k])).isspace()
    return MatArray(out, "logical")


@builtin("isletter", category="strings", min_in=1, max_in=1)
def m_isletter(s):
    h = s.host()
    out = np.zeros(h.shape, dtype=np.bool_)
    fo, fi = out.reshape(-1), h.reshape(-1)
    for k in range(fi.size):
        fo[k] = chr(int(fi[k])).isalpha()
    return MatArray(out, "logical")


@builtin("pad", category="strings", min_in=1, max_in=3)
def m_pad(s, n=None, side=None):
    t = text_of(s)
    width = int(n.scalar_double()) if n is not None else len(t)
    sd = text_of(side) if side is not None else "right"
    if sd == "left":
        return MatArray.char_from_str(t.rjust(width))
    if sd == "both":
        return MatArray.char_from_str(t.center(width))
    return MatArray.char_from_str(t.ljust(width))
