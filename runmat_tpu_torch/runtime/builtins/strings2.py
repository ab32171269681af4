"""Copy of runmat_tpu/runtime/builtins/strings2.py in the PyTorch port.

Strings batch 2: core extensions (string/char conversion matrix, scan,
tokens, properties) and transform family (replace/strip/append/matches/...).

Reference parity: runmat-runtime/src/builtins/strings/{core,transform} —
compose, convertCharsToStrings/convertStringsToChars/
convertContainedStringsToChars, int2str/mat2str, genvarname, isstrprop,
isStringScalar, newline, strings, strlength, strtok, sscanf,
native2unicode/unicode2native, append, erase*, matches, replace/
replaceBetween/eraseBetween, splitlines, strip, strjust, plus the pattern
builders (digitsPattern/lettersPattern/wildcardPattern/textBoundary/
regexpPattern) represented as regex-backed pattern strings.
"""

from __future__ import annotations

import re

import numpy as np

from ...errors import bad_arg
from ...values import (CellArray, MatArray, StringArray, is_char, is_text,
                       text_of)
from ..registry import builtin
from .common import scalar_int
from .strings import _map_text


def _texts_of(v) -> list[str]:
    """All text elements of a string array / cellstr / char row, in F order."""
    if isinstance(v, StringArray):
        return [s if s is not None else "" for s in v.data.reshape(-1, order="F")]
    if isinstance(v, CellArray):
        return [e.to_str() for e in v.data.reshape(-1, order="F")]
    return [text_of(v)]


# --------------------------------------------------------------- pattern type #
# MATLAB `pattern` objects are represented as strings carrying a regex with a
# marker prefix; text functions accepting patterns detect the marker.

_PAT_PREFIX = "\x00rx:"


def _pat(rx: str) -> StringArray:
    return StringArray.scalar(_PAT_PREFIX + rx)


def _as_regex(v) -> str:
    """Literal text -> escaped regex; pattern object -> its regex."""
    t = text_of(v)
    if t.startswith(_PAT_PREFIX):
        return t[len(_PAT_PREFIX):]
    return re.escape(t)


@builtin("pattern", category="strings/pattern", min_in=1, max_in=1)
def m_pattern(text):
    return _pat(_as_regex(text))


@builtin("digitsPattern", category="strings/pattern", min_in=0, max_in=2)
def m_digits_pattern(n=None, m=None):
    if n is None:
        return _pat(r"\d+")
    lo = scalar_int(n, "N")
    hi = scalar_int(m, "M") if m is not None else lo
    return _pat(r"\d{%d,%d}" % (lo, hi))


@builtin("lettersPattern", category="strings/pattern", min_in=0, max_in=2)
def m_letters_pattern(n=None, m=None):
    if n is None:
        return _pat(r"[A-Za-z]+")
    lo = scalar_int(n, "N")
    hi = scalar_int(m, "M") if m is not None else lo
    return _pat(r"[A-Za-z]{%d,%d}" % (lo, hi))


@builtin("wildcardPattern", category="strings/pattern", min_in=0, max_in=0)
def m_wildcard_pattern():
    return _pat(r".*?")


@builtin("textBoundary", category="strings/pattern", min_in=0, max_in=1)
def m_text_boundary(kind=None):
    k = text_of(kind).lower() if kind is not None else "both"
    if k == "start":
        return _pat(r"^")
    if k == "end":
        return _pat(r"$")
    return _pat(r"^|$")


@builtin("regexpPattern", category="strings/pattern", min_in=1, max_in=1)
def m_regexp_pattern(rx):
    return _pat(text_of(rx))


# ------------------------------------------------------------ core conversion #

@builtin("newline", category="strings", min_in=0, max_in=0)
def m_newline():
    return MatArray.char_from_str("\n")


@builtin("strings", category="strings", min_in=0)
def m_strings(*dims):
    if not dims:
        return StringArray.scalar("")
    ds = [scalar_int(d, "size") for d in dims]
    if len(ds) == 1:
        ds = [ds[0], ds[0]]
    data = np.full(tuple(ds), "", dtype=object)
    return StringArray(data)


@builtin("strlength", category="strings", min_in=1, max_in=1)
def m_strlength(s):
    if isinstance(s, StringArray):
        out = np.array([[float(len(t)) if t is not None else np.nan
                         for t in row] for row in
                        (s.data if s.data.ndim == 2 else s.data.reshape(1, -1))])
        return MatArray(out.reshape(s.shape), "double")
    if isinstance(s, CellArray):
        out = np.array([float(len(e.to_str())) for e in s.data.reshape(-1, order="F")])
        return MatArray(out.reshape(s.shape, order="F"), "double")
    return MatArray.scalar(float(len(text_of(s))))


@builtin("isStringScalar", category="strings", min_in=1, max_in=1)
def m_is_string_scalar(s):
    return MatArray.logical_scalar(isinstance(s, StringArray) and s.size == 1)


@builtin("convertCharsToStrings", category="strings", min_in=1, pass_nargout=True)
def m_convert_chars_to_strings(*args, nargout=1):
    outs = []
    for a in args:
        if isinstance(a, MatArray) and a.mclass == "char":
            outs.append(StringArray.scalar(a.to_str()))
        elif isinstance(a, CellArray) and all(
                is_char(e) for e in a.data.reshape(-1)) and a.size > 0:
            data = np.empty(a.shape, dtype=object)
            df, sf = data.reshape(-1), a.data.reshape(-1)
            for i in range(sf.size):
                df[i] = sf[i].to_str()
            outs.append(StringArray(data))
        else:
            outs.append(a)
    return outs[0] if len(outs) == 1 else outs[:max(1, nargout)]


@builtin("convertStringsToChars", category="strings", min_in=1, pass_nargout=True)
def m_convert_strings_to_chars(*args, nargout=1):
    outs = []
    for a in args:
        if isinstance(a, StringArray):
            if a.size == 1:
                outs.append(MatArray.char_from_str(a.item() or ""))
            else:
                data = np.empty(a.shape, dtype=object)
                df, sf = data.reshape(-1), a.data.reshape(-1)
                for i in range(sf.size):
                    df[i] = MatArray.char_from_str(sf[i] or "")
                outs.append(CellArray(data))
        else:
            outs.append(a)
    return outs[0] if len(outs) == 1 else outs[:max(1, nargout)]


@builtin("convertContainedStringsToChars", category="strings", min_in=1,
         pass_nargout=True)
def m_convert_contained(*args, nargout=1):
    outs = [_convert_contained_one(a) for a in args]
    return outs[:max(1, nargout)] if len(args) > 1 else outs[0]


def _convert_contained_one(a):
    if isinstance(a, StringArray):
        return m_convert_strings_to_chars(a)
    if isinstance(a, CellArray):
        data = np.empty(a.shape, dtype=object)
        df, sf = data.reshape(-1), a.data.reshape(-1)
        for i in range(sf.size):
            df[i] = _convert_contained_one(sf[i])
        return CellArray(data)
    return a


@builtin("int2str", category="strings", min_in=1, max_in=1)
def m_int2str(x):
    h = x.host().astype(np.float64)
    r = np.round(h)
    if r.size == 1:
        return MatArray.char_from_str(str(int(r.reshape(-1)[0])))
    rows = []
    for i in range(r.shape[0]):
        rows.append("  ".join(str(int(v)) for v in r[i]))
    w = max(len(s) for s in rows)
    return MatArray.char_from_str("\n".join(s.rjust(w) for s in rows)) if len(rows) > 1 \
        else MatArray.char_from_str(rows[0])


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


@builtin("mat2str", category="strings", min_in=1, max_in=2)
def m_mat2str(x, prec=None):
    h = x.host()
    p = scalar_int(prec, "precision") if prec is not None else 15

    def fmt(v):
        if isinstance(v, (np.bool_, bool)):
            return "true" if v else "false"
        if np.iscomplexobj(np.asarray(v)):
            c = complex(v)
            op = "+" if c.imag >= 0 else "-"
            return f"{c.real:.{p}g}{op}{abs(c.imag):.{p}g}i"
        return f"{float(v):.{p}g}"  # p significant digits (MATLAB %.{p}g)

    if h.size == 1:
        return MatArray.char_from_str(fmt(h.reshape(-1)[0]))
    rows = []
    for i in range(h.shape[0]):
        rows.append(" ".join(fmt(v) for v in h[i]))
    return MatArray.char_from_str("[" + ";".join(rows) + "]")


@builtin("genvarname", category="strings", min_in=1, max_in=2)
def m_genvarname(s, exclusions=None):
    taken = set(_texts_of(exclusions)) if exclusions is not None else set()

    def make(t: str) -> str:
        v = re.sub(r"[^A-Za-z0-9_]", "", re.sub(r"\s+(.)", lambda m: m.group(1).upper(), t))
        if not v or not (v[0].isalpha()):
            v = "x" + v
        base, k = v, 1
        while v in taken:
            v = f"{base}{k}"
            k += 1
        taken.add(v)
        return v

    if isinstance(s, (StringArray, CellArray)) and getattr(s, "size", 1) > 1:
        return _map_text(s, make)
    return MatArray.char_from_str(make(text_of(s)))


_STRPROP = {
    "alpha": str.isalpha, "digit": str.isdigit, "alphanum": str.isalnum,
    "upper": str.isupper, "lower": str.islower, "wspace": str.isspace,
    "punct": lambda c: not c.isalnum() and not c.isspace() and c.isprintable(),
    "xdigit": lambda c: c in "0123456789abcdefABCDEF",
    "cntrl": lambda c: not c.isprintable() and not c.isspace() or c in "\t\n\r\f\v",
    "print": str.isprintable, "graphic": lambda c: c.isprintable() and not c.isspace(),
}


@builtin("isstrprop", category="strings", min_in=2, max_in=2)
def m_isstrprop(s, prop):
    p = text_of(prop).lower()
    fn = _STRPROP.get(p)
    if fn is None:
        raise bad_arg("isstrprop", f"Unknown property '{p}'.")
    t = text_of(s)
    return MatArray(np.array([[fn(c) for c in t]], dtype=bool) if t else
                    np.zeros((0, 0), dtype=bool), "logical")


@builtin("strtok", category="strings", min_in=1, max_in=2, pass_nargout=True)
def m_strtok(s, delims=None, nargout=1):
    t = text_of(s)
    d = text_of(delims) if delims is not None else " \t\n"
    i = 0
    while i < len(t) and t[i] in d:
        i += 1
    j = i
    while j < len(t) and t[j] not in d:
        j += 1
    tok = t[i:j]
    rem = t[j:]
    mk = StringArray.scalar if isinstance(s, StringArray) else MatArray.char_from_str
    if nargout <= 1:
        return mk(tok)
    return [mk(tok), mk(rem)]


@builtin("sscanf", category="strings", min_in=2, max_in=3, pass_nargout=True)
def m_sscanf(s, fmt, size=None, nargout=1):
    t = text_of(s)
    f = text_of(fmt)
    # Collect conversions across repeated applications of the format.
    specs = re.findall(r"%(?:\d+)?(?:\.\d+)?([dioux]|[eEfgG]|s|c)", f)
    if not specs:
        raise bad_arg("sscanf", "Format must contain a conversion.")
    num_rx = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|[+-]?(?:Inf|NaN)"
    vals: list[float] = []
    chars = all(c == "c" or c == "s" for c in specs)
    if chars:
        return MatArray.char_from_str(t)
    for m in re.finditer(num_rx, t):
        vals.append(float(m.group(0)))
    arr = np.array(vals, dtype=np.float64).reshape(-1, 1)
    if size is not None and not is_text(size):
        hs = size.host().astype(np.float64).reshape(-1)
        if hs.size == 1:
            arr = arr[:int(hs[0])]
        else:
            r, c = int(hs[0]), int(hs[1]) if np.isfinite(hs[1]) else -1
            total = arr.size if c < 0 else r * c
            arr = arr[:total].reshape((r, -1), order="F")
    out = MatArray(arr, "double")
    if nargout <= 1:
        return out
    return [out, MatArray.scalar(float(arr.size))]


@builtin("native2unicode", category="strings", min_in=1, max_in=2)
def m_native2unicode(b, enc=None):
    h = b.host().astype(np.uint8).reshape(-1, order="F")
    e = text_of(enc) if enc is not None else "utf-8"
    return MatArray.char_from_str(bytes(h.tolist()).decode(e, errors="replace"))


@builtin("unicode2native", category="strings", min_in=1, max_in=2)
def m_unicode2native(s, enc=None):
    e = text_of(enc) if enc is not None else "utf-8"
    bs = text_of(s).encode(e, errors="replace")
    return MatArray(np.frombuffer(bs, dtype=np.uint8).astype(np.uint8).reshape(1, -1),
                    "uint8")


@builtin("compose", category="strings", min_in=1)
def m_compose(fmt, *args):
    """compose(fmt, A...): sprintf per row of the array arguments, returning a
    string array."""
    from .strings import m_sprintf
    f = text_of(fmt)
    if not args:
        return StringArray.scalar(m_sprintf(MatArray.char_from_str(f)).to_str())
    n_rows = max(a.shape[0] if isinstance(a, MatArray) else 1 for a in args)
    out = np.empty((n_rows, 1), dtype=object)
    for r in range(n_rows):
        row_args = []
        for a in args:
            h = a.host()
            row = h[min(r, h.shape[0] - 1), :]
            row_args.append(MatArray(row.reshape(1, -1), a.mclass))
        out[r, 0] = m_sprintf(MatArray.char_from_str(f), *row_args).to_str()
    return StringArray(out)


# ------------------------------------------------------------------ transform #

@builtin("append", category="strings/transform", min_in=1)
def m_append(*args):
    """append(s1, s2, ...): elementwise text concatenation (no trailing-space
    stripping, unlike strcat)."""
    shapes = [a.shape for a in args if isinstance(a, (StringArray, CellArray))
              and a.size != 1]
    shape = shapes[0] if shapes else (1, 1)
    n = int(np.prod(shape))
    parts = []
    for a in args:
        ts = _texts_of(a)
        parts.append(ts * n if len(ts) == 1 else ts)
    out = np.empty(shape, dtype=object)
    of = out.reshape(-1, order="F")
    for i in range(n):
        of[i] = "".join(p[i] for p in parts)
    if any(isinstance(a, StringArray) for a in args):
        return StringArray(out) if n > 1 else StringArray.scalar(of[0])
    if n == 1:
        return MatArray.char_from_str(of[0])
    return StringArray(out)


@builtin("replace", category="strings/transform", min_in=3, max_in=3)
def m_replace(s, old, new):
    olds = _texts_of(old) if isinstance(old, (StringArray, CellArray)) else [text_of(old)]
    news = _texts_of(new) if isinstance(new, (StringArray, CellArray)) else [text_of(new)]
    if len(news) == 1:
        news = news * len(olds)
    rxs = [_as_regex(StringArray.scalar(o)) if not o.startswith(_PAT_PREFIX)
           else o[len(_PAT_PREFIX):] for o in olds]

    def rep(t: str) -> str:
        for rx, nw in zip(rxs, news):
            t = re.sub(rx, nw.replace("\\", "\\\\"), t)
        return t

    if isinstance(s, StringArray) or isinstance(s, CellArray):
        return _map_text(s, rep)
    return MatArray.char_from_str(rep(text_of(s)))


@builtin("matches", category="strings/transform", min_in=2, max_in=3)
def m_matches(s, pat, *opts):
    rx = _as_regex(pat)
    flags = 0
    if opts and is_text(opts[0]) and text_of(opts[0]) == "IgnoreCase":
        flags = re.IGNORECASE
    texts = _texts_of(s)
    mask = np.array([re.fullmatch(rx, t, flags) is not None for t in texts], dtype=bool)
    shape = s.shape if isinstance(s, (StringArray, CellArray)) else (1, 1)
    return MatArray(mask.reshape(shape, order="F"), "logical")


@builtin("replaceBetween", category="strings/transform", min_in=4, max_in=4)
def m_replace_between(s, a, b, new):
    nw = text_of(new)

    def rep(t: str) -> str:
        if is_text(a) and is_text(b):
            sa, sb = text_of(a), text_of(b)
            i = t.find(sa)
            if i < 0:
                return t
            j = t.find(sb, i + len(sa))
            if j < 0:
                return t
            return t[:i + len(sa)] + nw + t[j:]
        lo = scalar_int(a, "start") - 1
        hi = scalar_int(b, "end")
        return t[:lo] + nw + t[hi:]

    if isinstance(s, (StringArray, CellArray)):
        return _map_text(s, rep)
    return MatArray.char_from_str(rep(text_of(s)))


@builtin("eraseBetween", category="strings/transform", min_in=3, max_in=3)
def m_erase_between(s, a, b):
    def rep(t: str) -> str:
        if is_text(a) and is_text(b):
            sa, sb = text_of(a), text_of(b)
            i = t.find(sa)
            if i < 0:
                return t
            j = t.find(sb, i + len(sa))
            if j < 0:
                return t
            return t[:i + len(sa)] + t[j:]
        lo = scalar_int(a, "start") - 1
        hi = scalar_int(b, "end")
        return t[:lo] + t[hi:]

    if isinstance(s, (StringArray, CellArray)):
        return _map_text(s, rep)
    return MatArray.char_from_str(rep(text_of(s)))


@builtin("erasePunctuation", category="strings/transform", min_in=1, max_in=1)
def m_erase_punctuation(s):
    return _map_text(s, lambda t: "".join(
        c for c in t if c.isalnum() or c.isspace() or c == "_"))


@builtin("eraseURLs", category="strings/transform", min_in=1, max_in=1)
def m_erase_urls(s):
    rx = re.compile(r"https?://\S+|www\.\S+")
    return _map_text(s, lambda t: rx.sub("", t))


@builtin("splitlines", category="strings/transform", min_in=1, max_in=1)
def m_splitlines(s):
    t = text_of(s) if not isinstance(s, StringArray) else (s.item() or "")
    lines = re.split(r"\r\n|\n|\r", t)
    out = np.array([[ln] for ln in lines], dtype=object)
    if isinstance(s, StringArray):
        return StringArray(out)
    data = np.empty((len(lines), 1), dtype=object)
    for i, ln in enumerate(lines):
        data[i, 0] = MatArray.char_from_str(ln)
    return CellArray(data)


@builtin("strip", category="strings/transform", min_in=1, max_in=3)
def m_strip(s, side=None, ch=None):
    sd = "both"
    c = None
    if side is not None:
        if is_text(side) and text_of(side).lower() in ("left", "right", "both"):
            sd = text_of(side).lower()
            if ch is not None:
                c = text_of(ch)
        else:
            c = text_of(side)
    if c is None:
        c = " "

    def do(t: str) -> str:
        if sd == "left":
            return t.lstrip(c)
        if sd == "right":
            return t.rstrip(c)
        return t.strip(c)

    return _map_text(s, do)


@builtin("strjust", category="strings/transform", min_in=1, max_in=2)
def m_strjust(s, side=None):
    sd = text_of(side).lower() if side is not None else "right"

    def do(t: str) -> str:
        w = len(t)
        core = t.strip()
        if sd == "left":
            return core.ljust(w)
        if sd == "center":
            return core.center(w)
        return core.rjust(w)

    return _map_text(s, do)
