"""Copy of runmat_tpu/runtime/builtins/breadth2.py in the PyTorch port.

Breadth batch 2: string fns, number bases, special functions,
containers.Map, matrix functions, misc introspection/io.

Reference parity: assorted runmat-runtime builtin families (strings,
introspection, math/discrete, containers, io)."""

from __future__ import annotations

import math
import re

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, is_text, normalize_shape, text_of)
from ..registry import builtin, register_alias


def _np(v):
    return v.host().astype(np.float64)


def _sc(v):
    return float(_np(v).reshape(-1)[0])


def _text_result(template, s: str):
    """Return str result with the same text type as the input."""
    if isinstance(template, StringArray):
        return StringArray.scalar(s)
    return MatArray.char_from_str(s)


# ------------------------------------------------------------------ strings - #


@builtin("regexpi", category="strings", min_in=2, max_in=3, pass_nargout=True)
def m_regexpi(s, pat, mode=None, nargout=1):
    return _regexpi_fallback(s, pat, mode, nargout)


def _regexpi_fallback(s, pat, mode, nargout):
    txt = text_of(s)
    p = re.compile(text_of(pat), re.IGNORECASE)
    kind = text_of(mode) if mode is not None else "start"
    if kind == "match":
        ms = p.findall(txt)
        data = np.empty((1, len(ms)), dtype=object)
        for i, m in enumerate(ms):
            data[0, i] = MatArray.char_from_str(m if isinstance(m, str) else m[0])
        return CellArray(data)
    if kind == "once":
        m = p.search(txt)
        return MatArray.char_from_str(m.group(0) if m else "")
    starts = [m.start() + 1 for m in p.finditer(txt)]
    return MatArray(np.array(starts, np.float64).reshape(1, -1), "double")


@builtin("erase", category="strings", min_in=2, max_in=2)
def m_erase(s, sub):
    return _text_result(s, text_of(s).replace(text_of(sub), ""))


@builtin("insertAfter", category="strings", min_in=3, max_in=3)
def m_insertafter(s, where, what):
    txt = text_of(s)
    w = text_of(where)
    return _text_result(s, txt.replace(w, w + text_of(what), 1))


@builtin("insertBefore", category="strings", min_in=3, max_in=3)
def m_insertbefore(s, where, what):
    txt = text_of(s)
    w = text_of(where)
    return _text_result(s, txt.replace(w, text_of(what) + w, 1))


@builtin("extractBetween", category="strings", min_in=3, max_in=3)
def m_extractbetween(s, a, b):
    txt = text_of(s)
    pa, pb = text_of(a), text_of(b)
    out = []
    pos = 0
    while True:
        i = txt.find(pa, pos)
        if i < 0:
            break
        j = txt.find(pb, i + len(pa))
        if j < 0:
            break
        out.append(txt[i + len(pa):j])
        pos = j + len(pb)
    data = np.empty((len(out), 1), dtype=object)
    for i, t in enumerate(out):
        data[i, 0] = t
    return StringArray(data)


@builtin("extractAfter", category="strings", min_in=2, max_in=2)
def m_extractafter(s, where):
    txt = text_of(s)
    w = text_of(where)
    i = txt.find(w)
    return _text_result(s, txt[i + len(w):] if i >= 0 else "")


@builtin("extractBefore", category="strings", min_in=2, max_in=2)
def m_extractbefore(s, where):
    txt = text_of(s)
    i = txt.find(text_of(where))
    return _text_result(s, txt[:i] if i >= 0 else "")


@builtin("split", category="strings", min_in=1, max_in=2)
def m_split(s, delim=None):
    txt = text_of(s)
    parts = txt.split(text_of(delim)) if delim is not None else txt.split()
    data = np.empty((len(parts), 1), dtype=object)
    for i, p in enumerate(parts):
        data[i, 0] = p
    return StringArray(data)


@builtin("join", category="strings", min_in=1, max_in=2)
def m_join(arr, delim=None):
    d = text_of(delim) if delim is not None else " "
    if isinstance(arr, StringArray):
        parts = [x or "" for x in arr.data.reshape(-1, order="F")]
    elif isinstance(arr, CellArray):
        parts = [text_of(x) for x in arr.data.reshape(-1, order="F")]
    else:
        raise bad_arg("join", "Expected a string or cell array.")
    return StringArray.scalar(d.join(parts))


# (startsWith/endsWith live in strings.py with the IgnoreCase option)


@builtin("count", category="strings", min_in=2, max_in=2)
def m_count(s, sub):
    return MatArray.scalar(float(text_of(s).count(text_of(sub))))


@builtin("reverse", category="strings", min_in=1, max_in=1)
def m_reverse(s):
    return _text_result(s, text_of(s)[::-1])


# --------------------------------------------------------------- num bases --- #


@builtin("dec2bin", category="conversion", min_in=1, max_in=2)
def m_dec2bin(x, n=None):
    v = int(_sc(x))
    w = int(_sc(n)) if n is not None else 0
    return MatArray.char_from_str(format(v, f"0{w}b") if w else format(v, "b"))


@builtin("bin2dec", category="conversion", min_in=1, max_in=1)
def m_bin2dec(s):
    return MatArray.scalar(float(int(text_of(s), 2)))


@builtin("dec2hex", category="conversion", min_in=1, max_in=2)
def m_dec2hex(x, n=None):
    v = int(_sc(x))
    w = int(_sc(n)) if n is not None else 0
    return MatArray.char_from_str(format(v, f"0{w}X") if w else format(v, "X"))


@builtin("hex2dec", category="conversion", min_in=1, max_in=1)
def m_hex2dec(s):
    return MatArray.scalar(float(int(text_of(s), 16)))


@builtin("dec2base", category="conversion", min_in=2, max_in=2)
def m_dec2base(x, b):
    v = int(_sc(x))
    base = int(_sc(b))
    if not (2 <= base <= 36):
        raise MatError("MATLAB:dec2base:InvalidBase",
                       "Base must be an integer between 2 and 36.")
    if v < 0:
        raise MatError("MATLAB:dec2base:MustBeNonNegative",
                       "Input must be a nonnegative integer.")
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    if v == 0:
        return MatArray.char_from_str("0")
    out = ""
    while v:
        out = digits[v % base] + out
        v //= base
    return MatArray.char_from_str(out)


@builtin("base2dec", category="conversion", min_in=2, max_in=2)
def m_base2dec(s, b):
    return MatArray.scalar(float(int(text_of(s), int(_sc(b)))))


@builtin("idivide", category="math/elementwise", min_in=2, max_in=3)
def m_idivide(a, b, mode=None):
    from ... import dtypes
    ha = a.host().astype(np.float64)
    hb = b.host().astype(np.float64)
    m = text_of(mode) if mode is not None else "fix"
    q = ha / hb
    if m == "fix":
        r = np.trunc(q)
    elif m == "floor":
        r = np.floor(q)
    elif m == "ceil":
        r = np.ceil(q)
    else:
        r = np.round(q)
    oc = a.mclass if a.mclass.startswith(("int", "uint")) else b.mclass
    return MatArray(dtypes.saturate_cast(r, oc), oc)


@builtin("typecast", category="conversion", min_in=2, max_in=2)
def m_typecast(x, cls):
    from ... import dtypes
    c = text_of(cls)
    h = np.ascontiguousarray(x.host())
    out = h.view(dtypes.np_dtype(c)).reshape(1, -1)
    return MatArray(out.copy(), c)


@builtin("swapbytes", category="conversion", min_in=1, max_in=1)
def m_swapbytes(x):
    h = x.host()
    return MatArray(h.byteswap(), x.mclass)


# ----------------------------------------------------------- special functions #


@builtin("erfc", category="math/elementwise", min_in=1, max_in=1)
def m_erfc(x):
    from scipy import special
    return MatArray(special.erfc(_np(x)), "double")


@builtin("erfinv", category="math/elementwise", min_in=1, max_in=1)
def m_erfinv(x):
    from scipy import special
    return MatArray(special.erfinv(_np(x)), "double")


@builtin("erfcinv", category="math/elementwise", min_in=1, max_in=1)
def m_erfcinv(x):
    from scipy import special
    return MatArray(special.erfcinv(_np(x)), "double")


@builtin("gammaln", category="math/elementwise", min_in=1, max_in=1)
def m_gammaln(x):
    from scipy import special
    return MatArray(special.gammaln(_np(x)), "double")


@builtin("beta", category="math/elementwise", min_in=2, max_in=2)
def m_beta(a, b):
    from scipy import special
    return MatArray(special.beta(_np(a), _np(b)), "double")


@builtin("betainc", category="math/elementwise", min_in=3, max_in=3)
def m_betainc(x, a, b):
    from scipy import special
    return MatArray(special.betainc(_np(a), _np(b), _np(x)), "double")


@builtin("besselj", category="math/elementwise", min_in=2, max_in=2)
def m_besselj(nu, x):
    from scipy import special
    return MatArray(special.jv(_np(nu), _np(x)), "double")


@builtin("bessely", category="math/elementwise", min_in=2, max_in=2)
def m_bessely(nu, x):
    from scipy import special
    return MatArray(special.yv(_np(nu), _np(x)), "double")


@builtin("nchoosek", category="math/discrete", min_in=2, max_in=2)
def m_nchoosek(n, k):
    return MatArray.scalar(float(math.comb(int(_sc(n)), int(_sc(k)))))


@builtin("perms", category="math/discrete", min_in=1, max_in=1)
def m_perms(v):
    import itertools
    vals = _np(v).reshape(-1)
    if vals.size > 10:
        # matches MATLAB's practical bound (n! rows exhaust memory; MATLAB
        # errors with a maximum-variable-size failure)
        raise MatError("MATLAB:pmaxsize",
                       "Too many permutations: input must have 10 or fewer "
                       "elements.")
    rows = list(itertools.permutations(vals))[::-1]
    return MatArray(np.array(rows, np.float64), "double")


@builtin("fibonacci", category="math/discrete", min_in=1, max_in=1)
def m_fibonacci(n):
    """fibonacci(n): nth Fibonacci number (elementwise over arrays)."""
    h = _np(n)
    out = np.empty(h.shape, dtype=np.float64)
    flat_in = h.reshape(-1)
    flat = out.reshape(-1)
    for i, v in enumerate(flat_in):
        k = int(v)
        if k < 0:
            raise MatError("MATLAB:fibonacci:negative",
                           "Input must be nonnegative.")
        a, b = 0, 1
        for _ in range(k):
            a, b = b, a + b
        flat[i] = float(a)
    return MatArray(out, "double")


@builtin("primes", category="math/discrete", min_in=1, max_in=1)
def m_primes(n):
    nn = int(_sc(n))
    sieve = np.ones(max(nn + 1, 2), dtype=bool)
    sieve[:2] = False
    for p in range(2, int(nn ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return MatArray(np.nonzero(sieve)[0].astype(np.float64).reshape(1, -1),
                    "double")


@builtin("isprime", category="math/discrete", min_in=1, max_in=1)
def m_isprime(x):
    h = _np(x).astype(np.int64)
    def chk(v):
        if v < 2:
            return False
        for p in range(2, int(v ** 0.5) + 1):
            if v % p == 0:
                return False
        return True
    out = np.vectorize(chk)(h)
    return MatArray(out.astype(np.bool_), "logical")


@builtin("gcd", category="math/discrete", min_in=2, max_in=2)
def m_gcd(a, b):
    return MatArray(np.gcd(_np(a).astype(np.int64),
                           _np(b).astype(np.int64)).astype(np.float64), "double")


@builtin("lcm", category="math/discrete", min_in=2, max_in=2)
def m_lcm(a, b):
    return MatArray(np.lcm(_np(a).astype(np.int64),
                           _np(b).astype(np.int64)).astype(np.float64), "double")


@builtin("skewness", category="stats", min_in=1, max_in=1)
def m_skewness(x):
    h = _np(x).reshape(-1)
    m = h.mean()
    s = h.std()
    return MatArray.scalar(float(np.mean((h - m) ** 3) / (s ** 3 or 1)))


@builtin("kurtosis", category="stats", min_in=1, max_in=1)
def m_kurtosis(x):
    h = _np(x).reshape(-1)
    m = h.mean()
    s = h.std()
    return MatArray.scalar(float(np.mean((h - m) ** 4) / (s ** 4 or 1)))


# --------------------------------------------------------- matrix functions --- #


@builtin("logm", category="math/linalg", min_in=1, max_in=1)
def m_logm(x):
    from scipy.linalg import logm as _logm
    r = _logm(x.host().astype(np.float64))
    if np.allclose(r.imag, 0):
        r = r.real
    return MatArray(np.asarray(r), "double")


@builtin("sqrtm", category="math/linalg", min_in=1, max_in=1)
def m_sqrtm(x):
    from scipy.linalg import sqrtm as _sqrtm
    r = np.asarray(_sqrtm(x.host().astype(np.float64)))
    if np.allclose(r.imag, 0):
        r = r.real
    return MatArray(r, "double")


@builtin("gradient", category="math/elementwise", min_in=1, max_in=2,
         pass_nargout=True)
def m_gradient(f, h=None, nargout=1):
    hf = _np(f)
    dx = _sc(h) if h is not None else 1.0
    if 1 in hf.shape or hf.ndim == 1:
        g = np.gradient(hf.reshape(-1), dx)
        return MatArray(g.reshape(hf.shape), "double")
    gy, gx = np.gradient(hf, dx)
    res = [MatArray(gx, "double"), MatArray(gy, "double")]
    return res[:max(1, nargout)]


@builtin("del2", category="math/elementwise", min_in=1, max_in=1)
def m_del2(f):
    h = _np(f)
    if 1 in h.shape:
        v = h.reshape(-1)
        out = np.zeros_like(v)
        out[1:-1] = (v[:-2] - 2 * v[1:-1] + v[2:]) / 4
        out[0] = out[1] if v.size > 1 else 0
        out[-1] = out[-2] if v.size > 1 else 0
        return MatArray(out.reshape(h.shape), "double")
    out = np.zeros_like(h)
    out[1:-1, 1:-1] = (h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2]
                       + h[1:-1, 2:] - 4 * h[1:-1, 1:-1]) / 4
    return MatArray(out, "double")


# ------------------------------------------------------------ containers.Map - #


class MapValue:
    __slots__ = ("store", "shared")
    mclass = "containers.Map"

    def __init__(self, store=None):
        self.store = dict(store or {})
        self.shared = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self        # Map is a handle class in MATLAB

    # dot-method / property protocol (≙ containers.Map.keys/values/isKey/
    # remove dotted builtins in the reference)
    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "keys":
            return [m_keys(self)]
        if fname == "values":
            return [m_values(self, *args)]
        if fname == "isKey":
            return [m_iskey(self, args[0])]
        if fname == "remove":
            return [m_remove(self, args[0])]
        if fname == "length":
            return [MatArray.scalar(float(len(self.store)))]
        return NotImplemented

    def _mat_get_field_(self, fname):
        if fname == "Count":
            return MatArray.scalar(float(len(self.store)))
        if fname == "KeyType":
            return MatArray.char_from_str("char")
        if fname == "ValueType":
            return MatArray.char_from_str("any")
        return NotImplemented


def _map_ctor(*args):
    m = MapValue()
    if len(args) >= 2:
        keys, vals = args[0], args[1]
        if isinstance(keys, CellArray):
            ks = [text_of(k) for k in keys.data.reshape(-1, order="F")]
            vs = list(vals.data.reshape(-1, order="F")) if \
                isinstance(vals, CellArray) else \
                [MatArray.scalar(float(x)) for x in vals.host().reshape(-1)]
            for k, v in zip(ks, vs):
                m.store[k] = v
        else:
            m.store[text_of(keys)] = vals
    return m


@builtin("containers_Map_ctor", category="containers", max_in=None)
def m_containers_map_ctor(*args):
    return _map_ctor(*args)


@builtin("containers", category="containers", max_in=0)
def m_containers():
    """The containers package namespace: containers.Map(...) resolves the Map
    field to the constructor handle."""
    return StructArray.scalar({
        "Map": FunctionHandle("named", name="containers_Map_ctor"),
    })


def _is_dict(v) -> bool:
    return getattr(v, "mclass", "") == "dictionary"


@builtin("keys", category="containers", min_in=1, max_in=1)
def m_keys(m):
    if _is_dict(m):
        return m._mat_call_method_(None, None, "keys", [], 1)[0]
    if not isinstance(m, MapValue):
        raise bad_arg("keys", "Expected a containers.Map.")
    ks = sorted(m.store)
    data = np.empty((1, max(len(ks), 0)), dtype=object)
    for i, k in enumerate(ks):
        data[0, i] = MatArray.char_from_str(k)
    return CellArray(data)


@builtin("values", category="containers", min_in=1, max_in=2)
def m_values(m, which=None):
    if _is_dict(m):
        return m._mat_call_method_(None, None, "values", [], 1)[0]
    if not isinstance(m, MapValue):
        raise bad_arg("values", "Expected a containers.Map.")
    if which is not None and isinstance(which, CellArray):
        ks = [text_of(k) for k in which.data.reshape(-1, order="F")]
    else:
        ks = sorted(m.store)
    data = np.empty((1, max(len(ks), 0)), dtype=object)
    for i, k in enumerate(ks):
        if k not in m.store:
            raise MatError("MATLAB:Containers:Map:NoKey",
                           f"The given key is not present: '{k}'.")
        data[0, i] = m.store[k]
    return CellArray(data)


@builtin("isKey", category="containers", min_in=2, max_in=2)
def m_iskey(m, k):
    if _is_dict(m):
        return m._mat_call_method_(None, None, "isKey", [k], 1)[0]
    return MatArray.logical_scalar(isinstance(m, MapValue)
                                   and text_of(k) in m.store)


@builtin("remove", category="containers", min_in=2, max_in=2)
def m_remove(m, k):
    if _is_dict(m):
        # dictionary has value semantics: remove returns a modified copy
        out = m.copy()
        out._mat_call_method_(None, None, "remove", [k], 1)
        return out
    if isinstance(m, MapValue):
        m.store.pop(text_of(k), None)
    return m


# ------------------------------------------------------------------- misc io - #


@builtin("which", category="introspection", min_in=1, max_in=1, pass_ctx=True)
def m_which(name, ctx=None):
    from ..registry import lookup
    nm = text_of(name)
    if ctx is not None and nm in ctx.session.functions:
        return MatArray.char_from_str(f"{nm} (user function)")
    if ctx is not None and nm in ctx.session.classes:
        return MatArray.char_from_str(f"{nm} (classdef)")
    b = lookup(nm)
    if b is not None:
        return MatArray.char_from_str(f"built-in ({nm})")
    return MatArray.char_from_str(f"'{nm}' not found.")


@builtin("narginchk", category="control", min_in=2, max_in=2, pass_ctx=True)
def m_narginchk(lo, hi, ctx=None):
    n = ctx.frame.nargin
    if n < _sc(lo):
        raise MatError("MATLAB:narginchk:notEnoughInputs",
                       "Not enough input arguments.")
    if n > _sc(hi):
        raise MatError("MATLAB:narginchk:tooManyInputs",
                       "Too many input arguments.")
    return None


register_alias("nargchk", "narginchk")


@builtin("evalc", category="control", min_in=1, max_in=1, pass_ctx=True)
def m_evalc(code, ctx=None):
    import io as _io
    sess = ctx.session
    buf = _io.StringIO()
    old = sess.stdout
    sess.stdout = buf
    try:
        ctx.interp.eval_source(text_of(code), ctx.frame)
    finally:
        sess.stdout = old
    return MatArray.char_from_str(buf.getvalue())


@builtin("lasterr", category="diagnostics", max_in=0, pass_ctx=True)
def m_lasterr(ctx=None):
    e = ctx.session.last_error
    return MatArray.char_from_str(e.message if e else "")


@builtin("mat2cell", category="cells", min_in=2, max_in=3)
def m_mat2cell(a, rdims, cdims=None):
    h = a.host()
    rr = _np(rdims).reshape(-1).astype(int)
    cc = _np(cdims).reshape(-1).astype(int) if cdims is not None else \
        np.array([h.shape[1]])
    out = np.empty((rr.size, cc.size), dtype=object)
    r0 = 0
    for i, r in enumerate(rr):
        c0 = 0
        for j, c in enumerate(cc):
            out[i, j] = MatArray(h[r0:r0 + r, c0:c0 + c].copy(), a.mclass)
            c0 += c
        r0 += r
    return CellArray(out)


@builtin("fftn", category="math/fft", min_in=1, max_in=1)
def m_fftn(x):
    h = x.host().astype(np.complex128)
    return MatArray(np.fft.fftn(h), "double")


@builtin("ifftn", category="math/fft", min_in=1, max_in=1)
def m_ifftn(x):
    h = x.host().astype(np.complex128)
    r = np.fft.ifftn(h)
    if np.allclose(r.imag, 0, atol=1e-12):
        r = r.real
    return MatArray(np.ascontiguousarray(r), "double")


@builtin("dct", category="math/fft", min_in=1, max_in=1)
def m_dct(x):
    from scipy.fft import dct as _dct
    return MatArray(_dct(_np(x).reshape(-1), norm="ortho")
                    .reshape(x.host().shape), "double")


@builtin("idct", category="math/fft", min_in=1, max_in=1)
def m_idct(x):
    from scipy.fft import idct as _idct
    return MatArray(_idct(_np(x).reshape(-1), norm="ortho")
                    .reshape(x.host().shape), "double")
