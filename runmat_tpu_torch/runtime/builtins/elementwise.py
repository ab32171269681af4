"""Copy of runmat_tpu/runtime/builtins/elementwise.py in the PyTorch port.

Elementwise math builtins (trigonometry, exp/log, rounding, complex parts).

Reference parity: runmat-runtime/src/builtins/math/{trigonometry,elementwise,
rounding}/ — each registered with a GPU spec + fusion spec; here the accel_op
metadata points at the shared op table (ops/table.py) which the accel engine
traces into fused jax computations.
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import MatArray
from ..dispatch import binary, unary
from ..registry import builtin

_UNARY_BUILTINS = [
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "exp", "log", "log2", "log10", "log1p",
    "expm1", "sqrt", "abs", "sign", "floor", "ceil", "fix",
    "real", "imag", "conj", "angle", "isnan", "isinf", "isfinite", "erf",
    "gamma",
]

for _name in _UNARY_BUILTINS:
    def _mk(op):
        @builtin(op, category="math/elementwise", min_in=1, max_in=1, accel_op=op)
        def _f(x, _op=op):
            return unary(_op, x)
        return _f
    _mk(_name)


@builtin("round", category="math/elementwise", min_in=1, max_in=3,
         accel_op="round")
def m_round(x, n=None, kind=None):
    """round(X) half-away-from-zero; round(X, N) to N decimal digits
    (negative N rounds left of the decimal point) — the scaled form rides
    the same elementwise device ops so gpuArrays stay resident.
    round(X, N, 'significant') rounds to N significant digits (doc:
    N must be positive; the scale is per-element 10^(N-1-floor(log10|x|)))."""
    if n is None:
        return unary("round", x)
    digits = int(n.scalar_double())
    if kind is not None:
        k = kind.to_str().lower() if hasattr(kind, "to_str") else str(kind)
        if k == "decimals":
            pass
        elif k == "significant":
            if digits <= 0:
                raise bad_arg("round", "N must be positive for 'significant'")
            h = np.asarray(x.host(), dtype=np.float64)
            with np.errstate(all="ignore"):
                mag = np.floor(np.log10(np.abs(h)))
            mag = np.where(np.isfinite(mag), mag, 0.0)
            scale = np.power(10.0, digits - 1 - mag)
            r = np.trunc(h * scale + np.where(h >= 0, 0.5, -0.5)) / scale
            r = np.where(np.isfinite(h), r, h)
            out_class = "single" if x.mclass == "single" else "double"
            from ... import dtypes as _dt
            return MatArray(_dt.cast_to_class(r, out_class), out_class)
        else:
            raise bad_arg("round", f"unknown rounding type '{k}'")
    scale = MatArray.scalar(10.0 ** digits)
    return binary("div", unary("round", binary("mul", x, scale)), scale)


@builtin("not", category="logical", min_in=1, max_in=1, accel_op="logical_not")
def m_not(x):
    return unary("logical_not", x)


@builtin("mod", category="math/elementwise", min_in=2, max_in=2, accel_op="mod")
def m_mod(a, b):
    return binary("mod", a, b)


@builtin("rem", category="math/elementwise", min_in=2, max_in=2, accel_op="rem")
def m_rem(a, b):
    return binary("rem", a, b)


@builtin("atan2", category="math/trigonometry", min_in=2, max_in=2, accel_op="atan2")
def m_atan2(a, b):
    return binary("atan2", a, b)


@builtin("hypot", category="math/elementwise", min_in=2, max_in=2, accel_op="hypot")
def m_hypot(a, b):
    return binary("hypot", a, b)


@builtin("power", category="math/elementwise", min_in=2, max_in=2, accel_op="pow")
def m_power(a, b):
    return binary("pow", a, b)


@builtin("plus", category="math/elementwise", min_in=2, max_in=2, accel_op="add")
def m_plus(a, b):
    return binary("add", a, b)


@builtin("minus", category="math/elementwise", min_in=2, max_in=2, accel_op="sub")
def m_minus(a, b):
    return binary("sub", a, b)


@builtin("times", category="math/elementwise", min_in=2, max_in=2, accel_op="mul")
def m_times(a, b):
    return binary("mul", a, b)


@builtin("rdivide", category="math/elementwise", min_in=2, max_in=2, accel_op="div")
def m_rdivide(a, b):
    return binary("div", a, b)


@builtin("ldivide", category="math/elementwise", min_in=2, max_in=2, accel_op="ldiv")
def m_ldivide(a, b):
    return binary("ldiv", a, b)


@builtin("uminus", category="math/elementwise", min_in=1, max_in=1, accel_op="neg")
def m_uminus(x):
    return unary("neg", x)


@builtin("uplus", category="math/elementwise", min_in=1, max_in=1)
def m_uplus(x):
    return unary("uplus", x)


@builtin("mtimes", category="math/linalg", min_in=2, max_in=2, accel_op="matmul")
def m_mtimes(a, b):
    from ..dispatch import mtimes
    return mtimes(a, b)


@builtin("mldivide", category="math/linalg", min_in=2, max_in=2)
def m_mldivide(a, b):
    from ..dispatch import mldivide
    return mldivide(a, b)


@builtin("mrdivide", category="math/linalg", min_in=2, max_in=2)
def m_mrdivide(a, b):
    from ..dispatch import mrdivide
    return mrdivide(a, b)


@builtin("sec", category="math/trigonometry", min_in=1, max_in=1)
def m_sec(x):
    return binary("div", MatArray.scalar(1.0), unary("cos", x))


@builtin("csc", category="math/trigonometry", min_in=1, max_in=1)
def m_csc(x):
    return binary("div", MatArray.scalar(1.0), unary("sin", x))


@builtin("cot", category="math/trigonometry", min_in=1, max_in=1)
def m_cot(x):
    return binary("div", MatArray.scalar(1.0), unary("tan", x))


@builtin("sind", category="math/trigonometry", min_in=1, max_in=1)
def m_sind(x):
    return unary("sin", binary("mul", x, MatArray.scalar(np.pi / 180.0)))


@builtin("cosd", category="math/trigonometry", min_in=1, max_in=1)
def m_cosd(x):
    return unary("cos", binary("mul", x, MatArray.scalar(np.pi / 180.0)))


@builtin("tand", category="math/trigonometry", min_in=1, max_in=1)
def m_tand(x):
    return unary("tan", binary("mul", x, MatArray.scalar(np.pi / 180.0)))


@builtin("deg2rad", category="math/elementwise", min_in=1, max_in=1)
def m_deg2rad(x):
    return binary("mul", x, MatArray.scalar(np.pi / 180.0))


@builtin("rad2deg", category="math/elementwise", min_in=1, max_in=1)
def m_rad2deg(x):
    return binary("mul", x, MatArray.scalar(180.0 / np.pi))


@builtin("factorial", category="math/elementwise", min_in=1, max_in=1)
def m_factorial(x):
    h = x.host().astype(np.float64)
    if np.any(h < 0) or np.any(h != np.floor(h)):
        raise bad_arg("factorial", "N must contain non-negative integers.")
    from math import gamma as _g
    vals = np.vectorize(lambda v: _g(v + 1.0) if v < 171 else np.inf,
                        otypes=[np.float64])(h)
    from ... import dtypes
    out_class = x.mclass if x.mclass in ("double", "single") else "double"
    return MatArray(dtypes.cast_to_class(vals, out_class), out_class)


@builtin("nthroot", category="math/elementwise", min_in=2, max_in=2)
def m_nthroot(x, n):
    hx = x.host().astype(np.float64)
    hn = n.host().astype(np.float64)
    hx, hn = np.broadcast_arrays(hx, hn)
    r = np.sign(hx) * np.abs(hx) ** (1.0 / hn)
    out_class = "single" if "single" in (x.mclass, n.mclass) else "double"
    from ... import dtypes
    return MatArray(dtypes.cast_to_class(r, out_class), out_class)


@builtin("exp2", category="math/elementwise", min_in=1, max_in=1)
def m_exp2(x):
    return binary("pow", MatArray.scalar(2.0), x)
