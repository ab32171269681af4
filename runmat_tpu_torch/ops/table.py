"""Copy of runmat_tpu/ops/table.py in the PyTorch port, with the device
table of the port's engine added at the end.

Elementwise operation table of the host (numpy) path.

Reference parity: the per-builtin BuiltinGpuSpec/BuiltinFusionSpec metadata
(e.g. runmat-runtime/src/builtins/math/trigonometry/sin.rs:23-38, 174-188) maps
each builtin to a provider hook + a WGSL expression template. Here one table maps
an op name to a function over an array namespace `xp`; in the port `xp` is
always numpy, so the JAX package's jax branches (`erf`, `gamma`) and its
`saturate_cast_device` are not copied. `TORCH_UNARY`/`TORCH_BINARY` below
are the same ops on torch tensors for `TorchEngine`.

MATLAB domain rules (sqrt(-1) -> i, log(-x) -> complex, etc.) are encoded as
`complex_when` predicates evaluated on *host* semantics before dispatch; the
device path receives the already-resolved output class.
"""

from __future__ import annotations

import numpy as np
import torch


def _xp_erf(xp, x):
    from math import erf
    return np.vectorize(erf, otypes=[np.float64])(x) if np.ndim(x) else erf(float(x))


# --- unary ops --------------------------------------------------------------- #
# name -> fn(xp, a)
UNARY = {
    "neg": lambda xp, a: xp.negative(a),
    "uplus": lambda xp, a: a,
    "abs": lambda xp, a: xp.abs(a),
    "sign": lambda xp, a: xp.sign(a),
    "sqrt": lambda xp, a: xp.sqrt(a),
    "exp": lambda xp, a: xp.exp(a),
    "expm1": lambda xp, a: xp.expm1(a),
    "log": lambda xp, a: xp.log(a),
    "log2": lambda xp, a: xp.log2(a),
    "log10": lambda xp, a: xp.log10(a),
    "log1p": lambda xp, a: xp.log1p(a),
    "sin": lambda xp, a: xp.sin(a),
    "cos": lambda xp, a: xp.cos(a),
    "tan": lambda xp, a: xp.tan(a),
    "asin": lambda xp, a: _matlab_asin(xp, a),
    "acos": lambda xp, a: _matlab_acos(xp, a),
    "atan": lambda xp, a: xp.arctan(a),
    "sinh": lambda xp, a: xp.sinh(a),
    "cosh": lambda xp, a: xp.cosh(a),
    "tanh": lambda xp, a: xp.tanh(a),
    "asinh": lambda xp, a: xp.arcsinh(a),
    "acosh": lambda xp, a: xp.arccosh(a),
    "atanh": lambda xp, a: xp.arctanh(a),
    "floor": lambda xp, a: xp.floor(a),
    "ceil": lambda xp, a: xp.ceil(a),
    "fix": lambda xp, a: xp.trunc(a),
    "round": lambda xp, a: xp.trunc(a + xp.where(a >= 0, 0.5, -0.5)),  # half away from zero
    "real": lambda xp, a: xp.real(a),
    "imag": lambda xp, a: xp.imag(a),
    "conj": lambda xp, a: xp.conj(a),
    "angle": lambda xp, a: xp.angle(a),
    "reciprocal": lambda xp, a: 1.0 / a,
    "square": lambda xp, a: a * a,
    "gamma": lambda xp, a: _gamma(xp, a),
    "erf": _xp_erf,
    "isnan": lambda xp, a: xp.isnan(a),
    "isinf": lambda xp, a: xp.isinf(a),
    "isfinite": lambda xp, a: xp.isfinite(a),
    "logical_not": lambda xp, a: xp.logical_not(a),
}


def _matlab_asin(xp, a):
    """MATLAB doc formula asin(z) = -i*log(i*z + sqrt(1-z^2)). Equals
    numpy's arcsin everywhere except ON the branch cut (real |x| > 1
    promoted to complex with +0 imag), where MATLAB's principal-sqrt
    composition gives asin(2) = pi/2 - 1.3170i vs numpy's +1.3170i."""
    import numpy as _np
    if _np.iscomplexobj(a):
        return -1j * xp.log(1j * a + xp.sqrt(1 - a * a))
    return xp.arcsin(a)


def _matlab_acos(xp, a):
    """MATLAB doc formula acos(z) = -i*log(z + i*sqrt(1-z^2));
    acos(2) = +1.3170i in MATLAB, -1.3170i in numpy (branch cut side)."""
    import numpy as _np
    if _np.iscomplexobj(a):
        return -1j * xp.log(a + 1j * xp.sqrt(1 - a * a))
    return xp.arccos(a)


def _matlab_pow(xp, a, b):
    """MATLAB power identities the underlying pow may miss (XLA's pow):
    x^0 is 1 for EVERY x including NaN/Inf; 1^y is 1 for every y. The
    repair applies ONLY where pow produced NaN — an unconditional
    where(a == 1, 1, r) would zero the autodiff gradient at a == 1
    (caught by test_dlarray.test_grad_square)."""
    r = xp.power(a, b)
    one = xp.asarray(1, dtype=r.dtype)
    bad = r != r                      # NaN (real or complex)
    return xp.where(bad & ((b == 0) | (a == 1)), one, r)


def _gamma(xp, a):
    from math import gamma as _g
    return np.vectorize(lambda v: _g(v) if v > 0 or v != np.floor(v) else np.inf,
                        otypes=[np.float64])(a)


# --- binary ops -------------------------------------------------------------- #
# name -> fn(xp, a, b)
BINARY = {
    "add": lambda xp, a, b: xp.add(a, b),
    "sub": lambda xp, a, b: xp.subtract(a, b),
    "mul": lambda xp, a, b: xp.multiply(a, b),
    "div": lambda xp, a, b: xp.divide(a, b),
    "ldiv": lambda xp, a, b: xp.divide(b, a),
    "pow": lambda xp, a, b: _matlab_pow(xp, a, b),
    "atan2": lambda xp, a, b: xp.arctan2(a, b),
    "hypot": lambda xp, a, b: xp.hypot(a, b),
    "mod": lambda xp, a, b: _matlab_mod(xp, a, b),
    "rem": lambda xp, a, b: _matlab_rem(xp, a, b),
    "min2": lambda xp, a, b: xp.fmin(a, b),   # NaN-ignoring, MATLAB min(a,b)
    "max2": lambda xp, a, b: xp.fmax(a, b),
    "and": lambda xp, a, b: xp.logical_and(a != 0, b != 0),
    "or": lambda xp, a, b: xp.logical_or(a != 0, b != 0),
    "xor": lambda xp, a, b: xp.logical_xor(a != 0, b != 0),
    "lt": lambda xp, a, b: xp.less(a, b),
    "le": lambda xp, a, b: xp.less_equal(a, b),
    "gt": lambda xp, a, b: xp.greater(a, b),
    "ge": lambda xp, a, b: xp.greater_equal(a, b),
    "eq": lambda xp, a, b: xp.equal(a, b),
    "ne": lambda xp, a, b: xp.not_equal(a, b),
}

COMPARE_OPS = {"lt", "le", "gt", "ge", "eq", "ne"}
LOGICAL_OPS = {"and", "or", "xor"}


def _matlab_mod(xp, a, b):
    # doc mod: mod(a, 0) = a; result takes the SIGN OF THE DIVISOR. With an
    # infinite divisor and finite a: mod(a, Inf) = a when signs agree (or
    # a == 0), otherwise ±Inf (the divisor); mod(Inf, m) stays NaN.
    r = a - xp.floor(a / b) * b
    r = xp.where(b == 0, a, r)
    inf_b = xp.isinf(b) & xp.isfinite(a)
    same = (a >= 0) == (b > 0)
    return xp.where(inf_b, xp.where((a == 0) | same, a, b), r)


def _matlab_rem(xp, a, b):
    # doc rem: rem(a, 0) = NaN (float classes); result takes the SIGN OF
    # THE DIVIDEND; rem(a, ±Inf) = a for finite a.
    r = a - xp.trunc(a / b) * b
    r = xp.where(b == 0, xp.full_like(r, float("nan")), r)
    inf_b = xp.isinf(b) & xp.isfinite(a)
    return xp.where(inf_b, a, r)


# Arithmetic ops that, on MATLAB integer classes, compute in wide float and
# saturate on the way back (mirrors dispatch._INT_SAFE_BINARY's host path).
INT_SAT_BINARY = {"add", "sub", "mul", "div", "ldiv", "pow", "mod", "rem",
                  "min2", "max2"}


# Unary ops whose real-domain violation promotes to complex in MATLAB.
COMPLEX_PROMOTING_UNARY = {
    "sqrt": lambda h: (h < 0).any(),
    "log": lambda h: (h < 0).any(),
    "log2": lambda h: (h < 0).any(),
    "log10": lambda h: (h < 0).any(),
    "log1p": lambda h: (h < -1).any(),
    "asin": lambda h: ((h < -1) | (h > 1)).any(),
    "acos": lambda h: ((h < -1) | (h > 1)).any(),
    "acosh": lambda h: (h < 1).any(),
    "atanh": lambda h: ((h < -1) | (h > 1)).any(),
}

# Unary ops valid for complex inputs.
COMPLEX_OK_UNARY = {
    "neg", "uplus", "abs", "sqrt", "exp", "log", "log2", "log10", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "real", "imag", "conj", "angle", "reciprocal", "square", "isnan",
    "isinf", "isfinite", "expm1", "log1p", "round", "floor", "ceil", "fix",
    "sign",
}


# --------------------------------------------------------------------------- #
# The device table: the same op names on torch tensors, for TorchEngine.
# torch names differ from numpy's (no `xp.power`, no `.astype`), so the
# entries are written against torch. Where torch's primitive differs from
# numpy's, the entry repairs it: `sign(NaN)` is NaN, `x^0` and `1^y` are 1
# even where pow gives NaN, `min2`/`max2` ignore NaN. Complex tensors take
# MATLAB's rules, as the host path (`runtime/dispatch.py`) applies them:
# `<`, `<=`, `>`, `>=` compare real parts (`==`/`~=` both parts),
# `min2`/`max2` pick by modulus and then by angle, `sign` is z/|z|,
# rounding acts on each part, `asin`/`acos` follow MATLAB's formulas on the
# branch cuts, and `abs`/`real`/`imag`/`angle` give real values.
# --------------------------------------------------------------------------- #


def _parts(f):
    """A real rounding op applied to each part of a complex tensor."""
    def g(a):
        if a.is_complex():
            return torch.complex(f(a.real), f(a.imag))
        return f(a)
    return g


def _torch_sign(a):
    if a.is_complex():
        return torch.sgn(a)
    return torch.where(torch.isnan(a), a, torch.sign(a))


def _torch_round(a):
    # half away from zero, written as the host table writes it
    return torch.trunc(a + torch.where(a >= 0, 0.5, -0.5).to(a.dtype))


def _torch_asin(a):
    if a.is_complex():
        return -1j * torch.log(1j * a + torch.sqrt(1 - a * a))
    return torch.asin(a)


def _torch_acos(a):
    if a.is_complex():
        return -1j * torch.log(a + 1j * torch.sqrt(1 - a * a))
    return torch.acos(a)


def _torch_real(a):
    return a.real.contiguous() if a.is_complex() else a


def _torch_imag(a):
    return a.imag.contiguous() if a.is_complex() else torch.zeros_like(a)


def _torch_angle(a):
    if a.is_complex():
        return torch.angle(a)
    return torch.atan2(torch.zeros_like(a), a)


def _torch_gamma(a):
    sign = torch.where((torch.remainder(a, 2) >= 1) & (a < 0), -1.0, 1.0)
    return torch.exp(torch.lgamma(a)) * sign.to(a.dtype)


TORCH_UNARY = {
    "neg": torch.neg,
    "uplus": lambda a: a,
    "abs": torch.abs,
    "sign": _torch_sign,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": _torch_asin,
    "acos": _torch_acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "floor": _parts(torch.floor),
    "ceil": _parts(torch.ceil),
    "fix": _parts(torch.trunc),
    "round": _parts(_torch_round),
    "real": _torch_real,
    "imag": _torch_imag,
    "conj": lambda a: torch.conj_physical(a) if a.is_complex() else a,
    "angle": _torch_angle,
    "reciprocal": lambda a: 1.0 / a,
    "square": lambda a: a * a,
    "gamma": _torch_gamma,
    "erf": torch.special.erf,
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
    "logical_not": torch.logical_not,
}


def _torch_pow(a, b):
    """MATLAB: x^0 is 1 for every x, 1^y is 1 for every y. The repair
    applies only where pow produced NaN."""
    r = torch.pow(a, b)
    return torch.where(torch.isnan(r) & ((b == 0) | (a == 1)),
                       torch.ones((), dtype=r.dtype, device=r.device), r)


def _torch_mod(a, b):
    # mod(a, 0) = a; the result takes the sign of the divisor; a finite a
    # over an infinite divisor is a when the signs agree (or a == 0), else b
    r = a - torch.floor(a / b) * b
    r = torch.where(b == 0, a, r)
    inf_b = torch.isinf(b) & torch.isfinite(a)
    same = (a >= 0) == (b > 0)
    return torch.where(inf_b, torch.where((a == 0) | same, a, b), r)


def _torch_rem(a, b):
    # rem(a, 0) = NaN; the result takes the sign of the dividend;
    # rem(a, +-Inf) = a for finite a
    r = a - torch.trunc(a / b) * b
    r = torch.where(b == 0, torch.full_like(r, float("nan")), r)
    inf_b = torch.isinf(b) & torch.isfinite(a)
    return torch.where(inf_b, a, r)


def _re(a):
    return a.real if a.is_complex() else a


def _minmax2(pick_b_over_a):
    """min2/max2: NaN-ignoring; complex by modulus, a tie by angle."""
    def f(a, b):
        if not (a.is_complex() or b.is_complex()):
            return (torch.fmax if pick_b_over_a is _gt else torch.fmin)(a, b)
        a, b = torch.broadcast_tensors(a, b)
        ma, mb = torch.abs(a), torch.abs(b)
        take_b = pick_b_over_a(mb, ma) | ((mb == ma) & pick_b_over_a(
            torch.angle(b), torch.angle(a)))
        take_b = (take_b & ~torch.isnan(b)) | torch.isnan(a)
        return torch.where(take_b, b, a)
    return f


def _gt(x, y):
    return x > y


def _lt(x, y):
    return x < y


TORCH_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "ldiv": lambda a, b: torch.div(b, a),
    "pow": _torch_pow,
    "atan2": torch.atan2,
    "hypot": torch.hypot,
    "mod": _torch_mod,
    "rem": _torch_rem,
    "min2": _minmax2(_lt),
    "max2": _minmax2(_gt),
    "and": lambda a, b: torch.logical_and(a != 0, b != 0),
    "or": lambda a, b: torch.logical_or(a != 0, b != 0),
    "xor": lambda a, b: torch.logical_xor(a != 0, b != 0),
    "lt": lambda a, b: torch.lt(_re(a), _re(b)),
    "le": lambda a, b: torch.le(_re(a), _re(b)),
    "gt": lambda a, b: torch.gt(_re(a), _re(b)),
    "ge": lambda a, b: torch.ge(_re(a), _re(b)),
    "eq": torch.eq,
    "ne": torch.ne,
}


def saturate_cast(r: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """MATLAB round-half-away and saturation into an integer dtype; NaN -> 0,
    +-Inf -> the class limits (`saturate_cast_device` of the JAX package's table)."""
    info = torch.iinfo(dt)
    rr = torch.where(r >= 0, torch.floor(r + 0.5), torch.ceil(r - 0.5))
    rr = torch.where(torch.isnan(rr), torch.zeros_like(rr), rr)
    rr = torch.clamp(rr, float(info.min), float(info.max))
    out = rr.to(dt)
    if info.bits == 64:
        # f64 cannot hold the 64-bit limits exactly; repair the ends
        out = torch.where(rr >= float(info.max),
                          torch.full_like(out, info.max), out)
        out = torch.where(rr <= float(info.min),
                          torch.full_like(out, info.min), out)
    return out
