"""Elementwise ops for the PyTorch engine, with the MATLAB semantics of
`runmat_tpu/ops/table.py`.

The shared table takes an array namespace `xp` and reaches jax inside some
entries (`erf`, `gamma`), and names torch lacks (`xp.power`, `.astype`), so
torch gets its own table over the same op names. Where torch's primitive
differs from numpy's, the entry repairs it: `sign(NaN)` is NaN, `x^0` and
`1^y` are 1 even where pow gives NaN, `min2`/`max2` ignore NaN.
Real inputs only: complex values do not reach the device in this port.
"""

from __future__ import annotations

import torch

from runmat_tpu.ops.table import (COMPARE_OPS, INT_SAT_BINARY,  # noqa: F401
                                  LOGICAL_OPS)


def _sign(a):
    return torch.where(torch.isnan(a), a, torch.sign(a))


def _round(a):
    # half away from zero, written as the shared table writes it
    return torch.trunc(a + torch.where(a >= 0, 0.5, -0.5).to(a.dtype))


def _gamma(a):
    sign = torch.where((torch.remainder(a, 2) >= 1) & (a < 0), -1.0, 1.0)
    return torch.exp(torch.lgamma(a)) * sign.to(a.dtype)


UNARY = {
    "neg": torch.neg,
    "uplus": lambda a: a,
    "abs": torch.abs,
    "sign": _sign,
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
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "fix": torch.trunc,
    "round": _round,
    "real": lambda a: a,
    "imag": torch.zeros_like,
    "conj": lambda a: a,
    "angle": lambda a: torch.atan2(torch.zeros_like(a), a),
    "reciprocal": lambda a: 1.0 / a,
    "square": lambda a: a * a,
    "gamma": _gamma,
    "erf": torch.special.erf,
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
    "logical_not": torch.logical_not,
}


def _pow(a, b):
    """MATLAB: x^0 is 1 for every x, 1^y is 1 for every y. The repair
    applies only where pow produced NaN."""
    r = torch.pow(a, b)
    return torch.where(torch.isnan(r) & ((b == 0) | (a == 1)),
                       torch.ones((), dtype=r.dtype, device=r.device), r)


def _mod(a, b):
    # mod(a, 0) = a; the result takes the sign of the divisor; a finite a
    # over an infinite divisor is a when the signs agree (or a == 0), else b
    r = a - torch.floor(a / b) * b
    r = torch.where(b == 0, a, r)
    inf_b = torch.isinf(b) & torch.isfinite(a)
    same = (a >= 0) == (b > 0)
    return torch.where(inf_b, torch.where((a == 0) | same, a, b), r)


def _rem(a, b):
    # rem(a, 0) = NaN; the result takes the sign of the dividend;
    # rem(a, +-Inf) = a for finite a
    r = a - torch.trunc(a / b) * b
    r = torch.where(b == 0, torch.full_like(r, float("nan")), r)
    inf_b = torch.isinf(b) & torch.isfinite(a)
    return torch.where(inf_b, a, r)


BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "ldiv": lambda a, b: torch.div(b, a),
    "pow": _pow,
    "atan2": torch.atan2,
    "hypot": torch.hypot,
    "mod": _mod,
    "rem": _rem,
    "min2": torch.fmin,
    "max2": torch.fmax,
    "and": lambda a, b: torch.logical_and(a != 0, b != 0),
    "or": lambda a, b: torch.logical_or(a != 0, b != 0),
    "xor": lambda a, b: torch.logical_xor(a != 0, b != 0),
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
}


def saturate_cast(r: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """MATLAB round-half-away and saturation into an integer dtype; NaN -> 0,
    +-Inf -> the class limits (`runmat_tpu.ops.table.saturate_cast_device`)."""
    info = torch.iinfo(dt)
    rr = torch.where(r >= 0, torch.floor(r + 0.5), torch.ceil(r - 0.5))
    rr = torch.where(torch.isnan(rr), torch.zeros_like(rr), rr)
    rr = torch.clamp(rr, float(info.min), float(info.max))
    out = rr.to(dt)
    if info.bits == 64:
        # f64 cannot hold the 64-bit limits exactly; repair the ends
        out = torch.where(rr >= float(info.max),
                          torch.tensor(info.max, dtype=dt, device=r.device), out)
        out = torch.where(rr <= float(info.min),
                          torch.tensor(info.min, dtype=dt, device=r.device), out)
    return out
