"""Copy of runmat_tpu/runtime/builtins/logical_ops.py in the PyTorch port.

Logical & bitwise builtins.

Reference parity: runmat-runtime/src/builtins/logical/.
"""

from __future__ import annotations

import numpy as np

from ... import dtypes
from ...errors import bad_arg
from ...values import MatArray
from ..dispatch import binary
from ..registry import builtin


@builtin("and", category="logical", min_in=2, max_in=2, accel_op="and")
def m_and(a, b):
    return binary("and", a, b)


@builtin("or", category="logical", min_in=2, max_in=2, accel_op="or")
def m_or(a, b):
    return binary("or", a, b)


@builtin("xor", category="logical", min_in=2, max_in=2, accel_op="xor")
def m_xor(a, b):
    return binary("xor", a, b)


def _bits(x: MatArray) -> np.ndarray:
    h = x.host()
    if dtypes.is_integer_class(x.mclass):
        return h
    return h.astype(np.int64)


def _bit_out(r: np.ndarray, a: MatArray, b=None) -> MatArray:
    cls = a.mclass if dtypes.is_integer_class(a.mclass) else \
        (b.mclass if b is not None and dtypes.is_integer_class(b.mclass) else "double")
    if cls == "double":
        return MatArray(r.astype(np.float64), "double")
    return MatArray(r.astype(dtypes.np_dtype(cls)), cls)


@builtin("bitand", category="logical", min_in=2, max_in=2)
def m_bitand(a, b):
    return _bit_out(_bits(a) & _bits(b), a, b)


@builtin("bitor", category="logical", min_in=2, max_in=2)
def m_bitor(a, b):
    return _bit_out(_bits(a) | _bits(b), a, b)


@builtin("bitxor", category="logical", min_in=2, max_in=2)
def m_bitxor(a, b):
    return _bit_out(_bits(a) ^ _bits(b), a, b)


@builtin("bitshift", category="logical", min_in=2, max_in=2)
def m_bitshift(a, k):
    ha = _bits(a)
    hk = k.host().astype(np.int64)
    r = np.where(hk >= 0, ha << np.abs(hk), ha >> np.abs(hk))
    return _bit_out(r, a)


@builtin("bitcmp", category="logical", min_in=1, max_in=2)
def m_bitcmp(a, cls=None):
    ha = _bits(a)
    if dtypes.is_integer_class(a.mclass):
        return MatArray(~a.host(), a.mclass)
    return MatArray((~ha & 0xFFFFFFFFFFFFF).astype(np.float64), "double")


@builtin("bitget", category="logical", min_in=2, max_in=2)
def m_bitget(a, pos):
    ha = _bits(a)
    p = pos.host().astype(np.int64)
    return MatArray(((ha >> (p - 1)) & 1).astype(np.float64), "double")


@builtin("bitset", category="logical", min_in=2, max_in=3)
def m_bitset(a, pos, val=None):
    ha = _bits(a)
    p = pos.host().astype(np.int64)
    v = val.host().astype(np.int64) if val is not None else 1
    mask = 1 << (p - 1)
    r = np.where(v != 0 if val is not None else True, ha | mask, ha & ~mask)
    return _bit_out(r, a)
