"""Copy of runmat_tpu/runtime/builtins/common.py in the PyTorch port.

Shared argument-parsing helpers for builtins.

Reference parity: runmat-runtime/src/builtins/common/ (arg coercion utilities
shared by the 1128 builtins).
"""

from __future__ import annotations

import numpy as np

from ... import dtypes
from ...errors import MatError, bad_arg
from ...values import MatArray, StringArray, is_text, text_of


def scalar_int(v, what: str = "argument") -> int:
    if isinstance(v, MatArray) and v.size == 1:
        x = v.scalar_double()
        if not np.isfinite(x):
            raise MatError("MATLAB:badInput", f"Expected a finite integer {what}.")
        return int(round(x))
    raise MatError("MATLAB:badInput", f"Expected a scalar integer {what}.")


def scalar_num(v, what: str = "argument") -> float:
    if isinstance(v, MatArray) and v.size == 1:
        return v.scalar_double()
    raise MatError("MATLAB:badInput", f"Expected a scalar {what}.")


def text_or_none(v):
    try:
        return text_of(v)
    except MatError:
        return None


def parse_size_args(args: list, default_square: bool = True):
    """Parse trailing MATLAB size/class/'like' arguments as used by zeros/ones/
    rand/...: (dims tuple, mclass, like_proto). Accepts zeros(), zeros(n),
    zeros(m,n,...), zeros([m n]), trailing 'single'/'int32'/..., and
    'like', proto."""
    mclass = None
    like = None
    dims_args = []
    i = 0
    while i < len(args):
        a = args[i]
        if is_text(a):
            t = text_of(a)
            if t == "like":
                if i + 1 >= len(args):
                    raise bad_arg("zeros", "'like' requires a prototype argument.")
                like = args[i + 1]
                i += 2
                continue
            if t in dtypes.NUMERIC_CLASSES + ("logical",):
                mclass = t
                i += 1
                continue
            raise bad_arg("zeros", f"Unknown option '{t}'.")
        dims_args.append(a)
        i += 1
    dims: list[int] = []
    if len(dims_args) == 0:
        dims = [1, 1]
    elif len(dims_args) == 1:
        d = dims_args[0]
        if not isinstance(d, MatArray):
            raise bad_arg("zeros", "Size inputs must be numeric.")
        if d.size == 1:
            n = scalar_int(d, "size")
            dims = [n, n] if default_square else [n, 1]
        else:
            dims = [int(x) for x in d.host().reshape(-1)]
    else:
        for d in dims_args:
            dims.append(scalar_int(d, "size"))
    dims = [max(0, d) for d in dims]
    if len(dims) == 1:
        dims = [dims[0], dims[0]] if default_square else [dims[0], 1]
    return tuple(dims), mclass, like


def class_and_device_of_proto(proto):
    """'like' prototype -> (mclass, on_device, is_complex)."""
    if isinstance(proto, MatArray):
        return proto.mclass, proto.on_device, proto.is_complex
    raise bad_arg("like", "Prototype for 'like' must be numeric.")


def as_shape_tuple(v) -> tuple[int, ...]:
    if isinstance(v, MatArray):
        h = v.host()
        return tuple(int(x) for x in h.reshape(-1))
    raise MatError("MATLAB:badInput", "Expected a size vector.")
