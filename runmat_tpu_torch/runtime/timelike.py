"""Copy of runmat_tpu/runtime/timelike.py in the PyTorch port.

Generic datetime/duration routing through the numeric builtin library.

MATLAB's ordering, structural, and (for duration) accumulating functions all
work on datetime/duration arrays. The reference gets this via its datetime
objects wrapping plain serial tensors plus per-method registrations
(datetime.sort and friends route through the numeric paths,
runmat-runtime/src/builtins/datetime/mod.rs). Here the same breadth comes
from ONE shim at the dispatcher: a timelike argument is encoded as a float64
MatArray of microseconds-since-epoch (NaT -> NaN, so MATLAB's omit-NaN
defaults give the omit-NaT datetime semantics for free), the ordinary
builtin runs, and the first output decodes back per a small kind table
("same" class, "dur"ation results like diff/std, or "raw" logical/index
passthrough).

Microsecond counts stay under 2^53 until year ~287396, so the float64
encoding is exact for the representable datetime range.
"""

from __future__ import annotations

import numpy as np

from ..errors import MatError
from ..values import MatArray

# first output decodes to the class of the first timelike input
_SAME = frozenset((
    "sort", "sortrows", "unique", "min", "max", "median", "mode",
    "flip", "fliplr", "flipud", "reshape", "permute", "squeeze",
    "circshift", "repmat", "rot90", "transpose", "ctranspose",
    "cat", "horzcat", "vertcat", "linspace", "head", "tail",
    "intersect", "union", "setdiff", "setxor", "cummin", "cummax",
    "mean",
))
# duration-typed results
_DUR = frozenset(("diff", "std"))
# numeric/logical outputs pass through undecoded
_RAW = frozenset(("ismember", "issorted", "isequal", "isequaln",
                  "find", "nnz", "any", "all", "histcounts", "discretize"))
# arithmetic-flavored names only defined for duration inputs
_DURATION_ONLY = frozenset(("sum", "cumsum", "abs", "uminus", "uplus"))

_NAMES = _SAME | _DUR | _RAW | _DURATION_ONLY

_NAT = np.iinfo(np.int64).min


def _kind(v) -> str:
    return type(v).__name__


def is_timelike(v) -> bool:
    return _kind(v) in ("MatDatetime", "MatDuration")


def applies(name: str, args: list) -> bool:
    return name in _NAMES and any(is_timelike(a) for a in args)


def encode(v) -> MatArray:
    ints = v.data.astype(np.int64)
    out = ints.astype(np.float64)
    out[ints == _NAT] = np.nan
    return MatArray(out, "double")


def decode(arr, cls_name: str):
    from .builtins.datetime_builtins import MatDatetime, MatDuration
    if not isinstance(arr, MatArray) or arr.mclass not in ("double", "single") \
            or arr.is_complex:
        return arr                      # index/logical/count outputs
    h = arr.host().astype(np.float64)
    ints = np.where(np.isnan(h), _NAT, np.round(h)).astype(np.int64)
    if cls_name == "MatDatetime":
        return MatDatetime(ints.astype("datetime64[us]"))
    return MatDuration(ints.astype("timedelta64[us]"))


def shim(b, args: list, nargout: int, invoke):
    """Encode timelike args, run the numeric builtin via `invoke`, decode.
    Returns the result list, or None when the shim does not apply."""
    if not applies(b.name, args):
        return None
    first = next(_kind(a) for a in args if is_timelike(a))
    if b.name in _DURATION_ONLY and first == "MatDatetime":
        raise MatError("MATLAB:datetime:undefinedFunction",
                       f"'{b.name}' is not defined for datetime arrays.")
    if len({_kind(a) for a in args if is_timelike(a)}) > 1:
        raise MatError("MATLAB:datetime:classMismatch",
                       "Inputs must have the same class.")
    enc = [encode(a) if is_timelike(a) else a for a in args]
    res = invoke(enc)
    if not res:
        return res
    if b.name in _RAW:
        return res
    out_cls = "MatDuration" if b.name in _DUR or first == "MatDuration" \
        else "MatDatetime"
    return [decode(res[0], out_cls)] + list(res[1:])
