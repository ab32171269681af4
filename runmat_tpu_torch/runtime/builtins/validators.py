"""Copy of runmat_tpu/runtime/builtins/validators.py in the PyTorch port.

Argument validator functions (mustBe* family).

Reference parity: the validators usable in runmat-hir argument-validation
blocks (and directly as functions). Each raises a MATLAB-style error when the
condition fails and returns nothing on success.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError
from ...values import CellArray, MatArray, StringArray, class_name, is_text, text_of
from ..registry import builtin


def _fail(ident: str, msg: str):
    raise MatError(f"MATLAB:validators:{ident}", msg)


def _num(v) -> np.ndarray:
    if not isinstance(v, MatArray) or v.mclass == "char":
        _fail("mustBeNumeric", "Value must be numeric.")
    return v.host()


@builtin("mustBeNumeric", category="validators", min_in=1, max_in=1)
def m_must_be_numeric(v):
    if not isinstance(v, MatArray) or v.mclass in ("char",):
        _fail("mustBeNumeric", "Value must be numeric.")
    return None


@builtin("mustBeReal", category="validators", min_in=1, max_in=1)
def m_must_be_real(v):
    if _num(v).dtype.kind == "c":
        _fail("mustBeReal", "Value must be real.")
    return None


@builtin("mustBeFinite", category="validators", min_in=1, max_in=1)
def m_must_be_finite(v):
    h = _num(v)
    if h.dtype.kind == "f" and not np.isfinite(h).all():
        _fail("mustBeFinite", "Value must be finite.")
    return None


@builtin("mustBePositive", category="validators", min_in=1, max_in=1)
def m_must_be_positive(v):
    if not (np.real(_num(v)) > 0).all():
        _fail("mustBePositive", "Value must be positive.")
    return None


@builtin("mustBeNonnegative", category="validators", min_in=1, max_in=1)
def m_must_be_nonnegative(v):
    if not (np.real(_num(v)) >= 0).all():
        _fail("mustBeNonnegative", "Value must be nonnegative.")
    return None


@builtin("mustBeNegative", category="validators", min_in=1, max_in=1)
def m_must_be_negative(v):
    if not (np.real(_num(v)) < 0).all():
        _fail("mustBeNegative", "Value must be negative.")
    return None


@builtin("mustBeNonpositive", category="validators", min_in=1, max_in=1)
def m_must_be_nonpositive(v):
    if not (np.real(_num(v)) <= 0).all():
        _fail("mustBeNonpositive", "Value must be nonpositive.")
    return None


@builtin("mustBeInteger", category="validators", min_in=1, max_in=1)
def m_must_be_integer(v):
    h = np.real(_num(v)).astype(np.float64)
    if not np.equal(np.mod(h, 1.0), 0.0).all():
        _fail("mustBeInteger", "Value must be integer.")
    return None


@builtin("mustBeNonzero", category="validators", min_in=1, max_in=1)
def m_must_be_nonzero(v):
    if (np.real(_num(v)) == 0).any():
        _fail("mustBeNonzero", "Value must be nonzero.")
    return None


@builtin("mustBeNonempty", category="validators", min_in=1, max_in=1)
def m_must_be_nonempty(v):
    if getattr(v, "size", 0) == 0:
        _fail("mustBeNonempty", "Value must be nonempty.")
    return None


@builtin("mustBeScalarOrEmpty", category="validators", min_in=1, max_in=1)
def m_must_be_scalar_or_empty(v):
    if getattr(v, "size", 0) > 1:
        _fail("mustBeScalarOrEmpty", "Value must be scalar or empty.")
    return None


@builtin("mustBeText", category="validators", min_in=1, max_in=1)
def m_must_be_text(v):
    if not (is_text(v) or isinstance(v, StringArray) or
            (isinstance(v, CellArray) and all(
                is_text(e) for e in v.data.reshape(-1)))):
        _fail("mustBeText", "Value must be text (char or string).")
    return None


@builtin("mustBeGreaterThan", category="validators", min_in=2, max_in=2)
def m_must_be_greater_than(v, bound):
    b = float(bound.host().reshape(-1)[0])
    if not (np.real(_num(v)) > b).all():
        _fail("mustBeGreaterThan", f"Value must be greater than {b:g}.")
    return None


@builtin("mustBeGreaterThanOrEqual", category="validators", min_in=2, max_in=2)
def m_must_be_ge(v, bound):
    b = float(bound.host().reshape(-1)[0])
    if not (np.real(_num(v)) >= b).all():
        _fail("mustBeGreaterThanOrEqual",
              f"Value must be greater than or equal to {b:g}.")
    return None


@builtin("mustBeLessThan", category="validators", min_in=2, max_in=2)
def m_must_be_less_than(v, bound):
    b = float(bound.host().reshape(-1)[0])
    if not (np.real(_num(v)) < b).all():
        _fail("mustBeLessThan", f"Value must be less than {b:g}.")
    return None


@builtin("mustBeLessThanOrEqual", category="validators", min_in=2, max_in=2)
def m_must_be_le(v, bound):
    b = float(bound.host().reshape(-1)[0])
    if not (np.real(_num(v)) <= b).all():
        _fail("mustBeLessThanOrEqual",
              f"Value must be less than or equal to {b:g}.")
    return None


@builtin("mustBeInRange", category="validators", min_in=3, max_in=3)
def m_must_be_in_range(v, lo, hi):
    l = float(lo.host().reshape(-1)[0])
    h = float(hi.host().reshape(-1)[0])
    x = np.real(_num(v))
    if not ((x >= l) & (x <= h)).all():
        _fail("mustBeInRange", f"Value must be in range [{l:g}, {h:g}].")
    return None


@builtin("mustBeMember", category="validators", min_in=2, max_in=2)
def m_must_be_member(v, allowed):
    if is_text(v) or isinstance(v, StringArray):
        val = text_of(v) if is_text(v) else (v.item() or "")
        opts = []
        if isinstance(allowed, CellArray):
            opts = [text_of(e) for e in allowed.data.reshape(-1)]
        elif isinstance(allowed, StringArray):
            opts = [s or "" for s in allowed.data.reshape(-1)]
        if val not in opts:
            _fail("mustBeMember", f"Value must be one of: {', '.join(opts)}.")
        return None
    x = np.real(_num(v)).reshape(-1)
    opts_n = np.real(allowed.host()).reshape(-1)
    if not np.isin(x, opts_n).all():
        _fail("mustBeMember", "Value must be a member of the allowed set.")
    return None


@builtin("mustBeA", category="validators", min_in=2, max_in=2)
def m_must_be_a(v, cls):
    want = text_of(cls)
    got = class_name(v)
    numeric = {"double", "single", "int8", "int16", "int32", "int64",
               "uint8", "uint16", "uint32", "uint64"}
    if got == want or (want == "numeric" and got in numeric) or \
            (want == "float" and got in ("double", "single")):
        return None
    _fail("mustBeA", f"Value must be of class {want}; got {got}.")


@builtin("mustBeVector", category="validators", min_in=1, max_in=1)
def m_must_be_vector(v):
    shape = getattr(v, "shape", (1, 1))
    if len(shape) != 2 or (1 not in shape) or getattr(v, "size", 0) == 0:
        _fail("mustBeVector", "Value must be a vector.")
    return None


@builtin("mustBeNonNan", category="validators", min_in=1, max_in=1)
def m_must_be_nonnan(v):
    h = _num(v)
    if h.dtype.kind == "f" and np.isnan(h).any():
        _fail("mustBeNonNan", "Value must not be NaN.")
    return None


@builtin("mustBeValidVariableName", category="validators", min_in=1, max_in=1)
def m_must_be_valid_variable_name(v):
    t = text_of(v) if is_text(v) else None
    if not t or not (t[0].isalpha() and all(c.isalnum() or c == "_" for c in t)):
        _fail("mustBeValidVariableName", "Value must be a valid variable name.")
    return None


@builtin("validatestring", category="validators", min_in=2, max_in=4)
def m_validatestring(v, valid, *ctx_args):
    """Match (case-insensitive, unambiguous-prefix) against valid strings."""
    val = (text_of(v) if is_text(v) else
           (v.item() or "") if isinstance(v, StringArray) else None)
    if val is None:
        _fail("validatestring", "Input must be text.")
    if isinstance(valid, CellArray):
        opts = [text_of(e) for e in valid.data.reshape(-1, order="F")]
    elif isinstance(valid, StringArray):
        opts = [s or "" for s in valid.data.reshape(-1, order="F")]
    else:
        opts = [text_of(valid)]
    low = val.lower()
    exact = [o for o in opts if o.lower() == low]
    if exact:
        return MatArray.char_from_str(exact[0])
    pref = [o for o in opts if o.lower().startswith(low)]
    if len(pref) == 1:
        return MatArray.char_from_str(pref[0])
    if len(pref) > 1:
        raise MatError("MATLAB:validatestring:ambiguousStringChoice",
                       f"'{val}' matches multiple valid strings.")
    raise MatError("MATLAB:validatestring:unrecognizedStringChoice",
                   f"'{val}' did not match any valid string "
                   f"({', '.join(opts)}).")
