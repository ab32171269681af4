"""Copy of runmat_tpu/errors.py in the PyTorch port.

MATLAB-compatible error model (MException analog).

Reference parity: runmat-async/src/runtime_error.rs (RuntimeError builder) and
the MException surface described in runmat-builtins/src/lib.rs:73-123 (Value::MException).
Errors carry a MATLAB identifier ("component:mnemonic") and a message; try/catch in
the VM converts them into MException struct-like values.
"""

from __future__ import annotations


class MatError(Exception):
    """A MATLAB-style runtime error with an identifier and message."""

    def __init__(self, identifier: str, message: str):
        super().__init__(message)
        self.identifier = identifier
        self.message = message
        # Populated by the VM as the error unwinds: list of (fn_name, line) frames.
        self.stack: list[tuple[str, int]] = []

    def __str__(self) -> str:  # pragma: no cover - display helper
        return self.message


def undefined(name: str) -> MatError:
    return MatError(
        "MATLAB:UndefinedFunction",
        f"Unrecognized function or variable '{name}'.",
    )


def dim_mismatch(msg: str = "Matrix dimensions must agree.") -> MatError:
    return MatError("MATLAB:dimagree", msg)


def bad_index(msg: str = "Index exceeds the number of array elements.") -> MatError:
    return MatError("MATLAB:badsubscript", msg)


def bad_arg(func: str, msg: str) -> MatError:
    return MatError(f"MATLAB:{func}:invalidInput", msg)


def nargin_error(func: str) -> MatError:
    return MatError("MATLAB:narginchk:notEnoughInputs", f"Not enough input arguments for '{func}'.")


def mixed_int_error() -> MatError:
    return MatError(
        "MATLAB:mixedClasses",
        "Integers can only be combined with integers of the same class, or scalar doubles.",
    )


class InterruptError(Exception):
    """Cooperative interrupt (Ctrl-C analog); checked at loop back-edges.

    Reference parity: runmat-runtime/src/interrupt.rs + runner.rs:1082.
    """
