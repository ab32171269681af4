"""Copy of runmat_tpu/runtime/registry.py in the PyTorch port.

Builtin function registry.

Reference parity: runmat-builtins BuiltinFunction registry
(crates/runmat-builtins/src/lib.rs:2093-2107) + the #[runtime_builtin]
proc-macro (crates/runmat-macros/src/lib.rs:31-80). Python decorators replace
the proc-macro; per-builtin accel metadata replaces BuiltinGpuSpec /
BuiltinFusionSpec (runmat-runtime/src/builtins/math/trigonometry/sin.rs:23-38,
174-188): instead of WGSL body templates, a builtin carries the name of the
accel-engine op the fusion planner traces into jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Builtin:
    name: str
    fn: Callable                    # fn(ctx, *args, nargout=1) -> Value | list[Value]
    category: str = ""
    summary: str = ""
    min_in: int = 0
    max_in: Optional[int] = None    # None = varargs
    max_out: int = 1
    accel_op: Optional[str] = None  # engine op name for device-resident args
    is_sink: bool = False           # output must be gathered (e.g. disp)
    pass_nargout: bool = False
    pass_ctx: bool = False
    extension: bool = False         # RunMat extension, absent in MATLAB
    #                                 (gated off in strict compat mode)


_REGISTRY: dict[str, Builtin] = {}

# extension surface (≙ ParserOptions CompatMode, runmat-parser/src/
# options.rs + the HIR SPAWN/AWAIT extension gates): names that do not
# exist in MATLAB and disappear under `[language] compat = "strict"`
EXTENSION_BUILTINS = frozenset("""
spawn await accelInfo fea_authorStudy fibonacci
""".split())


def builtin(name: str, *, category: str = "", summary: str = "", min_in: int = 0,
            max_in: Optional[int] = None, max_out: int = 1,
            accel_op: Optional[str] = None, is_sink: bool = False,
            pass_nargout: bool = False, pass_ctx: bool = False,
            extension: bool = False):
    """Register a builtin. The wrapped function receives positional Values;
    set pass_nargout / pass_ctx to receive keyword nargout / the interpreter
    context."""

    def deco(fn):
        _REGISTRY[name] = Builtin(name, fn, category, summary, min_in, max_in,
                                  max_out, accel_op, is_sink, pass_nargout,
                                  pass_ctx,
                                  extension or name in EXTENSION_BUILTINS)
        return fn

    return deco


def register_alias(alias: str, name: str) -> None:
    _REGISTRY[alias] = _REGISTRY[name]


def lookup(name: str) -> Optional[Builtin]:
    return _REGISTRY.get(name)


def exists(name: str) -> bool:
    return name in _REGISTRY


def all_builtins() -> dict[str, Builtin]:
    return _REGISTRY


_LOADED = False


def ensure_loaded() -> None:
    """Import the builtin modules the port carries, exactly once (they
    self-register), in the JAX package's order. The others are still to be
    copied (ROADMAP A16); a name only they define is undefined here."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from .builtins import (  # noqa: F401
        elementwise, creation, reductions, arrays, linalg, rng, strings,
        io_console, introspection, control, cells_structs, gpu, stats,
        sets_sort, fft_signal, interp_poly, datetime_timing, logical_ops,
        handles, dl_builtins, ode_optim, sparse_builtins, async_builtins,
        fea_builtins, symbolic, breadth2, breadth3, breadth4, stats2,
        strings2, linalg2, signal2, optim2, ml, timing2, dl_layers,
        validators, profiler, itersolve, stats3,
    )
    # In the JAX package a later module, not carried yet, registers these
    # names over the carried definition; they stay undefined here until it
    # is copied, so no script gets another function than it would there.
    for name in _REGISTERED_LATER:
        _REGISTRY.pop(name, None)


# name -> the JAX package's builtin module that defines it last
_REGISTERED_LATER = {"isobject": "oop_builtins", "hold": "plotting",
                     "addpath": "file_io", "sortrows": "table_builtins",
                     "datestr": "datetime_builtins", "peaks": "plotting3"}
