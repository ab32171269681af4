"""runmat_tpu_torch: the PyTorch/CUDA port of runmat_tpu.

A package of its own: the front end, VM, builtins, values and session are
copies of `runmat_tpu`'s host layers at the same relative paths, and the
device layer is `accel.engine.TorchEngine`, whose random draws and
histograms run on hand-written CUDA kernels (`csrc/`).

    import runmat_tpu_torch
    s = runmat_tpu_torch.session("cuda")
    s.execute("x = rand(4096, 1, 'single'); m = gather(mean(x));")

It imports `torch`, never `jax`, and nothing of `runmat_tpu`.
"""

from __future__ import annotations

from . import accel as _accel
from .accel.engine import TorchEngine
# The submodule is imported before the function `session` below is
# defined, so the package attribute stays the function:
# `from runmat_tpu_torch.session import Session` names the class.
from .session import Session

__all__ = ["Session", "TorchEngine", "install", "uninstall", "session"]

_previous: list = []


def install(device="cuda", **engine_kw) -> TorchEngine:
    """Make a new `TorchEngine` on `device` the port's active engine.
    `uninstall()` restores the engine that was active before."""
    eng = TorchEngine(device, **engine_kw)
    _previous.append(_accel.active_engine())
    _accel.set_engine(eng)
    return eng


def uninstall() -> None:
    """Restore the previously active engine; the uninstalled one drops its
    captured graphs."""
    if _previous:
        eng = _accel.active_engine()
        if eng is not None:
            eng.release()
        _accel.set_engine(_previous.pop())


def session(device="cuda", **engine_kw):
    """The port's `Session` on a freshly installed `TorchEngine`.
    `accelerate=True`, so a failing engine raises instead of being skipped."""
    install(device, **engine_kw)
    return Session(accelerate=True)
