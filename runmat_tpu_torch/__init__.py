"""runmat_tpu_torch: the PyTorch/CUDA port of runmat_tpu's device layer.

The host layers of `runmat_tpu` (front end, VM, builtins, values, session)
are jax-free and are used as they are. This package supplies the engine they
call (`accel.engine.TorchEngine`), the `for`-loop fold, and the hand-written
CUDA kernel behind every device random draw (`csrc/threefry.cu`).

    import runmat_tpu_torch
    s = runmat_tpu_torch.session("cuda")
    s.execute("x = rand(4096, 1, 'single'); m = gather(mean(x));")

It imports `torch` and never `jax`.
"""

from __future__ import annotations

from runmat_tpu import accel as _accel

from .accel import loops as _loops
from .accel.engine import TorchEngine

__all__ = ["TorchEngine", "install", "uninstall", "session"]

_previous: list = []


def install(device="cuda", **engine_kw) -> TorchEngine:
    """Make a new `TorchEngine` on `device` the active engine and install the
    loop seam. `uninstall()` restores the engine that was active before."""
    eng = TorchEngine(device, **engine_kw)
    _previous.append(_accel.active_engine())
    _accel.set_engine(eng)
    _loops.install_seam()
    return eng


def uninstall() -> None:
    """Restore the previously active engine and the original loop functions."""
    if _previous:
        _accel.set_engine(_previous.pop())
    _loops.remove_seam()


def session(device="cuda", **engine_kw):
    """A `runmat_tpu.session.Session` on a freshly installed `TorchEngine`.
    `accelerate=True`, so a failing engine raises instead of being skipped."""
    install(device, **engine_kw)
    from runmat_tpu.session import Session
    return Session(accelerate=True)
