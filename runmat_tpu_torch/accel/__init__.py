"""The port's engine registry: one active engine per process.

`active_engine`/`set_engine`/`reset_engine` are those of
`runmat_tpu/accel/__init__.py:12-35`. `init_engine` creates a `TorchEngine`
on the card ("cuda"); without one it raises, and a session that did not
require acceleration runs on the host. Tests choose the CPU explicitly with
`TorchEngine("cpu")`.
"""

from __future__ import annotations

_ENGINE = None


def active_engine():
    return _ENGINE


def set_engine(engine) -> None:
    global _ENGINE
    _ENGINE = engine


def init_engine(auto_offload=None, offload_threshold=None,
                matmul_precision=None, **_ignored):
    """Create and activate a `TorchEngine` on "cuda" (idempotent). The
    JAX engine's other options (platform, required) have no meaning here
    and are ignored."""
    global _ENGINE
    if _ENGINE is None:
        from .engine import TorchEngine
        _ENGINE = TorchEngine("cuda", auto_offload=auto_offload,
                              offload_threshold=offload_threshold,
                              matmul_precision=matmul_precision)
    return _ENGINE


def reset_engine() -> None:
    global _ENGINE
    _ENGINE = None
