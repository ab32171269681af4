"""Copy of runmat_tpu/native/__init__.py in the PyTorch port.

Native components: ctypes bindings + lazy build.

Reference parity: the reference's performance-critical native components
(runmat-turbine JIT, hot kernels). The shared library builds from the
port's own `native/turbine.cpp` (a copy of the repo root's, beside this
file) with g++ at first use, into `build/runmat_tpu_torch/` keyed by a
hash of the source, as `ops/_build.py` builds the `.cu` files.

Unlike the JAX package's, a failed build is not silent: `turbine()` still
returns None (the interpreter then runs the loop, which is always right),
but `build_error` keeps the compiler's message and `turbine_loop.bails`
counts each loop that fell back for it, under "not built".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "turbine.cpp"
BUILD_DIR = _PKG.parent / "build" / "runmat_tpu_torch"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False
build_error: str | None = None   # why the last build failed, else None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libturbine-{h.hexdigest()[:16]}.so"


def turbine() -> object:
    """The libturbine handle, building it if necessary; None if the build
    failed (`build_error` says why).

    The build is keyed by a hash of the source and flags (never by mtime),
    so a stale artifact can't be picked up silently, and no compiled binary
    lives in the repo."""
    global _LIB, _TRIED, build_error
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib_path = library_path()
    if not lib_path.exists():
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(lib_path.name + f".tmp{os.getpid()}")
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, text=True,
                           timeout=120)
            tmp.replace(lib_path)
        except subprocess.CalledProcessError as e:
            build_error = f"g++ exited {e.returncode}: {e.stderr.strip()}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lib.turbine_run.restype = ctypes.c_int32
        lib.turbine_run.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ]
        _LIB = lib
    except OSError as e:
        build_error = f"{type(e).__name__}: {e}"
        return None
    build_error = None
    return _LIB
