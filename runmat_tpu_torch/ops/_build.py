"""Build the package's CUDA sources with nvcc at first use, load with ctypes.

All of `csrc/*.cu` compile into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds). The output is named by a
hash of the sources and flags, under `build/runmat_tpu_torch/` beside the
package, so a changed source never loads a stale library. A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "runmat_tpu_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_seconds = 0.0     # wall time of the nvcc run in this process (0 if cached)
build_log = ""          # nvcc's stderr: ptxas registers, spills, shared memory


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("runmat_tpu_torch: nvcc not found; put it on PATH "
                       "or set CUDA_HOME")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librunmat_tpu_torch-{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp),
               *(str(p) for p in sorted(CSRC.glob("*.cu")))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"runmat_tpu_torch: nvcc failed with code {proc.returncode}:"
                f"\n{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    _lib = ctypes.CDLL(str(out))
    return _lib
