"""Build the package's CUDA sources with nvcc at first use, load with ctypes.

All of `csrc/*.cu` compile into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds): one nvcc per source, all
started together, then one link. The output is named by a hash of the
sources and flags, under `build/runmat_tpu_torch/` beside the package, so a
changed source never loads a stale library. A failed build raises; nothing
falls back.
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
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        sources = sorted(CSRC.glob("*.cu"))
        objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in sources]
        cmds = [[nvcc(), *FLAGS, "-c", "-o", str(o), str(p)]
                for p, o in zip(sources, objs)]
        cmds.append([nvcc(), *FLAGS, "-shared", "-o", str(tmp),
                     *(str(o) for o in objs)])
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds[:-1]]
        errs = [p.communicate()[1] for p in procs]
        runs = [(c, p.returncode, err)
                for c, p, err in zip(cmds, procs, errs)]
        if all(rc == 0 for _, rc, _ in runs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            runs.append((cmds[-1], link.returncode, link.stderr))
        build_seconds = time.perf_counter() - t0
        build_log = "".join(err for _, _, err in runs)
        for o in objs:
            o.unlink(missing_ok=True)
        for cmd, rc, err in runs:
            if rc != 0:
                raise RuntimeError(
                    f"runmat_tpu_torch: nvcc failed with code {rc}:"
                    f"\n{' '.join(cmd)}\n{err[-4000:]}")
        os.replace(tmp, out)
    _lib = ctypes.CDLL(str(out))
    return _lib
