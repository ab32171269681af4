"""Device random draws: the wrapper around `csrc/threefry.cu`.

`rng_draw` is the single device RNG of the port. A CPU device takes the plain
PyTorch stream (`ops/ctrng.py`); a CUDA device launches the hand-written
kernel or raises. `launches` counts kernel launches and nothing else, so a
run can show that its draws went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import ctrng
from ._build import library

launches = 0

_MODES = {("rand", torch.float32): 0, ("rand", torch.float64): 1,
          ("randn", torch.float32): 2, ("randn", torch.float64): 3}
_entry = None


def _kernel():
    global _entry
    if _entry is None:
        fn = library().runmat_threefry_draw
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def plain_draw(kind: str, key: tuple, counter, n: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """The plain PyTorch stream, on any device."""
    draw = ctrng.uniform if kind == "rand" else ctrng.normal
    return draw(key, counter, n, dtype, device)


def rng_draw(kind: str, key: tuple, counter, n: int, dtype: torch.dtype,
             device) -> torch.Tensor:
    """n values of `kind` ('rand' | 'randn') from the Threefry stream
    (key, counter) as a flat tensor of `dtype` (f32 | f64) on `device`.
    counter: 64-bit block index or a (lo, hi) pair of u32 values."""
    global launches
    if (kind, dtype) not in _MODES:
        raise ValueError(f"rng_draw: unsupported draw {kind!r} of {dtype}")
    device = torch.device(device)
    if device.type == "cpu":
        return plain_draw(kind, key, counter, n, dtype, device)
    if device.type != "cuda":
        raise ValueError(f"rng_draw: no kernel for device {device}")
    out = torch.empty(n, dtype=dtype, device=device)
    if n == 0:
        return out
    lo, hi = ctrng.split_counter(counter)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    rc = _kernel()(_MODES[(kind, dtype)], out.data_ptr(),
                   int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
                   lo, hi, n, torch.cuda.current_stream(index).cuda_stream,
                   index)
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
