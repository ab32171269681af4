"""Device random draws: the wrapper around `csrc/threefry.cu`.

`rng_draw` is the single device RNG of the port. A CPU device takes the plain
PyTorch stream (`ops/ctrng.py`); a CUDA device launches the hand-written
kernel or raises. `launches` counts kernel launches and nothing else, so a
run can show that its draws went through the kernel; `launches_by` splits
the count by draw ("rand float32", "randn float64", ...).
`device_transform` runs the normal kernels' Box-Muller transform alone over
given words, so a check can hold it to its numpy model (`ops/boxmuller.py`);
it is not a draw and is not counted.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from . import boxmuller, ctrng
from ._build import library

launches = 0
launches_by: collections.Counter = collections.Counter()

_MODES = {("rand", torch.float32): 0, ("rand", torch.float64): 1,
          ("randn", torch.float32): 2, ("randn", torch.float64): 3}
_entry = None
_transform_entry = None


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


def _transform_kernel():
    global _transform_entry
    if _transform_entry is None:
        fn = library().runmat_threefry_transform
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _transform_entry = fn
    return _transform_entry


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


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
    index = _device_index(device)
    rc = _kernel()(_MODES[(kind, dtype)], out.data_ptr(),
                   int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
                   lo, hi, n, torch.cuda.current_stream(index).cuda_stream,
                   index)
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_by[f"{kind} {str(dtype).split('.')[-1]}"] += 1
    return out


def device_transform(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The normal kernels' transform over given words: `words` holds u32
    values (any integer type) as rows [w0, w1] (float32: u1 from w0, u2
    from w1) or [a0, a1, b0, b1] (float64: u1 from block (a0, a1), u2 from
    (b0, b1)). Returns rows [r cos theta, r sin theta] of `dtype`. On a
    CUDA tensor the kernel's own device code runs; on a CPU tensor its
    numpy model (`ops/boxmuller.py`)."""
    rows = 2 if dtype == torch.float32 else 4
    if dtype not in (torch.float32, torch.float64) or words.dim() != 2 \
            or words.shape[0] != rows:
        raise ValueError(f"device_transform: {rows} rows of words for "
                         f"{dtype}, got {tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        w = words.numpy().astype(np.int64).astype(np.uint32)
        model = boxmuller.box_muller_f32 if rows == 2 \
            else boxmuller.box_muller_f64
        return torch.from_numpy(np.stack(model(*w)))
    if words.device.type != "cuda":
        raise ValueError(f"device_transform: no kernel for {words.device}")
    w = words.to(torch.int32).contiguous()
    count = w.shape[1]
    out = torch.empty((2, count), dtype=dtype, device=w.device)
    index = _device_index(w.device)
    rc = _transform_kernel()(2 if rows == 2 else 3, w.data_ptr(),
                             out.data_ptr(), count,
                             torch.cuda.current_stream(index).cuda_stream,
                             index)
    if rc != 0:
        raise RuntimeError(
            f"threefry transform launch failed: CUDA error {rc}")
    return out
