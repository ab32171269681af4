"""Device random draws: the wrapper around `csrc/threefry.cu`.

`rng_draw` is the single device RNG of the port. A CPU device takes the plain
PyTorch stream (`ops/ctrng.py`); a CUDA device launches the hand-written
kernel or raises. The counter is a host int (the kernel gets it as launch
arguments) or a 0-d int64 tensor on the draw's device (the kernel reads it
from device memory when it runs, `runmat_threefry_draw_at`; the plain
stream does tensor arithmetic on it), which is what a captured CUDA graph
needs. `launches` counts the draws the card executes and nothing else, so a
run can show that its draws went through the kernel; `launches_by` splits
the count by draw ("rand float32", "randn float64", ...), with
DEVICE_COUNTER appended for the entry that reads its counter from device
memory ("randn float32 (device counter)"). A draw made while
the stream is being captured runs only when its graph replays: it is
counted in `captured`, and `replayed` adds a graph's draws once per replay.
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
captured: collections.Counter = collections.Counter()
DEVICE_COUNTER = " (device counter)"

_MODES = {("rand", torch.float32): 0, ("rand", torch.float64): 1,
          ("randn", torch.float32): 2, ("randn", torch.float64): 3}
_entry = None
_entry_at = None
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


def _kernel_at():
    global _entry_at
    if _entry_at is None:
        fn = library().runmat_threefry_draw_at
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry_at = fn
    return _entry_at


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
    counter: 64-bit block index (an int, or a 0-d int64 tensor on `device`)
    or a (lo, hi) pair of u32 values."""
    global launches
    if (kind, dtype) not in _MODES:
        raise ValueError(f"rng_draw: unsupported draw {kind!r} of {dtype}")
    device = torch.device(device)
    on_card = isinstance(counter, torch.Tensor)
    if on_card and (counter.dtype != torch.int64 or counter.dim() != 0
                    or counter.device.type != device.type):
        raise ValueError(f"rng_draw: a tensor counter is one int64 on the "
                         f"draw's device, got {counter.dtype} "
                         f"{tuple(counter.shape)} on {counter.device}")
    if device.type == "cpu":
        return plain_draw(kind, key, counter, n, dtype, device)
    if device.type != "cuda":
        raise ValueError(f"rng_draw: no kernel for device {device}")
    out = torch.empty(n, dtype=dtype, device=device)
    if n == 0:
        return out
    index = _device_index(device)
    stream = torch.cuda.current_stream(index).cuda_stream
    k0, k1 = int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF
    mode = _MODES[(kind, dtype)]
    if on_card:
        rc = _kernel_at()(mode, out.data_ptr(), k0, k1, counter.data_ptr(), n,
                          stream, index)
    else:
        lo, hi = ctrng.split_counter(counter)
        rc = _kernel()(mode, out.data_ptr(), k0, k1, lo, hi, n, stream,
                       index)
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {rc}")
    label = f"{kind} {str(dtype).split('.')[-1]}" + \
        (DEVICE_COUNTER if on_card else "")
    if torch.cuda.is_current_stream_capturing():
        captured[label] += 1
    else:
        launches += 1
        launches_by[label] += 1
    return out


def replayed(draws: collections.Counter, times: int) -> None:
    """A captured graph holding `draws` ran `times` times."""
    global launches
    for label, k in draws.items():
        launches += k * times
        launches_by[label] += k * times


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
