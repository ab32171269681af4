"""Device colormapping for image-style plots: a hand-written CUDA C++
kernel (`csrc/cmap.cu`, two launches) and its plain PyTorch version.

The JAX package colormaps a device array inside one jitted program
(`runmat_tpu/accel/dense.py:_b_cmap`, 1064-1083; XLA compiled it, no
Pallas twin), so `imagesc` copies one byte a channel to the host and not
the float field. For a field `a` (float64 or float32):

    lo = nanmin(a), hi = nanmax(a)      (NaN where every value is NaN)
    hi2 = lo + 1 where hi == lo, else hi
    t = (a - lo) / (hi2 - lo) * 255     (in a's type, each op rounded)
    idx = trunc(clip(t, 0, 255)) where t is finite, else 0
    rgb = table[idx]                    (a.shape + (3,), uint8)

`table` is the colormap's 256 x 3 bytes, `(lut * 255 + 0.5)` truncated,
computed once a colormap on the host in float32 as the JAX builder rounds
it (its LUT is a float32 array; rounding in float64 instead changes 190
of jet's 768 entries). lo and hi come back in a's type.

`cmap(a, name)` returns (rgb, sc) with sc = (lo, hi, hi2) as a tensor of
a's type, all on a's device. A CPU tensor takes `plain_cmap`; a CUDA
tensor launches the kernel (the range pass with its last-block tail, then
the map) or raises `MatError("RunMat:cmapKernel")`: a failed build or
launch, an empty field, or a type other than float64 and float32.
`launches` counts the calls that launch the kernel pair (one a call) and
`launches_by` splits them ("cmap f64", "cmap f32").
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..errors import MatError

launches = 0
launches_by: collections.Counter = collections.Counter()

_NAMES = {torch.float64: "cmap f64", torch.float32: "cmap f32"}
_entries: dict = {}
_tables: dict = {}       # colormap name -> (256, 3) uint8 numpy
_device_tables: dict = {}    # (name, device) -> uint8 tensor on the card
_counters: dict = {}     # device -> the range pass's block counter


def table(name: str) -> np.ndarray:
    """The colormap's bytes, rounded in float32 as the JAX builder does."""
    t = _tables.get(name)
    if t is None:
        from ..plot.colors import colormap
        lut = np.asarray(colormap(name), dtype=np.float32)
        t = (lut * np.float32(255) + np.float32(0.5)).astype(np.uint8)
        _tables[name] = t
    return t


def plain_cmap(a: torch.Tensor, lut: torch.Tensor):
    """The function in torch ops: (rgb, (lo, hi, hi2)) for `lut` a (256, 3)
    uint8 tensor on a's device."""
    nan = torch.isnan(a)
    none = nan.all()
    inf = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    lo = torch.where(nan, inf, a).amin()
    hi = torch.where(nan, -inf, a).amax()
    lo = torch.where(none, torch.nan, lo)
    hi = torch.where(none, torch.nan, hi)
    hi2 = torch.where(hi == lo, lo + 1, hi)
    t = (a - lo) / (hi2 - lo) * 255
    idx = torch.where(torch.isfinite(t), t.clamp(0, 255), 0).to(torch.int64)
    return lut[idx], torch.stack([lo, hi, hi2])


def _kernel(name: str):
    fn = _entries.get(name)
    if fn is None:
        from ._build import library
        try:
            lib = library()
            fn = getattr(lib, name)
        except (RuntimeError, OSError, AttributeError) as e:
            raise MatError("RunMat:cmapKernel",
                           f"the colormap kernel could not be built or "
                           f"loaded: {str(e)[-1500:]}") from e
        P = ctypes.c_void_p
        if name == "runmat_cmap":
            fn.argtypes = [ctypes.c_int, ctypes.c_int64, P, P, P, P, P, P,
                           ctypes.c_int, P, ctypes.c_int]
        else:
            fn.argtypes = [ctypes.c_int64, ctypes.c_int]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def device_table(name: str, device: torch.device) -> torch.Tensor:
    """The colormap's bytes on `device`, copied there once (through pinned
    memory, so the copy does not wait for the card's queue)."""
    key = (name, str(device))
    t = _device_tables.get(key)
    if t is None:
        host = torch.from_numpy(table(name).copy())
        if device.type == "cuda":
            host = host.pin_memory()
        t = host.to(device, non_blocking=True)
        _device_tables[key] = t
    return t


def cmap(a: torch.Tensor, name: str, upto: int = 2):
    """(rgb, sc): the colormapped field, a.shape + (3,) uint8, and (lo, hi,
    hi2) in a's type, on a's device. `upto` 1 runs only the kernel's range
    pass (rgb then holds nothing), for timing."""
    global launches
    lut = device_table(name, a.device)
    if a.device.type == "cpu":
        return plain_cmap(a, lut)
    if a.device.type != "cuda" or a.dtype not in _NAMES:
        raise MatError("RunMat:cmapKernel",
                       f"the colormap kernel takes float64 or float32 on a "
                       f"card, not {a.dtype} on {a.device}")
    n = a.numel()
    if n == 0:
        raise MatError("RunMat:cmapKernel", "the colormap of an empty field")
    a = a.contiguous()
    dev = a.device.index if a.device.index is not None \
        else torch.cuda.current_device()
    blocks = _kernel("runmat_cmap_blocks")(n, dev)
    count = _counters.get(dev)
    if count is None:
        count = torch.zeros(1, dtype=torch.int32, device=a.device)
        _counters[dev] = count
    part = torch.empty(2 * blocks, dtype=a.dtype, device=a.device)
    sc = torch.empty(3, dtype=a.dtype, device=a.device)
    rgb = torch.empty(tuple(a.shape) + (3,), dtype=torch.uint8,
                      device=a.device)
    rc = _kernel("runmat_cmap")(
        int(a.dtype == torch.float64), n, a.data_ptr(), part.data_ptr(),
        count.data_ptr(), sc.data_ptr(), lut.data_ptr(), rgb.data_ptr(),
        int(upto), torch.cuda.current_stream(dev).cuda_stream, dev)
    if rc != 0:
        raise MatError("RunMat:cmapKernel",
                       f"{_NAMES[a.dtype]} launch failed: CUDA error {rc}")
    launches += 1
    launches_by[_NAMES[a.dtype]] += 1
    return rgb, sc
