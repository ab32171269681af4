"""IIR filtering, direct form II transposed: the wrapper around
`csrc/iir.cu`.

`iir(x, b, a, z0)` filters the vector x with N coefficients b and a (a[0]
is 1 and not read) from the state z0 (N-1 values), as the JAX package's
`_b_iir` scan does (runmat_tpu/accel/dense.py:706-728). A CPU tensor takes
the plain version below; a CUDA tensor launches the kernel or raises.
`launches` counts kernel launches and nothing else; `launches_by` splits
the count by dtype ("iir f32", "iir f64").

`plain_iir` is the scan's step, one sample at a time on the host, in the
scan's order of operations: y = b0 * x_i + z[0], then z = (b[1:] * x_i +
[z[1:], 0]) - a[1:] * y, over Python floats for float64 and numpy float32
scalars for float32, so that each product, sum and difference is rounded
on its own in x's type. The kernel rounds each one the same way in the same
order, so the two are bit-equal; the host loop takes a few seconds for 2^22
float64 samples, so the kernel is checked over a whole signal.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ._build import library

launches = 0
launches_by: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.float64: 1}
_NAMES = {torch.float32: "iir f32", torch.float64: "iir f64"}
MAX_COEFS = 33          # kMaxN of csrc/iir.cu: orders 1..32 (it refuses more)
_entry = None


def _kernel():
    global _entry
    if _entry is None:
        fn = library().runmat_iir
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def plain_iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
              z0: torch.Tensor) -> torch.Tensor:
    """The scan, one sample at a time on the host (flat x; b, a of N
    values; z0 of N-1); y comes back on x's device in x's dtype."""
    f64 = x.dtype == torch.float64
    scalar = float if f64 else np.float32

    def values(t):
        v = t.reshape(-1).cpu().tolist()
        return v if f64 else [scalar(e) for e in v]
    xs, bv, av = values(x), values(b), values(a)
    zero = scalar(0.0)
    z = values(z0) + [zero]
    b0 = bv[0]
    coefs = list(zip(bv[1:], av[1:], range(1, len(bv))))
    y = []
    for xi in xs:
        yi = b0 * xi + z[0]
        z = [bk * xi + z[k] - ak * yi for bk, ak, k in coefs]
        z.append(zero)
        y.append(yi)
    out = np.asarray(y, dtype=np.float64 if f64 else np.float32)
    return torch.from_numpy(out).to(x.device)


def iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
        z0: torch.Tensor) -> torch.Tensor:
    """y (flat, x's dtype) of the filter over flat x. x, b, a and z0 share
    one dtype (float32 or float64) and one device; b and a hold N = 2 ..
    MAX_COEFS values, z0 N - 1."""
    global launches
    n_coef = b.numel()
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (b, a, z0)):
        raise ValueError(f"iir: x {x.dtype}, b {b.dtype}, a {a.dtype} and "
                         f"z0 {z0.dtype} must share float32 or float64")
    if a.numel() != n_coef or z0.numel() != n_coef - 1 or n_coef < 2:
        raise ValueError(f"iir: b and a need the same N >= 2 values and z0 "
                         f"N - 1 (b {b.numel()}, a {a.numel()}, z0 "
                         f"{z0.numel()})")
    if any(t.device != x.device for t in (b, a, z0)):
        raise ValueError("iir: x, b, a and z0 must share one device")
    if x.device.type == "cpu":
        return plain_iir(x, b, a, z0)
    if x.device.type != "cuda":
        raise ValueError(f"iir: no kernel for device {x.device}")
    if n_coef > MAX_COEFS:
        raise ValueError(f"iir: the kernel takes at most {MAX_COEFS} "
                         f"coefficients, not {n_coef}")
    xv = x.reshape(-1).contiguous()
    bv, av = b.reshape(-1).contiguous(), a.reshape(-1).contiguous()
    zv = z0.reshape(-1).contiguous()
    y = torch.empty_like(xv)
    if xv.numel() == 0:
        return y
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    rc = _kernel()(_DTYPES[x.dtype], xv.data_ptr(), y.data_ptr(),
                   xv.numel(), n_coef, bv.data_ptr(), av.data_ptr(),
                   zv.data_ptr(), torch.cuda.current_stream(index).cuda_stream,
                   index)
    if rc != 0:
        raise RuntimeError(f"iir kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_by[_NAMES[x.dtype]] += 1
    return y
