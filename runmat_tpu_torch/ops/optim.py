"""The optimizer update of a network's learnables: a hand-written CUDA C++
kernel (`csrc/optim.cu`), one launch over every learnable, and its plain
PyTorch version.

The JAX package's training step (`runmat_tpu/runtime/builtins/
dl_layers.py:629-646`) updates each leaf of the parameter pytree with
`tree_map`s inside one `jax.jit`; XLA compiles them (no Pallas twin). The
port holds a network's learnables, their gradient and the optimizer's
moments each as one flat float32 buffer, and updates all of them in one
pass, in the JAX order of operations:

    Adam:  m = b1 m + (1 - b1) g
           v = b2 v + ((1 - b2) g) g
           p = p - (lr (m / c1)) / (sqrt(v / c2) + eps)
    SGDM:  m = 0.9 m + g
           p = p - lr m

with c1 = 1 - b1^t and c2 = 1 - b2^t computed in float64 from the step
count t and rounded to float32 (the JAX package runs with x64 on: its
`1 - b1 ** t` is a float64 scalar that meets a float32 array). The
constants are the float32 values JAX's weak-typed Python floats take. t
lives in device memory (a float64 0-d tensor), so a captured CUDA graph of
the step replays the right bias correction, and `update` advances it by
one before the step's arithmetic: the kernel does so inside its launch
(SGDM: one thread adds one; Adam: each block loads t, then adds a share
of one to it, and takes floor(what it loaded) + 1, the shares summing to
exactly one), so the step holds no launch of its own for it. Every
product, sum and quotient is rounded apart (no FMA contraction), as the
plain version's separate torch ops compute them on the card, and the
kernel equals it bit for bit there (`dlbench.held_optim`, three steps,
on an H100 with torch 2.11 and CUDA 12.8). XLA on the CPU contracts the
JAX step's products and sums into FMAs, so the plain version differs from
the JAX package's step by a few float32 ulps.

One element a thread, 512 threads a block, no reduction and no reuse:
bytes bound it (Adam reads p, g, m, v and writes p, m, v: 28 bytes an
element; SGDM 20). At the paths' 21,690 and 46,109 learnables that is
0.13-0.39 us at 3.35 TB/s, so a launch's fixed cost and a thread's chain
of IEEE divisions set its time.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (`MatError`): a failed build or launch, or a buffer that is not
contiguous float32 on p's device.
`launches` counts the launches the card executes and `launches_by` splits
them ("optim_adam", "optim_sgdm"); a launch into a graph being captured
counts in `captured`, and `replayed` adds a graph's launches for each
replay.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..errors import MatError

launches = 0
launches_by: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()

B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9
_entries: dict = {}


def f32(x: float) -> float:
    """A Python float as the float32 value JAX gives it."""
    return float(np.float32(x))


class State:
    """An optimizer's buffers beside flat learnables `p` (float32, 1-D):
    the moments m and v (zeros) and the step count t (a float64 0-d
    tensor, 0), all on `p`'s device, made once, so a captured graph of the
    step keeps their addresses."""

    def __init__(self, solver: str, p: torch.Tensor, lr: float):
        if solver not in ("adam", "sgdm"):
            raise MatError("RunMat:optimKernel", f"unknown solver {solver}")
        self.solver, self.lr = solver, float(lr)
        self.m = torch.zeros_like(p)
        self.v = torch.zeros_like(p) if solver == "adam" else None
        self.t = torch.zeros((), dtype=torch.float64, device=p.device)

    def reset(self) -> None:
        self.m.zero_()
        if self.v is not None:
            self.v.zero_()
        self.t.zero_()


def plain_update(st: State, p: torch.Tensor, g: torch.Tensor) -> None:
    """The update in torch ops, in place on p, m, v, after t += 1."""
    st.t.add_(1)
    lr = f32(st.lr)
    if st.solver == "adam":
        b = torch.full((), B1, dtype=torch.float64, device=p.device)
        c1 = (1.0 - torch.pow(b, st.t)).to(torch.float32)
        c2 = (1.0 - torch.pow(torch.full_like(b, B2), st.t)).to(torch.float32)
        m = f32(B1) * st.m + f32(1 - B1) * g
        v = f32(B2) * st.v + (f32(1 - B2) * g) * g
        den = torch.sqrt(v / c2) + f32(EPS)
        p.copy_(p - (lr * (m / c1)) / den)
        st.m.copy_(m)
        st.v.copy_(v)
    else:
        m = f32(MOMENTUM) * st.m + g
        p.copy_(p - lr * m)
        st.m.copy_(m)


def update(st: State, p: torch.Tensor, g: torch.Tensor) -> None:
    """One optimizer step over the flat learnables p with gradient g: t
    advances by one, then p, m and v are updated. A CPU tensor takes the
    plain version; a CUDA one launches the kernel once."""
    global launches
    if p.shape != g.shape or p.ndim != 1:
        raise MatError("RunMat:optimKernel",
                       f"optim update: p {tuple(p.shape)}, g "
                       f"{tuple(g.shape)}")
    if p.device.type == "cpu":
        plain_update(st, p, g)
        return
    for x in (p, g, st.m) + ((st.v,) if st.v is not None else ()):
        if x.dtype != torch.float32 or not x.is_contiguous() or \
                x.device != p.device:
            raise MatError("RunMat:optimKernel",
                           "optim update takes contiguous float32 tensors "
                           "on one device")
    if st.t.dtype != torch.float64 or st.t.device != p.device:
        raise MatError("RunMat:optimKernel",
                       "optim update: the step count is not a float64 on "
                       "p's device")
    fn = _entries.get("update")
    if fn is None:
        from ._build import library
        try:
            fn = library().runmat_optim_update
        except (RuntimeError, OSError, AttributeError) as e:
            raise MatError("RunMat:optimKernel",
                           f"the optimizer kernel could not be built or "
                           f"loaded: {str(e)[-1500:]}") from e
        P, F = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ctypes.c_int, ctypes.c_int64] + [P] * 5 + [F] * 6 + \
            [P, ctypes.c_int]
        fn.restype = ctypes.c_int
        _entries["update"] = fn
    adam = st.solver == "adam"
    dev = p.device.index if p.device.index is not None \
        else torch.cuda.current_device()
    rc = fn(int(adam), p.numel(), p.data_ptr(), g.data_ptr(),
            st.m.data_ptr(), st.v.data_ptr() if adam else None,
            st.t.data_ptr(), f32(st.lr),
            f32(B1) if adam else f32(MOMENTUM), f32(1 - B1), f32(B2),
            f32(1 - B2), f32(EPS), torch.cuda.current_stream(dev).cuda_stream,
            dev)
    name = "optim_adam" if adam else "optim_sgdm"
    if rc != 0:
        raise MatError("RunMat:optimKernel",
                       f"{name} launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        launches += 1
        launches_by[name] += 1


def replayed(kernels: collections.Counter, times: int) -> None:
    """A captured graph holding `kernels` ran `times` times."""
    global launches
    for key, k in kernels.items():
        launches += k * times
        launches_by[key] += k * times
