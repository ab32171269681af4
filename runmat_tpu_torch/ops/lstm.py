"""One LSTM step's elementwise cell: a hand-written Triton kernel for its
forward and one for its backward, their plain PyTorch versions, and the
`torch.autograd.Function` that joins them.

The JAX package runs an LSTM layer as a `lax.scan` whose body is
`lstm_dir`'s `step` (`runmat_tpu/runtime/builtins/dl_layers.py:380-391`),
and leaves its gradient to `jax.grad`; XLA compiles both (no Pallas twin).
The port runs the scan as a loop over the time steps: a step is one
product of the recurrent weights (`torch.addmm`, cuBLAS) and one launch of
this cell. Given z = Wx x_t + Wh h + b, (4H, N) float32 in the gate order
i, f, g, o, and the cell state c, (H, N) float32:

    i, f, o = sigmoid(z_i), sigmoid(z_f), sigmoid(z_o)
    g = tanh(z_g)
    c' = f c + i g
    h' = o tanh(c')

with sigmoid(x) = 1 / (1 + exp(-x)). The forward saves the four gate
activations, (4H, N), for the backward, which gives dz (4H, N) and dc (H,
N) from dh' and dc' (either may be absent: zeros):

    t = tanh(c')
    dc_all = dc' + (dh' o) (1 - t t)
    dz_i = (dc_all g) (i (1 - i))      dz_f = (dc_all c) (f (1 - f))
    dz_g = (dc_all i) (1 - g g)        dz_o = (dh' t) (o (1 - o))
    dc = dc_all f

Both kernels are one elementwise pass over H*N lanes, a lane reading its
four gates (rows k*H .. k*H + H - 1 of z, contiguous blocks of H*N): no
reduction and no reuse, so bytes bound them (forward: 5 HN floats read, 6
written with the activations, 2 without; backward: 8 read, 5 written).
At the path's H = 100, N = 27 that is under 0.05 us of bytes at 3.35 TB/s:
a launch's fixed cost sets their time. Each product and sum is rounded
apart (the launch turns FMA contraction off), the divisions are IEEE
(`tl.div_rn`), exp and tanh are libdevice's, as the plain version's
separate torch ops compute them on the card: both kernels equal the plain
version bit for bit there (`dlbench.held_cell`, on an H100 with torch
2.11 and CUDA 12.8).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (`MatError`): nothing falls back. `launches` counts the kernel
launches the card executes and `launches_by` splits them ("lstm_fwd",
"lstm_bwd"); a launch into a graph being captured counts in `captured`,
and `replayed` adds a graph's launches for each replay.
"""

from __future__ import annotations

import collections

import torch

from ..errors import MatError

launches = 0
launches_by: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()

# a lane an element: dl_vowels' 2,700 lanes take 22 programs (at 1,024 a
# program they took 3, and the cell read 5.2 us against 3.2 for
# aten._thnn_fused_lstm_cell on an H100)
BLOCK = 128
WARPS = 4

SOURCE = '''"""The LSTM cell (runmat_tpu_torch/ops/lstm.py)."""
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def _sigmoid(x):
    return tl.div_rn(1.0, 1.0 + libdevice.exp(-x))


@triton.jit
def lstm_fwd(z, c, h_out, c_out, act, HN, SAVE: tl.constexpr,
             BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < HN
    i = _sigmoid(tl.load(z + offs, mask=m, other=0.0))
    f = _sigmoid(tl.load(z + HN + offs, mask=m, other=0.0))
    g = libdevice.tanh(tl.load(z + 2 * HN + offs, mask=m, other=0.0))
    o = _sigmoid(tl.load(z + 3 * HN + offs, mask=m, other=0.0))
    cc = tl.load(c + offs, mask=m, other=0.0)
    c2 = f * cc + i * g
    tl.store(c_out + offs, c2, mask=m)
    tl.store(h_out + offs, o * libdevice.tanh(c2), mask=m)
    if SAVE:
        tl.store(act + offs, i, mask=m)
        tl.store(act + HN + offs, f, mask=m)
        tl.store(act + 2 * HN + offs, g, mask=m)
        tl.store(act + 3 * HN + offs, o, mask=m)


@triton.jit
def lstm_bwd(act, c, c2, dh, dc2, dz, dc, HN, HAS_DH: tl.constexpr,
             HAS_DC: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < HN
    i = tl.load(act + offs, mask=m, other=0.0)
    f = tl.load(act + HN + offs, mask=m, other=0.0)
    g = tl.load(act + 2 * HN + offs, mask=m, other=0.0)
    o = tl.load(act + 3 * HN + offs, mask=m, other=0.0)
    cc = tl.load(c + offs, mask=m, other=0.0)
    t = libdevice.tanh(tl.load(c2 + offs, mask=m, other=0.0))
    if HAS_DH:
        dhv = tl.load(dh + offs, mask=m, other=0.0)
    else:
        dhv = tl.zeros([BLOCK], tl.float32)
    dca = (dhv * o) * (1.0 - t * t)
    if HAS_DC:
        dca = tl.load(dc2 + offs, mask=m, other=0.0) + dca
    tl.store(dz + offs, (dca * g) * (i * (1.0 - i)), mask=m)
    tl.store(dz + HN + offs, (dca * cc) * (f * (1.0 - f)), mask=m)
    tl.store(dz + 2 * HN + offs, (dca * i) * (1.0 - g * g), mask=m)
    tl.store(dz + 3 * HN + offs, (dhv * t) * (o * (1.0 - o)), mask=m)
    tl.store(dc + offs, dca * f, mask=m)
'''


# ------------------------------------------------------------ plain versions


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), as the kernels write it."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def plain_forward(z: torch.Tensor, c: torch.Tensor, save: bool = True):
    """(h', c', the gate activations (4H, N) or None)."""
    i, f, g, o = z.chunk(4, 0)
    i, f, g, o = sigmoid(i), sigmoid(f), torch.tanh(g), sigmoid(o)
    c2 = f * c + i * g
    h2 = o * torch.tanh(c2)
    return h2, c2, (torch.cat([i, f, g, o]) if save else None)


def plain_backward(act, c, c2, dh, dc2):
    """(dz, dc) from the saved activations, c, c' and dh', dc' (None:
    zeros)."""
    i, f, g, o = act.chunk(4, 0)
    t = torch.tanh(c2)
    dhv = torch.zeros_like(c) if dh is None else dh
    dca = (dhv * o) * (1.0 - t * t)
    if dc2 is not None:
        dca = dc2 + dca
    dz = torch.cat([(dca * g) * (i * (1.0 - i)),
                    (dca * c) * (f * (1.0 - f)),
                    (dca * i) * (1.0 - g * g),
                    (dhv * t) * (o * (1.0 - o))])
    return dz, dca * f


# ------------------------------------------------------------------ kernels


def _module():
    from . import fused
    return fused.module(SOURCE)


def _check(what: str, *xs) -> None:
    for x in xs:
        if x is not None and (x.dtype != torch.float32 or
                              not x.is_contiguous() or
                              x.device != xs[0].device):
            raise MatError("RunMat:lstmKernel",
                           f"{what} takes contiguous float32 tensors on one "
                           f"device")


def _count(name: str) -> None:
    global launches
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        launches += 1
        launches_by[name] += 1


def _launch(name: str, args: list, consts: dict, hn: int) -> None:
    from . import fused
    try:
        fused._run(_module(), name, (-(-hn // BLOCK),), args,
                   dict(consts, BLOCK=BLOCK), WARPS)
    except MatError:
        raise
    except Exception as e:      # boundary: compile or launch
        raise MatError("RunMat:lstmKernel",
                       f"{name} failed: {type(e).__name__}: "
                       f"{str(e)[-1500:]}") from e
    _count(name)


def forward(z: torch.Tensor, c: torch.Tensor, save: bool = True):
    """One cell forward: (h', c', activations or None). A CPU tensor takes
    the plain version; a CUDA one launches `lstm_fwd`."""
    h4, n = z.shape
    if tuple(c.shape) != (h4 // 4, n) or h4 % 4:
        raise MatError("RunMat:lstmKernel",
                       f"lstm cell: z {tuple(z.shape)}, c {tuple(c.shape)}")
    if z.device.type == "cpu":
        return plain_forward(z, c, save)
    _check("lstm cell", z, c)
    h2 = torch.empty_like(c)
    c2 = torch.empty_like(c)
    act = torch.empty_like(z) if save else h2
    _launch("lstm_fwd", [z, c, h2, c2, act, c.numel()], {"SAVE": save},
            c.numel())
    return h2, c2, (act if save else None)


def backward(act, c, c2, dh, dc2):
    """One cell backward: (dz, dc). A CPU tensor takes the plain version; a
    CUDA one launches `lstm_bwd`."""
    if act.device.type == "cpu":
        return plain_backward(act, c, c2, dh, dc2)
    _check("lstm cell backward", act, c, c2, dh, dc2)
    dz = torch.empty_like(act)
    dc = torch.empty_like(c)
    _launch("lstm_bwd", [act, c, c2, c if dh is None else dh,
                         c if dc2 is None else dc2, dz, dc, c.numel()],
            {"HAS_DH": dh is not None, "HAS_DC": dc2 is not None},
            c.numel())
    return dz, dc


class LSTMCell(torch.autograd.Function):
    """The cell with its backward: (h', c') = LSTMCell.apply(z, c)."""

    @staticmethod
    def forward(ctx, z, c):
        h2, c2, act = forward(z.contiguous(), c.contiguous(), save=True)
        ctx.save_for_backward(act, c, c2)
        return h2, c2

    @staticmethod
    def backward(ctx, dh, dc2):
        act, c, c2 = ctx.saved_tensors
        return backward(act, c.contiguous(), c2,
                        None if dh is None else dh.contiguous(),
                        None if dc2 is None else dc2.contiguous())


def cell(z: torch.Tensor, c: torch.Tensor) -> tuple:
    """(h', c') of one step; differentiable where grad mode needs it."""
    if torch.is_grad_enabled() and (z.requires_grad or c.requires_grad):
        return LSTMCell.apply(z, c)
    h2, c2, _ = forward(z.contiguous(), c.contiguous(), save=False)
    return h2, c2


def replayed(kernels: collections.Counter, times: int) -> None:
    """A captured graph holding `kernels` ran `times` times."""
    global launches
    for key, k in kernels.items():
        launches += k * times
        launches_by[key] += k * times
