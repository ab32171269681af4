"""An LSTM layer's whole recurrence, one direction: the wrappers around
`csrc/lstm_seq.cu`, their plain PyTorch versions, the rule that picks the
path by shape, and the `torch.autograd.Function` that joins them.

The JAX package runs a direction as one `lax.scan` over `lstm_dir`'s step,
the recurrent product `Wh @ h` inside the body, and leaves its gradient to
`jax.grad` (`runmat_tpu/runtime/builtins/dl_layers.py:376-397`; no Pallas
twin). Here the input product zx = Wx x + b of every step is one
`torch.matmul` before the recurrence, laid out (4H, T, N), and the
recurrence is one launch of a thread-block cluster: `lstm_seq_fwd` runs all
T steps (the product Wh h_{t-1} and the cell), `lstm_seq_bwd` walks them
back (the cell's backward and Wh' dz_t) and writes dz (4H, T, N), which is
the gradient of zx; dWh = dz [0, h_0 .. h_{T-2}]' is one large
`torch.matmul` after it. The csrc file says how a cluster shares h and dz.

Saved for the backward (`save`): hbuf (H, T + 1, N), zeros then h_0 ..
h_{T-1} (the layer's output is the view hbuf[:, 1:]; hbuf[:, :T] is the
product's [0, h_0 .. h_{T-2}]), cs (T, H, N) and the gate activations act
(T, 4H, N). In 'last' mode the layer returns h_{T-1} alone, (H, 1, N), and
the backward reads the gradient of it alone.

`plain_seq_forward` and `plain_seq_backward` are the plain versions, the
cell `lstm.plain_forward`/`plain_backward`. With `ordered=True` every
product is formed as the kernels form it: a loop over the inner index of
z = z + w[:, k:k+1] * x[k:k+1] from zeros, then zx (or the incoming
gradient) added; the kernels equal that bit for bit on the card. With
`ordered=False` a step's product is one `torch.matmul`; the CPU path runs
that.

`layout(h, n)` picks the path by shape, never on failure: clusters of
CLUSTER blocks, where a block's shared memory holds both kernels' slices
for one column, and the fewest of them that share the n columns so that
each share fits (a batch's columns are independent: a
launch is one grid of such clusters), or (0, 0) where no cluster holds one
column, and the layer keeps the per-step path (`torch.addmm` and
`ops/lstm.py`'s cell, counted there). A CPU tensor
takes the plain versions; a CUDA tensor launches the kernels or raises
`MatError("RunMat:lstmKernel")`: a build, launch or capture that fails is
never run another way. `launches` counts the kernel launches the card
executes and `launches_by` splits them ("lstm_seq_fwd", "lstm_seq_bwd"); a
launch into a graph being captured counts in `captured`, and `replayed`
adds a graph's launches for each replay.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..errors import MatError
from . import lstm

launches = 0
launches_by: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()

# the cluster size, the largest the card runs: at dl_vowels' layer on an H100 80GB HBM3
# (700 W) 16 blocks took 0.115 / 0.166 ms a direction forward / backward,
# 8 took 0.182 / 0.203, 4 took 0.303 / 0.311 (dlbench.seq_sweep), all
# bit-equal to the ordered model
CLUSTER = 16
CLUSTER_SIZES = (4, 8, 16)   # 16 is a non-portable cluster on an H100
SMEM_LIMIT = 232448          # dynamic shared memory a block can take
BWD_UNITS = 2                # hidden units a lane carries (csrc: kBwdUnits)
STAGED = 7                   # rows of the backward's staged inputs (kStaged)

_entries: dict = {}
_prepared: set = set()
_P, _INT = ctypes.c_void_p, ctypes.c_int


def smem_bytes(h: int, n: int, c: int) -> tuple:
    """(forward, backward) dynamic shared memory of a block of a cluster
    of c, in bytes (csrc: fwd_smem, bwd_smem). Forward: its 4u gate rows of
    Wh, h in two buffers, its z, two stages of its zx rows and its c;
    backward: Wh's columns of its u units (padded to BWD_UNITS), all of
    dz_t and two of its own dz rows (rows padded to 4 floats), two stages
    of the cell's STAGED inputs, its dh and dc, and each dz row's source
    (two ints)."""
    u = -(-h // c)
    ub = -(-u // BWD_UNITS) * BWD_UNITS
    np_ = -(-n // 4) * 4
    return (4 * (h * 4 * u + 2 * h * n + 4 * u * n + 2 * 4 * u * n + u * n),
            4 * (4 * h * ub + 4 * h * np_ + 2 * 4 * u * np_ +
                 2 * STAGED * u * n + 2 * u * n + 2 * 4 * h))


def _fits(h: int, n: int, c: int) -> bool:
    return max(smem_bytes(h, n, c)) <= SMEM_LIMIT


def groups(h: int, n: int, c: int) -> int:
    """The fewest clusters of c blocks whose shares of the n columns (the
    batch: the recurrence of a column needs no other column) each fit a
    block's shared memory, or 0 where one column does not."""
    if not _fits(h, 1, c):
        return 0
    g = 1
    while not _fits(h, -(-n // g), c):
        g += 1
    return g


def layout(h: int, n: int) -> tuple:
    """(cluster size, clusters) the sequence kernels run (h, n) at, or (0,
    0) for the per-step path: CLUSTER blocks, the largest cluster, with the
    fewest clusters."""
    g = groups(h, n, CLUSTER)
    return (CLUSTER, g) if g else (0, 0)


# ------------------------------------------------------------ plain versions


def _product(w: torch.Tensor, x: torch.Tensor, ordered: bool) -> torch.Tensor:
    """w @ x; with `ordered`, over the inner index in ascending order from
    zeros, each product and sum rounded apart."""
    if not ordered:
        return torch.matmul(w, x)
    acc = x.new_zeros((w.shape[0], x.shape[1]))
    for k in range(w.shape[1]):
        acc = acc + w[:, k:k + 1] * x[k:k + 1]
    return acc


def _dwh(dz: torch.Tensor, hbuf: torch.Tensor) -> torch.Tensor:
    """dWh = sum_t dz_t h_{t-1}' as one product over (t, n)."""
    h4, n_t, n = dz.shape
    hprev = hbuf[:, :n_t, :].reshape(hbuf.shape[0], n_t * n)
    return torch.matmul(dz.reshape(h4, n_t * n), hprev.t())


def plain_seq_forward(zx: torch.Tensor, wh: torch.Tensor,
                      ordered: bool = False, save: bool = True,
                      last: bool = False) -> tuple:
    """(out, saved): out is h_0 .. h_{T-1} as (H, T, N), or h_{T-1} as (H,
    1, N) with `last`; saved is (hbuf, cs, act) with `save`, else None."""
    h4, n_t, n = zx.shape
    h = zx.new_zeros((h4 // 4, n))
    c = h
    hs, cs, acts = [h], [], []
    for t in range(n_t):
        h, c, act = lstm.plain_forward(zx[:, t, :] + _product(wh, h, ordered),
                                       c, save)
        hs.append(h)
        if save:
            cs.append(c)
            acts.append(act)
    hbuf = torch.stack(hs, 1)
    out = hbuf[:, n_t:, :].clone() if last else hbuf[:, 1:, :]
    return out, ((hbuf, torch.stack(cs), torch.stack(acts)) if save
                 else None)


def plain_seq_backward(wh: torch.Tensor, saved: tuple, dout: torch.Tensor,
                       last: bool, ordered: bool = False) -> tuple:
    """(dz (4H, T, N), dWh) from the forward's saved tensors and the
    gradient of its output."""
    hbuf, cs, act = saved
    n_t = cs.shape[0]
    dz = torch.empty((wh.shape[0], n_t, cs.shape[2]), dtype=cs.dtype,
                     device=cs.device)
    rec = dc = None
    for t in range(n_t - 1, -1, -1):
        inc = dout[:, t, :] if not last else \
            dout[:, 0, :] if t == n_t - 1 else None
        dh = inc if rec is None else rec if inc is None else rec + inc
        cprev = cs[t - 1] if t > 0 else torch.zeros_like(cs[0])
        dzt, dc = lstm.plain_backward(act[t], cprev, cs[t], dh, dc)
        dz[:, t, :] = dzt
        if t > 0:
            rec = _product(wh.t(), dzt, ordered)
    return dz, _dwh(dz, hbuf)


# ------------------------------------------------------------------ kernels


def _entry(name: str, argtypes: list, restype=ctypes.c_int):
    fn = _entries.get(name)
    if fn is None:
        from ._build import library
        try:
            fn = getattr(library(), name)
        except (RuntimeError, OSError, AttributeError) as e:
            raise MatError("RunMat:lstmKernel",
                           f"the sequence kernels could not be built or "
                           f"loaded: {str(e)[-1500:]}") from e
        fn.argtypes = argtypes
        fn.restype = restype
        _entries[name] = fn
    return fn


def kernel_smem(h: int, n: int, c: int) -> tuple:
    """The kernels' own (forward, backward) shared memory, from the
    library (what `smem_bytes` must equal)."""
    fn = _entry("runmat_lstm_seq_smem", [_INT] * 4, ctypes.c_longlong)
    return int(fn(h, n, c, 0)), int(fn(h, n, c, 1))


def _device(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def _prepare(h: int, n: int, c: int, device: int) -> None:
    """The kernels' attributes for n columns a cluster of c, once, before
    the first launch (and so before a capture of it); raises where the card
    cannot hold such a cluster."""
    key = (device, h, n, c)
    if key in _prepared:
        return
    out = (ctypes.c_int * 2)()
    rc = _entry("runmat_lstm_seq_prepare", [_INT, _INT, _INT, _INT, _P])(
        h, n, c, device, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise MatError("RunMat:lstmKernel",
                       f"lstm_seq: preparing a cluster of {c} failed: CUDA "
                       f"error {rc}")
    if min(out) < 1:
        raise MatError("RunMat:lstmKernel",
                       f"lstm_seq: a cluster of {c} blocks with "
                       f"{smem_bytes(h, n, c)} bytes of shared memory cannot "
                       f"be resident on this card ({list(out)} clusters)")
    _prepared.add(key)


def _check(what: str, *xs) -> None:
    for x in xs:
        if x is not None and (x.dtype != torch.float32 or
                              not x.is_contiguous() or
                              x.device != xs[0].device):
            raise MatError("RunMat:lstmKernel",
                           f"{what} takes contiguous float32 tensors on one "
                           f"device")


def _launched(name: str, rc: int) -> None:
    global launches
    if rc != 0:
        raise MatError("RunMat:lstmKernel",
                       f"{name} launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        launches += 1
        launches_by[name] += 1


def _layout(h: int, n: int, cluster: int | None, device: int) -> tuple:
    """(cluster size, clusters): `layout`'s, or the fewest clusters at the
    size asked for; prepared for launching."""
    c, g = layout(h, n) if cluster is None else (cluster,
                                                 groups(h, n, cluster) or 1)
    if not c:
        raise MatError("RunMat:lstmKernel",
                       f"lstm_seq: H = {h}, N = {n} does not fit a cluster "
                       f"(layout: the per-step path)")
    _prepare(h, -(-n // g), c, device)
    return c, g


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def forward(zx: torch.Tensor, wh: torch.Tensor, save: bool = True,
            last: bool = False, cluster: int | None = None) -> tuple:
    """All T steps of one direction: (out, saved) as `plain_seq_forward`
    gives them. A CPU tensor takes the plain version; a CUDA one launches
    `lstm_seq_fwd` at `cluster` blocks a cluster (default: `layout`'s)."""
    h4, n_t, n = zx.shape
    h = h4 // 4
    if h4 % 4 or tuple(wh.shape) != (h4, h) or n_t < 1 or n < 1:
        raise MatError("RunMat:lstmKernel",
                       f"lstm_seq: zx {tuple(zx.shape)}, Wh {tuple(wh.shape)}")
    if zx.device.type == "cpu":
        return plain_seq_forward(zx, wh, False, save, last)
    _check("lstm_seq", zx, wh)
    dev = _device(zx)
    c, g = _layout(h, n, cluster, dev)
    new = dict(dtype=torch.float32, device=zx.device)
    hbuf = torch.empty((h, n_t + 1, n), **new) if save or not last else None
    hlast = torch.empty((h, 1, n), **new) if last else None
    cs = torch.empty((n_t, h, n), **new) if save else None
    act = torch.empty((n_t, h4, n), **new) if save else None
    fn = _entry("runmat_lstm_seq_fwd", [_INT] * 5 + [_P] * 7 + [_INT])
    _launched("lstm_seq_fwd", fn(
        n_t, h, n, c, g, zx.data_ptr(), wh.data_ptr(), _ptr(hbuf), _ptr(hlast),
        _ptr(cs), _ptr(act), torch.cuda.current_stream(dev).cuda_stream,
        dev))
    out = hlast if last else hbuf[:, 1:, :]
    return out, ((hbuf, cs, act) if save else None)


def backward_dz(wh: torch.Tensor, cs: torch.Tensor, act: torch.Tensor,
                dout: torch.Tensor, last: bool,
                cluster: int | None = None) -> torch.Tensor:
    """dz (4H, T, N) of a CUDA direction: one launch of `lstm_seq_bwd`."""
    n_t, h, n = cs.shape
    want = (h, 1 if last else n_t, n)
    if tuple(dout.shape) != want or tuple(wh.shape) != (4 * h, h):
        raise MatError("RunMat:lstmKernel",
                       f"lstm_seq backward: dout {tuple(dout.shape)}, Wh "
                       f"{tuple(wh.shape)}, want dout {want}")
    dout = dout.contiguous()
    _check("lstm_seq backward", wh, cs, act, dout)
    dev = _device(cs)
    c, g = _layout(h, n, cluster, dev)
    dz = torch.empty((4 * h, n_t, n), dtype=torch.float32, device=cs.device)
    fn = _entry("runmat_lstm_seq_bwd", [_INT] * 5 + [_P] * 7 + [_INT])
    _launched("lstm_seq_bwd", fn(
        n_t, h, n, c, g, wh.data_ptr(), cs.data_ptr(), act.data_ptr(),
        None if last else dout.data_ptr(), dout.data_ptr() if last else None,
        dz.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, dev))
    return dz


def backward(wh: torch.Tensor, saved: tuple, dout: torch.Tensor, last: bool,
             cluster: int | None = None) -> tuple:
    """(dz (4H, T, N), dWh) as `plain_seq_backward` gives them. A CPU
    tensor takes the plain version; a CUDA one launches `lstm_seq_bwd`
    (`backward_dz`), then dWh is one torch.matmul."""
    hbuf, cs, act = saved
    if cs.device.type == "cpu":
        return plain_seq_backward(wh, saved, dout, last)
    dz = backward_dz(wh, cs, act, dout, last, cluster)
    return dz, _dwh(dz, hbuf)


class LSTMSeq(torch.autograd.Function):
    """One direction with its backward: out = LSTMSeq.apply(zx, Wh, last)."""

    @staticmethod
    def forward(ctx, zx, wh, last):
        out, saved = forward(zx.contiguous(), wh.contiguous(), True, last)
        ctx.last = last
        ctx.save_for_backward(wh, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        wh, *saved = ctx.saved_tensors
        dz, dwh = backward(wh.contiguous(), tuple(saved), dout, ctx.last)
        return dz, dwh, None


def sequence(zx: torch.Tensor, wh: torch.Tensor, last: bool) -> torch.Tensor:
    """The direction's output, (H, T, N) or (H, 1, N) with `last`;
    differentiable where grad mode needs it."""
    if torch.is_grad_enabled() and (zx.requires_grad or wh.requires_grad):
        return LSTMSeq.apply(zx, wh, last)
    return forward(zx.contiguous(), wh.contiguous(), False, last)[0]


def replayed(kernels: collections.Counter, times: int) -> None:
    """A captured graph holding `kernels` ran `times` times."""
    global launches
    for key, k in kernels.items():
        launches += k * times
        launches_by[key] += k * times
