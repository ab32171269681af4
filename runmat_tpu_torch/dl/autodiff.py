"""Copy of runmat_tpu/dl/autodiff.py in the PyTorch port.

dlarray reverse-mode autodiff: torch.autograd over the engine's lazy op-DAG.

Reference parity: the tape-based autodiff of the reference's deep-learning
toolbox (runmat-runtime/src/builtins/deep_learning/autodiff.rs:12-40 —
thread-local tape with per-op Node kinds). As in the JAX package, the
engine's lazy DAG *is* the tape: dlfeval runs the MATLAB function with an
uncapped fusion window so every op lands in one DAG, and dlgradient
replays the DAG's program (`TorchEngine._build_program`) op by op through
the eager executor (`TorchEngine._exec`) with the differentiated leaves
requiring grad, then asks `torch.autograd.grad` for the gradients. This is
the JAX package's own route (it runs `_exec` under `jax.grad`); the
generated Triton kernels have no backward and are not used here.

Every op of the executor that a dlarray snippet reaches is a torch op with
a backward (an indexed write is `index_copy_` into a clone, which autograd
differentiates). Two differ from jax where the derivative is a choice: `max2`/
`min2` run as torch.fmax/fmin, whose gradient goes to the first operand
where the two are equal, where `jnp.fmax(a, b) = where(a > b | isnan(b),
a, b)` gives it to the second (relu(0) has gradient 0 there); and the
gradient of abs at 0 is 0 in torch, 1 in jax. The replay computes max2 and
min2 as that `where` and abs with jax's derivative (`_Abs`), so the
gradients equal jax's there too; the values are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import MatError
from ..values import MatArray


class _Abs(torch.autograd.Function):
    """abs with jax's derivative of a real x: 1 where x >= 0, else -1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _exec(eng, op: str, static: tuple, dt: np.dtype, args: list,
          in_shapes: tuple, out_shape: tuple):
    """One op of the replay: `eng._exec`, but real max2/min2 as jnp.fmax/
    fmin write them and real abs with jax's derivative."""
    if op == "u:abs" and args[0].is_floating_point():
        return eng._tensor(_Abs.apply(eng._tensor(args[0], dt)), dt)
    if op in ("b:max2", "b:min2") and not any(a.is_complex() for a in args):
        work = np.dtype(static[0])
        if work.kind == "f":
            a = eng._tensor(args[0], work)
            b = eng._tensor(args[1], work)
            la, lb = in_shapes
            if a.ndim and b.ndim and tuple(la) != tuple(lb):
                a, b = a.reshape(la), b.reshape(lb)
                if a.ndim < b.ndim:
                    a = a.reshape(a.shape + (1,) * (b.ndim - a.ndim))
                elif b.ndim < a.ndim:
                    b = b.reshape(b.shape + (1,) * (a.ndim - b.ndim))
            pick = (a > b) if op == "b:max2" else (a < b)
            r = torch.where(pick | torch.isnan(b), a, b)
            return eng._to_phys(eng._tensor(r, dt), out_shape)
    return eng._exec(op, static, dt, args, in_shapes, out_shape)


def grad(loss: MatArray, wrt: list) -> list:
    """d(loss)/d(wrt_i) for a scalar device-resident loss whose DAG contains
    each wrt value as a leaf."""
    from ..accel import active_engine
    from ..accel.lazy import LazyNode, topo_order

    eng = active_engine()
    if eng is None:
        raise MatError("MATLAB:dlgradient:noEngine",
                       "dlgradient requires the accel engine.")
    if not (isinstance(loss, MatArray) and loss.on_device and loss.size == 1):
        raise MatError("MATLAB:dlgradient:scalarLoss",
                       "dlgradient requires a scalar traced (dlarray) loss. "
                       "Make sure the loss was computed from dlarray inputs "
                       "inside dlfeval and was not gathered.")
    for w in wrt:
        if not (isinstance(w, MatArray) and w.on_device
                and w.dev.value is not None):
            raise MatError("MATLAB:dlgradient:untraced",
                           "dlgradient targets must be dlarray leaves that "
                           "participated in the loss computation.")

    order = topo_order(loss.dev)
    index = {id(n): i for i, n in enumerate(order)}
    for w in wrt:
        if id(w.dev) not in index:
            raise MatError("MATLAB:dlgradient:unusedVariable",
                           "A dlgradient target does not participate in the "
                           "traced loss (was it used inside dlfeval?).")

    program = eng._build_program(order)
    wrt_ids = {id(w.dev): k for k, w in enumerate(wrt)}
    # the DAG leaves that are differentiated, by program index
    wrt_slot: dict[int, int] = {}
    for i, n in enumerate(order):
        if n.op != "scalar" and n.value is not None and id(n) in wrt_ids:
            wrt_slot[i] = wrt_ids[id(n)]

    # the JAX package's cache key and counters (`compiles` the first time a
    # program is differentiated, `cache_hits` after); torch compiles nothing
    key = ("dlgrad", tuple(
        (p[0], p[1], str(p[2]), p[3], p[4], p[5],
         wrt_slot.get(i, -1)) for i, p in enumerate(program)))
    if key in eng._jit_cache:
        eng.stats["cache_hits"] += 1
    else:
        eng._jit_cache[key] = None
        eng.stats["compiles"] += 1

    leaves = [w.dev.value.detach().requires_grad_() for w in wrt]
    values = eng._program_values(order)
    with torch.enable_grad():
        env: list = [None] * len(program)
        for i, (op, static, dt, in_idx, ishapes, oshape) in \
                enumerate(program):
            if op == "__leaf__":
                env[i] = leaves[wrt_slot[i]] if i in wrt_slot else values[i]
            elif op == "scalar":
                env[i] = values[i]
            else:
                env[i] = _exec(eng, op, static, dt, [env[j] for j in in_idx],
                               ishapes, oshape)
        out = env[-1].reshape(())
        grads = torch.autograd.grad(out, leaves, allow_unused=True)
    eng.stats["dispatches"] += 1
    result = []
    for w, leaf, g in zip(wrt, leaves, grads):
        g = torch.zeros_like(leaf) if g is None else g.detach()
        node = LazyNode(eng, "leaf", [], (), tuple(w.shape), w.dev.dtype,
                        value=g)
        ga = MatArray.from_device(node, w.mclass)
        ga.dl = True
        result.append(ga)
    return result
