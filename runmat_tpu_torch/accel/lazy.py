"""Copy of runmat_tpu/accel/lazy.py in the PyTorch port.

The lazy operation DAG: every device-resident value is a `LazyNode`, and
`TorchEngine.materialize` runs the DAG reachable from a node. Concrete
values are torch tensors. `gather` copies a tensor to the host in place of
the JAX package's `jax.device_get`. Complex values are complex64/complex128
tensors (JaxEngine's native-complex mode); the JAX package's split-plane
values do not exist here, so the node's `cplx` flag is always False.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# Node op-count cap before forced materialization: bounds trace size and
# compile time while leaving whole benchmark pipelines (10-60 ops) fused.
DEFAULT_FUSE_CAP = 96


class LazyNode:
    """One value in the device DAG. kind: 'leaf' (concrete tensor),
    'scalar' (host scalar parameter), or an op name."""

    __slots__ = ("op", "inputs", "static", "shape", "dtype", "_value",
                 "n_ops", "engine", "pinned", "dispatch_id", "cplx",
                 "__weakref__")

    def __init__(self, engine, op: str, inputs: list, static: tuple,
                 shape: tuple, dtype, value: Any = None, cplx: bool = False):
        self.engine = engine
        self.op = op
        self.inputs = inputs
        self.static = static
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.pinned = False         # workspace-bound: materialize alongside any root
        self.dispatch_id = None     # engine dispatch seq that produced .value
        self.cplx = bool(cplx)
        self.value = value          # concrete tensor for leaves / after force
        self.n_ops = (0 if op in ("leaf", "scalar")
                      else 1 + sum(i.n_ops for i in inputs))

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        """Setting a concrete device buffer enrolls this node in the engine's
        residency ledger; scalar nodes carry host payloads and stay out of
        the ledger."""
        self._value = v
        if v is not None and self.op != "scalar":
            pool = getattr(self.engine, "residency", None)
            if pool is not None:
                pool.track(self)

    # --- duck-typed device-handle protocol used by MatArray ----------------- #

    @property
    def is_complex(self) -> bool:
        return self.dtype.kind == "c" or self.cplx

    def gather(self) -> np.ndarray:
        """Materialize and copy to the host, in the logical MATLAB shape
        (device values are stored in their physical shape: vectors rank-1,
        scalars rank-0). Read-only, like a jax host copy: on the CPU the
        array shares the tensor's memory. Each call counts in the engine's
        `gathers` and `gather_bytes`, whatever its device."""
        eng = self.engine
        with eng.lock:
            t = eng.materialize(self)
            eng.stats["gathers"] += 1
            eng.stats["gather_bytes"] += int(t.nbytes)
            h = t.resolve_conj().cpu().numpy()
            h.setflags(write=False)
            # dispatches complete in program order on a device stream: a
            # blocking gather of this node proves every dispatch with id <=
            # this node's is finished
            if self.dispatch_id is not None:
                eng.gathered_seq = max(eng.gathered_seq, self.dispatch_id)
        return h if h.shape == self.shape else h.reshape(self.shape)

    def concrete(self):
        """Materialize on device without host transfer."""
        return self.engine.materialize(self)

    def __repr__(self):  # pragma: no cover
        return f"Lazy<{self.op} {self.shape} {self.dtype} ops={self.n_ops}>"


def topo_order(root: LazyNode) -> list[LazyNode]:
    seen: dict[int, LazyNode] = {}
    order: list[LazyNode] = []
    stack: list[tuple[LazyNode, bool]] = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen[id(node)] = node
        stack.append((node, True))
        if node.value is None:
            for i in node.inputs:
                stack.append((i, False))
    return order


def structure_key(root: LazyNode) -> tuple:
    """Hashable structural fingerprint of the DAG reachable from root.
    Leaves contribute (shape, dtype); scalar params contribute dtype only;
    op nodes contribute (op, static args, input slots)."""
    order = topo_order(root)
    index = {id(n): i for i, n in enumerate(order)}
    parts = []
    for n in order:
        if n.op == "scalar":
            parts.append(("S", str(n.dtype), n.cplx))
        elif n.value is not None:
            parts.append(("L", n.shape, str(n.dtype), n.cplx))
        else:
            parts.append((n.op, n.static, tuple(index[id(i)] for i in n.inputs),
                          str(n.dtype), n.shape, n.cplx))
    return tuple(parts)
