"""Carry a session's state across engines and packages.

`carry_session(src, dst)` gives `dst` (a session of the port) the workspace
and the RNG position of `src`, so a script continued in `dst` computes what
it would have computed in `src`. `src` may be a session of the port or of
the JAX package: arrays cross as host numpy copies of whatever holds them
(`to_matarray`), the RNG as `(seed, key, counter)`; a sparse matrix and a
tetrahedral mesh of either package become the port's `SparseMatrix` and
`TetMesh` over copies of their arrays, and a dlnetwork the port's
`DlNetwork` with the same learnables. Nothing here imports the JAX
package; its values are read through their attributes.
"""

from __future__ import annotations

import copy

import numpy as np

from .values import MatArray


def to_matarray(v) -> MatArray:
    """A numpy array, or any array value with `host()` and `mclass` (a
    MatArray of either package, on any device), as the port's host
    MatArray. A numpy array takes the class of its dtype."""
    if isinstance(v, np.ndarray):
        return MatArray.from_np(v.copy())
    return MatArray(np.array(v.host(), copy=True), v.mclass)


def to_numpy(v: MatArray) -> np.ndarray:
    """A port MatArray as a writable numpy array in its MATLAB shape."""
    return np.array(v.host(), copy=True)


def to_port_value(v):
    """A sparse matrix (`SparseMatrix`) or a mesh (`TetMesh`) of either
    package as the port's own, over copies of its arrays; None for any
    other value."""
    kind = type(v).__name__
    if kind == "SparseMatrix":
        from .sparse import SparseMatrix
        return SparseMatrix(v.m, v.n, v.indptr.copy(), v.rowind.copy(),
                            v.data.copy(), v.mclass)
    if kind == "TetMesh":
        from .fea.mesh import TetMesh
        return TetMesh(v.nodes.copy(), v.tets.copy(), copy.deepcopy(v.dims),
                       copy.deepcopy(v.shape))
    if kind == "DlNetwork":
        return _dlnetwork(v)
    return None


def _leaves(p) -> list:
    """A parameter pytree's arrays, depth first (`Learnables` order)."""
    if isinstance(p, (tuple, list)):
        return [a for e in p for a in _leaves(e)]
    return [np.asarray(p, dtype=np.float32).reshape(-1)]


def _dlnetwork(v):
    """A dlnetwork of either package as the port's, on the active
    engine's device: the same layers, loss and seed, its learnables
    through numpy into the port's flat leaf in the same nesting."""
    from .runtime.builtins.dl_layers import DlNetwork
    layers = [{k: (to_matarray(x) if hasattr(x, "host") and
                   hasattr(x, "mclass") else copy.deepcopy(x))
               for k, x in ly.items()} for ly in v.layers]
    arrays = v.learnables_np() if hasattr(v, "learnables_np") \
        else _leaves(v.params)
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in arrays] or [np.zeros(0, np.float32)])
    net = DlNetwork(layers, seed=getattr(v, "seed", 0), flat=flat)
    net.loss_kind = v.loss_kind
    return net


def carry_session(src, dst) -> None:
    for name, v in src.base_frame.vars.items():
        port = to_port_value(v)
        if port is not None:
            v = port
        elif hasattr(v, "host") and hasattr(v, "mclass"):
            v = to_matarray(v)
        else:
            v = copy.deepcopy(v)
        dst.base_frame.vars[name] = v
    dst.rng.seed, dst.rng.key, dst.rng.counter = src.rng.state_tuple()
