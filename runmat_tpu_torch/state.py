"""Carry a session's state across engines and packages.

`carry_session(src, dst)` gives `dst` (a session of the port) the workspace
and the RNG position of `src`, so a script continued in `dst` computes what
it would have computed in `src`. `src` may be a session of the port or of
the JAX package: arrays cross as host numpy copies of whatever holds them
(`to_matarray`), the RNG as `(seed, key, counter)`; a sparse matrix and a
tetrahedral mesh of either package become the port's `SparseMatrix` and
`TetMesh` over copies of their arrays. Nothing here imports the JAX
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
    return None


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
