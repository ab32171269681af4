"""Copy of runmat_tpu/fea/mesh.py in the PyTorch port.

Structured tetrahedral meshing of box domains + quality metrics.

Reference parity: runmat-meshing/tetrahedron (generate/structured_grid) and
runmat-meshing-core quality contracts. Each hex cell splits into 6 tets with
a consistent diagonal so faces are conforming.
"""

from __future__ import annotations

import numpy as np

# 6-tet decomposition of the unit hex (corner indices into the 8 hex nodes,
# consistent across neighboring cells)
_HEX_TO_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4],
    [1, 2, 3, 7], [1, 2, 7, 6], [1, 6, 7, 5],
])


class TetMesh:
    __slots__ = ("nodes", "tets", "shape", "dims", "shared")
    mclass = "femesh"

    def __init__(self, nodes: np.ndarray, tets: np.ndarray, dims, shape):
        self.nodes = nodes      # (N, 3)
        self.tets = tets        # (M, 4) int
        self.dims = dims        # (Lx, Ly, Lz)
        self.shape = shape      # (nx, ny, nz) cells
        self.shared = False

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_tets(self) -> int:
        return self.tets.shape[0]

    def volumes(self) -> np.ndarray:
        p = self.nodes[self.tets]
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        d3 = p[:, 3] - p[:, 0]
        return np.einsum("ij,ij->i", d1, np.cross(d2, d3)) / 6.0

    def quality(self) -> np.ndarray:
        """Radius-ratio quality in (0, 1]: 3*r_in/r_circ (1 = regular tet)."""
        p = self.nodes[self.tets]
        vol = np.abs(self.volumes())
        # face areas
        def area(a, b, c):
            return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        A = (area(p[:, 0], p[:, 1], p[:, 2]) + area(p[:, 0], p[:, 1], p[:, 3])
             + area(p[:, 0], p[:, 2], p[:, 3]) + area(p[:, 1], p[:, 2], p[:, 3]))
        r_in = 3 * vol / A
        # circumradius via the standard determinant formula
        a = np.linalg.norm(p[:, 1] - p[:, 0], axis=1) * \
            np.linalg.norm(p[:, 2] - p[:, 3], axis=1)
        b = np.linalg.norm(p[:, 2] - p[:, 0], axis=1) * \
            np.linalg.norm(p[:, 1] - p[:, 3], axis=1)
        c = np.linalg.norm(p[:, 3] - p[:, 0], axis=1) * \
            np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
        s = (a + b + c) / 2
        r_c = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 1e-300)) / (6 * vol)
        return np.clip(3 * r_in / np.maximum(r_c, 1e-300), 0, 1)

    def nodes_where(self, pred) -> np.ndarray:
        """Node indices satisfying a coordinate predicate."""
        return np.nonzero(pred(self.nodes))[0]

    def boundary_nodes(self, axis: int, value: float, tol=1e-9) -> np.ndarray:
        return self.nodes_where(lambda p: np.abs(p[:, axis] - value) < tol)


def box_mesh(L=(1.0, 1.0, 1.0), n=(4, 4, 4)) -> TetMesh:
    """Conforming 6-tet-per-hex mesh of an Lx x Ly x Lz box."""
    nx, ny, nz = (int(v) for v in n)
    Lx, Ly, Lz = (float(v) for v in L)
    xs = np.linspace(0, Lx, nx + 1)
    ys = np.linspace(0, Ly, ny + 1)
    zs = np.linspace(0, Lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                corners = [nid(i, j, k), nid(i + 1, j, k),
                           nid(i + 1, j + 1, k), nid(i, j + 1, k),
                           nid(i, j, k + 1), nid(i + 1, j, k + 1),
                           nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1)]
                corners = np.asarray(corners)
                tets.append(corners[_HEX_TO_TETS])
    tets = np.concatenate(tets, axis=0).astype(np.int64)
    return TetMesh(nodes, tets, (Lx, Ly, Lz), (nx, ny, nz))
