"""Copy of runmat_tpu/fea/select.py in the PyTorch port.

Face-selection tier: classify mesh nodes against B-rep face IDs.

The reference flows OCCT face identities through meshing into analysis so
boundary conditions address faces, not node coordinates
(the reference's crates/runmat-geometry/core/src/ selection/diagnostics,
runmat-meshing/cad). Here the tessellated shell carries a per-triangle
face ID (fea/brep.py), and this module closes the loop: given a tet mesh
of the part, each boundary node is assigned the ID of the nearest surface
triangle (exact point-triangle distance, vectorized over node x triangle
chunks), so ``face:N`` selectors resolve to node sets for BCs and loads.
"""

from __future__ import annotations

import numpy as np


def point_tri_dist2(pts: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Squared distance from each point to the nearest of ALL triangles.

    pts: (P, 3); tri: (F, 3, 3). Returns (P,) min squared distance and
    (P,) argmin triangle index. Exact: the closest point on a triangle is
    the plane projection when it lands inside, else the closest point on
    one of the three edges.
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]            # (F,3)
    e0, e1 = b - a, c - a
    n = np.cross(e0, e1)                                  # (F,3)
    nn = np.einsum("fj,fj->f", n, n)
    nsafe = np.where(nn > 1e-300, nn, 1.0)
    # Gram entries for barycentric solve of the in-plane projection
    d00 = np.einsum("fj,fj->f", e0, e0)
    d01 = np.einsum("fj,fj->f", e0, e1)
    d11 = np.einsum("fj,fj->f", e1, e1)
    den = d00 * d11 - d01 * d01
    dsafe = np.where(np.abs(den) > 1e-300, den, 1.0)

    P = pts.shape[0]
    best = np.full(P, np.inf)
    arg = np.zeros(P, dtype=np.int64)
    step = max(1, int(3e6 // max(tri.shape[0], 1)))
    segs = [(a, e0), (a, e1), (b, c - b)]
    for s in range(0, P, step):
        p = pts[s:s + step]                               # (Q,3)
        d = p[:, None, :] - a[None, :, :]                 # (Q,F,3)
        dp0 = np.einsum("qfj,fj->qf", d, e0)
        dp1 = np.einsum("qfj,fj->qf", d, e1)
        u = (d11 * dp0 - d01 * dp1) / dsafe               # (Q,F)
        v = (d00 * dp1 - d01 * dp0) / dsafe
        inside = (u >= 0) & (v >= 0) & (u + v <= 1) & (np.abs(den) > 1e-300)
        pn = np.einsum("qfj,fj->qf", d, n)
        plane2 = pn * pn / nsafe
        dist2 = np.where(inside, plane2, np.inf)
        for (o, e) in segs:                               # 3 edges
            ee = np.einsum("fj,fj->f", e, e)
            esafe = np.where(ee > 1e-300, ee, 1.0)
            do = p[:, None, :] - o[None, :, :]            # (Q,F,3)
            t = np.clip(np.einsum("qfj,fj->qf", do, e) / esafe, 0.0, 1.0)
            diff = do - t[..., None] * e[None, :, :]
            dist2 = np.minimum(dist2, np.einsum("qfj,qfj->qf", diff, diff))
        arg[s:s + step] = np.argmin(dist2, axis=1)
        best[s:s + step] = dist2[np.arange(dist2.shape[0]),
                                 arg[s:s + step]]
    return best, arg


def classify_nodes(nodes: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                   face_ids: np.ndarray, tol: float = None) -> np.ndarray:
    """Per-node B-rep face ID (0 = interior / not on the surface).

    A node gets the ID of its nearest surface triangle when it lies within
    `tol` of it (default: 1e-6 of the bounding-box diagonal — mesh
    boundary nodes sit exactly on the tessellated shell)."""
    nodes = np.asarray(nodes, np.float64)
    tri = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
    if tol is None:
        span = float(np.linalg.norm(verts.max(axis=0) - verts.min(axis=0)))
        tol = 1e-6 * (span or 1.0)
    d2, arg = point_tri_dist2(nodes, tri)
    ids = np.asarray(face_ids, np.int64)[arg]
    ids = np.where(d2 <= tol * tol, ids, 0)
    return ids


def face_node_sets(nodes: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                   face_ids: np.ndarray, tol: float = None) -> dict:
    """{face_id: node-index array}: a node belongs to EVERY face it lies
    on (within tol), so edge/rim nodes are members of all adjacent faces —
    the boundary-condition semantics of face selection (clamping a face
    clamps its rim)."""
    nodes = np.asarray(nodes, np.float64)
    fids = np.asarray(face_ids, np.int64)
    if tol is None:
        span = float(np.linalg.norm(verts.max(axis=0) - verts.min(axis=0)))
        tol = 1e-6 * (span or 1.0)
    uniq = [int(u) for u in np.unique(fids) if u > 0]
    out = {u: [] for u in uniq}
    tri_all = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
    for u in uniq:
        tri = tri_all[fids == u]
        d2, _ = point_tri_dist2(nodes, tri)
        hit = np.nonzero(d2 <= tol * tol)[0]
        if hit.size:
            out[u] = hit
    return {u: np.asarray(v, dtype=np.int64)
            for u, v in out.items() if len(v)}
