"""Copy of runmat_tpu/plot/volumetric.py in the PyTorch port.

Volume-visualization data algorithms: isosurface extraction (marching
tetrahedra), gradient normals, slice-plane sampling, streamline
integration, volume smoothing.

Reference parity: runmat-plot's volume plot family
(crates/runmat-plot/src/plots/volume.rs + gpu pipelines) and the runtime
plotting builtins (runmat-runtime/src/builtins/plotting). The algorithms
here are array-native: every stage (cell decomposition, edge
classification, interpolation, orientation) is one vectorized numpy pass
over the whole volume — no per-cell Python loop — mirroring how the
reference keeps these on the GPU.

Grid convention: MATLAB meshgrid — V has shape (ny, nx, nz); X varies
along axis 1, Y along axis 0, Z along axis 2.
"""

from __future__ import annotations

import numpy as np

# unit-cube corners (meshgrid index offsets (dy, dx, dz)) numbered
#   0:(0,0,0) 1:(1,0,0)x 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1)
#   6:(1,1,1) 7:(0,1,1)      (x = axis1, y = axis0, z = axis2)
_CORNER = [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0),
           (0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)]
# 6-tet decomposition of the cube, all sharing the 0-6 diagonal: every
# interior face is shared by two tets, so the extracted surface is
# watertight across cells as well as within them
_TETS = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
         (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]


def _tet_case_table():
    """code (4-bit hot mask) -> list of triangles, each a triple of local
    crossing edges (a, b) with a hot and b cold."""
    table = {}
    for code in range(1, 15):
        hot = [i for i in range(4) if code >> i & 1]
        cold = [i for i in range(4) if not code >> i & 1]
        if len(hot) == 1:
            h = hot[0]
            tris = [((h, cold[0]), (h, cold[1]), (h, cold[2]))]
        elif len(hot) == 3:
            c = cold[0]
            tris = [((hot[0], c), (hot[1], c), (hot[2], c))]
        else:
            (h0, h1), (c0, c1) = hot, cold
            e00, e01 = (h0, c0), (h0, c1)
            e10, e11 = (h1, c0), (h1, c1)
            tris = [(e00, e01, e11), (e00, e11, e10)]
        table[code] = tris
    return table


_CASES = _tet_case_table()


def isosurface(X, Y, Z, V, iso):
    """Marching-tetrahedra isosurface. Returns (vertices (N,3),
    faces (M,3)) with faces oriented so normals point toward decreasing V
    (out of the enclosed V > iso region, matching isonormals = -grad V).

    Vertices on shared cell edges are computed once per unique global
    edge, so the triangulation is watertight by construction."""
    V = np.asarray(V, np.float64)
    pts = np.stack([np.broadcast_to(np.asarray(X, np.float64), V.shape),
                    np.broadcast_to(np.asarray(Y, np.float64), V.shape),
                    np.broadcast_to(np.asarray(Z, np.float64), V.shape)],
                   axis=-1).reshape(-1, 3)
    vals = V.reshape(-1)
    I = np.arange(V.size).reshape(V.shape)
    ny, nx, nz = V.shape
    corner_ids = [I[dy:ny - 1 + dy, dx:nx - 1 + dx,
                    dz:nz - 1 + dz].reshape(-1)
                  for (dy, dx, dz) in _CORNER]
    cube = np.stack(corner_ids, axis=1)                 # (ncells, 8)
    tets = np.concatenate([cube[:, list(t)] for t in _TETS])  # (6n, 4)
    hot = vals[tets] > iso                              # (M, 4)
    code = hot @ np.array([1, 2, 4, 8])
    edge_list = []                                      # (K, 2) global ids
    for c, tris in _CASES.items():
        sel = tets[code == c]
        if not sel.size:
            continue
        idx = np.array(tris)                            # (k, 3, 2) local
        edge_list.append(sel[:, idx].reshape(-1, 2))    # face-major order
    if not edge_list:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    edges = np.concatenate(edge_list)                   # hot, cold columns
    ekey = np.sort(edges, axis=1)
    uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
    va, vb = vals[uniq[:, 0]], vals[uniq[:, 1]]
    t = np.clip((iso - va) / np.where(vb == va, 1.0, vb - va), 0.0, 1.0)
    verts = pts[uniq[:, 0]] + t[:, None] * (pts[uniq[:, 1]]
                                            - pts[uniq[:, 0]])
    # weld exact-duplicate vertices: when the iso passes exactly through a
    # grid node (t = 0 or 1) several edges interpolate to bit-identical
    # coordinates; merging them keeps the mesh combinatorially watertight
    verts, wmap = np.unique(verts, axis=0, return_inverse=True)
    faces = wmap[inv].reshape(-1, 3)
    # orient: normal should point from the hot side (V > iso) outward,
    # i.e. along (cold centroid - hot centroid) of the generating edges
    tri_pts = verts[faces]
    n = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
    e3 = edges.reshape(-1, 3, 2)                        # per-face edges
    outdir = (pts[e3[:, :, 1]].mean(axis=1)
              - pts[e3[:, :, 0]].mean(axis=1))          # cold - hot
    flip = np.einsum("ij,ij->i", n, outdir) < 0
    faces[flip] = faces[flip][:, ::-1]
    # drop degenerate (zero-area) triangles from edge-touching cases
    area2 = np.einsum("ij,ij->i", n, n)
    faces = faces[area2 > 0]
    return verts, faces


def _axes_of(X, Y, Z, V):
    """Extract the rectilinear axes from meshgrid inputs (or defaults)."""
    V = np.asarray(V, np.float64)
    ny, nx, nz = V.shape
    if X is None:
        return np.arange(nx, dtype=float), np.arange(ny, dtype=float), \
            np.arange(nz, dtype=float)
    X, Y, Z = (np.asarray(a, np.float64) for a in (X, Y, Z))
    return X[0, :, 0].copy(), Y[:, 0, 0].copy(), Z[0, 0, :].copy()


def trilinear(xax, yax, zax, V, P):
    """Trilinear interpolation of V (ny, nx, nz) at points P (n, 3)."""
    V = np.asarray(V, np.float64)
    P = np.asarray(P, np.float64)

    def frac(ax, q):
        i = np.clip(np.searchsorted(ax, q) - 1, 0, ax.size - 2)
        w = (q - ax[i]) / (ax[i + 1] - ax[i])
        return i, np.clip(w, 0.0, 1.0)

    ix, wx = frac(xax, P[:, 0])
    iy, wy = frac(yax, P[:, 1])
    iz, wz = frac(zax, P[:, 2])
    out = np.zeros(P.shape[0])
    for dy in (0, 1):
        for dx in (0, 1):
            for dz in (0, 1):
                w = (np.where(dy, wy, 1 - wy) * np.where(dx, wx, 1 - wx)
                     * np.where(dz, wz, 1 - wz))
                out += w * V[iy + dy, ix + dx, iz + dz]
    return out


def gradient_at(X, Y, Z, V, P):
    """Central-difference gradient of V, trilinearly sampled at P (n, 3).
    Returns (n, 3) [dV/dx, dV/dy, dV/dz]."""
    xax, yax, zax = _axes_of(X, Y, Z, V)
    V = np.asarray(V, np.float64)
    gy, gx, gz = np.gradient(V, yax, xax, zax)
    return np.stack([trilinear(xax, yax, zax, g, P)
                     for g in (gx, gy, gz)], axis=1)


def isonormals(X, Y, Z, V, verts):
    """Vertex normals = -grad V at the isosurface vertices (MATLAB
    isonormals semantics: normals point toward smaller values)."""
    return -gradient_at(X, Y, Z, V, verts)


def slice_planes(X, Y, Z, V, sx, sy, sz):
    """Sample V on axis-aligned planes. Returns a list of surface grids
    (Xs, Ys, Zs, Cs) ready to add as figure.Surface objects."""
    xax, yax, zax = _axes_of(X, Y, Z, V)
    out = []
    for x0 in np.atleast_1d(sx if sx is not None else []):
        Yg, Zg = np.meshgrid(yax, zax, indexing="ij")
        Xg = np.full_like(Yg, float(x0))
        P = np.stack([Xg.ravel(), Yg.ravel(), Zg.ravel()], axis=1)
        out.append((Xg, Yg, Zg,
                    trilinear(xax, yax, zax, V, P).reshape(Xg.shape)))
    for y0 in np.atleast_1d(sy if sy is not None else []):
        Xg, Zg = np.meshgrid(xax, zax, indexing="ij")
        Yg = np.full_like(Xg, float(y0))
        P = np.stack([Xg.ravel(), Yg.ravel(), Zg.ravel()], axis=1)
        out.append((Xg, Yg, Zg,
                    trilinear(xax, yax, zax, V, P).reshape(Xg.shape)))
    for z0 in np.atleast_1d(sz if sz is not None else []):
        Xg, Yg = np.meshgrid(xax, yax, indexing="xy")
        Zg = np.full_like(Xg, float(z0))
        P = np.stack([Xg.ravel(), Yg.ravel(), Zg.ravel()], axis=1)
        out.append((Xg, Yg, Zg,
                    trilinear(xax, yax, zax, V, P).reshape(Xg.shape)))
    return out


def stream3(X, Y, Z, U, Vv, W, seeds, step=0.1, max_steps=2000):
    """RK4 streamlines of the (U, V, W) field from seed points.
    `step` is relative to the smallest grid spacing. Integration stops
    when a line leaves the volume or stalls. Returns [(n_i, 3) arrays]."""
    xax, yax, zax = _axes_of(X, Y, Z, U)
    h = step * min(np.diff(xax).min(), np.diff(yax).min(),
                   np.diff(zax).min())
    lo = np.array([xax[0], yax[0], zax[0]])
    hi = np.array([xax[-1], yax[-1], zax[-1]])

    def vel(P):
        return np.stack([trilinear(xax, yax, zax, F, P)
                         for F in (U, Vv, W)], axis=1)

    lines = []
    for s in np.atleast_2d(np.asarray(seeds, np.float64)):
        p = s.copy()
        path = [p.copy()]
        for _ in range(max_steps):
            P = p[None, :]
            k1 = vel(P)[0]
            sp = np.linalg.norm(k1)
            if not np.isfinite(sp) or sp < 1e-12:
                break
            k1 = k1 / sp
            k2 = vel(P + 0.5 * h * k1)[0]
            k2 /= max(np.linalg.norm(k2), 1e-12)
            k3 = vel(P + 0.5 * h * k2)[0]
            k3 /= max(np.linalg.norm(k3), 1e-12)
            k4 = vel(P + h * k3)[0]
            k4 /= max(np.linalg.norm(k4), 1e-12)
            p = p + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            if (p < lo).any() or (p > hi).any():
                break
            path.append(p.copy())
        lines.append(np.array(path))
    return lines


def smooth3(V, method="box", size=3, sd=0.65):
    """Volume smoothing (MATLAB smooth3): 'box' uniform or 'gaussian'."""
    from scipy import ndimage
    V = np.asarray(V, np.float64)
    if method == "gaussian":
        return ndimage.gaussian_filter(V, sigma=float(sd), mode="nearest")
    return ndimage.uniform_filter(V, size=int(size), mode="nearest")
