"""Copy of runmat_tpu/plot/shade3d.py in the PyTorch port.

Shaded 3-D surface rendering: Lambert lighting, flat/Gouraud shading,
painter-sorted triangle rasterization, adaptive decimation.

≙ runmat-plot's GPU surface pipeline (crates/runmat-plot/src/gpu/surface.rs:
vertex normals + per-fragment lighting uniforms; src/plots/surface.rs). The
wgpu fragment shader maps to the vectorized barycentric rasterizer in
raster.Canvas.fill_tri; the vertex-buffer decimation maps to `stride_for`,
which the interactive-orbit draft path uses to render a coarse proxy while
the mouse is down (server.py 'view' op with draft=true).

Lighting model (MATLAB defaults): ambient 0.3, diffuse 0.6 + specular
omitted (MATLAB 'flat'/'gouraud' lighting on the default material is
dominated by the ambient+diffuse terms). 'flat' lighting uses one face
normal per quad; 'gouraud' averages face normals into vertex normals and
interpolates shaded VERTEX colors across each triangle.
"""

from __future__ import annotations

import numpy as np

AMBIENT = 0.35
DIFFUSE = 0.65


def stride_for(shape, max_faces: int) -> int:
    """Grid stride so the rendered face count stays under max_faces."""
    R, C = shape
    faces = max((R - 1), 1) * max((C - 1), 1)
    s = 1
    while faces / (s * s) > max_faces:
        s += 1
    return s


def _vertex_colors(C, cmap, clim):
    lo, hi = clim
    t = (C - lo) / ((hi - lo) or 1.0)
    idx = np.clip((t * 255), 0, 255)
    idx = np.where(np.isfinite(idx), idx, 0).astype(int)
    return cmap[idx]


def _face_normals(P):
    """P: (R, C, 3) vertex grid -> unit normals per quad (R-1, C-1, 3)."""
    a = P[:-1, :-1]
    du = P[:-1, 1:] - a
    dv = P[1:, :-1] - a
    n = np.cross(du, dv)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.where(ln == 0, 1.0, ln)


def _vertex_normals(fn):
    """Average the 4 adjacent face normals onto each vertex."""
    R1, C1, _ = fn.shape
    vn = np.zeros((R1 + 1, C1 + 1, 3))
    vn[:-1, :-1] += fn
    vn[:-1, 1:] += fn
    vn[1:, :-1] += fn
    vn[1:, 1:] += fn
    ln = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.where(ln == 0, 1.0, ln)


def _light_dir(lights):
    d = np.zeros(3)
    for li in lights:
        v = np.asarray(li.position, np.float64)
        n = np.linalg.norm(v)
        if n > 0:
            d += v / n
    n = np.linalg.norm(d)
    return d / n if n > 0 else np.array([0.0, 0.0, 1.0])


def draw_surface(cv, m, ax, s, max_faces=6000):
    """Rasterize a figure.Surface through Canvas cv with mapper m."""
    from .colors import colormap

    st = stride_for(s.Z.shape, max_faces)
    X, Y, Z = s.X[::st, ::st], s.Y[::st, ::st], s.Z[::st, ::st]
    C = s.C[::st, ::st]
    if X.shape[0] < 2 or X.shape[1] < 2:
        return
    R, Cn = Z.shape
    cm = colormap(ax.cmap)
    clim = ax.clim or (float(np.nanmin(C)), float(np.nanmax(C)))
    vcol = _vertex_colors(C, cm, clim)               # (R, C, 3)

    px, py, depth = m.map3(X, Y, Z)                  # (R, C) each

    lit = ax.lights and ax.lighting != "none"
    if lit:
        # normals in normalized data space so aspect ratio doesn't skew
        lims = m.lims
        P = np.stack([
            (X - lims[0][0]) / ((lims[0][1] - lims[0][0]) or 1),
            (Y - lims[1][0]) / ((lims[1][1] - lims[1][0]) or 1),
            (Z - lims[2][0]) / ((lims[2][1] - lims[2][0]) or 1)], axis=-1)
        fn = _face_normals(P)                        # (R-1, C-1, 3)
        L = _light_dir(ax.lights)
        if ax.lighting == "gouraud":
            vn = _vertex_normals(fn)
            shade_v = AMBIENT + DIFFUSE * np.clip(
                np.abs(vn @ L), 0, 1)                # (R, C)
            vcol = vcol * shade_v[..., None]
        else:                                        # flat: per-face shade
            shade_f = AMBIENT + DIFFUSE * np.clip(
                np.abs(fn @ L), 0, 1)                # (R-1, C-1)

    interp = s.style == "interp"
    mesh_only = s.style == "mesh"
    edges = s.style in ("faceted", "mesh")

    # painter's sort: faces far-to-near by mean projected depth
    fdepth = (depth[:-1, :-1] + depth[1:, 1:]) * 0.5
    order = np.argsort(fdepth, axis=None)
    rows, cols = np.unravel_index(order, fdepth.shape)

    ecol = (0.25, 0.25, 0.3)
    for r, c in zip(rows, cols):
        q = [(r, c), (r, c + 1), (r + 1, c + 1), (r + 1, c)]
        qx = np.array([px[i] for i in q])
        qy = np.array([py[i] for i in q])
        if not (np.isfinite(qx).all() and np.isfinite(qy).all()):
            continue
        if not mesh_only:
            if interp:
                cols4 = np.array([vcol[i] for i in q])
            else:
                base = vcol[r, c]
                if lit and ax.lighting != "gouraud":
                    base = base * shade_f[r, c]
                cols4 = np.repeat(base[None, :], 4, axis=0)
                if lit and ax.lighting == "gouraud":
                    cols4 = np.array([vcol[i] for i in q])
            cv.fill_tri(qx[[0, 1, 2]], qy[[0, 1, 2]], cols4[[0, 1, 2]],
                        s.alpha)
            cv.fill_tri(qx[[0, 2, 3]], qy[[0, 2, 3]], cols4[[0, 2, 3]],
                        s.alpha)
        if edges:
            col = vcol[r, c] if mesh_only else ecol
            cv.polyline(np.append(qx, qx[0]), np.append(qy, qy[0]),
                        tuple(np.clip(col, 0, 1)), 1.0)


def surface_polys_svg(m, ax, s, max_faces=1500):
    """Flat-shaded polygons for the SVG renderer (far-to-near order):
    [(xs, ys, (r, g, b), edge_rgb_or_None), ...]."""
    from .colors import colormap

    st = stride_for(s.Z.shape, max_faces)
    X, Y, Z, C = s.X[::st, ::st], s.Y[::st, ::st], s.Z[::st, ::st], \
        s.C[::st, ::st]
    if X.shape[0] < 2 or X.shape[1] < 2:
        return []
    cm = colormap(ax.cmap)
    clim = ax.clim or (float(np.nanmin(C)), float(np.nanmax(C)))
    vcol = _vertex_colors(C, cm, clim)
    px, py, depth = m.map3(X, Y, Z)
    lit = ax.lights and ax.lighting != "none"
    if lit:
        lims = m.lims
        P = np.stack([
            (X - lims[0][0]) / ((lims[0][1] - lims[0][0]) or 1),
            (Y - lims[1][0]) / ((lims[1][1] - lims[1][0]) or 1),
            (Z - lims[2][0]) / ((lims[2][1] - lims[2][0]) or 1)], axis=-1)
        shade = AMBIENT + DIFFUSE * np.clip(
            np.abs(_face_normals(P) @ _light_dir(ax.lights)), 0, 1)
    fdepth = (depth[:-1, :-1] + depth[1:, 1:]) * 0.5
    order = np.argsort(fdepth, axis=None)
    rows, cols = np.unravel_index(order, fdepth.shape)
    out = []
    mesh_only = s.style == "mesh"
    edges = s.style in ("faceted", "mesh")
    for r, c in zip(rows, cols):
        q = [(r, c), (r, c + 1), (r + 1, c + 1), (r + 1, c)]
        qx = [float(px[i]) for i in q]
        qy = [float(py[i]) for i in q]
        base = vcol[r, c].copy()
        if lit:
            base = base * shade[r, c]
        face = None if mesh_only else tuple(np.clip(base, 0, 1))
        edge = tuple(np.clip(vcol[r, c], 0, 1)) if mesh_only else \
            ((0.25, 0.25, 0.3) if edges else None)
        out.append((qx, qy, face, edge))
    return out


def trimesh_polys(m, ax, t, max_faces=4000):
    """Painter-sorted shaded triangles for a figure.TriMesh:
    [(xs, ys, face_rgb_or_None, edge_rgb_or_None), ...]. Decimates to
    max_faces by uniform face stride (the draft-orbit proxy path)."""
    from .colors import colormap

    V, F = t.verts, t.faces
    if F.shape[0] == 0:
        return []
    if F.shape[0] > max_faces:
        F = F[::int(np.ceil(F.shape[0] / max_faces))]
    # per-vertex base colors
    if t.cvals is not None:
        cm = colormap(ax.cmap)
        clim = ax.clim or (float(np.nanmin(t.cvals)),
                           float(np.nanmax(t.cvals)))
        vcol = _vertex_colors(t.cvals, cm, clim)         # (N, 3)
    else:
        base = t.facecolor if t.facecolor is not None else (0.3, 0.5, 0.8)
        vcol = np.tile(np.asarray(base, np.float64), (V.shape[0], 1))
    px, py, depth = m.map3(V[:, 0], V[:, 1], V[:, 2])
    lit = ax.lights and ax.lighting != "none"
    fshade = None
    if lit:
        lims = m.lims
        P = np.stack([
            (V[:, 0] - lims[0][0]) / ((lims[0][1] - lims[0][0]) or 1),
            (V[:, 1] - lims[1][0]) / ((lims[1][1] - lims[1][0]) or 1),
            (V[:, 2] - lims[2][0]) / ((lims[2][1] - lims[2][0]) or 1)],
            axis=-1)
        tp = P[F]
        n = np.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0])
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.where(ln == 0, 1.0, ln)
        fshade = AMBIENT + DIFFUSE * np.clip(
            np.abs(n @ _light_dir(ax.lights)), 0, 1)     # (M,)
    fdepth = depth[F].mean(axis=1)
    order = np.argsort(fdepth)
    mesh_only = t.style == "mesh"
    out = []
    for fi in order:
        tri = F[fi]
        qx = [float(px[i]) for i in tri]
        qy = [float(py[i]) for i in tri]
        base = vcol[tri].mean(axis=0)
        if fshade is not None:
            base = base * fshade[fi]
        face = None if mesh_only else tuple(np.clip(base, 0, 1))
        if mesh_only:
            edge = tuple(np.clip(vcol[tri].mean(axis=0), 0, 1))
        else:
            edge = t.edgecolor
        out.append((qx, qy, face, edge))
    return out
