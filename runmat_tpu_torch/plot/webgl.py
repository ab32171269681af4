"""Copy of runmat_tpu/plot/webgl.py in the PyTorch port.

Typed-geometry scene export for client-side WebGL rendering.

The browser host receives vertex/index buffers (base64 float32/uint8/uint32)
once per scene revision and renders them with WebGL — orbit/zoom/pan run
entirely client-side with ZERO server round trips per frame. This is the
TPU-native re-home of the reference's GPU plotting engine, where figures are
vertex buffers consumed by wgpu render pipelines and the camera lives in the
winit/egui event loop (crates/runmat-plot/src/gpu/{surface,line,scatter3,
axis}.rs, src/plots/figure.rs): here the "GPU" is the client's, the scene
graph crosses the wire as typed arrays, and the server re-renders nothing
while the user drags.

Lighting (ambient+diffuse Lambert, shade3d.py) is view-independent, so
shading is BAKED into per-vertex colors server-side; the client shader is a
plain Gouraud-interpolating pass-through. Geometry ships in normalized,
centered data coordinates (each axis mapped to [-0.5, 0.5] by the axes data
limits), so the client camera matrix is the same az/el orthographic rotation
as figure.project3.

Draw records (all vertex data base64 little-endian):
  {"kind": "tris",   "pos": f32 N*3, "col": u8 N*3, "idx": u32 M*3, "alpha"}
  {"kind": "lines",  "pos": f32 N*3, "col": u8 N*3, "width"}   # GL_LINES pairs
  {"kind": "points", "pos": f32 N*3, "col": u8 N*3, "size"}
"""

from __future__ import annotations

import base64

import numpy as np

from .colors import colormap
from .figure import Figure, Axes, nice_ticks, fmt_tick
from .shade3d import (AMBIENT, DIFFUSE, stride_for, _face_normals,
                      _vertex_normals, _light_dir, _vertex_colors)

EDGE_COLOR = (0.25, 0.25, 0.3)


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _u8(col: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(col, np.float64) * 255.0, 0, 255).astype(np.uint8)


def _norm(vals, lim):
    lo, hi = lim
    return (np.asarray(vals, np.float64) - lo) / ((hi - lo) or 1.0) - 0.5


def _tris(pos, col, idx, alpha=1.0):
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    return {"kind": "tris", "pos": _b64(pos.astype(np.float32)),
            "col": _b64(_u8(np.asarray(col).reshape(-1, 3))),
            "idx": _b64(np.asarray(idx, np.uint32).reshape(-1)),
            "nv": int(pos.shape[0]),
            "ni": int(np.asarray(idx).size),
            "alpha": float(alpha)}


def _lines(pos, col, width=1.0):
    """pos: (N, 3) endpoints of N/2 segments; col: (N, 3) or (3,)."""
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    col = np.asarray(col, np.float64)
    if col.ndim == 1:
        col = np.tile(col, (pos.shape[0], 1))
    return {"kind": "lines", "pos": _b64(pos.astype(np.float32)),
            "col": _b64(_u8(col)), "nv": int(pos.shape[0]),
            "width": float(width)}


def _points(pos, col, size=4.0):
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    col = np.asarray(col, np.float64)
    if col.ndim == 1:
        col = np.tile(col, (pos.shape[0], 1))
    return {"kind": "points", "pos": _b64(pos.astype(np.float32)),
            "col": _b64(_u8(col)), "nv": int(pos.shape[0]),
            "size": float(size)}


def _segments_from_strip(P):
    """(N, 3+K) polyline -> (2*(N-1), 3+K) GL_LINES endpoint pairs, with
    non-finite POSITIONS (first 3 columns) breaking the strip (MATLAB NaN
    line breaks). Extra columns (e.g. packed vertex colors) ride along."""
    P = np.asarray(P, np.float32)
    if P.shape[0] < 2:
        return np.zeros((0, P.shape[1]), np.float32)
    a, b = P[:-1], P[1:]
    ok = np.isfinite(a[:, :3]).all(axis=1) & np.isfinite(b[:, :3]).all(axis=1)
    out = np.empty((int(ok.sum()) * 2, P.shape[1]), np.float32)
    out[0::2] = a[ok]
    out[1::2] = b[ok]
    return out


def _grid_edge_segments(P):
    """(R, C, 3+K) vertex grid -> line segments along both grid directions."""
    segs = [_segments_from_strip(P[r]) for r in range(P.shape[0])]
    segs += [_segments_from_strip(P[:, c]) for c in range(P.shape[1])]
    segs = [s for s in segs if s.shape[0]]
    return np.concatenate(segs) if segs else np.zeros((0, P.shape[-1]),
                                                      np.float32)


def _shade(ax: Axes, vn_or_fn):
    """Lambert shade factors from unit normals (any leading shape)."""
    L = _light_dir(ax.lights)
    return AMBIENT + DIFFUSE * np.clip(np.abs(vn_or_fn @ L), 0, 1)


def _export_surface(ax, s, lims, max_faces):
    st = stride_for(s.Z.shape, max_faces)
    X, Y, Z = s.X[::st, ::st], s.Y[::st, ::st], s.Z[::st, ::st]
    C = s.C[::st, ::st]
    if X.shape[0] < 2 or X.shape[1] < 2:
        return []
    P = np.stack([_norm(X, lims[0]), _norm(Y, lims[1]),
                  _norm(Z, lims[2])], axis=-1)             # (R, C, 3)
    cm = colormap(ax.cmap)
    clim = ax.clim or (float(np.nanmin(C)), float(np.nanmax(C)))
    vcol = _vertex_colors(C, cm, clim)                      # (R, C, 3)
    lit = bool(ax.lights) and ax.lighting != "none"
    fn = _face_normals(P) if lit else None
    R, Cn = Z.shape
    draws = []
    mesh_only = s.style == "mesh"
    if not mesh_only:
        if s.style == "interp" or (lit and ax.lighting == "gouraud"):
            # shared vertices, per-vertex color (GL interpolates = Gouraud)
            col = vcol
            if lit:
                col = col * _shade(ax, _vertex_normals(fn))[..., None]
            r, c = np.meshgrid(np.arange(R - 1), np.arange(Cn - 1),
                               indexing="ij")
            v00 = (r * Cn + c).ravel()
            idx = np.stack([v00, v00 + 1, v00 + Cn + 1,
                            v00, v00 + Cn + 1, v00 + Cn], axis=1)
            draws.append(_tris(P.reshape(-1, 3), col.reshape(-1, 3),
                               idx, s.alpha))
        else:
            # flat/faceted: one color per quad -> duplicated vertices
            fcol = vcol[:-1, :-1]
            if lit:
                fcol = fcol * _shade(ax, fn)[..., None]
            quads = np.stack([P[:-1, :-1], P[:-1, 1:], P[1:, 1:], P[1:, :-1]],
                             axis=2).reshape(-1, 4, 3)      # (F, 4, 3)
            pos = quads.reshape(-1, 3)
            col = np.repeat(fcol.reshape(-1, 3), 4, axis=0)
            base = np.arange(quads.shape[0], dtype=np.uint32) * 4
            idx = np.stack([base, base + 1, base + 2,
                            base, base + 2, base + 3], axis=1)
            draws.append(_tris(pos, col, idx, s.alpha))
    if s.style in ("faceted", "mesh"):
        if mesh_only:
            # per-vertex colormap-colored wireframe (MATLAB mesh): pack
            # colors next to positions so NaN strip breaks keep endpoints
            # and colors aligned
            packed = _grid_edge_segments(np.concatenate([P, vcol], axis=-1))
            if packed.shape[0]:
                draws.append(_lines(packed[:, :3], packed[:, 3:6]))
        else:
            segs = _grid_edge_segments(P)
            if segs.shape[0]:
                draws.append(_lines(segs, EDGE_COLOR))
    return draws


def _export_trimesh(ax, t, lims, max_faces):
    V, F = t.verts, t.faces
    if F.shape[0] == 0:
        return []
    if F.shape[0] > max_faces:
        F = F[::int(np.ceil(F.shape[0] / max_faces))]
    P = np.stack([_norm(V[:, 0], lims[0]), _norm(V[:, 1], lims[1]),
                  _norm(V[:, 2], lims[2])], axis=-1)        # (N, 3)
    if t.cvals is not None:
        cm = colormap(ax.cmap)
        clim = ax.clim or (float(np.nanmin(t.cvals)), float(np.nanmax(t.cvals)))
        vcol = _vertex_colors(t.cvals, cm, clim)
    else:
        base = t.facecolor if t.facecolor is not None else (0.3, 0.5, 0.8)
        vcol = np.tile(np.asarray(base, np.float64), (V.shape[0], 1))
    lit = bool(ax.lights) and ax.lighting != "none"
    draws = []
    if t.style == "mesh":
        e01, e12, e20 = F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]
        edges = np.concatenate([e01, e12, e20]).reshape(-1)
        draws.append(_lines(P[edges], vcol[edges]))
        return draws
    if lit:
        tp = P[F]
        n = np.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0])
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.where(ln == 0, 1.0, ln)
        fshade = _shade(ax, n)                              # (M,)
        # flat shading needs per-face colors -> duplicate vertices
        pos = tp.reshape(-1, 3)
        fcol = vcol[F].mean(axis=1) * fshade[:, None]
        col = np.repeat(fcol, 3, axis=0)
        idx = np.arange(pos.shape[0], dtype=np.uint32)
        draws.append(_tris(pos, col, idx, t.alpha))
    else:
        draws.append(_tris(P, vcol, F.astype(np.uint32), t.alpha))
    if t.edgecolor is not None:
        e01, e12, e20 = F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]
        edges = np.concatenate([e01, e12, e20]).reshape(-1)
        draws.append(_lines(P[edges], np.asarray(t.edgecolor, np.float64)))
    return draws


def _export_patch(ax, p, lims):
    draws = []
    tri_pos, tri_col, lin = [], [], []
    for k, poly in enumerate(p.polys):
        poly = np.asarray(poly, np.float64)
        if poly.shape[0] < 3:
            continue
        z = poly[:, 2] if poly.shape[1] > 2 else np.zeros(poly.shape[0])
        P = np.stack([_norm(poly[:, 0], lims[0]), _norm(poly[:, 1], lims[1]),
                      _norm(z, lims[2])], axis=-1)
        if p.facecolor is not None or p.vertexcolors is not None:
            if p.vertexcolors is not None:
                vc = np.asarray(p.vertexcolors[k], np.float64)
            else:
                vc = np.tile(np.asarray(p.facecolor, np.float64),
                             (P.shape[0], 1))
            # fan triangulation
            for i in range(1, P.shape[0] - 1):
                tri_pos += [P[0], P[i], P[i + 1]]
                tri_col += [vc[0], vc[i], vc[i + 1]]
        if p.edgecolor is not None:
            closed = np.concatenate([P, P[:1]])
            lin.append(_segments_from_strip(closed))
    if tri_pos:
        pos = np.asarray(tri_pos, np.float32)
        draws.append(_tris(pos, np.asarray(tri_col),
                           np.arange(pos.shape[0], dtype=np.uint32)))
    if lin:
        segs = np.concatenate(lin)
        if segs.shape[0]:
            draws.append(_lines(segs, np.asarray(p.edgecolor, np.float64)))
    return draws


def _export_axes(ax: Axes, max_faces: int) -> dict:
    lims = ax.data_limits()
    draws = []
    for ch in ax.children:
        if ch.kind == "surface":
            draws += _export_surface(ax, ch, lims, max_faces)
        elif ch.kind == "trimesh":
            draws += _export_trimesh(ax, ch, lims, max_faces)
        elif ch.kind == "patch":
            draws += _export_patch(ax, ch, lims)
        elif ch.kind == "line":
            z = ch.z if ch.z is not None else np.zeros_like(ch.x)
            P = np.stack([_norm(ch.x, lims[0]), _norm(ch.y, lims[1]),
                          _norm(z, lims[2])], axis=-1)
            if ch.style not in (None, "none"):
                segs = _segments_from_strip(P)
                if segs.shape[0]:
                    draws.append(_lines(segs, ch.color, ch.width))
            if ch.marker:
                draws.append(_points(P, ch.color))
        elif ch.kind == "scatter":
            z = ch.z if ch.z is not None else np.zeros_like(ch.x)
            P = np.stack([_norm(ch.x, lims[0]), _norm(ch.y, lims[1]),
                          _norm(z, lims[2])], axis=-1)
            size = float(np.sqrt(np.median(ch.sizes))) if ch.sizes.size else 6.0
            draws.append(_points(P, ch.color, size))
    ticks = {}
    for name, lim in zip("xyz", lims):
        tv = nice_ticks(lim[0], lim[1])
        ticks[name] = [[float(_norm(v, lim)), fmt_tick(v)] for v in tv
                       if lim[0] <= v <= lim[1]]
    return {"rect": list(ax.rect), "view": list(ax.view),
            "lims": [list(l) for l in lims], "ticks": ticks,
            "title": ax.title, "xlabel": ax.xlabel, "ylabel": ax.ylabel,
            "zlabel": ax.zlabel, "grid": bool(ax.grid),
            "axis_off": bool(ax.axis_off), "draws": draws}


def export_scene(fig: Figure, max_faces: int = 120_000) -> dict:
    """Figure -> JSON-serializable WebGL scene (3-D axes only).

    max_faces bounds the shipped tessellation per surface — above it the
    grid is stride-decimated (the full-resolution analog of the draft-orbit
    proxy; 120k faces ≈ 1.4 MB of b64 per buffer, a one-time transfer
    after which every orbit frame is client-local).
    """
    return {"num": fig.num, "size": list(fig.size),
            "axes": [_export_axes(ax, max_faces)
                     for ax in fig.axes if ax.is3d]}
