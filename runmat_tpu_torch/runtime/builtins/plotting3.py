"""Copy of runmat_tpu/runtime/builtins/plotting3.py in the PyTorch port.

Plotting batch 3: volume visualization + triangulated-surface commands.

Reference parity: runmat-runtime/src/builtins/plotting volume family over
runmat-plot's volume/patch pipelines (crates/runmat-plot/src/plots/
{volume,patch}.rs, gpu vertex pipelines). Data extraction lives in
plot/volumetric.py (marching tetrahedra, trilinear sampling, RK4
streamlines); rendering rides the TriMesh scene object (lit,
painter-sorted, decimating — plot/shade3d.py trimesh_polys).
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...plot import figure as figmod
from ...values import (CellArray, MatArray, StructArray, fortran_ravel,
                       is_text, text_of)
from ..registry import builtin
from .plotting import _prep_ax
from .plotting2 import GObj


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _vol_args(args, n_extra):
    """(X,Y,Z,V, *extra) or (V, *extra) -> (X, Y, Z, V, extra) with
    default meshgrid axes when only V is given."""
    args = list(args)
    if len(args) >= 4 + n_extra and getattr(args[3], "host", None):
        X, Y, Z, V = (_f(a) for a in args[:4])
        return X, Y, Z, V, args[4:]
    V = _f(args[0])
    ny, nx, nz = V.shape
    X, Y, Z = np.meshgrid(np.arange(1.0, nx + 1), np.arange(1.0, ny + 1),
                          np.arange(1.0, nz + 1))
    return X, Y, Z, V, args[1:]


def _fv_struct(verts, faces):
    return StructArray.scalar({
        "vertices": MatArray(verts, "double"),
        "faces": MatArray(faces.astype(np.float64) + 1, "double")})


@builtin("isosurface", category="plotting/volume", min_in=1,
         pass_nargout=True)
def m_isosurface(*args, nargout=0):
    """fv = isosurface(X,Y,Z,V,isovalue) / isosurface(V,isovalue):
    marching-tetrahedra extraction; with no output, draws the surface."""
    from ...plot.volumetric import isosurface
    X, Y, Z, V, extra = _vol_args(args, 1)
    if not extra:
        raise bad_arg("isosurface", "Missing isovalue.")
    iso = float(_f(extra[0]).reshape(-1)[0])
    verts, faces = isosurface(X, Y, Z, V, iso)
    if nargout:
        return _fv_struct(verts, faces)
    ax = _prep_ax()
    ax.is3d = True
    t = figmod.TriMesh(verts, faces, cvals=verts[:, 2], style="interp")
    ax.add(t)
    return None


@builtin("isonormals", category="plotting/volume", min_in=2)
def m_isonormals(*args):
    """n = isonormals(X,Y,Z,V,vertices) / isonormals(V,vertices):
    vertex normals from -grad V (point toward smaller values)."""
    from ...plot.volumetric import isonormals
    X, Y, Z, V, extra = _vol_args(args, 1)
    if not extra:
        raise bad_arg("isonormals", "Missing vertices.")
    vts = extra[0]
    if isinstance(vts, StructArray) and "vertices" in vts.fields:
        vts = vts.get_scalar_field("vertices")
    return MatArray(isonormals(X, Y, Z, V, _f(vts)), "double")


@builtin("slice", category="plotting/volume", min_in=4, pass_nargout=True)
def m_slice(*args, nargout=0):
    """slice(X,Y,Z,V,sx,sy,sz) / slice(V,sx,sy,sz): axis-aligned volume
    slices rendered as colormapped surfaces."""
    from ...plot.volumetric import slice_planes
    X, Y, Z, V, extra = _vol_args(args, 3)
    if len(extra) < 3:
        raise bad_arg("slice", "Expected sx, sy, sz slice positions.")
    sx, sy, sz = (fortran_ravel(_f(a)) for a in extra[:3])
    ax = _prep_ax()
    ax.is3d = True
    last = None
    for (Xg, Yg, Zg, Cg) in slice_planes(X, Y, Z, V, sx, sy, sz):
        last = figmod.Surface(Xg, Yg, Zg, Cg, style="flat")
        ax.add(last)
    if last is not None:
        cs = [ch.C for ch in ax.children if ch.kind == "surface"]
        ax.clim = (min(float(np.nanmin(c)) for c in cs),
                   max(float(np.nanmax(c)) for c in cs))
    return GObj("surface", last) if (nargout and last is not None) else None


@builtin("stream3", category="plotting/volume", min_in=6, max_in=9)
def m_stream3(*args):
    """xyz = stream3(X,Y,Z,U,V,W,sx,sy,sz): streamline vertex arrays."""
    from ...plot.volumetric import stream3
    if len(args) == 9:
        X, Y, Z, U, V, W = (_f(a) for a in args[:6])
        seeds = np.stack([fortran_ravel(_f(a)) for a in args[6:9]], axis=1)
    else:
        U, V, W = (_f(a) for a in args[:3])
        ny, nx, nz = U.shape
        X, Y, Z = np.meshgrid(np.arange(1.0, nx + 1),
                              np.arange(1.0, ny + 1),
                              np.arange(1.0, nz + 1))
        seeds = np.stack([fortran_ravel(_f(a)) for a in args[3:6]], axis=1)
    lines = stream3(X, Y, Z, U, V, W, seeds)
    data = np.empty((1, len(lines)), dtype=object)
    for i, ln in enumerate(lines):
        data[0, i] = MatArray(ln, "double")
    return CellArray(data)


@builtin("stream2", category="plotting/volume", min_in=4, max_in=6)
def m_stream2(*args):
    """xy = stream2(X,Y,U,V,sx,sy): planar streamlines (z-extruded)."""
    from ...plot.volumetric import stream3
    if len(args) == 6:
        X2, Y2, U2, V2 = (_f(a) for a in args[:4])
        sx, sy = (fortran_ravel(_f(a)) for a in args[4:6])
    else:
        U2, V2 = (_f(a) for a in args[:2])
        ny, nx = U2.shape
        X2, Y2 = np.meshgrid(np.arange(1.0, nx + 1),
                             np.arange(1.0, ny + 1))
        sx, sy = (fortran_ravel(_f(a)) for a in args[2:4])
    # extrude to a 2-layer volume with w == 0
    def ext(A):
        return np.repeat(A[:, :, None], 2, axis=2)
    Z3 = np.zeros_like(ext(X2))
    Z3[:, :, 1] = 1.0
    lines = stream3(ext(X2), ext(Y2), Z3, ext(U2), ext(V2),
                    np.zeros_like(ext(U2)),
                    np.stack([sx, sy, np.zeros_like(sx)], axis=1))
    data = np.empty((1, len(lines)), dtype=object)
    for i, ln in enumerate(lines):
        data[0, i] = MatArray(ln[:, :2], "double")
    return CellArray(data)


@builtin("streamline", category="plotting/volume", min_in=1,
         pass_ctx=True)
def m_streamline(*args, ctx=None):
    """streamline(X,Y,Z,U,V,W,sx,sy,sz) or streamline(xyz_cell):
    draws the integrated field lines."""
    if isinstance(args[0], CellArray):
        lines = [c.host() for c in args[0].data.reshape(-1)]
    else:
        xyz = m_stream3(*args) if len(args) >= 9 else m_stream2(*args)
        lines = [c.host() for c in xyz.data.reshape(-1)]
    ax = _prep_ax()
    for ln in lines:
        ln = np.asarray(ln, np.float64)
        if ln.shape[0] < 2:
            continue
        z = ln[:, 2] if ln.shape[1] > 2 else None
        if z is not None:
            ax.is3d = True
        ax.add(figmod.Line(ln[:, 0], ln[:, 1], z=z,
                           color=(0.0, 0.35, 0.74)))
    return None


@builtin("smooth3", category="plotting/volume", min_in=1, max_in=4)
def m_smooth3(v, method=None, size=None, sd=None):
    from ...plot.volumetric import smooth3
    meth = text_of(method).lower() if method is not None else "box"
    return MatArray(smooth3(_f(v), meth,
                            int(_f(size).reshape(-1)[0]) if size is not None
                            else 3,
                            float(_f(sd).reshape(-1)[0]) if sd is not None
                            else 0.65), "double")


def _tri_impl(tri, x, y, z, c, style, nargout, rest=()):
    ax = _prep_ax()
    ax.is3d = True
    F = _f(tri).astype(np.int64) - 1
    verts = np.stack([fortran_ravel(_f(a)) for a in (x, y, z)], axis=1)
    cvals = fortran_ravel(_f(c)) if c is not None else verts[:, 2]
    if cvals.size == F.shape[0]:
        # per-face colors: average onto vertices for the interp pipeline
        acc = np.zeros(verts.shape[0])
        cnt = np.zeros(verts.shape[0])
        for k in range(3):
            np.add.at(acc, F[:, k], cvals)
            np.add.at(cnt, F[:, k], 1.0)
        cvals = acc / np.maximum(cnt, 1.0)
    t = figmod.TriMesh(verts, F, cvals=cvals, style=style,
                       edgecolor=(0.25, 0.25, 0.3) if style != "mesh"
                       else None)
    i = 0
    rest = list(rest)
    while i + 1 < len(rest):
        name = text_of(rest[i]).lower() if is_text(rest[i]) else ""
        val = rest[i + 1]
        if name == "facecolor" and is_text(val):
            if text_of(val).lower() == "none":
                t.style = "mesh"
        elif name == "edgecolor" and is_text(val) \
                and text_of(val).lower() == "none":
            t.edgecolor = None
        elif name == "facealpha":
            t.alpha = float(_f(val).reshape(-1)[0])
        i += 2
    ax.add(t)
    ax.clim = ax.clim or (float(np.nanmin(t.cvals)),
                          float(np.nanmax(t.cvals)))
    return GObj("trimesh", t) if nargout else None


@builtin("trisurf", category="plotting/volume", min_in=4,
         pass_nargout=True)
def m_trisurf(tri, x, y, z, c=None, *rest, nargout=0):
    """trisurf(T, x, y, z[, c]): filled triangulated surface."""
    if c is not None and is_text(c):
        rest = (c,) + rest
        c = None
    return _tri_impl(tri, x, y, z, c, "interp", nargout, rest)


@builtin("trimesh", category="plotting/volume", min_in=4,
         pass_nargout=True)
def m_trimesh(tri, x, y, z, c=None, *rest, nargout=0):
    """trimesh(T, x, y, z[, c]): wireframe triangulated surface."""
    if c is not None and is_text(c):
        rest = (c,) + rest
        c = None
    return _tri_impl(tri, x, y, z, c, "mesh", nargout, rest)


# --------------------------------------------------- shape generators ---- #

@builtin("peaks", category="plotting/volume", min_in=0, max_in=1,
         pass_nargout=True)
def m_peaks(n=None, nargout=0):
    """The MATLAB peaks demo function on an n x n grid (default 49)."""
    k = int(_f(n).reshape(-1)[0]) if n is not None else 49
    x = np.linspace(-3.0, 3.0, k)
    X, Y = np.meshgrid(x, x)
    Z = (3 * (1 - X) ** 2 * np.exp(-X ** 2 - (Y + 1) ** 2)
         - 10 * (X / 5 - X ** 3 - Y ** 5) * np.exp(-X ** 2 - Y ** 2)
         - 1.0 / 3 * np.exp(-(X + 1) ** 2 - Y ** 2))
    if nargout >= 3:
        return [MatArray(X, "double"), MatArray(Y, "double"),
                MatArray(Z, "double")]
    if nargout == 0:
        from .plotting import _surface_impl
        _surface_impl(MatArray(X, "double"), MatArray(Y, "double"),
                      MatArray(Z, "double"), style="faceted")
        return None
    return MatArray(Z, "double")


@builtin("cylinder", category="plotting/volume", min_in=0, max_in=2,
         pass_nargout=True)
def m_cylinder(r=None, n=None, nargout=0):
    """[X,Y,Z] = cylinder(r, n): unit-height revolution surface with
    profile r (scalar or vector of radii along z)."""
    prof = fortran_ravel(_f(r)) if r is not None else np.array([1.0, 1.0])
    if prof.size == 1:
        prof = np.array([prof[0], prof[0]])
    m = int(_f(n).reshape(-1)[0]) if n is not None else 20
    th = np.linspace(0, 2 * np.pi, m + 1)
    zl = np.linspace(0.0, 1.0, prof.size)
    X = prof[:, None] * np.cos(th)[None, :]
    Y = prof[:, None] * np.sin(th)[None, :]
    Z = np.repeat(zl[:, None], m + 1, axis=1)
    out = [MatArray(X, "double"), MatArray(Y, "double"),
           MatArray(Z, "double")]
    if nargout >= 2:
        return out
    from .plotting import _surface_impl
    _surface_impl(out[0], out[1], out[2], style="faceted")
    return None


@builtin("ellipsoid", category="plotting/volume", min_in=6, max_in=7,
         pass_nargout=True)
def m_ellipsoid(xc, yc, zc, xr, yr, zr, n=None, nargout=0):
    """[X,Y,Z] = ellipsoid(xc,yc,zc,xr,yr,zr,n)."""
    m = int(_f(n).reshape(-1)[0]) if n is not None else 20
    th = np.linspace(-np.pi / 2, np.pi / 2, m + 1)      # latitude
    ph = np.linspace(-np.pi, np.pi, m + 1)              # longitude
    T, P = np.meshgrid(th, ph, indexing="ij")
    cx, cy, cz, rx, ry, rz = (float(_f(a).reshape(-1)[0])
                              for a in (xc, yc, zc, xr, yr, zr))
    X = cx + rx * np.cos(T) * np.cos(P)
    Y = cy + ry * np.cos(T) * np.sin(P)
    Z = cz + rz * np.sin(T)
    out = [MatArray(X, "double"), MatArray(Y, "double"),
           MatArray(Z, "double")]
    if nargout >= 2:
        return out
    from .plotting import _surface_impl
    _surface_impl(out[0], out[1], out[2], style="faceted")
    return None
