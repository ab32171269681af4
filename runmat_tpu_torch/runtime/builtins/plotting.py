"""Copy of runmat_tpu/runtime/builtins/plotting.py in the PyTorch port.

Plot commands: the MATLAB plotting builtin surface over runmat_tpu.plot.

Reference parity: runmat-runtime/src/builtins/plotting (83k LoC, 30+ commands)
over the runmat-plot engine. Device-resident inputs are gathered at figure
build time (the analog of the reference's zero-copy GPU vertex consumption,
export_wgpu_buffer — here the transfer is explicit and batched).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...plot import figure as figmod
from ...plot.colors import NAMED, colormap, parse_linespec
from ...plot.figure import (Axes, ImageObj, Line, Patch, Scatter, TextObj,
                            close_all, close_figure, gca, gcf)
from ...values import CellArray, MatArray, StringArray, is_text, text_of
from ..registry import builtin


def _np1(v) -> np.ndarray:
    return v.host().astype(np.float64).reshape(-1)


def _np2(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _prep_ax(hold_default=False) -> Axes:
    ax = gca()
    if not ax.hold:
        ax.children = []
        ax.color_idx = 0
        ax.is3d = False
    return ax


def _parse_pairs(rest, line_obj=None):
    """Name-value pairs ('LineWidth', 'Color', 'DisplayName', ...)."""
    i = 0
    props = {}
    while i + 1 < len(rest):
        if is_text(rest[i]):
            props[text_of(rest[i]).lower()] = rest[i + 1]
            i += 2
        else:
            i += 1
    return props


def _apply_line_props(obj, props):
    if "linewidth" in props:
        obj.width = float(_np1(props["linewidth"])[0])
    if "color" in props:
        c = props["color"]
        if is_text(c):
            obj.color = NAMED.get(text_of(c), obj.color)
        else:
            obj.color = tuple(_np1(c)[:3])
    if "displayname" in props:
        obj.label = text_of(props["displayname"])
    if "marker" in props:
        obj.marker = text_of(props["marker"])
    if "linestyle" in props:
        obj.style = text_of(props["linestyle"])


# ------------------------------------------------------------------ figures - #


@builtin("figure", category="plotting", max_in=1)
def m_figure(num=None):
    f = figmod.figure(None if num is None else int(_np1(num)[0]))
    return MatArray.scalar(float(f.num))


@builtin("close", category="plotting", max_in=1)
def m_close(which=None):
    if which is not None and is_text(which) and text_of(which) == "all":
        close_all()
    elif which is not None and isinstance(which, MatArray) and \
            which.mclass != "char":
        close_figure(int(_np1(which)[0]))
    else:
        close_figure()
    return None


@builtin("clf", category="plotting", max_in=0)
def m_clf():
    gcf().axes = [Axes()]
    gcf().current = 0
    return None


@builtin("hold", category="plotting", max_in=1)
def m_hold(mode=None):
    ax = gca()
    if mode is None:
        ax.hold = not ax.hold
    else:
        ax.hold = text_of(mode) == "on"
    return None


@builtin("subplot", category="plotting", min_in=3, max_in=3)
def m_subplot(r, c, k):
    gcf().subplot(int(_np1(r)[0]), int(_np1(c)[0]), int(_np1(k)[0]))
    return None


@builtin("tiledlayout", category="plotting", min_in=0, max_in=4)
def m_tiledlayout(r=None, c=None, *opts):
    """tiledlayout(m, n): tile grid over the current figure; 'flow' and
    spacing options are accepted (tiles map onto the subplot grid)."""
    f = gcf()
    if r is not None and is_text(r):          # tiledlayout('flow')
        f._tiled = [1, 1, 0, True]
        return None
    m = int(_np1(r)[0]) if r is not None else 1
    n = int(_np1(c)[0]) if c is not None else 1
    f._tiled = [m, n, 0, False]
    return None


@builtin("nexttile", category="plotting", min_in=0, max_in=1)
def m_nexttile(k=None):
    f = gcf()
    grid = getattr(f, "_tiled", None)
    if grid is None:
        grid = f._tiled = [1, 1, 0, True]
    if k is not None:
        grid[2] = int(_np1(k)[0])
    else:
        grid[2] += 1
    if grid[3] and grid[2] > grid[0] * grid[1]:
        # 'flow': grow the grid toward squareness
        import math as _math
        total = grid[2]
        grid[1] = int(_math.ceil(_math.sqrt(total)))
        grid[0] = int(_math.ceil(total / grid[1]))
    idx = min(grid[2], grid[0] * grid[1])
    f.subplot(grid[0], grid[1], idx)
    return None


@builtin("annotation", category="plotting", min_in=2, max_in=None)
def m_annotation(kind, pos, *opts):
    """annotation('textbox'|'textarrow'|'line'|'arrow', [x y w h], ...)
    in figure-fraction coordinates; 'String' option sets the text."""
    f = gcf()
    k = text_of(kind).lower()
    p = [float(v) for v in _np1(pos)]
    text = ""
    for i, o in enumerate(opts):
        if is_text(o) and text_of(o).lower() == "string" and \
                i + 1 < len(opts):
            text = text_of(opts[i + 1])
    if not hasattr(f, "annotations"):
        f.annotations = []
    f.annotations.append({"kind": k, "pos": p, "text": text})
    return None


@builtin("drawnow", category="plotting", max_in=0)
def m_drawnow():
    return None


# ------------------------------------------------------------------ 2-D plots #


def _plot_impl(ax, args, threed=False):
    args = list(args)
    # consume triples/pairs: x, y[, z][, linespec]
    while args:
        if threed:
            if len(args) < 3:
                break
            x, y, z = _np1(args[0]), _np1(args[1]), _np1(args[2])
            args = args[3:]
        else:
            if len(args) >= 2 and isinstance(args[1], MatArray) and \
                    args[1].mclass != "char":
                x, y = _np2(args[0]), _np2(args[1])
                args = args[2:]
            else:
                y = _np2(args[0])
                x = None
                args = args[1:]
            z = None
        spec = None
        if args and is_text(args[0]) and text_of(args[0]) and \
                all(ch in "rgbcmykw-.:ox+*sd^v<>ph" for ch in text_of(args[0])):
            spec = text_of(args[0])
            args = args[1:]
        props = _parse_pairs(args)
        color, style, marker = parse_linespec(spec) if spec else (None, None, None)
        if not threed and y.ndim == 2 and 1 not in y.shape:
            cols = [y[:, k] for k in range(y.shape[1])]
        else:
            cols = [np.asarray(y).reshape(-1)]
        for yc in cols:
            xv = np.arange(1, yc.size + 1, dtype=np.float64) if x is None \
                else np.asarray(x).reshape(-1)
            ln = Line(xv, yc, z,
                      color or ax.next_color(),
                      style or ("none" if (marker and not style) else "-"),
                      marker)
            _apply_line_props(ln, props)
            ax.add(ln)
    return None


@builtin("plot", category="plotting", min_in=1, max_in=None)
def m_plot(*args):
    ax = _prep_ax()
    return _plot_impl(ax, args)


@builtin("plot3", category="plotting", min_in=3, max_in=None)
def m_plot3(*args):
    ax = _prep_ax()
    ax.is3d = True
    return _plot_impl(ax, args, threed=True)


@builtin("loglog", category="plotting", min_in=1, max_in=None)
def m_loglog(*args):
    ax = _prep_ax()
    ax.xscale = ax.yscale = "log"
    return _plot_impl(ax, args)


@builtin("semilogx", category="plotting", min_in=1, max_in=None)
def m_semilogx(*args):
    ax = _prep_ax()
    ax.xscale = "log"
    return _plot_impl(ax, args)


@builtin("semilogy", category="plotting", min_in=1, max_in=None)
def m_semilogy(*args):
    ax = _prep_ax()
    ax.yscale = "log"
    return _plot_impl(ax, args)


@builtin("scatter", category="plotting", min_in=2, max_in=None)
def m_scatter(x, y, *rest):
    ax = _prep_ax()
    sizes = 36.0
    color = None
    rest = list(rest)
    if rest and isinstance(rest[0], MatArray) and rest[0].mclass != "char" \
            and rest[0].size:
        sizes = _np1(rest[0])
        rest = rest[1:]
    if rest and is_text(rest[0]) and text_of(rest[0]) in NAMED:
        color = NAMED[text_of(rest[0])]
        rest = rest[1:]
    sc = Scatter(_np1(x), _np1(y), None, sizes, color or ax.next_color())
    props = _parse_pairs(rest)
    if "displayname" in props:
        sc.label = text_of(props["displayname"])
    ax.add(sc)
    return None


@builtin("scatter3", category="plotting", min_in=3, max_in=None)
def m_scatter3(x, y, z, *rest):
    ax = _prep_ax()
    ax.is3d = True
    ax.add(Scatter(_np1(x), _np1(y), _np1(z), 36.0, ax.next_color()))
    return None


@builtin("bar", category="plotting", min_in=1, max_in=2)
def m_bar(a, b=None):
    ax = _prep_ax()
    if b is None:
        y = _np1(a)
        x = np.arange(1, y.size + 1, dtype=np.float64)
    else:
        x, y = _np1(a), _np1(b)
    w = 0.8 * (np.min(np.diff(np.sort(x))) if x.size > 1 else 1.0)
    color = ax.next_color()
    polys = [np.array([[xi - w / 2, 0], [xi + w / 2, 0],
                       [xi + w / 2, yi], [xi - w / 2, yi]])
             for xi, yi in zip(x, y)]
    ax.add(Patch(polys, color, (0, 0, 0)))
    return None


@builtin("barh", category="plotting", min_in=1, max_in=2)
def m_barh(a, b=None):
    ax = _prep_ax()
    if b is None:
        y = _np1(a)
        x = np.arange(1, y.size + 1, dtype=np.float64)
    else:
        x, y = _np1(a), _np1(b)
    w = 0.8
    color = ax.next_color()
    polys = [np.array([[0, xi - w / 2], [0, xi + w / 2],
                       [yi, xi + w / 2], [yi, xi - w / 2]])
             for xi, yi in zip(x, y)]
    ax.add(Patch(polys, color, (0, 0, 0)))
    return None


@builtin("histogram", category="plotting", min_in=1, max_in=2)
def m_histogram(v, nbins=None):
    ax = _prep_ax()
    h = _np1(v)
    h = h[np.isfinite(h)]
    nb = int(_np1(nbins)[0]) if nbins is not None else \
        max(4, int(np.ceil(np.sqrt(max(h.size, 1)))))
    counts, edges = np.histogram(h, bins=nb)
    color = ax.next_color()
    polys = [np.array([[edges[i], 0], [edges[i + 1], 0],
                       [edges[i + 1], counts[i]], [edges[i], counts[i]]])
             for i in range(nb)]
    ax.add(Patch(polys, color, (1, 1, 1)))
    return None


@builtin("histogram2", category="plotting", min_in=2, max_in=3)
def m_histogram2(x, y, nbins=None):
    ax = _prep_ax()
    nb = int(_np1(nbins)[0]) if nbins is not None else 16
    Hc, xe, ye = np.histogram2d(_np1(x), _np1(y), bins=nb)
    img = Hc.T[::-1] / max(Hc.max(), 1)
    cm = colormap(ax.cmap)
    rgb = cm[(img * 255).astype(int)]
    ax.add(ImageObj(rgb, (xe[0], xe[-1], ye[0], ye[-1])))
    return None


@builtin("pie", category="plotting", min_in=1, max_in=1)
def m_pie(v):
    ax = _prep_ax()
    vals = _np1(v)
    total = vals.sum() or 1.0
    th0 = np.pi / 2
    for val in vals:
        th1 = th0 - 2 * np.pi * val / total
        ts = np.linspace(th0, th1, 40)
        poly = np.vstack([[0, 0], np.stack([np.cos(ts), np.sin(ts)], axis=1)])
        ax.add(Patch([poly], ax.next_color(), (1, 1, 1)))
        th0 = th1
    ax.axis_equal = True
    ax.axis_off = True
    return None


@builtin("stairs", category="plotting", min_in=1, max_in=2)
def m_stairs(a, b=None):
    ax = _prep_ax()
    if b is None:
        y = _np1(a)
        x = np.arange(1, y.size + 1, dtype=np.float64)
    else:
        x, y = _np1(a), _np1(b)
    xs = np.repeat(x, 2)[1:]
    ys = np.repeat(y, 2)[:-1]
    ax.add(Line(xs, ys, None, ax.next_color()))
    return None


@builtin("stem", category="plotting", min_in=1, max_in=2)
def m_stem(a, b=None):
    ax = _prep_ax()
    if b is None:
        y = _np1(a)
        x = np.arange(1, y.size + 1, dtype=np.float64)
    else:
        x, y = _np1(a), _np1(b)
    color = ax.next_color()
    xs, ys = [], []
    for xi, yi in zip(x, y):
        xs += [xi, xi, np.nan]
        ys += [0.0, yi, np.nan]
    ax.add(Line(np.array(xs), np.array(ys), None, color))
    ax.add(Scatter(x, y, None, 20.0, color))
    return None


@builtin("stem3", category="plotting", min_in=1, max_in=3)
def m_stem3(a, b=None, c=None):
    """stem3(Z) / stem3(X, Y, Z): 3-D stems from the z=0 plane."""
    ax = _prep_ax()
    ax.is3d = True
    if c is None:
        if b is not None:
            raise bad_arg("stem3", "Use stem3(Z) or stem3(X, Y, Z).")
        z = _np1(a)
        x = np.arange(1, z.size + 1, dtype=np.float64)
        y = np.zeros_like(x)
    else:
        x, y, z = _np1(a), _np1(b), _np1(c)
    color = ax.next_color()
    xs, ys, zs = [], [], []
    for xi, yi, zi in zip(x, y, z):
        xs += [xi, xi, np.nan]
        ys += [yi, yi, np.nan]
        zs += [0.0, zi, np.nan]
    ax.add(Line(np.array(xs), np.array(ys), np.array(zs), color))
    ax.add(Scatter(x, y, z, 20.0, color))
    return None


@builtin("area", category="plotting", min_in=1, max_in=2)
def m_area(a, b=None):
    ax = _prep_ax()
    if b is None:
        y = _np1(a)
        x = np.arange(1, y.size + 1, dtype=np.float64)
    else:
        x, y = _np1(a), _np1(b)
    poly = np.vstack([np.stack([x, y], axis=1), [[x[-1], 0]], [[x[0], 0]]])
    ax.add(Patch([poly], ax.next_color(), (0, 0, 0)))
    return None


@builtin("fill", category="plotting", min_in=3, max_in=3)
def m_fill(x, y, c):
    ax = _prep_ax()
    color = NAMED.get(text_of(c), (0, 0, 1)) if is_text(c) else tuple(_np1(c)[:3])
    ax.add(Patch([np.stack([_np1(x), _np1(y)], axis=1)], color, (0, 0, 0)))
    return None


@builtin("errorbar", category="plotting", min_in=3, max_in=3)
def m_errorbar(x, y, e):
    ax = _prep_ax()
    xv, yv, ev = _np1(x), _np1(y), _np1(e)
    color = ax.next_color()
    ax.add(Line(xv, yv, None, color, marker="o"))
    xs, ys = [], []
    for xi, yi, ei in zip(xv, yv, ev):
        xs += [xi, xi, np.nan]
        ys += [yi - ei, yi + ei, np.nan]
    ax.add(Line(np.array(xs), np.array(ys), None, color))
    return None


@builtin("quiver", category="plotting", min_in=2, max_in=4)
def m_quiver(x, y, u=None, v=None):
    ax = _prep_ax()
    if u is None:                       # quiver(U, V): grid positions
        hu, hv = _np2(x), _np2(y)
        Y, X = np.mgrid[1:hu.shape[0] + 1, 1:hu.shape[1] + 1]
        xv, yv = X.ravel(), Y.ravel()
        uv, vv = hu.ravel(), hv.ravel()
    else:
        xv, yv, uv, vv = (_np1(a) for a in (x, y, u, v))
    color = ax.next_color()
    xs, ys = [], []
    for xi, yi, ui, vi in zip(xv, yv, uv, vv):
        xs += [xi, xi + ui, np.nan]
        ys += [yi, yi + vi, np.nan]
    ax.add(Line(np.array(xs), np.array(ys), None, color))
    return None


@builtin("imagesc", category="plotting", min_in=1, max_in=3)
def m_imagesc(*args):
    ax = _prep_ax()
    v = args[-1]
    rgb = lo = hi = None
    if getattr(v, "on_device", False):
        # device-side colormap: normalize + LUT on chip, gather u8 RGB
        # (3 bytes/px vs the 8-byte f64 field — the zero-copy analog;
        # accel/dense.py _b_cmap)
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            out = eng.dense.call("cmap", [v], (ax.cmap,))
            if out is not None:
                u8, lo_d, hi_d = out
                rgb = np.asarray(u8).astype(np.float64) / 255.0
                lo, hi = float(np.asarray(lo_d)), float(np.asarray(hi_d))
                if hi == lo:
                    hi = lo + 1
                h = np.zeros(rgb.shape[:2])   # extent-only use below
    if rgb is None:
        h = _np2(v)
        lo, hi = float(np.nanmin(h)), float(np.nanmax(h))
        if hi == lo:
            hi = lo + 1
        norm = (h - lo) / (hi - lo)
        cm = colormap(ax.cmap)
        rgb = cm[np.clip((norm * 255).astype(int), 0, 255)]
    if len(args) >= 3:
        x, y = _np1(args[0]), _np1(args[1])
        extent = (x[0], x[-1], y[-1], y[0])
    else:
        extent = (0.5, h.shape[1] + 0.5, h.shape[0] + 0.5, 0.5)
    ax.add(ImageObj(rgb[::-1] if extent[2] > extent[3] else rgb, extent))
    ax.clim = (lo, hi)
    return None


@builtin("image", category="plotting", min_in=1, max_in=1)
def m_image(v):
    return m_imagesc(v)


@builtin("pcolor", category="plotting", min_in=1, max_in=1)
def m_pcolor(v):
    return m_imagesc(v)


def _contour_args(args):
    """contour(Z[,n]) or contour(X,Y,Z[,n]) — X/Y grids only set extents."""
    args = list(args)
    if len(args) >= 3:
        z = args[2]
        n = args[3] if len(args) > 3 else None
    else:
        z = args[0]
        n = args[1] if len(args) > 1 else None
    return z, n


@builtin("contour", category="plotting", min_in=1, max_in=4)
def m_contour(*args):
    z, n = _contour_args(args)
    return _contour_impl(z, n, filled=False)


@builtin("contourf", category="plotting", min_in=1, max_in=4)
def m_contourf(*args):
    z, n = _contour_args(args)
    return _contour_impl(z, n, filled=True)


def _contour_impl(z, n, filled):
    """Marching-squares contour lines/bands."""
    ax = _prep_ax()
    h = _np2(z)
    levels = int(_np1(n)[0]) if n is not None else 8
    lo, hi = float(np.nanmin(h)), float(np.nanmax(h))
    cm = colormap(ax.cmap)
    if filled:
        norm = (h - lo) / ((hi - lo) or 1)
        rgb = cm[np.clip((norm * 255).astype(int), 0, 255)]
        ax.add(ImageObj(rgb, (1, h.shape[1], h.shape[0], 1)))
    for li in range(1, levels + 1):
        lev = lo + (hi - lo) * li / (levels + 1)
        segs_x, segs_y = _marching_squares(h, lev)
        color = cm[int(255 * (li / (levels + 1)))]
        ax.add(Line(np.array(segs_x), np.array(segs_y), None, tuple(color)))
    return None


def _marching_squares(h, lev):
    xs, ys = [], []
    R, C = h.shape
    for r in range(R - 1):
        for c in range(C - 1):
            vals = [h[r, c], h[r, c + 1], h[r + 1, c + 1], h[r + 1, c]]
            pts = []
            corners = [(c + 1, r + 1), (c + 2, r + 1), (c + 2, r + 2), (c + 1, r + 2)]
            for k in range(4):
                v1, v2 = vals[k], vals[(k + 1) % 4]
                if (v1 < lev) != (v2 < lev):
                    t = (lev - v1) / (v2 - v1)
                    x1, y1 = corners[k]
                    x2, y2 = corners[(k + 1) % 4]
                    pts.append((x1 + t * (x2 - x1), y1 + t * (y2 - y1)))
            if len(pts) >= 2:
                xs += [pts[0][0], pts[1][0], np.nan]
                ys += [pts[0][1], pts[1][1], np.nan]
    return xs, ys


# ------------------------------------------------------------------ 3-D plots #


def _surface_impl(*args, style):
    """surf(Z) / surf(X,Y,Z[,C]) -> full-resolution Surface scene node.

    The renderer shades (flat/Gouraud per ax.lighting) and decimates
    adaptively; the interactive-orbit draft path renders a coarse proxy
    (≙ runmat-plot/src/gpu/surface.rs keeping vertex buffers device-side
    and re-rasterizing per camera move)."""
    ax = _prep_ax()
    ax.is3d = True
    C = None
    if len(args) >= 3:
        X, Y, Z = (_np2(a) for a in args[:3])
        if X.ndim == 1 or 1 in X.shape:
            X, Y = np.meshgrid(X.reshape(-1), Y.reshape(-1))
        if len(args) >= 4:
            C = _np2(args[3])
    else:
        Z = _np2(args[0])
        X, Y = np.meshgrid(np.arange(1, Z.shape[1] + 1, dtype=np.float64),
                           np.arange(1, Z.shape[0] + 1, dtype=np.float64))
        if len(args) >= 2:
            C = _np2(args[1])
    if Z.ndim != 2 or Z.shape[0] < 2 or Z.shape[1] < 2:
        raise MatError("MATLAB:surf:InvalidInput",
                       "Z must be a matrix with at least 2 rows and columns.")
    s = figmod.Surface(X, Y, Z, C, style=style)
    ax.add(s)
    ax.clim = ax.clim or (float(np.nanmin(s.C)), float(np.nanmax(s.C)))
    return s


def _gobj(kind, node):
    from .plotting2 import GObj
    return GObj(kind, node)


@builtin("surf", category="plotting", min_in=1, max_in=6, pass_nargout=True)
def m_surf(*args, nargout=0):
    s = _surface_impl(*args, style="faceted")
    return _gobj("surface", s) if nargout else None


@builtin("mesh", category="plotting", min_in=1, max_in=6, pass_nargout=True)
def m_mesh(*args, nargout=0):
    s = _surface_impl(*args, style="mesh")
    return _gobj("surface", s) if nargout else None


@builtin("surfc", category="plotting", min_in=1, max_in=6)
def m_surfc(*args):
    _surface_impl(*args, style="faceted")
    return None


@builtin("waterfall", category="plotting", min_in=1, max_in=3)
def m_waterfall(*args):
    _surface_impl(*args, style="mesh")
    return None


@builtin("surfl", category="plotting", min_in=1, max_in=4)
def m_surfl(*args):
    """surf with a default light (MATLAB surfl shades without lights set)."""
    _surface_impl(*args, style="flat")
    ax = gca()
    if not ax.lights:
        ax.lights.append(figmod.Light(position=(1.0, -1.0, 1.0)))
    return None


@builtin("shading", category="plotting", min_in=1, max_in=1)
def m_shading(mode):
    """shading flat|interp|faceted — applies to all surfaces in gca."""
    mode = text_of(mode).lower()
    if mode not in ("flat", "interp", "faceted"):
        raise bad_arg("shading", "mode must be flat, interp, or faceted")
    ax = gca()
    for ch in ax.children:
        if getattr(ch, "kind", None) == "surface" and ch.style != "mesh":
            ch.style = mode
    figmod.bump_rev()
    return None


@builtin("lighting", category="plotting", min_in=1, max_in=1)
def m_lighting(mode):
    mode = text_of(mode).lower()
    if mode not in ("none", "flat", "gouraud"):
        raise bad_arg("lighting", "mode must be none, flat, or gouraud")
    gca().lighting = mode
    figmod.bump_rev()
    return None


@builtin("light", category="plotting", min_in=0, max_in=None,
         pass_nargout=True)
def m_light(*args, nargout=0):
    """light('Position',[x y z],'Color',[r g b],'Style','infinite')."""
    pos, col, style = (1.0, 0.0, 1.0), (1.0, 1.0, 1.0), "infinite"
    i = 0
    while i + 1 < len(args):
        name = text_of(args[i]).lower()
        v = args[i + 1]
        if name == "position":
            pos = tuple(_np1(v)[:3])
        elif name == "color":
            col = tuple(_np1(v)[:3]) if not is_text(v) else \
                NAMED.get(text_of(v), (1.0, 1.0, 1.0))
        elif name == "style":
            style = text_of(v).lower()
        i += 2
    li = figmod.Light(pos, col, style)
    ax = gca()
    ax.lights.append(li)
    figmod.bump_rev()
    return _gobj("light", li) if nargout else None


@builtin("camlight", category="plotting", min_in=0, max_in=2,
         pass_nargout=True)
def m_camlight(*args, nargout=0):
    """camlight [headlight|left|right] — light positioned relative to the
    camera direction derived from ax.view (az, el)."""
    mode = text_of(args[0]).lower() if args and is_text(args[0]) else "right"
    ax = gca()
    az, el = ax.view if getattr(ax, "view", None) else (-37.5, 30.0)
    daz = {"headlight": 0.0, "left": -30.0, "right": 30.0}.get(mode, 30.0)
    a, e = np.deg2rad(az + daz), np.deg2rad(el + (0 if mode == "headlight"
                                                  else 30))
    pos = (float(np.cos(e) * np.sin(a)), float(-np.cos(e) * np.cos(a)),
           float(np.sin(e)))
    li = figmod.Light(pos)
    ax.lights.append(li)
    if ax.lighting == "none":
        ax.lighting = "flat"
    figmod.bump_rev()
    return _gobj("light", li) if nargout else None


@builtin("material", category="plotting", min_in=1, max_in=4)
def m_material(*args):
    return None   # reflectance presets: accepted, renderer uses defaults


# ---------------------------------------------------------------- decorations #


def _settext(attr):
    @builtin(attr, category="plotting", min_in=1, max_in=None)
    def _f(s, *rest, _attr=attr):
        setattr(gca(), _attr, text_of(s))
        return None
    return _f


_settext("title")
_settext("xlabel")
_settext("ylabel")
_settext("zlabel")


@builtin("legend", category="plotting", max_in=None)
def m_legend(*args):
    ax = gca()
    ax.legend_on = True
    labels = []
    for a in args:
        if is_text(a):
            t = text_of(a)
            if t in ("off", "hide"):
                ax.legend_on = False
                return None
            labels.append(t)
        elif isinstance(a, CellArray):
            for k in range(a.size):
                labels.append(text_of(a.data.reshape(-1, order="F")[k]))
    ax.legend_labels = labels or None
    return None


@builtin("grid", category="plotting", max_in=1)
def m_grid(mode=None):
    ax = gca()
    ax.grid = (text_of(mode) == "on") if mode is not None else not ax.grid
    return None


@builtin("xlim", category="plotting", min_in=1, max_in=1)
def m_xlim(v):
    h = _np1(v)
    gca().xlim = (float(h[0]), float(h[1]))
    return None


@builtin("ylim", category="plotting", min_in=1, max_in=1)
def m_ylim(v):
    h = _np1(v)
    gca().ylim = (float(h[0]), float(h[1]))
    return None


@builtin("zlim", category="plotting", min_in=1, max_in=1)
def m_zlim(v):
    h = _np1(v)
    gca().zlim = (float(h[0]), float(h[1]))
    return None


@builtin("axis", category="plotting", min_in=1, max_in=1)
def m_axis(v):
    ax = gca()
    if is_text(v):
        t = text_of(v)
        if t == "equal":
            ax.axis_equal = True
        elif t == "off":
            ax.axis_off = True
        elif t == "on":
            ax.axis_off = False
        elif t == "tight":
            ax.xlim = ax.ylim = None
        return None
    h = _np1(v)
    ax.xlim = (float(h[0]), float(h[1]))
    ax.ylim = (float(h[2]), float(h[3]))
    return None


@builtin("colormap", category="plotting", max_in=1)
def m_colormap(name=None):
    if name is not None:
        gca().cmap = text_of(name)
    return None


@builtin("colorbar", category="plotting", max_in=0)
def m_colorbar():
    gca().colorbar = True
    return None


@builtin("view", category="plotting", min_in=1, max_in=2)
def m_view(a, b=None):
    ax = gca()
    if b is not None:
        ax.view = (float(_np1(a)[0]), float(_np1(b)[0]))
    else:
        h = _np1(a)
        if h.size >= 2:
            ax.view = (float(h[0]), float(h[1]))
    return None


@builtin("text", category="plotting", min_in=3, max_in=3)
def m_text(x, y, s):
    gca().add(TextObj(float(_np1(x)[0]), float(_np1(y)[0]), text_of(s)))
    return None


# --------------------------------------------------------------------- export #


_HTML_VIEWER = """<!doctype html>
<html><head><meta charset="utf-8"><title>runmat-tpu figure</title>
<style>body{margin:0;background:#fff}#wrap{overflow:hidden;width:100vw;height:100vh;cursor:grab}
#wrap svg{transform-origin:0 0}</style></head>
<body><div id="wrap">%s</div>
<script>
// pan + wheel-zoom over the embedded SVG (the headless analog of the
// reference's interactive winit/egui figure window)
const wrap=document.getElementById('wrap'),svg=wrap.querySelector('svg');
let s=1,tx=0,ty=0,drag=null;
function apply(){svg.style.transform=`translate(${tx}px,${ty}px) scale(${s})`;}
wrap.addEventListener('wheel',e=>{e.preventDefault();
  const f=e.deltaY<0?1.15:1/1.15,r=wrap.getBoundingClientRect();
  const mx=e.clientX-r.left,my=e.clientY-r.top;
  tx=mx-(mx-tx)*f; ty=my-(my-ty)*f; s*=f; apply();},{passive:false});
wrap.addEventListener('mousedown',e=>{drag=[e.clientX-tx,e.clientY-ty];
  wrap.style.cursor='grabbing';});
window.addEventListener('mousemove',e=>{if(drag){tx=e.clientX-drag[0];
  ty=e.clientY-drag[1];apply();}});
window.addEventListener('mouseup',()=>{drag=null;wrap.style.cursor='grab';});
wrap.addEventListener('dblclick',()=>{s=1;tx=ty=0;apply();});
</script></body></html>
"""


def _export(path: str):
    fig = gcf()
    low = path.lower()
    if low.endswith(".svg"):
        from ...plot.svg import render_svg
        data = render_svg(fig).encode()
    elif low.endswith(".png"):
        from ...plot.raster import render_png
        data = render_png(fig)
    elif low.endswith((".html", ".htm")):
        from ...plot.svg import render_svg
        data = (_HTML_VIEWER % render_svg(fig)).encode()
    else:
        raise bad_arg("saveas", f"Unsupported image format for '{path}' "
                      "(use .svg, .png, or .html).")
    with open(path, "wb") as f:
        f.write(data)


@builtin("saveas", category="plotting", min_in=2, max_in=3)
def m_saveas(fig, path, fmt=None):
    p = text_of(path)
    if fmt is not None:
        p = p.rsplit(".", 1)[0] + "." + text_of(fmt)
    _export(p)
    return None


@builtin("exportgraphics", category="plotting", min_in=2, max_in=2)
def m_exportgraphics(obj, path):
    _export(text_of(path))
    return None


@builtin("print", category="plotting", min_in=1, max_in=4)
def m_print(*args):
    """print('file.png') / print('-dpng', 'file') / print('file', '-dpng')
    — device flags (-dpng/-dsvg) and the filename may come in any order;
    resolution flags (-r<N>) are accepted and ignored (the SVG/PNG export
    is resolution-independent)."""
    flag = None
    path = None
    for a in args:
        t = text_of(a)
        if t.startswith("-d"):
            flag = t
        elif t.startswith("-r") or t.startswith("-f"):
            continue
        else:
            path = t
    if path is None:
        raise bad_arg("print", "No output filename given.")
    if flag == "-dpng" and not path.endswith(".png"):
        path += ".png"
    if flag == "-dsvg" and not path.endswith(".svg"):
        path += ".svg"
    _export(path)
    return None


@builtin("gcf", category="plotting", max_in=0)
def m_gcf():
    from .plotting2 import GObj
    return GObj("figure", gcf())


@builtin("gca", category="plotting", max_in=0)
def m_gca():
    from .plotting2 import GObj
    return GObj("axes", gca())
