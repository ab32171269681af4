"""Copy of runmat_tpu/plot/figure.py in the PyTorch port.

Figure/Axes scene graph + layout (ticks, limits, legend, 3-D projection).

Reference parity: runmat-plot scene graph + figure lifecycle
(crates/runmat-plot/src/plots/figure.rs, gpu pipelines per plot type).
Graphics objects here are plain data; rendering happens in svg.py/raster.py.
"""

from __future__ import annotations

import math

import numpy as np

from .colors import COLOR_ORDER, colormap


class Line:
    kind = "line"

    def __init__(self, x, y, z=None, color=(0, 0, 0), style="-", marker=None,
                 width=1.5, label=None):
        self.x = np.asarray(x, dtype=np.float64).reshape(-1)
        self.y = np.asarray(y, dtype=np.float64).reshape(-1)
        self.z = None if z is None else np.asarray(z, np.float64).reshape(-1)
        self.color = color
        self.style = style or "-"
        self.marker = marker
        self.width = width
        self.label = label


class Scatter:
    kind = "scatter"

    def __init__(self, x, y, z=None, sizes=36.0, color=(0, 0, 0), marker="o",
                 label=None):
        self.x = np.asarray(x, np.float64).reshape(-1)
        self.y = np.asarray(y, np.float64).reshape(-1)
        self.z = None if z is None else np.asarray(z, np.float64).reshape(-1)
        self.sizes = np.broadcast_to(np.asarray(sizes, np.float64).reshape(-1),
                                     self.x.shape).copy()
        self.color = color
        self.marker = marker
        self.label = label


class Patch:
    """Filled polygon(s): bars, areas, pie wedges, fills, contour bands."""
    kind = "patch"

    def __init__(self, polys, facecolor, edgecolor=None, label=None,
                 depth=None, vertexcolors=None):
        self.polys = polys          # list of (N,2) float arrays (data coords)
        self.facecolor = facecolor
        self.edgecolor = edgecolor
        self.label = label
        self.depth = depth          # painter's key for 3-D
        # per-poly (N,3) RGB arrays -> Gouraud 'interp' face shading
        # (≙ FaceVertexCData + FaceColor='interp';
        #  reference: runmat-plot/src/plots/surface.rs vertex pipelines)
        self.vertexcolors = vertexcolors


class Surface:
    """Full-resolution surf/mesh data: kept un-tessellated so the renderer
    can shade (flat/Gouraud) and DECIMATE adaptively per render — the
    interactive-orbit draft path re-renders a coarse proxy while dragging
    (≙ runmat-plot/src/gpu/surface.rs keeping vertex buffers on device)."""
    kind = "surface"

    def __init__(self, X, Y, Z, C=None, style="faceted", alpha=1.0,
                 label=None):
        self.X = np.asarray(X, np.float64)
        self.Y = np.asarray(Y, np.float64)
        self.Z = np.asarray(Z, np.float64)
        self.C = self.Z if C is None else np.asarray(C, np.float64)
        self.style = style          # 'faceted' | 'flat' | 'interp' | 'mesh'
        self.alpha = float(alpha)
        self.label = label
        self.depth = None


class TriMesh:
    """Indexed triangle soup: isosurfaces, trisurf/trimesh, FEA results.
    Rendered lit + painter-sorted like Surface, but over arbitrary
    connectivity (≙ runmat-plot patch/volume vertex pipelines)."""
    kind = "trimesh"

    def __init__(self, verts, faces, cvals=None, facecolor=None,
                 edgecolor=None, style="flat", alpha=1.0, label=None):
        self.verts = np.asarray(verts, np.float64)       # (N, 3)
        self.faces = np.asarray(faces, np.int64)         # (M, 3)
        # per-vertex scalars -> colormap; None -> solid facecolor
        self.cvals = None if cvals is None else \
            np.asarray(cvals, np.float64).reshape(-1)
        self.facecolor = facecolor
        self.edgecolor = edgecolor
        self.style = style          # 'flat' | 'interp' | 'mesh'
        self.alpha = float(alpha)
        self.label = label


class Light:
    """Infinite (directional) light (≙ MATLAB light object; reference:
    runmat-plot/src/gpu/{surface,axis}.rs lighting uniforms)."""
    kind = "light"

    def __init__(self, position=(1.0, 0.0, 1.0), color=(1.0, 1.0, 1.0),
                 style="infinite"):
        self.position = tuple(float(v) for v in position)
        self.color = tuple(float(v) for v in color)
        self.style = style


class ImageObj:
    kind = "image"

    def __init__(self, data_rgb, extent):
        self.data = data_rgb        # (H, W, 3) floats 0..1
        self.extent = extent        # (x0, x1, y0, y1)


class TextObj:
    kind = "text"

    def __init__(self, x, y, s, size=10, color=(0, 0, 0), anchor="middle",
                 rotate=0):
        self.x, self.y, self.s = float(x), float(y), str(s)
        self.size = size
        self.color = color
        self.anchor = anchor
        self.rotate = rotate


class Axes:
    def __init__(self, rect=(0.13, 0.11, 0.775, 0.815)):
        self.rect = rect            # figure-fraction (left, bottom, w, h)
        self.children: list = []
        self.title = ""
        self.xlabel = ""
        self.ylabel = ""
        self.zlabel = ""
        self.xlim = None            # None = auto
        self.ylim = None
        self.zlim = None
        self.xscale = "linear"
        self.yscale = "linear"
        self.hold = False
        self.grid = False
        self.legend_on = False
        self.legend_labels = None
        self.color_idx = 0
        self.is3d = False
        self.view = (-37.5, 30.0)   # MATLAB default az/el
        self.cmap = "parula"
        self.colorbar = False
        self.clim = None
        self.axis_equal = False
        self.axis_off = False
        self.lights: list = []      # Light objects (empty = unlit render)
        self.lighting = "flat"      # 'none' | 'flat' | 'gouraud'

    def next_color(self):
        c = COLOR_ORDER[self.color_idx % len(COLOR_ORDER)]
        self.color_idx += 1
        return c

    def add(self, obj):
        self.children.append(obj)
        bump_rev()

    def reset(self):
        self.__init__(self.rect)
        bump_rev()

    # -- limits ---------------------------------------------------------------

    def data_limits(self):
        xs, ys, zs = [], [], []
        for ch in self.children:
            if ch.kind in ("line", "scatter"):
                xs.append(ch.x)
                ys.append(ch.y)
                if ch.z is not None:
                    zs.append(ch.z)
            elif ch.kind == "patch":
                for p in ch.polys:
                    p = np.asarray(p)
                    xs.append(p[:, 0])
                    ys.append(p[:, 1])
                    if p.shape[1] > 2:
                        zs.append(p[:, 2])
            elif ch.kind == "image":
                x0, x1, y0, y1 = ch.extent
                xs.append(np.array([x0, x1]))
                ys.append(np.array([y0, y1]))
            elif ch.kind == "surface":
                xs.append(ch.X.reshape(-1))
                ys.append(ch.Y.reshape(-1))
                zs.append(ch.Z.reshape(-1))
            elif ch.kind == "trimesh":
                xs.append(ch.verts[:, 0])
                ys.append(ch.verts[:, 1])
                zs.append(ch.verts[:, 2])
        def rng(vals, lim):
            if lim is not None:
                return lim
            if not vals:
                return (0.0, 1.0)
            v = np.concatenate(vals)
            v = v[np.isfinite(v)]
            if v.size == 0:
                return (0.0, 1.0)
            lo, hi = float(v.min()), float(v.max())
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            return lo, hi
        return rng(xs, self.xlim), rng(ys, self.ylim), rng(zs, self.zlim)


def nice_ticks(lo: float, hi: float, target: int = 6):
    """Nice tick positions covering [lo, hi]."""
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo, hi]
    span = hi - lo
    raw = span / max(target - 1, 1)
    mag = 10 ** math.floor(math.log10(raw))
    for mult in (1, 2, 2.5, 5, 10):
        if raw <= mult * mag:
            step = mult * mag
            break
    start = math.ceil(lo / step) * step
    ticks = []
    t = start
    while t <= hi + 1e-12 * span:
        ticks.append(round(t, 12))
        t += step
    return ticks or [lo, hi]


def fmt_tick(v: float) -> str:
    if v == int(v) and abs(v) < 1e7:
        return str(int(v))
    a = abs(v)
    if a >= 1e5 or (0 < a < 1e-3):
        return f"{v:.2e}"
    return f"{v:g}"


class Figure:
    def __init__(self, num: int = 1, size=(800, 600)):
        self.num = num
        self.size = size
        self.axes: list[Axes] = [Axes()]
        self.current = 0

    @property
    def ax(self) -> Axes:
        return self.axes[self.current]

    def subplot(self, rows: int, cols: int, idx: int) -> Axes:
        """MATLAB subplot: lazily switch to/create the (rows,cols,idx) axes."""
        key = (rows, cols, idx)
        r = (idx - 1) // cols
        c = (idx - 1) % cols
        mx, my = 0.08, 0.08
        w = (1 - mx * (cols + 1)) / cols
        h = (1 - my * (rows + 1)) / rows
        rect = (mx + c * (w + mx), 1 - (my + h) * (r + 1) + my * r * 0, w, h)
        rect = (mx + c * (w + mx), 1 - (r + 1) * (h + my), w, h)
        for i, ax in enumerate(self.axes):
            if getattr(ax, "_subplot_key", None) == key:
                self.current = i
                return ax
        ax = Axes(rect)
        ax._subplot_key = key  # type: ignore[attr-defined]
        if len(self.axes) == 1 and not self.axes[0].children and \
                getattr(self.axes[0], "_subplot_key", None) is None:
            self.axes = []
        self.axes.append(ax)
        self.current = len(self.axes) - 1
        return ax


# ------------------------------------------------------------------ registry #

_FIGURES: dict[int, Figure] = {}
_CURRENT: list[int] = [1]

# monotone scene revision: every mutation bumps it, so hosts can long-poll
# for live figure updates (≙ the reference GUI's redraw-on-change loop,
# runmat-plot/src/gui/) without re-rendering unchanged scenes
_REV: list[int] = [0]


_TOUCH: list = []        # figure numbers touched, in order (bounded)
_TOUCH_BASE = [0]        # entries trimmed off the front (keeps marks valid)


def bump_rev() -> None:
    _REV[0] += 1
    _TOUCH.append(_CURRENT[0])
    if len(_TOUCH) > 4096:
        del _TOUCH[:2048]
        _TOUCH_BASE[0] += 2048


def touch_log_len() -> int:
    return _TOUCH_BASE[0] + len(_TOUCH)


def touched_since(mark: int) -> list:
    """Figure numbers mutated since the mark (for the execution ABI's
    figures_touched; ≙ SessionExecutionResult.figures_touched)."""
    return sorted(set(_TOUCH[max(mark - _TOUCH_BASE[0], 0):]))


def scene_rev() -> int:
    return _REV[0]


def figure(num=None) -> Figure:
    if num is None:
        num = max(_FIGURES) + 1 if _FIGURES else 1
    num = int(num)
    if num not in _FIGURES:
        _FIGURES[num] = Figure(num)
    _CURRENT[0] = num
    return _FIGURES[num]


def gcf() -> Figure:
    if _CURRENT[0] not in _FIGURES:
        _FIGURES[_CURRENT[0]] = Figure(_CURRENT[0])
    return _FIGURES[_CURRENT[0]]


def gca() -> Axes:
    return gcf().ax


def current_figure():
    return _FIGURES.get(_CURRENT[0])


def close_figure(num=None):
    n = _CURRENT[0] if num is None else int(num)
    _FIGURES.pop(n, None)
    if _FIGURES:
        _CURRENT[0] = max(_FIGURES)
    else:
        _CURRENT[0] = 1
    bump_rev()


def close_all():
    _FIGURES.clear()
    _CURRENT[0] = 1
    bump_rev()


# --------------------------------------------------------------- projection  #

def project3(ax: Axes, x, y, z, lims):
    """Orthographic 3-D -> 2-D projection with the MATLAB az/el convention.
    Returns screen-plane (u, v) in normalized data space plus depth."""
    (x0, x1), (y0, y1), (z0, z1) = lims
    nx = (np.asarray(x) - x0) / (x1 - x0 or 1) - 0.5
    ny = (np.asarray(y) - y0) / (y1 - y0 or 1) - 0.5
    nz = (np.asarray(z) - z0) / (z1 - z0 or 1) - 0.5
    az = math.radians(ax.view[0])
    el = math.radians(ax.view[1])
    u = nx * math.cos(az) + ny * math.sin(az)
    t = -nx * math.sin(az) + ny * math.cos(az)
    v = t * math.sin(el) * -1 + nz * math.cos(el)
    depth = t * math.cos(el) + nz * math.sin(el)
    return u, v, depth
