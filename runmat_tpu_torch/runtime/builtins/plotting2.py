"""Copy of runmat_tpu/runtime/builtins/plotting2.py in the PyTorch port.

Plotting batch 2: handle-graphics object model (get/set/findobj/groot),
axes property commands, and the long tail of plot commands.

Reference parity: runmat-runtime/src/builtins/plotting/ops/ (69 commands over
the runmat-plot scene graph). Handles are `GObj` values wrapping scene-graph
nodes (Figure/Axes/series), with MATLAB property names routed through the
built-in-object field protocols; `get`/`set` are the function forms.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...plot import figure as figmod
from ...values import (CellArray, MatArray, StringArray, StructArray,
                       fortran_ravel, is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num
from .plotting import _prep_ax, _np1


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


# ----------------------------------------------------------- handle object --- #

class GObj:
    """Graphics handle: Type in {'root','figure','axes','line','scatter',
    'patch','image','text','surface','animatedline'} wrapping the scene node."""

    mclass = "matlab.graphics.Graphics"
    shared = False

    def __init__(self, gtype: str, target):
        self.gtype = gtype
        self.target = target

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self     # handles are reference semantics

    # -- property table -- #

    def _props(self) -> dict:
        t, o = self.gtype, self.target
        if t == "figure":
            return {"Number": MatArray.scalar(float(o.num)),
                    "Type": MatArray.char_from_str("figure"),
                    "Children": _handle_array([GObj("axes", a) for a in o.axes]),
                    "Position": MatArray(np.array(
                        [[0.0, 0.0, float(o.size[0]), float(o.size[1])]]), "double")}
        if t == "axes":
            ch = [GObj(getattr(c, "kind", "line"), c) for c in o.children]
            lims = o.data_limits()
            props = {
                "Type": MatArray.char_from_str("axes"),
                "Children": _handle_array(ch),
                "XLim": MatArray(np.array([list(o.xlim or lims[0])]), "double"),
                "YLim": MatArray(np.array([list(o.ylim or lims[1])]), "double"),
                "XScale": MatArray.char_from_str(o.xscale),
                "YScale": MatArray.char_from_str(o.yscale),
                "Title": MatArray.char_from_str(o.title),
                "XLabel": MatArray.char_from_str(o.xlabel),
                "YLabel": MatArray.char_from_str(o.ylabel),
                "NextPlot": MatArray.char_from_str("add" if o.hold else "replace"),
                "Box": MatArray.char_from_str(
                    "on" if getattr(o, "box", False) else "off"),
                "XTick": MatArray(np.asarray(
                    getattr(o, "xticks", np.zeros(0))).reshape(1, -1), "double"),
                "YTick": MatArray(np.asarray(
                    getattr(o, "yticks", np.zeros(0))).reshape(1, -1), "double"),
            }
            return props
        if t == "root":
            figs = [GObj("figure", f) for f in figmod._FIGURES.values()]
            return {"Type": MatArray.char_from_str("root"),
                    "Children": _handle_array(figs),
                    "ScreenSize": MatArray(np.array([[1.0, 1, 1920, 1080]]), "double")}
        # series objects
        props = {"Type": MatArray.char_from_str(t)}
        for name, attr in (("XData", "x"), ("YData", "y"), ("ZData", "z"),
                           ("LineWidth", "width"), ("Color", "color"),
                           ("String", "s")):
            v = getattr(o, attr, None)
            if v is None:
                continue
            if isinstance(v, str):
                props[name] = MatArray.char_from_str(v)
            elif isinstance(v, tuple):
                props[name] = MatArray(np.array([list(v)], dtype=np.float64), "double")
            else:
                props[name] = MatArray(np.asarray(v, dtype=np.float64)
                                       .reshape(1, -1), "double")
        return props

    def _mat_get_field_(self, fname):
        p = self._props()
        if fname in p:
            return p[fname]
        return NotImplemented

    _AXES_SET = {
        "XLim": ("xlim", "pair"), "YLim": ("ylim", "pair"), "ZLim": ("zlim", "pair"),
        "XScale": ("xscale", "text"), "YScale": ("yscale", "text"),
        "Title": ("title", "text"), "XLabel": ("xlabel", "text"),
        "YLabel": ("ylabel", "text"), "XTick": ("xticks", "vec"),
        "YTick": ("yticks", "vec"), "Box": ("box", "onoff"),
    }

    def _mat_set_field_(self, fname, value):
        if self.gtype == "axes":
            spec = self._AXES_SET.get(fname)
            if spec is None:
                return NotImplemented
            attr, kind = spec
            if kind == "pair":
                setattr(self.target, attr, tuple(_f(value).reshape(-1)[:2]))
            elif kind == "text":
                setattr(self.target, attr, text_of(value))
            elif kind == "vec":
                setattr(self.target, attr, _f(value).reshape(-1))
            elif kind == "onoff":
                setattr(self.target, attr, text_of(value) == "on")
            return True
        if self.gtype in ("line", "scatter"):
            if fname == "XData":
                self.target.x = _f(value).reshape(-1)
                return True
            if fname == "YData":
                self.target.y = _f(value).reshape(-1)
                return True
            if fname == "LineWidth":
                self.target.width = float(_f(value).reshape(-1)[0])
                return True
        return NotImplemented


def _handle_array(objs: list) -> CellArray:
    data = np.empty((len(objs), 1), dtype=object)
    for i, o in enumerate(objs):
        data[i, 0] = o
    return CellArray(data)


def _as_gobj(v) -> GObj:
    if isinstance(v, GObj):
        return v
    if isinstance(v, MatArray) and v.size == 1 and v.mclass != "char":
        num = int(v.host().reshape(-1)[0].real)
        if num in figmod._FIGURES:
            return GObj("figure", figmod._FIGURES[num])
    raise bad_arg("graphics", "Expected a graphics handle.")


# ------------------------------------------------------------------ get/set --- #

@builtin("groot", category="plotting/ops", min_in=0, max_in=0)
def m_groot():
    return GObj("root", None)


@builtin("gobjects", category="plotting/ops", min_in=0, max_in=2)
def m_gobjects(r=None, c=None):
    rr = scalar_int(r, "rows") if r is not None else 0
    cc = scalar_int(c, "cols") if c is not None else (rr if r is not None else 0)
    data = np.empty((rr, cc if c is not None else rr or 0), dtype=object)
    for i in range(data.shape[0]):
        for j in range(data.shape[1]):
            data[i, j] = GObj("placeholder", None)
    return CellArray(data)


@builtin("axes", category="plotting/ops", min_in=0)
def m_axes(*args):
    f = figmod.gcf()
    ax = figmod.Axes()
    if len(f.axes) == 1 and not f.axes[0].children:
        f.axes = []
    f.axes.append(ax)
    f.current = len(f.axes) - 1
    return GObj("axes", ax)


@builtin("cla", category="plotting/ops", min_in=0, max_in=1)
def m_cla(h=None):
    ax = _as_gobj(h).target if isinstance(h, GObj) else figmod.gca()
    ax.reset()
    return None


@builtin("get", category="plotting/ops", min_in=1, max_in=2)
def m_get(h, prop=None):
    g = _as_gobj(h)
    props = g._props()
    if prop is None:
        return StructArray.scalar(props)
    key = text_of(prop)
    if key not in props:
        raise MatError("MATLAB:class:InvalidProperty",
                       f"There is no '{key}' property on a {g.gtype}.")
    return props[key]


@builtin("set", category="plotting/ops", min_in=1)
def m_set(h, *pairs):
    g = _as_gobj(h)
    i = 0
    pairs = list(pairs)
    while i + 1 < len(pairs):
        key = text_of(pairs[i])
        if g._mat_set_field_(key, pairs[i + 1]) is NotImplemented:
            raise MatError("MATLAB:class:InvalidProperty",
                           f"Cannot set '{key}' on a {g.gtype}.")
        i += 2
    return None


@builtin("isgraphics", category="plotting/ops", min_in=1, max_in=2)
def m_isgraphics(h, kind=None):
    try:
        g = _as_gobj(h)
    except MatError:
        return MatArray.logical_scalar(False)
    if kind is not None:
        return MatArray.logical_scalar(g.gtype == text_of(kind))
    return MatArray.logical_scalar(True)


@builtin("findobj", category="plotting/ops", min_in=0)
def m_findobj(*args):
    args = list(args)
    root: list[GObj] = []
    if args and isinstance(args[0], (GObj, MatArray)) and not is_text(args[0]):
        try:
            root = [_as_gobj(args.pop(0))]
        except MatError:
            root = []
    if not root:
        root = [GObj("root", None)]
    # walk the tree
    found: list[GObj] = []

    def walk(g: GObj):
        found.append(g)
        ch = g._props().get("Children")
        if isinstance(ch, CellArray):
            for e in ch.data.reshape(-1):
                walk(e)

    for r in root:
        walk(r)
    # filters: 'Type', t pairs
    i = 0
    sel = [g for g in found if g.gtype not in ("root",)]
    while i + 1 < len(args):
        key, val = text_of(args[i]), args[i + 1]
        if key == "Type":
            sel = [g for g in sel if g.gtype == text_of(val)]
        else:
            want = text_of(val) if is_text(val) else None
            out = []
            for g in sel:
                p = g._props().get(key)
                if p is not None and want is not None and \
                        getattr(p, "mclass", "") == "char" and p.to_str() == want:
                    out.append(g)
            sel = out
        i += 2
    return _handle_array(sel)


@builtin("ancestor", category="plotting/ops", min_in=2, max_in=2)
def m_ancestor(h, kind):
    g = _as_gobj(h)
    want = text_of(kind)
    if g.gtype == want:
        return g
    # series -> owning axes -> figure
    for f in figmod._FIGURES.values():
        for ax in f.axes:
            if g.target is ax or g.target in ax.children:
                if want == "axes":
                    return GObj("axes", ax)
                if want == "figure":
                    return GObj("figure", f)
    return MatArray.empty()


@builtin("copyobj", category="plotting/ops", min_in=2, max_in=2)
def m_copyobj(h, parent):
    import copy
    g = _as_gobj(h)
    p = _as_gobj(parent)
    clone = copy.deepcopy(g.target)
    if p.gtype == "axes":
        p.target.children.append(clone)
    elif p.gtype == "figure" and g.gtype == "axes":
        p.target.axes.append(clone)
    return GObj(g.gtype, clone)


# -------------------------------------------------------- axes state cmds --- #

@builtin("box", category="plotting/ops", min_in=0, max_in=1)
def m_box(state=None):
    ax = figmod.gca()
    ax.box = (text_of(state) == "on") if state is not None else \
        not getattr(ax, "box", False)
    return None


@builtin("caxis", category="plotting/ops", min_in=0, max_in=1)
def m_caxis(lims=None):
    ax = figmod.gca()
    if lims is not None and not is_text(lims):
        ax.clim = tuple(_f(lims).reshape(-1)[:2])
    elif lims is not None and text_of(lims) == "auto":
        ax.clim = None
    return MatArray(np.array([list(ax.clim or (0.0, 1.0))]), "double")


@builtin("clim", category="plotting/ops", min_in=0, max_in=1)
def m_clim(lims=None):
    return m_caxis(lims)


@builtin("colororder", category="plotting/ops", min_in=0, max_in=1)
def m_colororder(colors=None):
    from ...plot import colors as cmod
    if colors is None:
        return MatArray(np.array(cmod.COLOR_ORDER, dtype=np.float64), "double")
    figmod.gca().color_order = _f(colors)
    return None


@builtin("daspect", category="plotting/ops", min_in=0, max_in=1)
def m_daspect(ratio=None):
    ax = figmod.gca()
    if ratio is not None and not is_text(ratio):
        ax.daspect = tuple(_f(ratio).reshape(-1)[:3])
        ax.axis_equal = len(set(ax.daspect[:2])) == 1
    return MatArray(np.array([list(getattr(ax, "daspect", (1.0, 1, 1)))]), "double")


@builtin("sgtitle", category="plotting/ops", min_in=1, max_in=1)
def m_sgtitle(s):
    f = figmod.gcf()
    f.suptitle = text_of(s)
    return None


@builtin("suptitle", category="plotting/ops", min_in=1, max_in=1)
def m_suptitle(s):
    return m_sgtitle(s)


@builtin("subtitle", category="plotting/ops", min_in=1, max_in=1)
def m_subtitle(s):
    figmod.gca().subtitle = text_of(s)
    return None


def _const_line(vertical: bool, v, spec=None):
    ax = _prep_ax()
    val = float(_f(v).reshape(-1)[0])
    (x0, x1), (y0, y1) = ax.data_limits()[:2]
    if vertical:
        x = np.array([val, val])
        y = np.array([min(y0, 0.0), max(y1, 1.0)])
    else:
        y = np.array([val, val])
        x = np.array([min(x0, 0.0), max(x1, 1.0)])
    ln = figmod.Line(x, y, color=(0.3, 0.3, 0.3), style="--")
    ln.const_line = ("x" if vertical else "y", val)
    ax.add(ln)
    return GObj("line", ln)


@builtin("xline", category="plotting/ops", min_in=1, max_in=3)
def m_xline(v, *rest):
    return _const_line(True, v)


@builtin("yline", category="plotting/ops", min_in=1, max_in=3)
def m_yline(v, *rest):
    return _const_line(False, v)


def _ticks(attr):
    def fn(v=None):
        ax = figmod.gca()
        if v is None:
            return MatArray(np.asarray(getattr(ax, attr, np.zeros(0)))
                            .reshape(1, -1), "double")
        if is_text(v):
            if text_of(v) == "auto":
                setattr(ax, attr, None)
            return None
        setattr(ax, attr, _f(v).reshape(-1))
        return None
    return fn


builtin("xticks", category="plotting/ops", min_in=0, max_in=1)(_ticks("xticks"))
builtin("yticks", category="plotting/ops", min_in=0, max_in=1)(_ticks("yticks"))
builtin("zticks", category="plotting/ops", min_in=0, max_in=1)(_ticks("zticks"))


def _ticklabels(attr):
    def fn(v=None):
        ax = figmod.gca()
        if v is None:
            cur = getattr(ax, attr, [])
            data = np.empty((len(cur), 1), dtype=object)
            for i, s in enumerate(cur):
                data[i, 0] = MatArray.char_from_str(s)
            return CellArray(data)
        if isinstance(v, CellArray):
            setattr(ax, attr, [e.to_str() for e in v.data.reshape(-1, order="F")])
        elif isinstance(v, StringArray):
            setattr(ax, attr, [s or "" for s in v.data.reshape(-1, order="F")])
        return None
    return fn


builtin("xticklabels", category="plotting/ops", min_in=0, max_in=1)(_ticklabels("xticklabels"))
builtin("yticklabels", category="plotting/ops", min_in=0, max_in=1)(_ticklabels("yticklabels"))


def _tickangle(attr):
    def fn(v):
        setattr(figmod.gca(), attr, scalar_num(v, "angle"))
        return None
    return fn


builtin("xtickangle", category="plotting/ops", min_in=1, max_in=1)(_tickangle("xtickangle"))
builtin("ytickangle", category="plotting/ops", min_in=1, max_in=1)(_tickangle("ytickangle"))


def _tickformat(attr):
    def fn(v):
        setattr(figmod.gca(), attr, text_of(v))
        return None
    return fn


builtin("xtickformat", category="plotting/ops", min_in=1, max_in=1)(_tickformat("xtickformat"))
builtin("ytickformat", category="plotting/ops", min_in=1, max_in=1)(_tickformat("ytickformat"))


@builtin("xscale", category="plotting/ops", min_in=1, max_in=1)
def m_xscale(s):
    figmod.gca().xscale = text_of(s)
    return None


@builtin("yscale", category="plotting/ops", min_in=1, max_in=1)
def m_yscale(s):
    figmod.gca().yscale = text_of(s)
    return None


@builtin("hidden", category="plotting/ops", min_in=0, max_in=1)
def m_hidden(state=None):
    figmod.gca().hidden = (text_of(state) == "on") if state is not None else True
    return None


@builtin("linkaxes", category="plotting/ops", min_in=1, max_in=2)
def m_linkaxes(handles, which=None):
    """Link limits now (static link: copies the union of current limits)."""
    axs = []
    if isinstance(handles, CellArray):
        axs = [_as_gobj(e).target for e in handles.data.reshape(-1)]
    if len(axs) >= 2:
        lims = [a.data_limits()[0] for a in axs]
        lo = min(l[0] for l in lims)
        hi = max(l[1] for l in lims)
        for a in axs:
            a.xlim = (lo, hi)
    return None


@builtin("pan", category="plotting/ops", min_in=0, max_in=1)
def m_pan(*a):
    return None   # interactive tool: no-op headless


@builtin("zoom", category="plotting/ops", min_in=0, max_in=1)
def m_zoom(*a):
    return None


@builtin("datacursormode", category="plotting/ops", min_in=0, max_in=1)
def m_datacursormode(*a):
    return None


@builtin("opengl", category="plotting/ops", min_in=0, max_in=1)
def m_opengl(*a):
    return MatArray.char_from_str("software")


# ------------------------------------------------------------ plot commands --- #

@builtin("line", category="plotting/ops", min_in=2)
def m_line(x, y, *rest):
    ax = _prep_ax()
    ln = figmod.Line(_np1(x), _np1(y), color=ax.next_color())
    ax.add(ln)
    return GObj("line", ln)


def _patch_colors(ax, c, ncols, nvert):
    """Resolve patch CData -> (facecolor, per-poly vertexcolors or None).

    MATLAB semantics (≙ runmat-plot/src/plots/patch.rs FaceVertexCData):
    color spec / RGB triple -> solid; per-face scalars -> flat colormap
    faces; per-vertex matrix (nvert x ncols) -> Gouraud 'interp' faces."""
    from ...plot.colors import NAMED, colormap
    if c is None:
        return (0.2, 0.4, 0.8), None, None
    if is_text(c):
        return NAMED.get(text_of(c), (0.2, 0.4, 0.8)), None, None
    cd = c.host().astype(np.float64)
    if cd.size == 3 and cd.ndim <= 2 and 3 not in (ncols, nvert):
        return tuple(cd.reshape(-1)), None, None
    cm = colormap(figmod.gca().cmap)
    lo, hi = float(np.nanmin(cd)), float(np.nanmax(cd))
    ax.clim = ax.clim or (lo, hi)
    lo, hi = ax.clim

    def map1(v):
        t = (v - lo) / ((hi - lo) or 1.0)
        idx = np.clip(np.where(np.isfinite(t), t, 0) * 255, 0, 255)
        return cm[idx.astype(int)]
    if cd.size == ncols:                       # per-face scalar CData
        return None, [tuple(map1(v)) for v in cd.reshape(-1)], None
    if cd.shape == (nvert, ncols) or (ncols == 1 and cd.size == nvert):
        cd = cd.reshape(nvert, ncols)          # per-vertex -> interp
        return None, None, [map1(cd[:, j]) for j in range(ncols)]
    return (0.2, 0.4, 0.8), None, None


def _patch_impl(ax, cols_xyz, c, rest, nargout):
    """cols_xyz: list of (nvert, ncols) coordinate matrices [X, Y(, Z)]."""
    mats = [np.atleast_2d(a) for a in cols_xyz]
    # MATLAB: column vectors are single polygons; matrices are one
    # polygon per column
    mats = [m.reshape(-1, 1) if 1 in m.shape else m for m in mats]
    nvert, ncols = mats[0].shape
    face, percol, vcols = _patch_colors(ax, c, ncols, nvert)
    edge = (0.0, 0.0, 0.0)
    alpha = 1.0
    i = 0
    rest = list(rest)
    while i + 1 < len(rest):
        name = text_of(rest[i]).lower() if is_text(rest[i]) else ""
        v = rest[i + 1]
        if name == "facecolor":
            if is_text(v):
                t = text_of(v).lower()
                if t == "none":
                    face, percol, vcols = None, None, None
                elif t not in ("flat", "interp"):
                    from ...plot.colors import NAMED
                    face, percol, vcols = NAMED.get(t, face), None, None
            else:
                face, percol, vcols = tuple(_np1(v)[:3]), None, None
        elif name == "edgecolor":
            if is_text(v):
                from ...plot.colors import NAMED
                edge = None if text_of(v).lower() == "none" else \
                    NAMED.get(text_of(v).lower(), edge)
            else:
                edge = tuple(_np1(v)[:3])
        elif name == "facealpha":
            alpha = float(_np1(v)[0])
        i += 2
    polys = [np.column_stack([m[:, j] for m in mats]) for j in range(ncols)]
    if percol is not None:
        # flat per-face colors: one Patch per face keeps the painter sort
        nodes = []
        for j, poly in enumerate(polys):
            p = figmod.Patch([poly], percol[j], edge,
                             depth=(float(np.mean(poly[:, 2]))
                                    if poly.shape[1] > 2 else None))
            p.alpha = alpha
            ax.add(p)
            nodes.append(p)
        return GObj("patch", nodes[0]) if nargout else None
    p = figmod.Patch(polys, face, edge, vertexcolors=vcols,
                     depth=(float(np.mean(polys[0][:, 2]))
                            if polys[0].shape[1] > 2 else None))
    p.alpha = alpha
    ax.add(p)
    return GObj("patch", p) if nargout else None


def _patch_fv(verts, faces, rest, nargout):
    """patch from a face-vertex set: renders through the lit TriMesh
    pipeline (isosurface/trisurf share it)."""
    ax = _prep_ax()
    ax.is3d = True
    V = verts.host().astype(np.float64)
    F = faces.host().astype(np.int64) - 1
    if V.shape[1] == 2:
        V = np.column_stack([V, np.zeros(V.shape[0])])
        ax.is3d = False
    t = figmod.TriMesh(V, F, facecolor=(0.3, 0.5, 0.8))
    i = 0
    rest = list(rest)
    while i + 1 < len(rest):
        name = text_of(rest[i]).lower() if is_text(rest[i]) else ""
        val = rest[i + 1]
        if name == "facecolor":
            if is_text(val):
                tname = text_of(val).lower()
                if tname == "none":
                    t.style = "mesh"
                elif tname not in ("flat", "interp"):
                    from ...plot.colors import NAMED
                    t.facecolor = NAMED.get(tname, t.facecolor)
            else:
                t.facecolor = tuple(_np1(val)[:3])
        elif name == "edgecolor":
            if is_text(val):
                from ...plot.colors import NAMED
                t.edgecolor = None if text_of(val).lower() == "none" \
                    else NAMED.get(text_of(val).lower(), (0, 0, 0))
            else:
                t.edgecolor = tuple(_np1(val)[:3])
        elif name == "facevertexcdata":
            t.cvals = fortran_ravel(val.host().astype(np.float64))
            t.style = "interp"
        elif name == "facealpha":
            t.alpha = float(_np1(val)[0])
        i += 2
    ax.add(t)
    if t.cvals is not None:
        ax.clim = ax.clim or (float(np.nanmin(t.cvals)),
                              float(np.nanmax(t.cvals)))
    return GObj("patch", t) if nargout else None


@builtin("patch", category="plotting/ops", min_in=1, pass_nargout=True)
def m_patch(x, y=None, *rest, nargout=0):
    # patch(fv) / patch(fv, 'Prop', val, ...): face-vertex struct
    if isinstance(x, StructArray) and x.is_scalar and \
            "vertices" in x.fields and "faces" in x.fields:
        pre = [] if y is None else [y]
        return _patch_fv(x.get_scalar_field("vertices"),
                         x.get_scalar_field("faces"),
                         pre + list(rest), nargout)
    # patch('Vertices', V, 'Faces', F, 'Prop', val, ...)
    if is_text(x) and text_of(x).lower() in ("vertices", "faces"):
        pairs = [x, y] + list(rest)
        props = {}
        other = []
        i = 0
        while i + 1 < len(pairs):
            nm = text_of(pairs[i]).lower() if is_text(pairs[i]) else ""
            if nm in ("vertices", "faces"):
                props[nm] = pairs[i + 1]
            else:
                other += [pairs[i], pairs[i + 1]]
            i += 2
        if "vertices" in props and "faces" in props:
            return _patch_fv(props["vertices"], props["faces"], other,
                             nargout)
    if y is None:
        raise bad_arg("patch", "Expected coordinate matrices or a "
                               "face-vertex struct.")
    ax = _prep_ax()
    rest = list(rest)
    c = None
    # patch(X,Y,Z,C,...) vs patch(X,Y,C,...): Z present when the 3rd
    # positional is numeric AND the 4th is too (or is a color spec)
    xs = [x.host().astype(np.float64), y.host().astype(np.float64)]

    def is_prop(a):
        return is_text(a) and text_of(a).lower() in _PATCH_PROPS

    # patch(X,Y,Z,C,...): 3rd arg numeric with X's shape and a 4th
    # non-property arg follows
    if (len(rest) >= 2 and not is_text(rest[0]) and not is_prop(rest[1])
            and np.atleast_2d(rest[0].host()).shape
            == np.atleast_2d(xs[0]).shape):
        xs.append(rest[0].host().astype(np.float64))
        ax.is3d = True
        c, rest = rest[1], rest[2:]
    elif rest and not is_prop(rest[0]):      # patch(X,Y,C,...)
        c, rest = rest[0], rest[1:]
    return _patch_impl(ax, xs, c, rest, nargout)


_PATCH_PROPS = {"facecolor", "edgecolor", "facealpha", "linewidth",
                "displayname", "facevertexcdata", "edgealpha", "linestyle"}


@builtin("fill3", category="plotting/ops", min_in=3, pass_nargout=True)
def m_fill3(x, y, z, c=None, *rest, nargout=0):
    ax = _prep_ax()
    ax.is3d = True
    xs = [a.host().astype(np.float64) for a in (x, y, z)]
    return _patch_impl(ax, xs, c, rest, nargout)


@builtin("quiver3", category="plotting/ops", min_in=6)
def m_quiver3(x, y, z, u, v, w, *rest):
    ax = _prep_ax()
    ax.is3d = True
    for xi, yi, zi, ui, vi, wi in zip(*[_np1(a) for a in (x, y, z, u, v, w)]):
        ln = figmod.Line(np.array([xi, xi + ui]), np.array([yi, yi + vi]),
                         z=np.array([zi, zi + wi]), color=(0.0, 0.35, 0.74))
        ax.add(ln)
    return None


@builtin("contour3", category="plotting/ops", min_in=1, pass_ctx=True,
         pass_nargout=True)
def m_contour3(*args, ctx=None, nargout=0):
    r = ctx.interp.call_named("contour", list(args), max(nargout, 1), ctx.frame)
    figmod.gca().is3d = True
    return r[:nargout] if nargout else None


@builtin("meshc", category="plotting/ops", min_in=1, pass_ctx=True)
def m_meshc(*args, ctx=None):
    ctx.interp.call_named("mesh", list(args), 0, ctx.frame)
    ctx.interp.call_named("contour", list(args), 0, ctx.frame)
    return None


@builtin("ribbon", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True)
def m_ribbon(y, width=None, ctx=None):
    return ctx.interp.call_named("surf", [y], 0, ctx.frame)


def _polar_to_xy(th, r):
    return r * np.cos(th), r * np.sin(th)


@builtin("polarplot", category="plotting/ops", min_in=1, max_in=3)
def m_polarplot(th, r=None, spec=None):
    ax = _prep_ax()
    if r is None:
        rr = _np1(th)
        tt = np.linspace(0, 2 * np.pi, rr.size)
    else:
        tt, rr = _np1(th), _np1(r)
    x, y = _polar_to_xy(tt, rr)
    ln = figmod.Line(x, y, color=ax.next_color())
    ax.add(ln)
    ax.axis_equal = True
    return GObj("line", ln)


@builtin("polarscatter", category="plotting/ops", min_in=2, max_in=4)
def m_polarscatter(th, r, *rest):
    ax = _prep_ax()
    x, y = _polar_to_xy(_np1(th), _np1(r))
    sc = figmod.Line(x, y, color=ax.next_color(), style="none", marker="o")
    sc.kind = "scatter"
    ax.add(sc)
    ax.axis_equal = True
    return GObj("scatter", sc)


@builtin("polarhistogram", category="plotting/ops", min_in=1, max_in=2)
def m_polarhistogram(th, nbins=None):
    ax = _prep_ax()
    nb = scalar_int(nbins, "nbins") if nbins is not None else 12
    counts, edges = np.histogram(np.mod(_np1(th), 2 * np.pi),
                                 bins=nb, range=(0, 2 * np.pi))
    for c, e0, e1 in zip(counts, edges[:-1], edges[1:]):
        tt = np.linspace(e0, e1, 8)
        x, y = _polar_to_xy(np.concatenate([[e0], tt, [e1]]),
                            np.concatenate([[0], np.full(8, c), [0]]))
        ax.add(figmod.Line(x, y, color=(0.0, 0.35, 0.74)))
    ax.axis_equal = True
    return None


@builtin("sphere", category="plotting/ops", min_in=0, max_in=1, pass_nargout=True)
def m_sphere(n=None, nargout=0):
    k = scalar_int(n, "n") if n is not None else 20
    th = np.linspace(0, 2 * np.pi, k + 1)
    ph = np.linspace(-np.pi / 2, np.pi / 2, k + 1)
    TH, PH = np.meshgrid(th, ph)
    X = np.cos(PH) * np.cos(TH)
    Y = np.cos(PH) * np.sin(TH)
    Z = np.sin(PH)
    if nargout >= 1:
        return [MatArray(X, "double"), MatArray(Y, "double"),
                MatArray(Z, "double")][:nargout]
    from .plotting import m_surf
    m_surf(MatArray(X, "double"), MatArray(Y, "double"), MatArray(Z, "double"))
    return None


@builtin("hist", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True,
         pass_nargout=True)
def m_hist(x, nbins=None, ctx=None, nargout=0):
    h = fortran_ravel(_f(x))
    nb = scalar_int(nbins, "nbins") if nbins is not None else 10
    counts, edges = np.histogram(h[np.isfinite(h)], bins=nb)
    centers = (edges[:-1] + edges[1:]) / 2
    if nargout >= 1:
        return [MatArray(counts.astype(np.float64).reshape(1, -1), "double"),
                MatArray(centers.reshape(1, -1), "double")][:nargout]
    ctx.interp.call_named("bar", [MatArray(centers.reshape(1, -1), "double"),
                                  MatArray(counts.astype(np.float64)
                                           .reshape(1, -1), "double")],
                          0, ctx.frame)
    return None


@builtin("imshow", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True)
def m_imshow(img, *rest, ctx=None):
    r = ctx.interp.call_named("image", [img], 0, ctx.frame)
    ax = figmod.gca()
    ax.axis_off = True
    ax.axis_equal = True
    return r


@builtin("fcontour", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True)
def m_fcontour(f, lims=None, ctx=None):
    lo, hi = (-5.0, 5.0)
    if lims is not None:
        v = _f(lims).reshape(-1)
        lo, hi = float(v[0]), float(v[1])
    g = np.linspace(lo, hi, 60)
    X, Y = np.meshgrid(g, g)
    Z = np.empty_like(X)
    for i in range(X.shape[0]):
        r = ctx.interp.call_value(f, [MatArray(X[i:i + 1, :], "double"),
                                      MatArray(Y[i:i + 1, :], "double")],
                                  1, ctx.frame)
        Z[i, :] = r[0].host().reshape(-1)
    return ctx.interp.call_named("contour", [MatArray(X, "double"),
                                             MatArray(Y, "double"),
                                             MatArray(Z, "double")], 0, ctx.frame)


@builtin("fsurf", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True)
def m_fsurf(f, lims=None, ctx=None):
    lo, hi = (-5.0, 5.0)
    if lims is not None:
        v = _f(lims).reshape(-1)
        lo, hi = float(v[0]), float(v[1])
    g = np.linspace(lo, hi, 40)
    X, Y = np.meshgrid(g, g)
    Z = np.empty_like(X)
    for i in range(X.shape[0]):
        r = ctx.interp.call_value(f, [MatArray(X[i:i + 1, :], "double"),
                                      MatArray(Y[i:i + 1, :], "double")],
                                  1, ctx.frame)
        Z[i, :] = r[0].host().reshape(-1)
    return ctx.interp.call_named("surf", [MatArray(X, "double"),
                                          MatArray(Y, "double"),
                                          MatArray(Z, "double")], 0, ctx.frame)


@builtin("triplot", category="plotting/ops", min_in=3, max_in=3)
def m_triplot(tri, x, y):
    ax = _prep_ax()
    T = _f(tri).astype(int)
    px, py = _np1(x), _np1(y)
    for row in T:
        idx = np.array([row[0], row[1], row[2], row[0]]) - 1
        ax.add(figmod.Line(px[idx], py[idx], color=(0.0, 0.35, 0.74)))
    return None


@builtin("plotyy", category="plotting/ops", min_in=4, max_in=4, pass_ctx=True,
         pass_nargout=True)
def m_plotyy(x1, y1, x2, y2, ctx=None, nargout=0):
    ctx.interp.call_named("plot", [x1, y1], 0, ctx.frame)
    ctx.interp.call_named("plot", [x2, y2], 0, ctx.frame)
    if nargout:
        ax = figmod.gca()
        return [GObj("axes", ax), GObj("axes", ax)][:nargout]
    return None


@builtin("plotmatrix", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True)
def m_plotmatrix(X, Y=None, ctx=None):
    hx = _f(X)
    hy = _f(Y) if Y is not None else hx
    n = hx.shape[1]
    m = hy.shape[1]
    f = figmod.gcf()
    for i in range(m):
        for j in range(n):
            f.subplot(m, n, i * n + j + 1)
            ctx.interp.call_named(
                "scatter", [MatArray(hx[:, j].reshape(-1, 1), "double"),
                            MatArray(hy[:, i].reshape(-1, 1), "double")],
                0, ctx.frame)
    return None


@builtin("stackedplot", category="plotting/ops", min_in=1, max_in=1, pass_ctx=True)
def m_stackedplot(t, ctx=None):
    from ...tables import MatTable
    f = figmod.gcf()
    if isinstance(t, MatTable):
        cols = [(nm, c) for nm, c in zip(t.varnames, t.cols)
                if isinstance(c, MatArray)]
        for i, (nm, c) in enumerate(cols):
            ax = f.subplot(len(cols), 1, i + 1)
            ax.ylabel = nm
            ctx.interp.call_named("plot", [c], 0, ctx.frame)
        return None
    h = _f(t)
    for j in range(h.shape[1]):
        f.subplot(h.shape[1], 1, j + 1)
        ctx.interp.call_named("plot", [MatArray(h[:, j].reshape(-1, 1),
                                                "double")], 0, ctx.frame)
    return None


@builtin("scatterplot", category="plotting/ops", min_in=1, max_in=1, pass_ctx=True)
def m_scatterplot(x, ctx=None):
    """Comms-toolbox constellation scatter: complex -> (re, im)."""
    h = x.host()
    re = np.real(h).reshape(-1, 1)
    im = np.imag(h).reshape(-1, 1)
    ctx.interp.call_named("scatter", [MatArray(re, "double"),
                                      MatArray(im, "double")], 0, ctx.frame)
    figmod.gca().axis_equal = True
    return None


@builtin("textscatter", category="plotting/ops", min_in=3, max_in=3)
def m_textscatter(x, y, labels):
    ax = _prep_ax()
    px, py = _np1(x), _np1(y)
    texts = ([e.to_str() for e in labels.data.reshape(-1, order="F")]
             if isinstance(labels, CellArray)
             else [s or "" for s in labels.data.reshape(-1, order="F")])
    for xi, yi, s in zip(px, py, texts):
        t = type("Text", (), {})()
        t.kind = "text"
        t.x, t.y, t.s = float(xi), float(yi), s
        ax.add(t)
    return None


@builtin("textscatter3", category="plotting/ops", min_in=4, max_in=4)
def m_textscatter3(x, y, z, labels):
    m_textscatter(x, y, labels)
    figmod.gca().is3d = True
    return None


@builtin("wordcloud", category="plotting/ops", min_in=1, max_in=2, pass_ctx=True)
def m_wordcloud(words, counts=None, ctx=None):
    texts = ([e.to_str() for e in words.data.reshape(-1, order="F")]
             if isinstance(words, CellArray)
             else [s or "" for s in words.data.reshape(-1, order="F")])
    w = fortran_ravel(_f(counts)) if counts is not None else np.ones(len(texts))
    order = np.argsort(-w)
    ax = _prep_ax()
    rng = np.random.default_rng(0)
    for k, i in enumerate(order[:60]):
        t = type("Text", (), {})()
        t.kind = "text"
        t.x, t.y = float(rng.uniform(0, 1)), float(rng.uniform(0, 1))
        t.s = texts[i]
        t.fontsize = 8 + 24 * float(w[i] / max(w.max(), 1))
        ax.add(t)
    ax.axis_off = True
    return None


@builtin("heatmap", category="plotting/ops", min_in=1, pass_ctx=True)
def m_heatmap(*args, ctx=None):
    data = args[-1] if len(args) >= 3 else args[0]
    r = ctx.interp.call_named("imagesc", [data], 0, ctx.frame)
    figmod.gca().colorbar = True
    return r


@builtin("waitbar", category="plotting/ops", min_in=1, max_in=3)
def m_waitbar(frac, handle_or_msg=None, msg=None):
    return GObj("figure", figmod.gcf())


# ----------------------------------------------------------- animated line --- #

class AnimatedLine:
    kind = "line"

    def __init__(self, ax):
        self.ax = ax
        self.x = np.zeros(0)
        self.y = np.zeros(0)
        self.z = None
        self.color = (0.0, 0.35, 0.74)
        self.style = "-"
        self.marker = None
        self.width = 1.0
        self.label = None


@builtin("animatedline", category="plotting/ops", min_in=0)
def m_animatedline(*args):
    ax = _prep_ax()
    al = AnimatedLine(ax)
    ax.add(al)
    return GObj("animatedline", al)


@builtin("addpoints", category="plotting/ops", min_in=3, max_in=4)
def m_addpoints(h, x, y, z=None):
    g = _as_gobj(h)
    if not isinstance(g.target, AnimatedLine):
        raise bad_arg("addpoints", "Expected an animatedline handle.")
    g.target.x = np.concatenate([g.target.x, _np1(x)])
    g.target.y = np.concatenate([g.target.y, _np1(y)])
    return None


# --------------------------------------------------------- figure save/load --- #

def _scene_dict(f) -> dict:
    axes = []
    for ax in f.axes:
        chs = []
        for c in ax.children:
            d = {"kind": getattr(c, "kind", "line")}
            for a in ("x", "y", "z"):
                v = getattr(c, a, None)
                if v is not None and not isinstance(v, (str, float)):
                    d[a] = np.asarray(v).tolist()
            if d["kind"] == "surface":
                for a in ("X", "Y", "Z", "C"):
                    d[a] = np.asarray(getattr(c, a)).tolist()
            for a in ("color", "style", "marker", "s"):
                v = getattr(c, a, None)
                if v is not None:
                    d[a] = list(v) if isinstance(v, tuple) else v
            chs.append(d)
        axes.append({"title": ax.title, "xlabel": ax.xlabel, "ylabel": ax.ylabel,
                     "children": chs,
                     "is3d": ax.is3d, "lighting": ax.lighting,
                     "lights": [{"position": list(li.position),
                                 "color": list(li.color), "style": li.style}
                                for li in ax.lights]})
    return {"num": f.num, "axes": axes}


@builtin("savefig", category="plotting/ops", min_in=1, max_in=2)
def m_savefig(a, b=None):
    import json
    from ...fs import fs
    if b is None:
        f, path = figmod.gcf(), text_of(a)
    else:
        f, path = _as_gobj(a).target, text_of(b)
    fs().write_bytes(path, json.dumps(_scene_dict(f)).encode("utf-8"))
    return None


@builtin("hgsave", category="plotting/ops", min_in=2, max_in=2)
def m_hgsave(h, path):
    return m_savefig(h, path)


def _load_fig(path: str):
    import json
    from ...fs import fs
    d = json.loads(fs().read_bytes(path).decode("utf-8"))
    f = figmod.figure(None)
    f.axes = []
    for axd in d["axes"]:
        ax = figmod.Axes()
        ax.title = axd.get("title", "")
        ax.xlabel = axd.get("xlabel", "")
        ax.ylabel = axd.get("ylabel", "")
        ax.is3d = bool(axd.get("is3d", False))
        ax.lighting = axd.get("lighting", "flat")
        for lid in axd.get("lights", ()):
            ax.lights.append(figmod.Light(tuple(lid["position"]),
                                          tuple(lid["color"]),
                                          lid.get("style", "infinite")))
        for chd in axd["children"]:
            if chd.get("kind") in ("line", "scatter") and "x" in chd:
                ln = figmod.Line(np.asarray(chd["x"]), np.asarray(chd["y"]),
                                 color=tuple(chd.get("color", (0, 0.35, 0.74))))
                ln.kind = chd["kind"]
                ax.add(ln)
            elif chd.get("kind") == "surface" and "Z" in chd:
                ax.add(figmod.Surface(np.asarray(chd["X"]),
                                      np.asarray(chd["Y"]),
                                      np.asarray(chd["Z"]),
                                      np.asarray(chd["C"]),
                                      style=chd.get("style", "faceted")))
        f.axes.append(ax)
    if not f.axes:
        f.axes = [figmod.Axes()]
    f.current = 0
    return f


@builtin("openfig", category="plotting/ops", min_in=1, max_in=2)
def m_openfig(path, *rest):
    return GObj("figure", _load_fig(text_of(path)))


@builtin("hgload", category="plotting/ops", min_in=1, max_in=1)
def m_hgload(path):
    return GObj("figure", _load_fig(text_of(path)))
