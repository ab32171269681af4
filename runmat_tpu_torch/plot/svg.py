"""Copy of runmat_tpu/plot/svg.py in the PyTorch port.

SVG export of the figure scene graph (headless vector path).

Reference parity: runmat-plot headless export (crates/runmat-plot/src/export/).
"""

from __future__ import annotations

import math
from xml.sax.saxutils import escape

import numpy as np

from .colors import colormap, css
from .figure import Axes, Figure, fmt_tick, nice_ticks, project3

_DASH = {"-": None, "--": "8,4", ":": "2,3", "-.": "8,3,2,3"}


class _Mapper:
    """data -> pixel coordinates for one axes box."""

    def __init__(self, ax: Axes, fig_w: int, fig_h: int):
        l, b, w, h = ax.rect
        self.px0 = l * fig_w
        self.py0 = (1 - b - h) * fig_h
        self.pw = w * fig_w
        self.ph = h * fig_h
        self.ax = ax
        self.lims = ax.data_limits()
        (self.x0, self.x1) = self.lims[0]
        (self.y0, self.y1) = self.lims[1]
        if ax.xscale == "log":
            self.x0 = math.log10(max(self.x0, 1e-300))
            self.x1 = math.log10(max(self.x1, 1e-300))
        if ax.yscale == "log":
            self.y0 = math.log10(max(self.y0, 1e-300))
            self.y1 = math.log10(max(self.y1, 1e-300))

    def _tx(self, x):
        x = np.asarray(x, np.float64)
        if self.ax.xscale == "log":
            x = np.log10(np.maximum(x, 1e-300))
        return self.px0 + (x - self.x0) / (self.x1 - self.x0 or 1) * self.pw

    def _ty(self, y):
        y = np.asarray(y, np.float64)
        if self.ax.yscale == "log":
            y = np.log10(np.maximum(y, 1e-300))
        return self.py0 + self.ph - (y - self.y0) / (self.y1 - self.y0 or 1) * self.ph

    def map2(self, x, y):
        return self._tx(x), self._ty(y)

    def map3(self, x, y, z):
        u, v, d = project3(self.ax, x, y, z, self.lims)
        px = self.px0 + (np.asarray(u) + 0.75) / 1.5 * self.pw
        py = self.py0 + self.ph - (np.asarray(v) + 0.75) / 1.5 * self.ph
        return px, py, d


def _marker_svg(px, py, marker, color, size=4.0):
    c = css(color)
    out = []
    for x, y in zip(np.atleast_1d(px), np.atleast_1d(py)):
        if not (math.isfinite(x) and math.isfinite(y)):
            continue
        if marker == "o":
            out.append(f'<circle cx="{x:.2f}" cy="{y:.2f}" r="{size:.2f}" '
                       f'fill="none" stroke="{c}"/>')
        elif marker == ".":
            out.append(f'<circle cx="{x:.2f}" cy="{y:.2f}" r="{size/2:.2f}" fill="{c}"/>')
        elif marker in ("x", "+"):
            d = size
            if marker == "x":
                out.append(f'<path d="M{x-d:.2f},{y-d:.2f}L{x+d:.2f},{y+d:.2f}'
                           f'M{x-d:.2f},{y+d:.2f}L{x+d:.2f},{y-d:.2f}" stroke="{c}"/>')
            else:
                out.append(f'<path d="M{x-d:.2f},{y:.2f}L{x+d:.2f},{y:.2f}'
                           f'M{x:.2f},{y-d:.2f}L{x:.2f},{y+d:.2f}" stroke="{c}"/>')
        elif marker == "s":
            d = size
            out.append(f'<rect x="{x-d:.2f}" y="{y-d:.2f}" width="{2*d:.2f}" '
                       f'height="{2*d:.2f}" fill="none" stroke="{c}"/>')
        elif marker in ("^", "v", "d", "*", "p", "h", "<", ">"):
            d = size * 1.2
            pts = [(x, y - d), (x - d, y + d), (x + d, y + d)] if marker == "^" \
                else [(x, y + d), (x - d, y - d), (x + d, y - d)] if marker == "v" \
                else [(x, y - d), (x + d, y), (x, y + d), (x - d, y)]
            p = " ".join(f"{a:.2f},{b:.2f}" for a, b in pts)
            out.append(f'<polygon points="{p}" fill="none" stroke="{c}"/>')
    return "".join(out)


def _polyline(px, py, color, width, style):
    c = css(color)
    dash = _DASH.get(style or "-")
    dd = f' stroke-dasharray="{dash}"' if dash else ""
    # split at NaNs
    segs = []
    cur = []
    for x, y in zip(px, py):
        if math.isfinite(x) and math.isfinite(y):
            cur.append(f"{x:.2f},{y:.2f}")
        elif cur:
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    return "".join(
        f'<polyline points="{" ".join(s)}" fill="none" stroke="{c}" '
        f'stroke-width="{width}"{dd}/>' for s in segs if len(s) > 1)


def render_svg(fig: Figure, draft: bool = False) -> str:
    W, H = fig.size
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
             f'viewBox="0 0 {W} {H}">',
             f'<rect width="{W}" height="{H}" fill="white"/>']
    for ax in fig.axes:
        parts.append(_render_axes(ax, W, H, draft=draft))
    # figure-fraction annotations (textbox/line/arrow)
    for an in getattr(fig, "annotations", ()):
        p = an.get("pos", [0, 0, 0.1, 0.1])
        if an["kind"] in ("textbox",):
            x = p[0] * W
            y = (1 - p[1] - (p[3] if len(p) > 3 else 0)) * H
            w = (p[2] if len(p) > 2 else 0.1) * W
            h = (p[3] if len(p) > 3 else 0.1) * H
            parts.append(
                f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" '
                f'height="{h:.1f}" fill="none" stroke="#444"/>')
            parts.append(
                f'<text x="{x + 4:.1f}" y="{y + h / 2 + 4:.1f}" '
                f'font-size="11" font-family="sans-serif">'
                f'{escape(an.get("text", ""))}</text>')
        elif an["kind"] in ("line", "arrow", "textarrow") and len(p) >= 4:
            x1, x2 = p[0] * W, p[1] * W
            y1, y2 = (1 - p[2]) * H, (1 - p[3]) * H
            parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" '
                         f'x2="{x2:.1f}" y2="{y2:.1f}" stroke="#444"/>')
            if an.get("text"):
                parts.append(
                    f'<text x="{x1:.1f}" y="{y1 - 3:.1f}" font-size="11" '
                    f'font-family="sans-serif">'
                    f'{escape(an["text"])}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _render_axes(ax: Axes, W: int, H: int, draft: bool = False) -> str:
    m = _Mapper(ax, W, H)
    out = []
    x0p, y0p = m.px0, m.py0
    wp, hp = m.pw, m.ph
    if not ax.axis_off:
        out.append(f'<rect x="{x0p:.1f}" y="{y0p:.1f}" width="{wp:.1f}" '
                   f'height="{hp:.1f}" fill="white" stroke="#333"/>')
    # ticks + grid (2-D only)
    if not ax.is3d and not ax.axis_off:
        xt = nice_ticks(m.x0, m.x1)
        yt = nice_ticks(m.y0, m.y1)
        for t in xt:
            tv = 10 ** t if ax.xscale == "log" else t
            px = float(m._tx(tv))
            if not (x0p - 0.5 <= px <= x0p + wp + 0.5):
                continue
            if ax.grid:
                out.append(f'<line x1="{px:.1f}" y1="{y0p:.1f}" x2="{px:.1f}" '
                           f'y2="{y0p+hp:.1f}" stroke="#ddd"/>')
            out.append(f'<line x1="{px:.1f}" y1="{y0p+hp:.1f}" x2="{px:.1f}" '
                       f'y2="{y0p+hp-4:.1f}" stroke="#333"/>')
            lbl = fmt_tick(tv)
            out.append(f'<text x="{px:.1f}" y="{y0p+hp+14:.1f}" font-size="10" '
                       f'text-anchor="middle" fill="#333">{escape(lbl)}</text>')
        for t in yt:
            tv = 10 ** t if ax.yscale == "log" else t
            py = float(m._ty(tv))
            if not (y0p - 0.5 <= py <= y0p + hp + 0.5):
                continue
            if ax.grid:
                out.append(f'<line x1="{x0p:.1f}" y1="{py:.1f}" x2="{x0p+wp:.1f}" '
                           f'y2="{py:.1f}" stroke="#ddd"/>')
            out.append(f'<line x1="{x0p:.1f}" y1="{py:.1f}" x2="{x0p+4:.1f}" '
                       f'y2="{py:.1f}" stroke="#333"/>')
            out.append(f'<text x="{x0p-6:.1f}" y="{py+3:.1f}" font-size="10" '
                       f'text-anchor="end" fill="#333">{escape(fmt_tick(tv))}</text>')
    # children (3-D: painter's sort on depth)
    kids = list(ax.children)
    if ax.is3d:
        def depth_key(ch):
            d = getattr(ch, "depth", None)
            return -1e9 if d is None else d
        kids.sort(key=depth_key)
    legend_entries = []
    for ch in kids:
        if ch.kind == "line":
            if ch.z is not None or ax.is3d and ch.z is not None:
                px, py, _ = m.map3(ch.x, ch.y, ch.z if ch.z is not None else
                                   np.zeros_like(ch.x))
            else:
                px, py = m.map2(ch.x, ch.y)
            if ch.style != "none":
                out.append(_polyline(px, py, ch.color, ch.width, ch.style))
            if ch.marker:
                out.append(_marker_svg(px, py, ch.marker, ch.color))
            if ch.label:
                legend_entries.append((ch.label, ch.color))
        elif ch.kind == "scatter":
            if ch.z is not None:
                px, py, _ = m.map3(ch.x, ch.y, ch.z)
            else:
                px, py = m.map2(ch.x, ch.y)
            for x, y, s in zip(px, py, ch.sizes):
                if math.isfinite(x) and math.isfinite(y):
                    r = max(1.5, math.sqrt(max(s, 1)) / 2)
                    out.append(f'<circle cx="{x:.2f}" cy="{y:.2f}" r="{r:.2f}" '
                               f'fill="{css(ch.color)}" fill-opacity="0.7"/>')
            if ch.label:
                legend_entries.append((ch.label, ch.color))
        elif ch.kind == "patch":
            vcs = getattr(ch, "vertexcolors", None)
            for pi, poly in enumerate(ch.polys):
                poly = np.asarray(poly, np.float64)
                if poly.shape[1] > 2:
                    px, py, _ = m.map3(poly[:, 0], poly[:, 1], poly[:, 2])
                else:
                    px, py = m.map2(poly[:, 0], poly[:, 1])
                pts = " ".join(f"{x:.2f},{y:.2f}" for x, y in zip(px, py)
                               if math.isfinite(x) and math.isfinite(y))
                ec = css(ch.edgecolor) if ch.edgecolor else "none"
                if vcs is not None and pi < len(vcs) and vcs[pi] is not None:
                    # SVG has no native Gouraud fill: approximate the
                    # 'interp' face with the mean vertex color (the PNG
                    # path does true barycentric interpolation)
                    fc = css(tuple(np.clip(np.mean(np.asarray(vcs[pi],
                                                              np.float64),
                                                   axis=0), 0, 1)))
                elif ch.facecolor is not None:
                    fc = css(ch.facecolor)
                else:
                    fc = "none"
                out.append(f'<polygon points="{pts}" fill="{fc}" stroke="{ec}" '
                           f'stroke-width="0.5"/>')
            if ch.label:
                legend_entries.append((ch.label, ch.facecolor))
        elif ch.kind == "surface":
            from .shade3d import surface_polys_svg
            for qx, qy, face, edge in surface_polys_svg(
                    m, ax, ch, max_faces=(240 if draft else 1500)):
                pts = " ".join(f"{x:.2f},{y:.2f}" for x, y in zip(qx, qy)
                               if math.isfinite(x) and math.isfinite(y))
                fc = css(face) if face is not None else "none"
                ec = css(edge) if edge is not None else "none"
                out.append(f'<polygon points="{pts}" fill="{fc}" stroke="{ec}" '
                           f'stroke-width="0.5"/>')
            if ch.label:
                legend_entries.append((ch.label, (0.2, 0.45, 0.7)))
        elif ch.kind == "trimesh":
            from .shade3d import trimesh_polys
            for qx, qy, face, edge in trimesh_polys(
                    m, ax, ch, max_faces=(600 if draft else 4000)):
                pts = " ".join(f"{x:.2f},{y:.2f}" for x, y in zip(qx, qy)
                               if math.isfinite(x) and math.isfinite(y))
                fc = css(face) if face is not None else "none"
                ec = css(edge) if edge is not None else "none"
                out.append(f'<polygon points="{pts}" fill="{fc}" stroke="{ec}" '
                           f'stroke-width="0.4"/>')
            if ch.label:
                legend_entries.append((ch.label, ch.facecolor
                                       or (0.3, 0.5, 0.8)))
        elif ch.kind == "image":
            out.append(_image_svg(m, ch))
        elif ch.kind == "text":
            px, py = m.map2(ch.x, ch.y)
            out.append(f'<text x="{float(px):.1f}" y="{float(py):.1f}" '
                       f'font-size="{ch.size}" text-anchor="{ch.anchor}" '
                       f'fill="{css(ch.color)}">{escape(ch.s)}</text>')
    # labels + title
    cx = x0p + wp / 2
    if ax.title:
        out.append(f'<text x="{cx:.1f}" y="{y0p-8:.1f}" font-size="13" '
                   f'font-weight="bold" text-anchor="middle">{escape(ax.title)}</text>')
    if ax.xlabel:
        out.append(f'<text x="{cx:.1f}" y="{y0p+hp+30:.1f}" font-size="11" '
                   f'text-anchor="middle">{escape(ax.xlabel)}</text>')
    if ax.ylabel:
        out.append(f'<text x="{x0p-34:.1f}" y="{y0p+hp/2:.1f}" font-size="11" '
                   f'text-anchor="middle" transform="rotate(-90 {x0p-34:.1f} '
                   f'{y0p+hp/2:.1f})">{escape(ax.ylabel)}</text>')
    # legend
    if ax.legend_on and not legend_entries and ax.legend_labels:
        # legend('a','b',...) with unlabeled series: label in child order
        series = [ch for ch in ax.children if ch.kind in ("line", "scatter")]
        legend_entries = [(lbl, getattr(s, "color", (0, 0, 0)))
                          for lbl, s in zip(ax.legend_labels, series)]
    if ax.legend_on and legend_entries:
        labels = ax.legend_labels or [e[0] for e in legend_entries]
        lx = x0p + wp - 120
        ly = y0p + 10
        lh = 16 * len(legend_entries) + 8
        out.append(f'<rect x="{lx:.1f}" y="{ly:.1f}" width="112" height="{lh}" '
                   f'fill="white" stroke="#999"/>')
        for i, (lbl, col) in enumerate(legend_entries):
            if i < len(labels):
                lbl = labels[i]
            yy = ly + 16 * i + 14
            out.append(f'<line x1="{lx+6:.1f}" y1="{yy-4:.1f}" x2="{lx+26:.1f}" '
                       f'y2="{yy-4:.1f}" stroke="{css(col)}" stroke-width="2"/>')
            out.append(f'<text x="{lx+32:.1f}" y="{yy:.1f}" font-size="10">'
                       f'{escape(str(lbl))}</text>')
    return "".join(out)


def _image_svg(m: _Mapper, ch) -> str:
    """Embed the image as a base64 PNG (lossless, small code path reuse)."""
    import base64

    from .raster import encode_png
    rgb = (np.clip(ch.data, 0, 1) * 255).astype(np.uint8)
    png = encode_png(rgb)
    b64 = base64.b64encode(png).decode()
    x0, x1, y0, y1 = ch.extent
    px0, py1 = m.map2(x0, y0)
    px1, py0 = m.map2(x1, y1)
    w = float(px1 - px0)
    h = float(py1 - py0)
    return (f'<image x="{float(px0):.1f}" y="{float(py0):.1f}" width="{w:.1f}" '
            f'height="{h:.1f}" preserveAspectRatio="none" '
            f'href="data:image/png;base64,{b64}"/>')


def probe_figure(fig, fx: float, fy: float):
    """Data cursor (≙ runmat-plot GUI picking): nearest line/scatter vertex
    to the figure-fraction point (fx, fy). Returns a readout dict with data
    coords, pixel coords (for the cursor dot), series label and 1-based
    index — or None when the figure has no probeable data."""
    W, H = fig.size
    px, py = fx * W, fy * H
    best = None
    for ax in fig.axes:
        try:
            m = _Mapper(ax, W, H)
        except Exception:
            continue
        for ch in ax.children:
            if ch.kind == "surface":
                from .shade3d import stride_for
                st = stride_for(ch.Z.shape, 4000)
                x = ch.X[::st, ::st].reshape(-1)
                y = ch.Y[::st, ::st].reshape(-1)
                z = ch.Z[::st, ::st].reshape(-1)
                sx, sy, _ = m.map3(x, y, z)
            elif ch.kind in ("line", "scatter"):
                x = np.asarray(ch.x, np.float64).reshape(-1)
                y = np.asarray(ch.y, np.float64).reshape(-1)
                z = None
                if getattr(ch, "z", None) is not None and ax.is3d:
                    z = np.asarray(ch.z, np.float64).reshape(-1)
                    sx, sy, _ = m.map3(x, y, z)
                else:
                    sx, sy = m.map2(x, y)
            else:
                continue
            d2 = (np.asarray(sx) - px) ** 2 + (np.asarray(sy) - py) ** 2
            finite = np.isfinite(d2)
            if not finite.any():
                continue
            i = int(np.argmin(np.where(finite, d2, np.inf)))
            rec = {"dist": float(np.sqrt(d2[i])),
                   "x": float(x[i]), "y": float(y[i]),
                   "px": float(np.asarray(sx).reshape(-1)[i]),
                   "py": float(np.asarray(sy).reshape(-1)[i]),
                   "series": getattr(ch, "label", None) or ch.kind,
                   "index": i + 1}
            if z is not None:
                rec["z"] = float(z[i])
            if best is None or rec["dist"] < best["dist"]:
                best = rec
    return best
