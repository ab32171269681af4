"""Copy of runmat_tpu/plot/raster.py in the PyTorch port.

PNG rasterizer: scanline renderer + PNG encoder, no external deps.

Reference parity: runmat-plot's headless PNG export
(crates/runmat-plot/src/export/) — the wgpu render target maps to a numpy
RGB canvas here; lines are drawn with a coverage-based thick-line sweep,
polygons with even-odd scanline fill, text with a built-in 5x7 bitmap font.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 5x7 bitmap font (columns LSB=top), covering the characters axes need
_FONT = {
    "0": "3E5149453E", "1": "00427F4000", "2": "4263554948", "3": "2241494936",
    "4": "1814127F10", "5": "2745454539", "6": "3C4A494930", "7": "0171090503",
    "8": "3649494936", "9": "064949291E", ".": "0060600000", "-": "0808080808",
    "+": "08083E0808", "e": "384545453C"[:10], " ": "0000000000",
    ",": "00A0600000", ":": "0036360000",
}
_FONT["e"] = "3854545418"
for _c in "abcdfghijklmnopqrstuvwxyz":
    _FONT.setdefault(_c, "7F7F7F7F7F")


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class Canvas:
    def __init__(self, w: int, h: int, bg=(1.0, 1.0, 1.0)):
        self.w, self.h = w, h
        self.buf = np.empty((h, w, 3), dtype=np.float32)
        self.buf[:] = bg

    def to_png(self) -> bytes:
        return encode_png((np.clip(self.buf, 0, 1) * 255).astype(np.uint8))

    # -- primitives ------------------------------------------------------------

    def line(self, x0, y0, x1, y1, color, width=1.5):
        if not all(np.isfinite([x0, y0, x1, y1])):
            return
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        ts = np.linspace(0.0, 1.0, n)
        xs = x0 + (x1 - x0) * ts
        ys = y0 + (y1 - y0) * ts
        r = max(0.5, width / 2)
        ri = int(np.ceil(r))
        col = np.asarray(color, np.float32)
        for dx in range(-ri, ri + 1):
            for dy in range(-ri, ri + 1):
                if dx * dx + dy * dy > r * r + 0.5:
                    continue
                px = np.round(xs).astype(int) + dx
                py = np.round(ys).astype(int) + dy
                ok = (px >= 0) & (px < self.w) & (py >= 0) & (py < self.h)
                self.buf[py[ok], px[ok]] = col

    def polyline(self, px, py, color, width=1.5, style="-"):
        pattern = {"-": None, "--": (8, 4), ":": (2, 3), "-.": (8, 3)}.get(style or "-")
        dist = 0.0
        for i in range(len(px) - 1):
            if pattern is None:
                self.line(px[i], py[i], px[i + 1], py[i + 1], color, width)
            else:
                seg = float(np.hypot(px[i + 1] - px[i], py[i + 1] - py[i]))
                on, off = pattern
                t = 0.0
                while t < seg:
                    phase = (dist + t) % (on + off)
                    if phase < on:
                        tend = min(seg, t + (on - phase))
                        f0, f1 = t / seg if seg else 0, tend / seg if seg else 0
                        self.line(px[i] + (px[i+1]-px[i])*f0, py[i] + (py[i+1]-py[i])*f0,
                                  px[i] + (px[i+1]-px[i])*f1, py[i] + (py[i+1]-py[i])*f1,
                                  color, width)
                        t = tend
                    else:
                        t += (on + off) - phase
                dist += seg

    def fill_poly(self, px, py, color):
        px = np.asarray(px, np.float64)
        py = np.asarray(py, np.float64)
        ok = np.isfinite(px) & np.isfinite(py)
        px, py = px[ok], py[ok]
        if px.size < 3:
            return
        col = np.asarray(color, np.float32)
        ylo = max(0, int(np.floor(py.min())))
        yhi = min(self.h - 1, int(np.ceil(py.max())))
        n = px.size
        for yy in range(ylo, yhi + 1):
            yc = yy + 0.5
            xs = []
            for i in range(n):
                x1, y1 = px[i], py[i]
                x2, y2 = px[(i + 1) % n], py[(i + 1) % n]
                if (y1 <= yc < y2) or (y2 <= yc < y1):
                    xs.append(x1 + (yc - y1) / (y2 - y1) * (x2 - x1))
            xs.sort()
            for k in range(0, len(xs) - 1, 2):
                a = max(0, int(np.ceil(xs[k] - 0.5)))
                b = min(self.w - 1, int(np.floor(xs[k + 1] - 0.5)))
                if b >= a:
                    self.buf[yy, a:b + 1] = col

    def fill_tri(self, px, py, colors, alpha=1.0):
        """Barycentric triangle fill with per-vertex RGB interpolation
        (Gouraud). px/py: 3 pixel coords; colors: (3, 3) vertex RGB rows
        (pass three identical rows for flat shading). Vectorized over the
        triangle's bounding box."""
        px = np.asarray(px, np.float64)
        py = np.asarray(py, np.float64)
        if not (np.isfinite(px).all() and np.isfinite(py).all()):
            return
        x0 = max(0, int(np.floor(px.min())))
        x1 = min(self.w - 1, int(np.ceil(px.max())))
        y0 = max(0, int(np.floor(py.min())))
        y1 = min(self.h - 1, int(np.ceil(py.max())))
        if x1 < x0 or y1 < y0:
            return
        xs = np.arange(x0, x1 + 1) + 0.5
        ys = np.arange(y0, y1 + 1) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        d = (py[1] - py[2]) * (px[0] - px[2]) + (px[2] - px[1]) * (py[0] - py[2])
        if abs(d) < 1e-12:
            return
        w0 = ((py[1] - py[2]) * (gx - px[2]) + (px[2] - px[1]) * (gy - py[2])) / d
        w1 = ((py[2] - py[0]) * (gx - px[2]) + (px[0] - px[2]) * (gy - py[2])) / d
        w2 = 1.0 - w0 - w1
        eps = -1e-7
        inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
        if not inside.any():
            return
        c = np.asarray(colors, np.float32)
        rgb = (w0[..., None] * c[0] + w1[..., None] * c[1]
               + w2[..., None] * c[2]).astype(np.float32)
        tile = self.buf[y0:y1 + 1, x0:x1 + 1]
        if alpha >= 1.0:
            tile[inside] = np.clip(rgb[inside], 0.0, 1.0)
        else:
            a = np.float32(alpha)
            tile[inside] = np.clip(a * rgb[inside] + (1 - a) * tile[inside],
                                   0.0, 1.0)

    def blit(self, rgb: np.ndarray, x0: int, y0: int, x1: int, y1: int):
        """Nearest-neighbor image into pixel rect [x0,x1)x[y0,y1)."""
        tw, th = max(1, x1 - x0), max(1, y1 - y0)
        sy = (np.arange(th) * rgb.shape[0] / th).astype(int)
        sx = (np.arange(tw) * rgb.shape[1] / tw).astype(int)
        img = rgb[sy][:, sx]
        ax0, ay0 = max(0, x0), max(0, y0)
        ax1, ay1 = min(self.w, x1), min(self.h, y1)
        if ax1 <= ax0 or ay1 <= ay0:
            return
        self.buf[ay0:ay1, ax0:ax1] = img[ay0 - y0:ay1 - y0, ax0 - x0:ax1 - x0]

    def text(self, x, y, s, color=(0, 0, 0), size=10, anchor="middle"):
        scale = max(1, int(round(size / 8)))
        wpx = len(s) * 6 * scale
        if anchor == "middle":
            x -= wpx / 2
        elif anchor == "end":
            x -= wpx
        col = np.asarray(color, np.float32)
        cx = int(round(x))
        cy = int(round(y)) - 7 * scale // 2
        for ch in s.lower():
            glyph = _FONT.get(ch, _FONT[" "])
            for cidx in range(5):
                bits = int(glyph[cidx * 2:cidx * 2 + 2], 16)
                for ridx in range(7):
                    if bits >> ridx & 1:
                        xx = cx + cidx * scale
                        yy = cy + ridx * scale
                        if 0 <= xx < self.w - scale and 0 <= yy < self.h - scale:
                            self.buf[yy:yy + scale, xx:xx + scale] = col
            cx += 6 * scale


def render_png(fig) -> bytes:
    """Rasterize a Figure through the same scene-graph walk as svg.py."""
    import math

    from .colors import css  # noqa: F401
    from .figure import nice_ticks, fmt_tick
    from .svg import _Mapper

    W, H = fig.size
    cv = Canvas(W, H)
    for ax in fig.axes:
        m = _Mapper(ax, W, H)
        x0p, y0p, wp, hp = m.px0, m.py0, m.pw, m.ph
        if not ax.axis_off:
            cv.polyline([x0p, x0p + wp, x0p + wp, x0p, x0p],
                        [y0p, y0p, y0p + hp, y0p + hp, y0p], (0.2, 0.2, 0.2), 1)
            if not ax.is3d:
                for t in nice_ticks(m.x0, m.x1):
                    tv = 10 ** t if ax.xscale == "log" else t
                    px = float(m._tx(tv))
                    if x0p <= px <= x0p + wp:
                        if ax.grid:
                            cv.polyline([px, px], [y0p, y0p + hp], (0.87, 0.87, 0.87), 1)
                        cv.text(px, y0p + hp + 10, fmt_tick(tv))
                for t in nice_ticks(m.y0, m.y1):
                    tv = 10 ** t if ax.yscale == "log" else t
                    py = float(m._ty(tv))
                    if y0p <= py <= y0p + hp:
                        if ax.grid:
                            cv.polyline([x0p, x0p + wp], [py, py], (0.87, 0.87, 0.87), 1)
                        cv.text(x0p - 16, py, fmt_tick(tv), anchor="middle")
        kids = list(ax.children)
        if ax.is3d:
            kids.sort(key=lambda ch: (getattr(ch, "depth", None) is None,
                                      getattr(ch, "depth", 0) or 0))
        for ch in kids:
            if ch.kind == "line":
                if ch.z is not None:
                    px, py, _ = m.map3(ch.x, ch.y, ch.z)
                else:
                    px, py = m.map2(ch.x, ch.y)
                if ch.style != "none":
                    cv.polyline(np.atleast_1d(px), np.atleast_1d(py), ch.color,
                                ch.width, ch.style)
                if ch.marker:
                    for x, y in zip(np.atleast_1d(px), np.atleast_1d(py)):
                        if math.isfinite(x) and math.isfinite(y):
                            cv.line(x - 3, y, x + 3, y, ch.color, 1.5)
                            cv.line(x, y - 3, x, y + 3, ch.color, 1.5)
            elif ch.kind == "scatter":
                if ch.z is not None:
                    px, py, _ = m.map3(ch.x, ch.y, ch.z)
                else:
                    px, py = m.map2(ch.x, ch.y)
                for x, y, s in zip(np.atleast_1d(px), np.atleast_1d(py), ch.sizes):
                    if math.isfinite(x) and math.isfinite(y):
                        r = max(1.5, np.sqrt(max(s, 1)) / 2)
                        cv.line(x - r, y, x + r, y, ch.color, 2 * r)
            elif ch.kind == "patch":
                vcs = getattr(ch, "vertexcolors", None)
                for pi, poly in enumerate(ch.polys):
                    poly = np.asarray(poly, np.float64)
                    if poly.shape[1] > 2:
                        px, py, _ = m.map3(poly[:, 0], poly[:, 1], poly[:, 2])
                    else:
                        px, py = m.map2(poly[:, 0], poly[:, 1])
                    vc = (vcs[pi] if vcs is not None and pi < len(vcs)
                          else None)
                    if vc is not None:
                        # Gouraud 'interp' face: fan-triangulate with
                        # per-vertex color interpolation
                        vc = np.asarray(vc, np.float64)
                        for k in range(1, len(px) - 1):
                            idx = [0, k, k + 1]
                            cv.fill_tri(np.asarray(px)[idx],
                                        np.asarray(py)[idx], vc[idx])
                    elif ch.facecolor is not None:
                        cv.fill_poly(px, py, ch.facecolor)
                    if ch.edgecolor is not None:
                        cv.polyline(np.append(px, px[0]), np.append(py, py[0]),
                                    ch.edgecolor, 1)
            elif ch.kind == "surface":
                from .shade3d import draw_surface
                draw_surface(cv, m, ax, ch,
                             max_faces=(400 if getattr(fig, "draft", False)
                                        else 6000))
            elif ch.kind == "trimesh":
                from .shade3d import trimesh_polys
                for qx, qy, face, edge in trimesh_polys(
                        m, ax, ch,
                        max_faces=(800 if getattr(fig, "draft", False)
                                   else 8000)):
                    if face is not None:
                        cv.fill_poly(np.asarray(qx), np.asarray(qy), face)
                    if edge is not None:
                        cv.polyline(np.append(qx, qx[0]),
                                    np.append(qy, qy[0]), edge, 1)
            elif ch.kind == "image":
                x0, x1, y0, y1 = ch.extent
                pa, pb = m.map2(x0, y0)
                pc, pd = m.map2(x1, y1)
                rgb = np.clip(ch.data, 0, 1).astype(np.float32)
                cv.blit(rgb, int(min(pa, pc)), int(min(pb, pd)),
                        int(max(pa, pc)), int(max(pb, pd)))
            elif ch.kind == "text":
                px, py = m.map2(ch.x, ch.y)
                cv.text(float(px), float(py), ch.s, ch.color, ch.size, ch.anchor)
        if ax.title:
            cv.text(x0p + wp / 2, y0p - 12, ax.title, size=13)
        if ax.xlabel:
            cv.text(x0p + wp / 2, y0p + hp + 26, ax.xlabel, size=11)
    return cv.to_png()
