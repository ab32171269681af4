"""Copy of runmat_tpu/runtime/builtins/domains.py in the PyTorch port.

Domain builtin families: communications, finance, image processing, graphs.

Reference parity: builtins/comms (constellation modulation, api
modulate_constellation runmat-accelerate-api/src/lib.rs:1963), builtins/finance
(Black-Scholes, api:1572), builtins/image, builtins/graph.
"""

from __future__ import annotations

import heapq
import math
import struct
import zlib

import numpy as np

from ...errors import MatError, bad_arg
from ...values import MatArray, StructArray, is_text, normalize_shape, text_of
from ..registry import builtin


def _np(v):
    return v.host().astype(np.float64)


def _sc(v):
    return float(_np(v).reshape(-1)[0])


# ------------------------------------------------------------------ comms --- #


def _psk_points(M: int, phase: float) -> np.ndarray:
    k = np.arange(M)
    return np.exp(1j * (2 * np.pi * k / M + phase))


def _qam_points(M: int) -> np.ndarray:
    side = int(round(math.sqrt(M)))
    if side * side != M:
        raise bad_arg("qammod", "M must be a perfect square.")
    levels = np.arange(side) * 2 - (side - 1)
    re, im = np.meshgrid(levels, levels)
    return (re + 1j * im).reshape(-1, order="F").astype(complex)


@builtin("pskmod", category="comms", min_in=2, max_in=3)
def m_pskmod(x, M, phase=None):
    sym = _np(x).astype(np.int64)
    m = int(_sc(M))
    ph = _sc(phase) if phase is not None else 0.0
    pts = _psk_points(m, ph)
    return MatArray(pts[sym], "double")


@builtin("pskdemod", category="comms", min_in=2, max_in=3)
def m_pskdemod(y, M, phase=None):
    m = int(_sc(M))
    ph = _sc(phase) if phase is not None else 0.0
    h = y.host().astype(complex)
    ang = (np.angle(h) - ph) % (2 * np.pi)
    sym = np.round(ang * m / (2 * np.pi)).astype(np.int64) % m
    return MatArray(sym.astype(np.float64), "double")


@builtin("qammod", category="comms", min_in=2, max_in=4)
def m_qammod(x, M, *opts):
    sym = _np(x).astype(np.int64)
    pts = _qam_points(int(_sc(M)))
    # 'UnitAveragePower', true normalizes the constellation energy
    for i, o in enumerate(opts):
        if is_text(o) and text_of(o).lower() == "unitaveragepower" and \
                i + 1 < len(opts):
            on = bool(np.asarray(opts[i + 1].host()).reshape(-1)[0])
            if on:
                pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    return MatArray(pts[sym], "double")


@builtin("qamdemod", category="comms", min_in=2, max_in=2)
def m_qamdemod(y, M):
    pts = _qam_points(int(_sc(M)))
    h = y.host().astype(complex).reshape(-1)
    d = np.abs(h[:, None] - pts[None, :])
    sym = np.argmin(d, axis=1).astype(np.float64)
    return MatArray(sym.reshape(y.host().shape), "double")


@builtin("awgn", category="comms", min_in=2, max_in=2, pass_ctx=True)
def m_awgn(x, snr_db, ctx=None):
    from ...ops import ctrng
    h = x.host()
    snr = 10 ** (_sc(snr_db) / 10)
    power = float(np.mean(np.abs(h.astype(complex)) ** 2)) or 1.0
    sigma = math.sqrt(power / snr)
    state = ctx.session.rng
    if np.iscomplexobj(h):
        z = ctrng.host_randn(state, 2 * h.size, "double")
        noise = (z[:h.size] + 1j * z[h.size:]).reshape(h.shape) * sigma / math.sqrt(2)
    else:
        noise = ctrng.host_randn(state, h.size, "double").reshape(h.shape) * sigma
    return MatArray(h + noise, "double")


# ---------------------------------------------------------------- finance --- #


def _norm_cdf(x):
    return 0.5 * (1 + np.vectorize(math.erf)(np.asarray(x) / math.sqrt(2)))


@builtin("blsprice", category="finance", min_in=5, max_in=6, max_out=2,
         pass_nargout=True)
def m_blsprice(S, K, r, T, sigma, q=None, nargout=1):
    """[call, put] = blsprice(S, K, r, T, sigma[, yield]) — Black-Scholes."""
    Sv, Kv, rv, Tv, sv = (_np(a) for a in (S, K, r, T, sigma))
    qv = _np(q) if q is not None else np.zeros_like(Sv)
    Sv, Kv, rv, Tv, sv, qv = np.broadcast_arrays(Sv, Kv, rv, Tv, sv, qv)
    d1 = (np.log(Sv / Kv) + (rv - qv + sv ** 2 / 2) * Tv) / (sv * np.sqrt(Tv))
    d2 = d1 - sv * np.sqrt(Tv)
    call = Sv * np.exp(-qv * Tv) * _norm_cdf(d1) - Kv * np.exp(-rv * Tv) * _norm_cdf(d2)
    put = Kv * np.exp(-rv * Tv) * _norm_cdf(-d2) - Sv * np.exp(-qv * Tv) * _norm_cdf(-d1)
    res = [MatArray(np.asarray(call, np.float64).reshape(normalize_shape(call.shape)), "double"),
           MatArray(np.asarray(put, np.float64).reshape(normalize_shape(put.shape)), "double")]
    return res[:max(1, nargout)]


@builtin("blsdelta", category="finance", min_in=5, max_in=5, max_out=2,
         pass_nargout=True)
def m_blsdelta(S, K, r, T, sigma, nargout=1):
    Sv, Kv, rv, Tv, sv = np.broadcast_arrays(*(_np(a) for a in (S, K, r, T, sigma)))
    d1 = (np.log(Sv / Kv) + (rv + sv ** 2 / 2) * Tv) / (sv * np.sqrt(Tv))
    res = [MatArray(np.asarray(_norm_cdf(d1)), "double"),
           MatArray(np.asarray(_norm_cdf(d1) - 1), "double")]
    return res[:max(1, nargout)]


# ------------------------------------------------------------------ image --- #


@builtin("rgb2gray", category="image", min_in=1, max_in=1)
def m_rgb2gray(x):
    h = _np(x)
    if h.ndim != 3 or h.shape[2] != 3:
        raise bad_arg("rgb2gray", "Input must be an MxNx3 RGB image.")
    g = 0.2989 * h[:, :, 0] + 0.5870 * h[:, :, 1] + 0.1140 * h[:, :, 2]
    if x.mclass.startswith("uint"):
        from ... import dtypes
        return MatArray(dtypes.saturate_cast(np.round(g), x.mclass), x.mclass)
    return MatArray(g, x.mclass)


@builtin("im2double", category="image", min_in=1, max_in=1)
def m_im2double(x):
    h = x.host()
    if x.mclass == "uint8":
        return MatArray(h.astype(np.float64) / 255.0, "double")
    if x.mclass == "uint16":
        return MatArray(h.astype(np.float64) / 65535.0, "double")
    return MatArray(h.astype(np.float64), "double")


@builtin("padarray", category="image", min_in=2, max_in=4)
def m_padarray(x, padsize, padval=None, direction=None):
    """padarray(A, [p q] [, val] [, 'pre'|'post'|'both']): constant padding
    (val default 0); 'replicate'/'symmetric'/'circular' methods accepted as
    the val argument."""
    h = _np(x)
    ps = [int(v) for v in padsize.host().reshape(-1)]
    while len(ps) < h.ndim:
        ps.append(0)
    side = text_of(direction).lower() if direction is not None else "both"
    mode = "constant"
    cval = 0.0
    if padval is not None:
        if is_text(padval):
            m = text_of(padval).lower()
            if m in ("replicate", "symmetric", "circular"):
                mode = {"replicate": "edge", "symmetric": "symmetric",
                        "circular": "wrap"}[m]
            elif m in ("pre", "post", "both"):
                side = m
        else:
            cval = float(np.asarray(padval.host()).reshape(-1)[0])
    pad = []
    for p in ps[:h.ndim]:
        if side == "pre":
            pad.append((p, 0))
        elif side == "post":
            pad.append((0, p))
        else:
            pad.append((p, p))
    if mode == "constant":
        r = np.pad(h, pad, mode="constant", constant_values=cval)
    else:
        r = np.pad(h, pad, mode=mode)
    return MatArray(r, "double" if x.mclass in ("logical", "char")
                    else x.mclass)


@builtin("imresize", category="image", min_in=2, max_in=2)
def m_imresize(x, scale_or_size):
    h = _np(x)
    s = _np(scale_or_size).reshape(-1)
    if s.size == 1:
        out_shape = (max(1, int(round(h.shape[0] * s[0]))),
                     max(1, int(round(h.shape[1] * s[0]))))
    else:
        out_shape = (int(s[0]), int(s[1]))
    ys = np.clip((np.arange(out_shape[0]) + 0.5) * h.shape[0] / out_shape[0] - 0.5,
                 0, h.shape[0] - 1)
    xs = np.clip((np.arange(out_shape[1]) + 0.5) * h.shape[1] / out_shape[1] - 0.5,
                 0, h.shape[1] - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h.shape[0] - 1)
    x1 = np.minimum(x0 + 1, h.shape[1] - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    def plane(p):
        return ((1 - wy) * (1 - wx) * p[np.ix_(y0, x0)] + (1 - wy) * wx * p[np.ix_(y0, x1)]
                + wy * (1 - wx) * p[np.ix_(y1, x0)] + wy * wx * p[np.ix_(y1, x1)])
    if h.ndim == 3:
        out = np.stack([plane(h[:, :, k]) for k in range(h.shape[2])], axis=2)
    else:
        out = plane(h)
    return MatArray(out, "double")


@builtin("imfilter", category="image", min_in=2, max_in=3)
def m_imfilter(x, k, opt=None):
    boundary = "replicate" if opt is not None and is_text(opt) and \
        text_of(opt) == "replicate" else "constant"
    from ...values import MatArray as _MA
    if isinstance(x, _MA) and not x.is_complex and len(x.shape) == 2:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x):
            # device correlation kernel (≙ provider imfilter hook)
            out = eng.linalg("imfilter", [x, k], (boundary,))
            if out is not None:
                return out[0]
    h = _np(x)
    kk = _np(k)
    pad_r, pad_c = kk.shape[0] // 2, kk.shape[1] // 2
    mode = "edge" if opt is not None and is_text(opt) and \
        text_of(opt) == "replicate" else "constant"
    def conv_plane(p):
        pp = np.pad(p, ((pad_r, kk.shape[0] - 1 - pad_r),
                        (pad_c, kk.shape[1] - 1 - pad_c)), mode=mode)
        out = np.zeros_like(p)
        for i in range(kk.shape[0]):
            for j in range(kk.shape[1]):
                out += kk[i, j] * pp[i:i + p.shape[0], j:j + p.shape[1]]
        return out
    if h.ndim == 3:
        return MatArray(np.stack([conv_plane(h[:, :, c]) for c in
                                  range(h.shape[2])], axis=2), "double")
    return MatArray(conv_plane(h), "double")


@builtin("fspecial", category="image", min_in=1, max_in=3)
def m_fspecial(kind, arg1=None, arg2=None):
    k = text_of(kind)
    if k == "average":
        n = int(_sc(arg1)) if arg1 is not None else 3
        return MatArray(np.full((n, n), 1.0 / (n * n)), "double")
    if k == "gaussian":
        n = int(_sc(arg1)) if arg1 is not None else 3
        sig = _sc(arg2) if arg2 is not None else 0.5
        ax = np.arange(n) - (n - 1) / 2
        g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2 * sig ** 2))
        return MatArray(g / g.sum(), "double")
    if k == "sobel":
        return MatArray(np.array([[1., 2, 1], [0, 0, 0], [-1, -2, -1]]), "double")
    if k == "laplacian":
        return MatArray(np.array([[0., 1, 0], [1, -4, 1], [0, 1, 0]]), "double")
    raise bad_arg("fspecial", f"Unknown filter '{k}'.")


@builtin("imwrite", category="image", min_in=2, max_in=2)
def m_imwrite(x, path):
    from ...plot.raster import encode_png
    p = text_of(path)
    h = x.host()
    if x.mclass == "uint8":
        rgb = h.astype(np.uint8)
    else:
        rgb = (np.clip(h.astype(np.float64), 0, 1) * 255).astype(np.uint8)
    if not p.lower().endswith(".png"):
        # JPEG/BMP/TIFF/... through the host imaging library (the PNG path
        # below stays dependency-free)
        try:
            from PIL import Image
        except ImportError:
            raise bad_arg("imwrite",
                          "Only PNG output is supported without PIL.")
        Image.fromarray(rgb).save(p)
        return None
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=2)
    with open(p, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(rgb[:, :, :3])))
    return None


@builtin("imread", category="image", min_in=1, max_in=1)
def m_imread(path):
    """Minimal PNG reader (8-bit gray/RGB/RGBA, non-interlaced)."""
    p = text_of(path)
    with open(p, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        try:
            from PIL import Image
        except ImportError:
            raise bad_arg("imread", "Only PNG input is supported without PIL.")
        img = np.asarray(Image.open(p))
        return MatArray(np.ascontiguousarray(img), "uint8")
    pos = 8
    idat = b""
    w = h = bitd = ctype = None
    while pos < len(data):
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bitd, ctype = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    if bitd != 8 or ctype not in (0, 2, 6):
        raise bad_arg("imread", "Only 8-bit gray/RGB/RGBA PNG is supported.")
    nch = {0: 1, 2: 3, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for r in range(h):
        filt = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride], dtype=np.uint8).copy()
        pos += 1 + stride
        if filt == 1:       # Sub
            for i in range(nch, stride):
                row[i] = (row[i] + row[i - nch]) & 0xFF
        elif filt == 2:     # Up
            row = (row.astype(np.int32) + prev) .astype(np.uint8)
        elif filt == 3:     # Average
            for i in range(stride):
                a = row[i - nch] if i >= nch else 0
                row[i] = (row[i] + ((int(a) + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:     # Paeth
            for i in range(stride):
                a = int(row[i - nch]) if i >= nch else 0
                b = int(prev[i])
                c = int(prev[i - nch]) if i >= nch else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pr = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        out[r] = row
        prev = out[r]
    img = out.reshape(h, w, nch)
    if nch == 4:
        img = img[:, :, :3]
    if nch == 1:
        img = img[:, :, 0]
    return MatArray(np.ascontiguousarray(img), "uint8")


# ------------------------------------------------------------------ graphs -- #


class MatGraph:
    __slots__ = ("n", "adj", "directed", "shared")
    mclass = "graph"

    def __init__(self, n, adj, directed):
        self.n = n
        self.adj = adj          # list[list[(node, weight)]]
        self.directed = directed
        self.shared = False


def _build_graph(s, t, w, directed):
    si = _np(s).reshape(-1).astype(int) - 1
    ti = _np(t).reshape(-1).astype(int) - 1
    wi = _np(w).reshape(-1) if w is not None else np.ones(si.size)
    if wi.size == 1:
        wi = np.full(si.size, wi[0])
    n = int(max(si.max(initial=-1), ti.max(initial=-1)) + 1)
    adj = [[] for _ in range(n)]
    for a, b, ww in zip(si, ti, wi):
        adj[a].append((int(b), float(ww)))
        if not directed:
            adj[b].append((int(a), float(ww)))
    return MatGraph(n, adj, directed)


@builtin("graph", category="graph", min_in=2, max_in=3)
def m_graph(s, t, w=None):
    return _build_graph(s, t, w, directed=False)


@builtin("digraph", category="graph", min_in=2, max_in=3)
def m_digraph(s, t, w=None):
    return _build_graph(s, t, w, directed=True)


@builtin("numnodes", category="graph", min_in=1, max_in=1)
def m_numnodes(g):
    return MatArray.scalar(float(g.n))


@builtin("numedges", category="graph", min_in=1, max_in=1)
def m_numedges(g):
    e = sum(len(a) for a in g.adj)
    return MatArray.scalar(float(e if g.directed else e // 2))


@builtin("shortestpath", category="graph", min_in=3, max_in=3, max_out=2,
         pass_nargout=True)
def m_shortestpath(g, s, t, nargout=1):
    """Dijkstra."""
    if not isinstance(g, MatGraph):
        raise bad_arg("shortestpath", "First input must be a graph.")
    src = int(_sc(s)) - 1
    dst = int(_sc(t)) - 1
    dist = [math.inf] * g.n
    prev = [-1] * g.n
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        if u == dst:
            break
        for v, w in g.adj[u]:
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                prev[v] = u
                heapq.heappush(pq, (nd, v))
    if math.isinf(dist[dst]):
        path = np.zeros((1, 0))
    else:
        nodes = []
        u = dst
        while u != -1:
            nodes.append(u + 1)
            u = prev[u]
        path = np.array(nodes[::-1], dtype=np.float64).reshape(1, -1)
    res = [MatArray(path, "double"), MatArray.scalar(dist[dst])]
    return res[:max(1, nargout)]


@builtin("adjacency", category="graph", min_in=1, max_in=1)
def m_adjacency(g):
    from ...sparse import SparseMatrix
    ii, jj, vv = [], [], []
    for u, nbrs in enumerate(g.adj):
        for v, w in nbrs:
            ii.append(u)
            jj.append(v)
            vv.append(1.0)
    return SparseMatrix.from_triplets(np.array(ii, dtype=np.int64),
                                      np.array(jj, dtype=np.int64),
                                      np.array(vv), g.n, g.n)


@builtin("degree", category="graph", min_in=1, max_in=2)
def m_degree(g, nodes=None):
    deg = np.array([len(a) for a in g.adj], np.float64)
    if nodes is not None:
        idx = nodes.host().astype(np.int64).reshape(-1) - 1
        return MatArray(deg[idx].reshape(-1, 1), "double")
    return MatArray(deg.reshape(-1, 1), "double")
