"""Copy of runmat_tpu/runtime/builtins/misc2.py in the PyTorch port.

Misc batch: stats plot commands, Delaunay triangulation objects,
griddedInterpolant, symbolic limit/piecewise/digits, TCP sockets, matfile
objects, namedargs2cell, runtests, gpuInfo, empty.

Reference parity: runmat-runtime/src/builtins/{stats (plot commands),
geometry (DelaunayTri family), math/interpolation (griddedInterpolant,
interp1q), math/symbolic (digits/limit/piecewise), io/net (tcpclient/
tcpserver/read/write/readline/accept), io/mat (matfile), common
(namedargs2cell), diagnostics (runtests), acceleration/gpu (gpuInfo),
array/creation (empty)}.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, StructArray,
                       fortran_ravel, is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


# ---------------------------------------------------------- stats plotting --- #

@builtin("boxplot", category="stats/plots", min_in=1, max_in=2, pass_ctx=True)
def m_boxplot(x, g=None, ctx=None):
    h = _f(x)
    cols = [h[:, j] for j in range(h.shape[1])] if h.ndim == 2 and 1 not in h.shape \
        else [fortran_ravel(h)]
    if g is not None:
        codes = fortran_ravel(_f(g)).astype(int)
        flat = fortran_ravel(h)
        cols = [flat[codes == c] for c in sorted(set(codes.tolist()))]
    for j, col in enumerate(cols, 1):
        col = col[~np.isnan(col)]
        q1, q2, q3 = np.percentile(col, [25, 50, 75])
        iqr = q3 - q1
        lo = col[col >= q1 - 1.5 * iqr].min()
        hi = col[col <= q3 + 1.5 * iqr].max()
        for (y0, y1) in ((lo, q1), (q3, hi)):
            ctx.interp.call_named("plot", [
                MatArray(np.array([[j, j]], dtype=np.float64), "double"),
                MatArray(np.array([[y0, y1]]), "double")], 0, ctx.frame)
        ctx.interp.call_named("plot", [
            MatArray(np.array([[j - 0.25, j + 0.25, j + 0.25, j - 0.25, j - 0.25]]),
                     "double"),
            MatArray(np.array([[q1, q1, q3, q3, q1]]), "double")], 0, ctx.frame)
        ctx.interp.call_named("plot", [
            MatArray(np.array([[j - 0.25, j + 0.25]]), "double"),
            MatArray(np.array([[q2, q2]]), "double")], 0, ctx.frame)
    return None


@builtin("binscatter", category="stats/plots", min_in=2, max_in=3, pass_ctx=True)
def m_binscatter(x, y, n=None, ctx=None):
    nb = scalar_int(n, "n") if n is not None else 32
    counts, _ex, _ey = np.histogram2d(fortran_ravel(_f(x)),
                                      fortran_ravel(_f(y)), bins=nb)
    return ctx.interp.call_named("imagesc", [MatArray(counts.T[::-1], "double")],
                                 0, ctx.frame)


@builtin("cdfplot", category="stats/plots", min_in=1, max_in=1, pass_ctx=True)
def m_cdfplot(x, ctx=None):
    h = np.sort(fortran_ravel(_f(x)))
    h = h[~np.isnan(h)]
    fvals = np.arange(1, h.size + 1) / h.size
    return ctx.interp.call_named("stairs", [
        MatArray(h.reshape(1, -1), "double"),
        MatArray(fvals.reshape(1, -1), "double")], 0, ctx.frame)


@builtin("qqplot", category="stats/plots", min_in=1, max_in=2, pass_ctx=True)
def m_qqplot(x, y=None, ctx=None):
    from scipy import special as sp
    h = np.sort(fortran_ravel(_f(x)))
    h = h[~np.isnan(h)]
    n = h.size
    p = (np.arange(1, n + 1) - 0.5) / n
    if y is None:
        q = -np.sqrt(2.0) * sp.erfcinv(2 * p)
    else:
        hy = np.sort(fortran_ravel(_f(y)))
        q = np.interp(p, (np.arange(1, hy.size + 1) - 0.5) / hy.size, hy)
    return ctx.interp.call_named("scatter", [
        MatArray(q.reshape(-1, 1), "double"),
        MatArray(h.reshape(-1, 1), "double")], 0, ctx.frame)


@builtin("scatterhist", category="stats/plots", min_in=2, max_in=2, pass_ctx=True)
def m_scatterhist(x, y, ctx=None):
    return ctx.interp.call_named("scatter", [x, y], 0, ctx.frame)


def _fit_line_through(ax_children, ctx):
    xs, ys = [], []
    for ch in ax_children:
        if getattr(ch, "kind", "") in ("line", "scatter"):
            xs.append(np.asarray(ch.x))
            ys.append(np.asarray(ch.y))
    if not xs:
        raise MatError("stats:lsline:NoData", "No plotted data to fit.")
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    b, a = np.polyfit(x, y, 1)
    gx = np.array([x.min(), x.max()])
    ctx.interp.call_named("plot", [MatArray(gx.reshape(1, -1), "double"),
                                   MatArray((b * gx + a).reshape(1, -1),
                                            "double")], 0, ctx.frame)
    return float(b), float(a)


@builtin("lsline", category="stats/plots", min_in=0, max_in=0, pass_ctx=True)
def m_lsline(ctx=None):
    from ...plot import figure as figmod
    _fit_line_through(figmod.gca().children, ctx)
    return None


@builtin("refline", category="stats/plots", min_in=0, max_in=2, pass_ctx=True)
def m_refline(slope=None, icpt=None, ctx=None):
    from ...plot import figure as figmod
    ax = figmod.gca()
    if slope is None:
        _fit_line_through(ax.children, ctx)
        return None
    b = scalar_num(slope, "slope")
    a = scalar_num(icpt, "intercept") if icpt is not None else 0.0
    (x0, x1), _ = ax.data_limits()[:2]
    gx = np.array([min(x0, 0.0), max(x1, 1.0)])
    ctx.interp.call_named("plot", [MatArray(gx.reshape(1, -1), "double"),
                                   MatArray((b * gx + a).reshape(1, -1),
                                            "double")], 0, ctx.frame)
    return None


# ----------------------------------------------------- Delaunay triangulation --- #

class DelaunayTriValue:
    """Delaunay triangulation object (2-D/3-D) with point location and
    nearest-neighbor queries (host scipy.spatial, like the reference's
    native meshing kernels)."""

    mclass = "delaunayTriangulation"
    shared = False

    def __init__(self, pts: np.ndarray):
        from scipy.spatial import Delaunay, cKDTree
        self.pts = pts
        self.tri = Delaunay(pts)
        self.tree = cKDTree(pts)

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def free_boundary(self):
        from collections import Counter
        d = self.pts.shape[1]
        faces = Counter()
        for simp in self.tri.simplices:
            for skip in range(d + 1):
                face = tuple(sorted(np.delete(simp, skip)))
                faces[face] += 1
        return np.array(sorted(f for f, c in faces.items() if c == 1))

    def _mat_get_field_(self, fname):
        if fname == "Points":
            return MatArray(self.pts.copy(), "double")
        if fname == "ConnectivityList":
            return MatArray(self.tri.simplices.astype(np.float64) + 1, "double")
        return NotImplemented

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "freeBoundary":
            fb = self.free_boundary()
            return [MatArray(fb.astype(np.float64) + 1, "double")]
        if fname == "nearestNeighbor":
            _d, idx = self.tree.query(self._query_points(args,
                                                         "nearestNeighbor"))
            return [MatArray(np.asarray(idx, dtype=np.float64).reshape(-1, 1) + 1,
                             "double")]
        if fname == "pointLocation":
            q = self._query_points(args, "pointLocation")
            s = self.tri.find_simplex(q).astype(np.float64)
            s = np.where(s < 0, np.nan, s + 1)
            return [MatArray(s.reshape(-1, 1), "double")]
        return NotImplemented

    def _query_points(self, args, name: str) -> np.ndarray:
        """Query points from either an (N, d) matrix or per-coordinate
        vectors: method(dt, P) or method(dt, qx, qy[, qz])."""
        if len(args) == 1:
            return np.atleast_2d(args[0].host().astype(np.float64))
        cols = [fortran_ravel(a.host().astype(np.float64)) for a in args]
        if len({c.size for c in cols}) != 1:
            raise bad_arg(name, "Coordinate inputs must have equal sizes.")
        return np.column_stack(cols)


def _points_from(args) -> np.ndarray:
    if len(args) == 1:
        return args[0].host().astype(np.float64)
    return np.column_stack([fortran_ravel(_f(a)) for a in args])


@builtin("delaunayTriangulation", category="geometry", min_in=1, max_in=3)
def m_delaunay_triangulation(*args):
    return DelaunayTriValue(_points_from(args))


@builtin("DelaunayTri", category="geometry", min_in=1, max_in=3)
def m_delaunay_tri(*args):
    """Legacy name for delaunayTriangulation."""
    return DelaunayTriValue(_points_from(args))


@builtin("freeBoundary", category="geometry", min_in=1, max_in=1, pass_ctx=True)
def m_free_boundary(dt, ctx=None):
    if not isinstance(dt, DelaunayTriValue):
        raise bad_arg("freeBoundary", "Expected a triangulation.")
    return dt._mat_call_method_(None, None, "freeBoundary", [], 1)[0]


@builtin("nearestNeighbor", category="geometry", min_in=2, max_in=4)
def m_nearest_neighbor(dt, *q):
    if not isinstance(dt, DelaunayTriValue):
        raise bad_arg("nearestNeighbor", "Expected a triangulation.")
    return dt._mat_call_method_(None, None, "nearestNeighbor", list(q), 1)[0]


@builtin("pointLocation", category="geometry", min_in=2, max_in=4)
def m_point_location(dt, *q):
    if not isinstance(dt, DelaunayTriValue):
        raise bad_arg("pointLocation", "Expected a triangulation.")
    return dt._mat_call_method_(None, None, "pointLocation", list(q), 1)[0]


# ---------------------------------------------------------- interpolation --- #

class GriddedInterpolantValue:
    """Callable interpolant F(xq) / F(xq, yq) over gridded data."""

    mclass = "griddedInterpolant"
    shared = False

    def __init__(self, grids: list[np.ndarray], values: np.ndarray,
                 method: str = "linear"):
        self.grids = grids
        self.values = values
        self.method = method

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_get_field_(self, fname):
        if fname == "Method":
            return MatArray.char_from_str(self.method)
        if fname == "Values":
            return MatArray(self.values.copy(), "double")
        if fname == "GridVectors":
            data = np.empty((1, len(self.grids)), dtype=object)
            for i, g in enumerate(self.grids):
                data[0, i] = MatArray(g.reshape(1, -1), "double")
            return CellArray(data)
        return NotImplemented

    def evaluate(self, qs: list[np.ndarray]) -> np.ndarray:
        if len(self.grids) == 1:
            x = self.grids[0]
            v = self.values.reshape(-1)
            q = qs[0]
            if self.method == "nearest":
                idx = np.clip(np.searchsorted(x, q), 1, x.size - 1)
                pick = np.where(q - x[idx - 1] <= x[idx] - q, idx - 1, idx)
                return v[pick]
            return np.interp(q, x, v)
        from scipy.interpolate import RegularGridInterpolator
        rgi = RegularGridInterpolator(
            tuple(self.grids), self.values, method=self.method,
            bounds_error=False, fill_value=np.nan)
        pts = np.column_stack([q.reshape(-1) for q in qs])
        return rgi(pts)

    def _mat_paren_call_(self, interp, frame, args, nargout):
        qs = [fortran_ravel(a.host().astype(np.float64)) for a in args]
        shape = args[0].host().shape
        r = self.evaluate(qs)
        return [MatArray(np.asarray(r).reshape(shape), "double")]


@builtin("griddedInterpolant", category="math/interpolation", min_in=1, max_in=4)
def m_gridded_interpolant(*args):
    args = list(args)
    method = "linear"
    if args and is_text(args[-1]):
        method = text_of(args[-1])
        args.pop()
    if len(args) == 1:
        vals = _f(args[0])
        grids = [np.arange(1.0, s + 1) for s in vals.shape if s > 1] or \
            [np.arange(1.0, vals.size + 1)]
        return GriddedInterpolantValue(grids, vals.reshape([s for s in vals.shape
                                                            if s > 1] or [-1]),
                                       method)
    vals = _f(args[-1])
    grid_args = args[:-1]
    if len(grid_args) == 1 and isinstance(grid_args[0], CellArray):
        # MATLAB grid-vector cell form: F = griddedInterpolant({x1,...,xn}, V)
        grid_args = [e for e in
                     grid_args[0].data.reshape(-1, order="F")]
    grids = [fortran_ravel(_f(g)) for g in grid_args]
    if len(grids) == 1:
        return GriddedInterpolantValue(grids, fortran_ravel(vals), method)
    return GriddedInterpolantValue(grids, vals, method)


class ScatteredInterpolantValue:
    """Callable interpolant over scattered points (≙ the reference's
    scattered-interpolation surface; host scipy.interpolate cores).

    'natural' is evaluated with the linear (barycentric) core; outside the
    convex hull, 'linear'/'nearest' extrapolation falls back to the nearest
    data point and 'none' yields NaN.
    """

    mclass = "scatteredInterpolant"
    shared = False

    def __init__(self, pts: np.ndarray, vals: np.ndarray,
                 method: str = "linear", extrap: str | None = None):
        self.pts = pts
        self.vals = vals
        self.method = method
        self.extrap = extrap if extrap is not None else (
            "none" if method == "none" else
            ("nearest" if method == "nearest" else "linear"))

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return ScatteredInterpolantValue(self.pts, self.vals,
                                         self.method, self.extrap)

    def _mat_get_field_(self, fname):
        if fname == "Points":
            return MatArray(self.pts.copy(), "double")
        if fname == "Values":
            return MatArray(self.vals.reshape(-1, 1).copy(), "double")
        if fname == "Method":
            return MatArray.char_from_str(self.method)
        if fname == "ExtrapolationMethod":
            return MatArray.char_from_str(self.extrap)
        return NotImplemented

    def _mat_set_field_(self, fname, rhs):
        if fname == "Values":
            v = fortran_ravel(rhs.host().astype(np.float64))
            if v.size != self.pts.shape[0]:
                raise bad_arg("scatteredInterpolant",
                              "Values must match the number of points.")
            self.vals = v
            return self
        if fname == "Method":
            self.method = text_of(rhs)
            return self
        if fname == "ExtrapolationMethod":
            self.extrap = text_of(rhs)
            return self
        return NotImplemented

    def evaluate(self, q: np.ndarray) -> np.ndarray:
        from scipy.interpolate import (LinearNDInterpolator,
                                       NearestNDInterpolator)
        if self.method == "nearest":
            return NearestNDInterpolator(self.pts, self.vals)(q)
        r = LinearNDInterpolator(self.pts, self.vals)(q)
        bad = ~np.isfinite(r)
        if bad.any() and self.extrap != "none":
            ex = (self.extrap or
                  ("linear" if self.method == "linear" else "nearest"))
            if ex == "linear":
                r[bad] = self._extrap_linear(q[bad])
            else:
                r[bad] = NearestNDInterpolator(self.pts, self.vals)(q[bad])
        return r

    def _extrap_linear(self, q: np.ndarray) -> np.ndarray:
        """True linear extrapolation outside the convex hull (MATLAB's
        default for method 'linear' — ADVICE r4 #5): extend the plane of
        the boundary-adjacent simplex nearest each query. Falls back to
        nearest-value for degenerate triangulations."""
        from scipy.interpolate import NearestNDInterpolator
        from scipy.spatial import Delaunay, cKDTree
        try:
            tri = Delaunay(self.pts)
        except Exception:
            return NearestNDInterpolator(self.pts, self.vals)(q)
        # simplices incident to each vertex
        incident: dict = {}
        for si, simp in enumerate(tri.simplices):
            for v in simp:
                incident.setdefault(int(v), []).append(si)
        centroids = self.pts[tri.simplices].mean(axis=1)
        kd = cKDTree(self.pts)
        _, nearest_v = kd.query(q)
        out = np.empty(q.shape[0])
        d = self.pts.shape[1]
        for k in range(q.shape[0]):
            cands = incident.get(int(nearest_v[k]), [])
            if not cands:
                out[k] = self.vals[nearest_v[k]]
                continue
            si = min(cands, key=lambda s: float(
                np.sum((centroids[s] - q[k]) ** 2)))
            verts = tri.simplices[si]
            # plane through the simplex: vals ~ c0 + g . x (least squares
            # is exact for a nondegenerate simplex)
            A = np.column_stack([np.ones(len(verts)), self.pts[verts]])
            try:
                coef, *_ = np.linalg.lstsq(A, self.vals[verts], rcond=None)
                out[k] = coef[0] + float(coef[1:1 + d] @ q[k])
            except Exception:
                out[k] = self.vals[nearest_v[k]]
        return out

    def _mat_paren_call_(self, interp, frame, args, nargout):
        if len(args) == 1:
            q = np.atleast_2d(args[0].host().astype(np.float64))
            return [MatArray(self.evaluate(q).reshape(-1, 1), "double")]
        shape = args[0].host().shape
        cols = [fortran_ravel(a.host().astype(np.float64)) for a in args]
        r = self.evaluate(np.column_stack(cols))
        return [MatArray(np.asarray(r).reshape(shape, order="F"), "double")]


@builtin("scatteredInterpolant", category="math/interpolation",
         min_in=2, max_in=6)
def m_scattered_interpolant(*args):
    args = list(args)
    texts = []
    while args and is_text(args[-1]):
        texts.insert(0, text_of(args[-1]).lower())
        args.pop()
    method = texts[0] if texts else "linear"
    extrap = texts[1] if len(texts) > 1 else None
    vals = fortran_ravel(args[-1].host().astype(np.float64))
    if len(args) == 2:
        pts = np.atleast_2d(args[0].host().astype(np.float64))
    else:
        pts = np.column_stack([fortran_ravel(a.host().astype(np.float64))
                               for a in args[:-1]])
    if pts.shape[0] != vals.size:
        raise bad_arg("scatteredInterpolant",
                      "Sample points and values must have the same length.")
    return ScatteredInterpolantValue(pts, vals, method, extrap)


@builtin("interp1q", category="math/interpolation", min_in=3, max_in=3)
def m_interp1q(x, y, xq):
    hx = fortran_ravel(_f(x))
    hy = _f(y)
    hq = fortran_ravel(_f(xq))
    if hy.ndim == 2 and 1 in hy.shape:
        r = np.interp(hq, hx, fortran_ravel(hy), left=np.nan, right=np.nan)
        return MatArray(r.reshape(-1, 1), "double")
    out = np.column_stack([np.interp(hq, hx, hy[:, j], left=np.nan, right=np.nan)
                           for j in range(hy.shape[1])])
    return MatArray(out, "double")


# ----------------------------------------------------------------- symbolic --- #

_VPA_DIGITS = [32]


@builtin("digits", category="math/symbolic", min_in=0, max_in=1, pass_nargout=True)
def m_digits(n=None, nargout=0):
    old = _VPA_DIGITS[0]
    if n is not None:
        _VPA_DIGITS[0] = scalar_int(n, "digits")
    if nargout >= 1 or n is None:
        return MatArray.scalar(float(old))
    return None


@builtin("limit", category="math/symbolic", min_in=1, max_in=4)
def m_limit(e, var=None, a=None, direction=None):
    import sympy as sp
    from .symbolic import SymValue, _to_sym
    se = _to_sym(e)
    expr = se.exprs.reshape(-1)[0]
    syms = sorted(expr.free_symbols, key=lambda s: s.name)
    v = sp.Symbol(text_of(var)) if var is not None and is_text(var) else \
        (_to_sym(var).exprs.reshape(-1)[0] if var is not None else
         (syms[0] if syms else sp.Symbol("x")))
    pt = 0
    if a is not None:
        pt = _to_sym(a).exprs.reshape(-1)[0]
    dirn = "+-"
    if direction is not None and is_text(direction):
        dirn = {"left": "-", "right": "+"}.get(text_of(direction), "+-")
    try:
        r = sp.limit(expr, v, pt, dirn)
    except Exception:
        r = sp.limit(expr, v, pt, "+")
    return SymValue.scalar(r)


@builtin("piecewise", category="math/symbolic", min_in=2)
def m_piecewise(*args):
    import sympy as sp
    from .symbolic import SymValue, _to_sym
    pairs = []
    args = list(args)
    while len(args) >= 2:
        cond = _to_sym(args.pop(0)).exprs.reshape(-1)[0]
        val = _to_sym(args.pop(0)).exprs.reshape(-1)[0]
        pairs.append((val, cond))
    if args:   # trailing otherwise-value
        pairs.append((_to_sym(args[0]).exprs.reshape(-1)[0], True))
    return SymValue.scalar(sp.Piecewise(*pairs))


# --------------------------------------------------------------- tcp sockets --- #

class TcpValue:
    mclass = "tcpclient"
    shared = False

    def __init__(self, sock, role: str):
        self.sock = sock
        self.role = role
        self._rbuf = b""

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _recv_into(self, want: int | None):
        import socket as _s
        self.sock.settimeout(5.0)
        try:
            while want is None or len(self._rbuf) < want:
                chunk = self.sock.recv(65536)
                if not chunk:
                    break
                self._rbuf += chunk
                if want is None:
                    break
        except (_s.timeout, OSError):
            pass

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "write":
            return [m_tcp_write(self, *args)]
        if fname == "read":
            return [m_tcp_read(self, *args)]
        if fname == "readline":
            return [m_tcp_readline(self)]
        if fname == "flush":
            self._rbuf = b""
            return []
        return NotImplemented

    def _mat_get_field_(self, fname):
        if fname == "NumBytesAvailable":
            self._recv_into(None)
            return MatArray.scalar(float(len(self._rbuf)))
        return NotImplemented


class TcpServerValue(TcpValue):
    mclass = "tcpserver"

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "accept":
            return [m_tcp_accept(self)]
        return super()._mat_call_method_(interp, frame, fname, args, nargout)


@builtin("tcpclient", category="io/net", min_in=2, max_in=2)
def m_tcpclient(host, port):
    import socket
    s = socket.create_connection((text_of(host), scalar_int(port, "port")),
                                 timeout=5.0)
    return TcpValue(s, "client")


@builtin("tcpserver", category="io/net", min_in=1, max_in=2)
def m_tcpserver(host_or_port, port=None):
    import socket
    if port is None:
        host, p = "127.0.0.1", scalar_int(host_or_port, "port")
    else:
        host, p = text_of(host_or_port), scalar_int(port, "port")
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, p))
    srv.listen(1)
    return TcpServerValue(srv, "server")


@builtin("accept", category="io/net", min_in=1, max_in=1)
def m_tcp_accept(srv):
    if not isinstance(srv, TcpServerValue):
        raise bad_arg("accept", "Expected a tcpserver.")
    conn, _addr = srv.sock.accept()
    return TcpValue(conn, "connection")


@builtin("write", category="io/net", min_in=2, max_in=3)
def m_tcp_write(conn, data, dtype=None):
    if not isinstance(conn, TcpValue):
        raise bad_arg("write", "Expected a tcp connection.")
    if is_text(data):
        raw = text_of(data).encode("utf-8")
    else:
        h = data.host()
        dt = text_of(dtype) if dtype is not None else \
            ("uint8" if h.dtype.kind in "ui" else "double")
        raw = h.astype({"uint8": np.uint8, "double": np.float64,
                        "single": np.float32}.get(dt, np.uint8)).tobytes()
    conn.sock.sendall(raw)
    return MatArray.scalar(float(len(raw)))


@builtin("read", category="io/net", min_in=1, max_in=3)
def m_tcp_read(conn, count=None, dtype=None):
    if not isinstance(conn, TcpValue):
        raise bad_arg("read", "Expected a tcp connection.")
    dt_name = text_of(dtype) if dtype is not None else "uint8"
    dt = {"uint8": np.uint8, "double": np.float64,
          "single": np.float32, "char": np.uint8}.get(dt_name, np.uint8)
    want = None
    if count is not None:
        want = scalar_int(count, "count") * np.dtype(dt).itemsize
    conn._recv_into(want)
    raw = conn._rbuf if want is None else conn._rbuf[:want]
    conn._rbuf = conn._rbuf[len(raw):]
    vals = np.frombuffer(raw, dtype=dt)
    if dt_name == "char":
        return MatArray.char_from_str(raw.decode("utf-8", errors="replace"))
    return MatArray(vals.astype(np.float64).reshape(1, -1), "double")


@builtin("readline", category="io/net", min_in=1, max_in=1)
def m_tcp_readline(conn):
    if not isinstance(conn, TcpValue):
        raise bad_arg("readline", "Expected a tcp connection.")
    while b"\n" not in conn._rbuf:
        n0 = len(conn._rbuf)
        conn._recv_into(n0 + 1)
        if len(conn._rbuf) == n0:
            break
    line, _sep, rest = conn._rbuf.partition(b"\n")
    conn._rbuf = rest
    return StringArray.scalar(line.decode("utf-8", errors="replace").rstrip("\r"))


# ------------------------------------------------------------------ matfile --- #

class MatFileValue:
    """Lazy .mat accessor: m.varname reads one variable; m.varname = v
    writes it back (≙ matlab.io.MatFile)."""

    mclass = "matlab.io.MatFile"
    shared = False

    def __init__(self, path: str, writable: bool):
        self.path = path
        self.writable = writable

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _load_all(self) -> dict:
        from ...matio import load_mat
        try:
            return load_mat(self.path)
        except FileNotFoundError:
            return {}

    def _mat_get_field_(self, fname):
        if fname == "Properties":
            return StructArray.scalar({
                "Source": MatArray.char_from_str(self.path),
                "Writable": MatArray.logical_scalar(self.writable)})
        vars_ = self._load_all()
        if fname in vars_:
            return vars_[fname]
        return NotImplemented

    def _mat_set_field_(self, fname, value):
        if not self.writable:
            raise MatError("MATLAB:MatFile:NotWritable",
                           "MAT-file object is not writable; use "
                           "matfile(path, 'Writable', true).")
        from ...matio import save_mat
        vars_ = self._load_all()
        vars_[fname] = value
        save_mat(self.path, vars_)
        return True

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "who":
            names = sorted(self._load_all())
            data = np.empty((len(names), 1), dtype=object)
            for i, n in enumerate(names):
                data[i, 0] = MatArray.char_from_str(n)
            return [CellArray(data)]
        return NotImplemented


@builtin("matfile", category="io/mat", min_in=1)
def m_matfile(path, *opts):
    writable = False
    opts = list(opts)
    for i in range(0, len(opts) - 1, 2):
        if is_text(opts[i]) and text_of(opts[i]) == "Writable":
            writable = bool(opts[i + 1].is_true())
    return MatFileValue(text_of(path), writable)


# --------------------------------------------------------------------- misc --- #

@builtin("namedargs2cell", category="common", min_in=1, max_in=1)
def m_namedargs2cell(s):
    if not isinstance(s, StructArray) or not s.is_scalar:
        raise bad_arg("namedargs2cell", "Expected a scalar struct.")
    items = []
    for k in s.fields:
        items.append(MatArray.char_from_str(k))
        items.append(s.get_scalar_field(k))
    data = np.empty((1, len(items)), dtype=object)
    for i, v in enumerate(items):
        data[0, i] = v
    return CellArray(data)


@builtin("runtests", category="diagnostics", min_in=0, max_in=1, pass_ctx=True)
def m_runtests(target=None, ctx=None):
    """Run test scripts (test*.m / *_test.m) from the target folder; a test
    passes if it executes without error."""
    import os
    from ...fs import fs
    base = text_of(target) if target is not None else "."
    names = [n for n in (fs().listdir(base) if fs().is_dir(base) else [])
             if n.endswith(".m") and (n.startswith("test") or
                                      n.endswith("_test.m"))]
    n = len(names)
    fields = {"Name": np.empty((n, 1), dtype=object),
              "Passed": np.empty((n, 1), dtype=object),
              "Failed": np.empty((n, 1), dtype=object),
              "Duration": np.empty((n, 1), dtype=object)}
    import time as _t
    for i, nm in enumerate(sorted(names)):
        src = fs().read_bytes(os.path.join(base, nm)).decode("utf-8")
        t0 = _t.perf_counter()
        ok = True
        try:
            ctx.session.run_source(src, nm)
        except Exception:
            ok = False
        fields["Name"][i, 0] = MatArray.char_from_str(nm)
        fields["Passed"][i, 0] = MatArray.logical_scalar(ok)
        fields["Failed"][i, 0] = MatArray.logical_scalar(not ok)
        fields["Duration"][i, 0] = MatArray.scalar(_t.perf_counter() - t0)
    return StructArray(fields, (n, 1))


@builtin("gpuInfo", category="acceleration", min_in=0, max_in=0)
def m_gpuinfo():
    from ...accel import active_engine
    eng = active_engine()
    if eng is None:
        return StructArray.scalar({"Available": MatArray.logical_scalar(False)})
    info = eng.device_info()
    return StructArray.scalar({
        "Available": MatArray.logical_scalar(True),
        "Name": MatArray.char_from_str(str(info.get("name", "device"))),
        "Platform": MatArray.char_from_str(eng.platform),
        "DeviceCount": MatArray.scalar(float(info.get("count", 1))),
    })


@builtin("empty", category="array/creation", min_in=0)
def m_empty(*dims):
    if not dims:
        return MatArray.empty()
    ds = [scalar_int(d, "size") for d in dims]
    if 0 not in ds:
        raise MatError("MATLAB:class:emptyMustBeEmpty",
                       "At least one dimension must be zero.")
    return MatArray(np.zeros(tuple(ds)), "double")


@builtin("import", category="language", min_in=0, max_in=None,
         pass_ctx=True, pass_nargout=True)
def m_import(*paths, ctx=None, nargout=1):
    """import pkg.fn / import pkg.* — extend unqualified-name resolution
    (≙ HIR import handling; statement form lowers to this builtin). With
    no inputs returns the current import list."""
    sess = ctx.session
    if not hasattr(sess, "imports"):
        sess.imports = []
    if not paths:
        data = np.empty((len(sess.imports), 1), dtype=object)
        for i, p in enumerate(sess.imports):
            data[i, 0] = MatArray.char_from_str(p)
        return CellArray(data)
    for p in paths:
        s = text_of(p)
        if s not in sess.imports:
            sess.imports.insert(0, s)   # most recent import wins
    return None
