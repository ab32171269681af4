"""Copy of runmat_tpu/runtime/builtins/interp_poly.py in the PyTorch port.

Interpolation & misc math: interp1, interp2, spline hooks.

Reference parity: runmat-runtime/src/builtins/math/interpolation.
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import MatArray, fortran_ravel, is_text, text_of
from ..registry import builtin


@builtin("interp1", category="math/interpolation", min_in=2, max_in=5)
def m_interp1(x, v=None, xq=None, method=None, extrap=None):
    # device path for the hot case: linear, default NaN extrapolation
    # (≙ provider interpolation hook) — one fused gather+lerp kernel
    if v is not None and xq is not None and extrap is None and \
            (method is None or (is_text(method)
                                and text_of(method) == "linear")) and \
            all(isinstance(z, MatArray) and not z.is_complex
                for z in (x, v, xq)):
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None and eng.route_linalg(x, v, xq):
            out = eng.linalg("interp1lin", [x, v, xq])
            if out is not None:
                return out[0]
    hx = x.host().astype(np.float64).reshape(-1)
    if v is None:
        raise bad_arg("interp1", "Not enough inputs.")
    hv = v.host().astype(np.float64).reshape(-1)
    hq = xq.host().astype(np.float64) if xq is not None else None
    m = text_of(method) if method is not None and is_text(method) else "linear"
    if hq is None:
        raise bad_arg("interp1", "Query points required.")
    if m in ("linear",):
        r = np.interp(hq.reshape(-1), hx, hv, left=np.nan, right=np.nan)
    elif m in ("nearest",):
        idx = np.clip(np.searchsorted(hx, hq.reshape(-1)), 1, hx.size - 1)
        lo = hx[idx - 1]
        hi = hx[idx]
        pick = np.where(np.abs(hq.reshape(-1) - lo) <= np.abs(hi - hq.reshape(-1)), idx - 1, idx)
        r = hv[pick]
        out_of = (hq.reshape(-1) < hx[0]) | (hq.reshape(-1) > hx[-1])
        r = np.where(out_of, np.nan, r)
    elif m in ("previous",):
        idx = np.searchsorted(hx, hq.reshape(-1), side="right") - 1
        r = np.where(idx >= 0, hv[np.clip(idx, 0, hv.size - 1)], np.nan)
        r = np.where(hq.reshape(-1) > hx[-1], np.nan, r)
    elif m in ("next",):
        idx = np.searchsorted(hx, hq.reshape(-1), side="left")
        r = np.where(idx < hx.size, hv[np.clip(idx, 0, hv.size - 1)], np.nan)
        r = np.where(hq.reshape(-1) < hx[0], np.nan, r)
    elif m in ("pchip", "cubic", "spline"):
        r = _spline_eval(hx, hv, hq.reshape(-1), m)
    else:
        raise bad_arg("interp1", f"Unknown method '{m}'.")
    if extrap is not None and not is_text(extrap):
        ev = extrap.scalar_double()
        out_of = (hq.reshape(-1) < hx[0]) | (hq.reshape(-1) > hx[-1])
        r = np.where(out_of, ev, r)
    elif extrap is not None and is_text(extrap) and text_of(extrap) == "extrap":
        out_of = (hq.reshape(-1) < hx[0]) | (hq.reshape(-1) > hx[-1])
        slope_lo = (hv[1] - hv[0]) / (hx[1] - hx[0]) if hx.size > 1 else 0.0
        slope_hi = (hv[-1] - hv[-2]) / (hx[-1] - hx[-2]) if hx.size > 1 else 0.0
        q = hq.reshape(-1)
        r = np.where(q < hx[0], hv[0] + slope_lo * (q - hx[0]), r)
        r = np.where(q > hx[-1], hv[-1] + slope_hi * (q - hx[-1]), r)
    return MatArray(r.reshape(hq.shape), "double")


def _spline_eval(x, y, q, method):
    """Natural cubic spline (spline) / monotone pchip-ish evaluation."""
    n = x.size
    if n < 3:
        return np.interp(q, x, y)
    h = np.diff(x)
    if method == "spline":
        # natural cubic spline: solve tridiagonal for second derivatives
        a = np.zeros((n, n))
        b = np.zeros(n)
        a[0, 0] = 1.0
        a[-1, -1] = 1.0
        for i in range(1, n - 1):
            a[i, i - 1] = h[i - 1]
            a[i, i] = 2 * (h[i - 1] + h[i])
            a[i, i + 1] = h[i]
            b[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
        c = np.linalg.solve(a, b)
        bcoef = (np.diff(y) / h) - h * (2 * c[:-1] + c[1:]) / 3
        dcoef = np.diff(c) / (3 * h)
        idx = np.clip(np.searchsorted(x, q) - 1, 0, n - 2)
        dx = q - x[idx]
        return y[idx] + bcoef[idx] * dx + c[idx] * dx ** 2 + dcoef[idx] * dx ** 3
    # pchip: monotone cubic hermite
    d = np.diff(y) / h
    m = np.zeros(n)
    m[1:-1] = np.where(np.sign(d[:-1]) * np.sign(d[1:]) > 0,
                       2 / (1 / np.where(d[:-1] == 0, 1, d[:-1]) +
                            1 / np.where(d[1:] == 0, 1, d[1:])), 0.0)
    m[0] = d[0]
    m[-1] = d[-1]
    idx = np.clip(np.searchsorted(x, q) - 1, 0, n - 2)
    t = (q - x[idx]) / h[idx]
    h00 = 2 * t ** 3 - 3 * t ** 2 + 1
    h10 = t ** 3 - 2 * t ** 2 + t
    h01 = -2 * t ** 3 + 3 * t ** 2
    h11 = t ** 3 - t ** 2
    return h00 * y[idx] + h10 * h[idx] * m[idx] + h01 * y[idx + 1] + h11 * h[idx] * m[idx + 1]


@builtin("interp2", category="math/interpolation", min_in=1, max_in=6)
def m_interp2(*args):
    if len(args) <= 2 and not (len(args) == 2 and
                               getattr(args[1], "size", 2) > 1):
        # refinement form: interp2(V[, k]) doubles the grid k times
        V = args[0]
        k = int(args[1].host().reshape(-1)[0]) if len(args) == 2 else 1
        v = V.host().astype(np.float64)
        m0, n0 = v.shape
        factor = 2 ** k
        xq1 = np.linspace(1, n0, (n0 - 1) * factor + 1)
        yq1 = np.linspace(1, m0, (m0 - 1) * factor + 1)
        XQ, YQ = np.meshgrid(xq1, yq1)
        from ...values import MatArray as _MA
        return m_interp2(
            _MA(np.arange(1.0, n0 + 1).reshape(1, -1), "double"),
            _MA(np.arange(1.0, m0 + 1).reshape(-1, 1), "double"),
            V, _MA(XQ, "double"), _MA(YQ, "double"))
    if len(args) >= 5:
        X, Y, V, XQ, YQ = args[:5]
        xv = X.host().astype(np.float64)
        yv = Y.host().astype(np.float64)
        x1 = xv[0, :] if xv.ndim == 2 and xv.shape[0] > 1 else xv.reshape(-1)
        y1 = yv[:, 0] if yv.ndim == 2 and yv.shape[1] > 1 else yv.reshape(-1)
        v = V.host().astype(np.float64)
        xq = XQ.host().astype(np.float64)
        yq = YQ.host().astype(np.float64)
    else:
        V, XQ, YQ = args[:3]
        v = V.host().astype(np.float64)
        x1 = np.arange(1, v.shape[1] + 1, dtype=np.float64)
        y1 = np.arange(1, v.shape[0] + 1, dtype=np.float64)
        xq = XQ.host().astype(np.float64)
        yq = YQ.host().astype(np.float64)
    # bilinear interpolation
    xq_f, yq_f = np.broadcast_arrays(xq, yq)
    xi = np.clip(np.searchsorted(x1, xq_f.reshape(-1)) - 1, 0, x1.size - 2)
    yi = np.clip(np.searchsorted(y1, yq_f.reshape(-1)) - 1, 0, y1.size - 2)
    tx = (xq_f.reshape(-1) - x1[xi]) / (x1[xi + 1] - x1[xi])
    ty = (yq_f.reshape(-1) - y1[yi]) / (y1[yi + 1] - y1[yi])
    r = (v[yi, xi] * (1 - tx) * (1 - ty) + v[yi, xi + 1] * tx * (1 - ty)
         + v[yi + 1, xi] * (1 - tx) * ty + v[yi + 1, xi + 1] * tx * ty)
    oob = (xq_f.reshape(-1) < x1[0]) | (xq_f.reshape(-1) > x1[-1]) | \
          (yq_f.reshape(-1) < y1[0]) | (yq_f.reshape(-1) > y1[-1])
    r = np.where(oob, np.nan, r)
    return MatArray(r.reshape(xq_f.shape), "double")


# --------------------------------------------------------------------------- #
# cubic splines / pchip (natural-spline and Fritsch-Carlson algorithms,
# implemented from the standard formulations)
# --------------------------------------------------------------------------- #


def _spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Not-a-knot cubic spline; returns per-interval [a,b,c,d] for
    s(t) = a + b*dt + c*dt^2 + d*dt^3."""
    n = x.size
    if n == 2:
        b = (y[1] - y[0]) / (x[1] - x[0])
        return np.array([[y[0], b, 0.0, 0.0]])
    h = np.diff(x)
    A = np.zeros((n, n))
    rhs = np.zeros(n)
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    if n == 3:
        A[0, 0] = 1; A[-1, -1] = 1          # natural fallback for 3 points
    else:
        # not-a-knot end conditions
        A[0, 0] = h[1]; A[0, 1] = -(h[0] + h[1]); A[0, 2] = h[0]
        A[-1, -3] = h[-1]; A[-1, -2] = -(h[-2] + h[-1]); A[-1, -1] = h[-2]
    c = np.linalg.solve(A, rhs)
    coeffs = np.empty((n - 1, 4))
    for i in range(n - 1):
        coeffs[i, 0] = y[i]
        coeffs[i, 2] = c[i]
        coeffs[i, 3] = (c[i + 1] - c[i]) / (3 * h[i])
        coeffs[i, 1] = (y[i + 1] - y[i]) / h[i] - h[i] * (2 * c[i] + c[i + 1]) / 3
    return coeffs


def _pchip_slopes(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Fritsch-Carlson monotone slopes."""
    h = np.diff(x)
    delta = np.diff(y) / h
    n = x.size
    d = np.zeros(n)
    for i in range(1, n - 1):
        if delta[i - 1] * delta[i] > 0:
            w1 = 2 * h[i] + h[i - 1]
            w2 = h[i] + 2 * h[i - 1]
            d[i] = (w1 + w2) / (w1 / delta[i - 1] + w2 / delta[i])
    def endslope(h0, h1, d0, d1):
        s = ((2 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
        if s * d0 <= 0:
            return 0.0
        if d0 * d1 <= 0 and abs(s) > 3 * abs(d0):
            return 3 * d0
        return s
    d[0] = endslope(h[0], h[1] if n > 2 else h[0], delta[0],
                    delta[1] if n > 2 else delta[0])
    d[-1] = endslope(h[-1], h[-2] if n > 2 else h[-1], delta[-1],
                     delta[-2] if n > 2 else delta[-1])
    return d


def _eval_piecewise_cubic(x, coeffs, xq):
    idx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, coeffs.shape[0] - 1)
    dt = xq - x[idx]
    a, b, c, d = (coeffs[idx, k] for k in range(4))
    return ((d * dt + c) * dt + b) * dt + a


def _hermite_eval(x, y, d, xq):
    idx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, x.size - 2)
    h = x[idx + 1] - x[idx]
    t = (xq - x[idx]) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t * t * (3 - 2 * t)
    h11 = t * t * (t - 1)
    return h00 * y[idx] + h10 * h * d[idx] + h01 * y[idx + 1] + h11 * h * d[idx + 1]


def _xy_prep(x, y):
    hx = x.host().astype(np.float64).reshape(-1)
    hy = y.host().astype(np.float64).reshape(-1)
    order = np.argsort(hx)
    return hx[order], hy[order]


@builtin("spline", category="math/interpolation", min_in=2, max_in=3)
def m_spline(x, y, xq=None):
    hx, hy = _xy_prep(x, y)
    coeffs = _spline_coeffs(hx, hy)
    if xq is None:
        from ...values import StructArray
        return StructArray.scalar({
            "form": MatArray.char_from_str("pp"),
            "breaks": MatArray(hx.reshape(1, -1), "double"),
            "coefs": MatArray(coeffs[:, ::-1].copy(), "double"),
            "pieces": MatArray.scalar(coeffs.shape[0]),
            "order": MatArray.scalar(4),
            "dim": MatArray.scalar(1),
        })
    hq = xq.host().astype(np.float64)
    r = _eval_piecewise_cubic(hx, coeffs, hq.reshape(-1))
    return MatArray(r.reshape(hq.shape), "double")


@builtin("pchip", category="math/interpolation", min_in=2, max_in=3)
def m_pchip(x, y, xq=None):
    hx, hy = _xy_prep(x, y)
    d = _pchip_slopes(hx, hy)
    if xq is None:
        from ...values import StructArray
        return StructArray.scalar({"form": MatArray.char_from_str("pp"),
                                   "breaks": MatArray(hx.reshape(1, -1), "double")})
    hq = xq.host().astype(np.float64)
    r = _hermite_eval(hx, hy, d, hq.reshape(-1))
    return MatArray(r.reshape(hq.shape), "double")


@builtin("ppval", category="math/interpolation", min_in=2, max_in=2)
def m_ppval(pp, xq):
    from ...values import StructArray
    if not isinstance(pp, StructArray):
        raise bad_arg("ppval", "First argument must be a pp struct.")
    breaks = pp.fields["breaks"].reshape(-1)[0].host().reshape(-1)
    coefs = pp.fields["coefs"].reshape(-1)[0].host()
    hq = xq.host().astype(np.float64)
    coeffs = coefs[:, ::-1]
    r = _eval_piecewise_cubic(breaks, coeffs, hq.reshape(-1))
    return MatArray(r.reshape(hq.shape), "double")


@builtin("interp3", category="math/interpolation", min_in=4, max_in=8)
def m_interp3(*args):
    """interp3(X,Y,Z,V,xq,yq,zq) or interp3(V,xq,yq,zq) — trilinear."""
    if len(args) >= 7:
        X, Y, Z, V, xq, yq, zq = args[:7]
        gx = X.host().astype(np.float64)
        gy = Y.host().astype(np.float64)
        gz = Z.host().astype(np.float64)
        # meshgrid convention: X varies along dim2, Y along dim1, Z along dim3
        xs = gx[0, :, 0] if gx.ndim == 3 else gx[0, :]
        ys = gy[:, 0, 0] if gy.ndim == 3 else gy[:, 0]
        zs = gz[0, 0, :] if gz.ndim == 3 else np.asarray([0.0])
    else:
        V, xq, yq, zq = args[:4]
        v = V.host()
        ys = np.arange(1, v.shape[0] + 1, dtype=np.float64)
        xs = np.arange(1, v.shape[1] + 1, dtype=np.float64)
        zs = np.arange(1, (v.shape[2] if v.ndim > 2 else 1) + 1, dtype=np.float64)
    v = V.host().astype(np.float64)
    if v.ndim == 2:
        v = v[:, :, None]
    q = [a.host().astype(np.float64).reshape(-1) for a in (xq, yq, zq)]

    def locate(grid, vals):
        i = np.clip(np.searchsorted(grid, vals, side="right") - 1, 0,
                    max(grid.size - 2, 0))
        g1 = grid[np.minimum(i + 1, grid.size - 1)]
        denom = np.where(g1 > grid[i], g1 - grid[i], 1.0)
        t = np.clip((vals - grid[i]) / denom, 0.0, 1.0)
        return i, t

    ix, tx = locate(xs, q[0])
    iy, ty = locate(ys, q[1])
    iz, tz = locate(zs, q[2])
    ix1 = np.minimum(ix + 1, xs.size - 1)
    iy1 = np.minimum(iy + 1, ys.size - 1)
    iz1 = np.minimum(iz + 1, zs.size - 1)
    r = np.zeros_like(q[0])
    for (jy, wy) in ((iy, 1 - ty), (iy1, ty)):
        for (jx, wx) in ((ix, 1 - tx), (ix1, tx)):
            for (jz, wz) in ((iz, 1 - tz), (iz1, tz)):
                r += wy * wx * wz * v[jy, jx, jz]
    oob = (q[0] < xs[0]) | (q[0] > xs[-1]) | (q[1] < ys[0]) | (q[1] > ys[-1]) \
        | (q[2] < zs[0]) | (q[2] > zs[-1])
    r = np.where(oob, np.nan, r)
    shape = xq.host().shape
    return MatArray(r.reshape(shape if len(shape) >= 2 else (1, -1)), "double")


@builtin("interpft", category="math/interpolation", min_in=2, max_in=2)
def m_interpft(x, n):
    h = x.host().astype(np.float64).reshape(-1)
    npts = int(n.host().reshape(-1)[0])
    sp = np.fft.fft(h)
    half = h.size // 2
    out_sp = np.zeros(npts, dtype=complex)
    k = min(half + 1, (npts // 2) + 1)
    out_sp[:k] = sp[:k]
    out_sp[-(h.size - half - 1):] = sp[half + 1:] if h.size - half - 1 else 0
    r = np.fft.ifft(out_sp).real * (npts / h.size)
    shape = x.host().shape
    return MatArray(r.reshape((1, -1) if shape[0] == 1 else (-1, 1)), "double")


# --------------------------------------------------------------------------- #
# polynomial calculus
# --------------------------------------------------------------------------- #


@builtin("polyder", category="math/poly", min_in=1, max_in=2)
def m_polyder(p, q=None):
    hp = p.host().astype(np.float64).reshape(-1)
    if q is not None:
        hp = np.polymul(hp, q.host().astype(np.float64).reshape(-1))
    d = np.polyder(hp)
    if d.size == 0:
        d = np.zeros(1)
    return MatArray(d.reshape(1, -1), "double")


@builtin("polyint", category="math/poly", min_in=1, max_in=2)
def m_polyint(p, k=None):
    hp = p.host().astype(np.float64).reshape(-1)
    kk = float(k.host().reshape(-1)[0]) if k is not None else 0.0
    r = np.append(np.polyint(hp)[:-1], kk)
    return MatArray(r.reshape(1, -1), "double")


@builtin("polyvalm", category="math/poly", min_in=2, max_in=2)
def m_polyvalm(p, X):
    hp = p.host().astype(np.float64).reshape(-1)
    A = X.host().astype(np.float64)
    n = A.shape[0]
    R = np.zeros_like(A)
    for c in hp:
        R = R @ A + c * np.eye(n)
    return MatArray(R, "double")


@builtin("griddata", category="math/interpolation", min_in=5, max_in=6)
def m_griddata(x, y, v, xq, yq, method=None):
    """Scattered 2-D interpolation (≙ runmat-runtime math/interpolation
    griddata): Delaunay-based 'linear' (default), 'nearest', 'cubic';
    queries outside the convex hull return NaN like MATLAB."""
    from scipy.interpolate import griddata as _gd
    m = text_of(method).lower() if method is not None else "linear"
    if m == "v4":
        m = "cubic"
    if m not in ("linear", "nearest", "cubic"):
        raise bad_arg("griddata", f"Unknown method '{m}'.")
    pts = np.column_stack([fortran_ravel(x.host().astype(np.float64)),
                           fortran_ravel(y.host().astype(np.float64))])
    vals = fortran_ravel(v.host().astype(np.float64))
    hxq = xq.host().astype(np.float64)
    hyq = yq.host().astype(np.float64)
    hxq, hyq = np.broadcast_arrays(hxq, hyq)
    q = np.column_stack([hxq.reshape(-1), hyq.reshape(-1)])
    r = _gd(pts, vals, q, method=m, fill_value=np.nan)
    return MatArray(np.asarray(r, np.float64).reshape(hxq.shape), "double")
