"""Copy of runmat_tpu/runtime/builtins/breadth3.py in the PyTorch port.

Breadth batch 3: special matrices, matrix predicates, distributions,
geometry transforms, morphology, computational geometry, categorical.

Reference parity: assorted runmat-runtime builtin families (array creation,
stats distributions, image morphology, geometry)."""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, is_text,
                       normalize_shape, text_of)
from ..registry import builtin, register_alias


def _np(v):
    return v.host().astype(np.float64)


def _sc(v):
    return float(_np(v).reshape(-1)[0])


def _sci(v):
    return int(_sc(v))


# ------------------------------------------------------------ special matrices #


@builtin("magic", category="array/creation", min_in=1, max_in=1)
def m_magic(n):
    """Magic square (odd: Siamese; doubly even: complement pattern; singly
    even: LUX method)."""
    k = _sci(n)
    if k < 1:
        return MatArray(np.zeros((0, 0)), "double")
    if k == 2:
        return MatArray(np.array([[1.0, 3], [4, 2]]), "double")
    if k % 2 == 1:
        M = np.zeros((k, k))
        i, j = 0, k // 2
        for v in range(1, k * k + 1):
            M[i, j] = v
            i2, j2 = (i - 1) % k, (j + 1) % k
            if M[i2, j2]:
                i = (i + 1) % k
            else:
                i, j = i2, j2
        return MatArray(M, "double")
    if k % 4 == 0:
        M = np.arange(1, k * k + 1, dtype=np.float64).reshape(k, k)
        I, J = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
        mask = (((I + 1) % 4) // 2) == (((J + 1) % 4) // 2)
        M[mask] = k * k + 1 - M[mask]
        return MatArray(M, "double")
    # singly even: LUX
    h = k // 2
    sub = m_magic(MatArray.scalar(float(h))).host()
    M = np.zeros((k, k))
    M[:h, :h] = sub
    M[h:, h:] = sub + h * h
    M[:h, h:] = sub + 2 * h * h
    M[h:, :h] = sub + 3 * h * h
    q = (k - 2) // 4
    for r in range(h):
        for c in range(k):
            swap = (c < q) if r != h // 2 else (1 <= c <= q)
            if c >= k - q + 1:
                swap = True
            if swap:
                M[r, c], M[r + h, c] = M[r + h, c], M[r, c]
    return MatArray(M, "double")


@builtin("toeplitz", category="array/creation", min_in=1, max_in=2)
def m_toeplitz(c, r=None):
    cv = _np(c).reshape(-1)
    rv = _np(r).reshape(-1) if r is not None else cv.copy()
    m, n = cv.size, rv.size
    out = np.empty((m, n))
    for i in range(m):
        for j in range(n):
            out[i, j] = cv[i - j] if i >= j else rv[j - i]
    return MatArray(out, "double")


@builtin("hankel", category="array/creation", min_in=1, max_in=2)
def m_hankel(c, r=None):
    cv = _np(c).reshape(-1)
    rv = _np(r).reshape(-1) if r is not None else np.zeros_like(cv)
    m, n = cv.size, rv.size
    out = np.zeros((m, n))
    for i in range(m):
        for j in range(n):
            k = i + j
            out[i, j] = cv[k] if k < m else (rv[k - m + 1] if k - m + 1 < n else 0)
    return MatArray(out, "double")


@builtin("vander", category="array/creation", min_in=1, max_in=1)
def m_vander(v):
    return MatArray(np.vander(_np(v).reshape(-1)), "double")


@builtin("pascal", category="array/creation", min_in=1, max_in=1)
def m_pascal(n):
    k = _sci(n)
    M = np.zeros((k, k))
    M[0, :] = 1
    M[:, 0] = 1
    for i in range(1, k):
        for j in range(1, k):
            M[i, j] = M[i - 1, j] + M[i, j - 1]
    return MatArray(M, "double")


@builtin("hilb", category="array/creation", min_in=1, max_in=1)
def m_hilb(n):
    k = _sci(n)
    i, j = np.meshgrid(np.arange(1, k + 1), np.arange(1, k + 1), indexing="ij")
    return MatArray(1.0 / (i + j - 1), "double")


@builtin("invhilb", category="array/creation", min_in=1, max_in=1)
def m_invhilb(n):
    return MatArray(np.linalg.inv(m_hilb(n).host()), "double")


@builtin("wilkinson", category="array/creation", min_in=1, max_in=1)
def m_wilkinson(n):
    k = _sci(n)
    d = np.abs(np.arange(k) - (k - 1) / 2)
    M = np.diag(d) + np.diag(np.ones(k - 1), 1) + np.diag(np.ones(k - 1), -1)
    return MatArray(M, "double")


@builtin("compan", category="array/creation", min_in=1, max_in=1)
def m_compan(p):
    pv = _np(p).reshape(-1)
    n = pv.size - 1
    M = np.zeros((n, n))
    M[0, :] = -pv[1:] / pv[0]
    M[1:, :-1] = np.eye(n - 1)
    return MatArray(M, "double")


@builtin("blkdiag", category="array/creation", min_in=1, max_in=None)
def m_blkdiag(*mats):
    hs = [m.host().astype(np.float64) for m in mats]
    rt = sum(h.shape[0] for h in hs)
    ct = sum(h.shape[1] for h in hs)
    out = np.zeros((rt, ct))
    r = c = 0
    for h in hs:
        out[r:r + h.shape[0], c:c + h.shape[1]] = h
        r += h.shape[0]
        c += h.shape[1]
    return MatArray(out, "double")


# ----------------------------------------------------------- matrix predicates #


def _mat_pred(name, fn):
    @builtin(name, category="introspection", min_in=1, max_in=1)
    def _f(x, _fn=fn):
        h = x.host().astype(np.complex128)
        return MatArray.logical_scalar(bool(_fn(h)))
    return _f


_mat_pred("issymmetric", lambda h: h.shape[0] == h.shape[1]
          and np.array_equal(h, h.T))
_mat_pred("ishermitian", lambda h: h.shape[0] == h.shape[1]
          and np.allclose(h, h.conj().T, rtol=0, atol=0))
_mat_pred("isdiag", lambda h: np.count_nonzero(h - np.diag(np.diag(h))) == 0)
_mat_pred("istriu", lambda h: np.count_nonzero(np.tril(h, -1)) == 0)
_mat_pred("istril", lambda h: np.count_nonzero(np.triu(h, 1)) == 0)


@builtin("isbanded", category="introspection", min_in=3, max_in=3)
def m_isbanded(x, lower, upper):
    """isbanded(A, lower, upper): all nonzeros within the band."""
    h = x.host()
    lo = int(lower.scalar_double())
    up = int(upper.scalar_double())
    if h.ndim != 2:
        return MatArray.logical_scalar(False)
    below = np.count_nonzero(np.tril(h, -(lo + 1)))
    above = np.count_nonzero(np.triu(h, up + 1))
    return MatArray.logical_scalar(below == 0 and above == 0)


@builtin("bandwidth", category="introspection", min_in=1, max_in=1,
         pass_nargout=True)
def m_bandwidth(x, nargout=1):
    h = x.host().astype(np.float64)
    nz = np.nonzero(h)
    if nz[0].size == 0:
        lo = hi = 0
    else:
        d = nz[1] - nz[0]
        lo = int(max(0, -d.min()))
        hi = int(max(0, d.max()))
    res = [MatArray.scalar(float(lo)), MatArray.scalar(float(hi))]
    return res[:max(1, nargout)]


@builtin("normest", category="math/linalg", min_in=1, max_in=1)
def m_normest(x):
    return MatArray.scalar(float(np.linalg.norm(x.host().astype(np.float64), 2)))


# --------------------------------------------------------------- distributions #


def _draws(ctx, n):
    from ...ops import ctrng
    return ctrng.host_rand(ctx.session.rng, n, "double")


def _ndraws(ctx, n):
    from ...ops import ctrng
    return ctrng.host_randn(ctx.session.rng, n, "double")


def _dims_of(args):
    if not args:
        return (1, 1)
    dims = [int(_sc(a)) for a in args]
    if len(dims) == 1:
        dims = [dims[0], dims[0]]
    return tuple(dims)


@builtin("normrnd", category="stats", min_in=2, max_in=None, pass_ctx=True)
def m_normrnd(mu, sigma, *dims, ctx=None):
    d = _dims_of(list(dims))
    n = int(np.prod(d))
    z = _ndraws(ctx, n).reshape(d, order="F") if dims else \
        _ndraws(ctx, 1).reshape(1, 1)
    return MatArray(_sc(mu) + _sc(sigma) * (z if dims else z), "double")


@builtin("unifrnd", category="stats", min_in=2, max_in=None, pass_ctx=True)
def m_unifrnd(a, b, *dims, ctx=None):
    d = _dims_of(list(dims))
    n = int(np.prod(d))
    u = _draws(ctx, n).reshape(d, order="F")
    return MatArray(_sc(a) + (_sc(b) - _sc(a)) * u, "double")


@builtin("exprnd", category="stats", min_in=1, max_in=None, pass_ctx=True)
def m_exprnd(mu, *dims, ctx=None):
    d = _dims_of(list(dims))
    n = int(np.prod(d))
    u = _draws(ctx, n).reshape(d, order="F")
    return MatArray(-_sc(mu) * np.log(1 - u), "double")


@builtin("poissrnd", category="stats", min_in=1, max_in=None, pass_ctx=True)
def m_poissrnd(lam, *dims, ctx=None):
    d = _dims_of(list(dims))
    n = int(np.prod(d))
    lv = _sc(lam)
    out = np.zeros(n)
    for i in range(n):
        L = np.exp(-lv)
        k, p = 0, 1.0
        while True:
            p *= _draws(ctx, 1)[0]
            if p <= L:
                break
            k += 1
        out[i] = k
    return MatArray(out.reshape(d, order="F"), "double")


@builtin("binornd", category="stats", min_in=2, max_in=None, pass_ctx=True)
def m_binornd(nn, p, *dims, ctx=None):
    d = _dims_of(list(dims))
    n = int(np.prod(d))
    trials = _sci(nn)
    pv = _sc(p)
    u = _draws(ctx, n * trials).reshape(n, max(trials, 1))
    out = (u < pv).sum(axis=1).astype(np.float64)
    return MatArray(out.reshape(d, order="F"), "double")


@builtin("mvnrnd", category="stats", min_in=2, max_in=3, pass_ctx=True)
def m_mvnrnd(mu, Sigma, n=None, ctx=None):
    m = _np(mu).reshape(-1)
    S = _np(Sigma)
    k = _sci(n) if n is not None else 1
    L = np.linalg.cholesky(S + 1e-12 * np.eye(S.shape[0]))
    z = _ndraws(ctx, k * m.size).reshape(k, m.size)
    return MatArray(m[None, :] + z @ L.T, "double")


@builtin("range", category="stats", min_in=1, max_in=1)
def m_range(x):
    h = _np(x).reshape(-1)
    return MatArray.scalar(float(h.max() - h.min()))


@builtin("mad", category="stats", min_in=1, max_in=1)
def m_mad(x):
    h = _np(x).reshape(-1)
    return MatArray.scalar(float(np.mean(np.abs(h - h.mean()))))


@builtin("iqr", category="stats", min_in=1, max_in=1)
def m_iqr(x):
    """Interquartile range via MATLAB's prctile interpolation (order
    statistics at (k - 0.5)/n — NOT numpy's linear percentile)."""
    from .stats import m_prctile
    q = m_prctile(x, MatArray(np.array([[25.0, 75.0]]), "double"))
    v = q.host().reshape(-1)
    return MatArray.scalar(float(v[1] - v[0]))


# ------------------------------------------------------- coordinate transforms #


@builtin("cart2pol", category="math/elementwise", min_in=2, max_in=3,
         pass_nargout=True)
def m_cart2pol(x, y, z=None, nargout=1):
    hx, hy = _np(x), _np(y)
    th = np.arctan2(hy, hx)
    r = np.hypot(hx, hy)
    res = [MatArray(th, "double"), MatArray(r, "double")]
    if z is not None:
        res.append(MatArray(_np(z), "double"))
    return res[:max(1, nargout)]


@builtin("pol2cart", category="math/elementwise", min_in=2, max_in=3,
         pass_nargout=True)
def m_pol2cart(th, r, z=None, nargout=1):
    t, rr = _np(th), _np(r)
    res = [MatArray(rr * np.cos(t), "double"), MatArray(rr * np.sin(t), "double")]
    if z is not None:
        res.append(MatArray(_np(z), "double"))
    return res[:max(1, nargout)]


@builtin("cart2sph", category="math/elementwise", min_in=3, max_in=3,
         pass_nargout=True)
def m_cart2sph(x, y, z, nargout=1):
    hx, hy, hz = _np(x), _np(y), _np(z)
    az = np.arctan2(hy, hx)
    el = np.arctan2(hz, np.hypot(hx, hy))
    r = np.sqrt(hx ** 2 + hy ** 2 + hz ** 2)
    return [MatArray(az, "double"), MatArray(el, "double"),
            MatArray(r, "double")][:max(1, nargout)]


@builtin("sph2cart", category="math/elementwise", min_in=3, max_in=3,
         pass_nargout=True)
def m_sph2cart(az, el, r, nargout=1):
    a, e, rr = _np(az), _np(el), _np(r)
    return [MatArray(rr * np.cos(e) * np.cos(a), "double"),
            MatArray(rr * np.cos(e) * np.sin(a), "double"),
            MatArray(rr * np.sin(e), "double")][:max(1, nargout)]


# ----------------------------------------------------------------- morphology - #


def _binary_img(x):
    return x.host() != 0


@builtin("imerode", category="image", min_in=2, max_in=2)
def m_imerode(x, se):
    img = _binary_img(x)
    k = _binary_img(se) if not is_text(se) else np.ones((3, 3), bool)
    pr, pc = k.shape[0] // 2, k.shape[1] // 2
    pad = np.pad(img, ((pr, k.shape[0] - 1 - pr), (pc, k.shape[1] - 1 - pc)),
                 constant_values=True)
    out = np.ones_like(img)
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if k[i, j]:
                out &= pad[i:i + img.shape[0], j:j + img.shape[1]]
    return MatArray(out, "logical")


@builtin("imdilate", category="image", min_in=2, max_in=2)
def m_imdilate(x, se):
    img = _binary_img(x)
    k = _binary_img(se) if not is_text(se) else np.ones((3, 3), bool)
    pr, pc = k.shape[0] // 2, k.shape[1] // 2
    pad = np.pad(img, ((pr, k.shape[0] - 1 - pr), (pc, k.shape[1] - 1 - pc)),
                 constant_values=False)
    out = np.zeros_like(img)
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if k[i, j]:
                out |= pad[i:i + img.shape[0], j:j + img.shape[1]]
    return MatArray(out, "logical")


@builtin("bwlabel", category="image", min_in=1, max_in=1, pass_nargout=True)
def m_bwlabel(x, nargout=1):
    img = _binary_img(x)
    labels = np.zeros(img.shape, dtype=np.float64)
    cur = 0
    for r in range(img.shape[0]):
        for c in range(img.shape[1]):
            if img[r, c] and labels[r, c] == 0:
                cur += 1
                stack = [(r, c)]
                while stack:
                    i, j = stack.pop()
                    if 0 <= i < img.shape[0] and 0 <= j < img.shape[1] and \
                            img[i, j] and labels[i, j] == 0:
                        labels[i, j] = cur
                        stack += [(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)]
    res = [MatArray(labels, "double"), MatArray.scalar(float(cur))]
    return res[:max(1, nargout)]


@builtin("edge", category="image", min_in=1, max_in=2)
def m_edge(x, method=None):
    h = _np(x)
    kx = np.array([[1.0, 0, -1], [2, 0, -2], [1, 0, -1]])
    pad = np.pad(h, 1, mode="edge")
    gx = np.zeros_like(h)
    gy = np.zeros_like(h)
    for i in range(3):
        for j in range(3):
            gx += kx[i, j] * pad[i:i + h.shape[0], j:j + h.shape[1]]
            gy += kx.T[i, j] * pad[i:i + h.shape[0], j:j + h.shape[1]]
    mag = np.hypot(gx, gy)
    thr = 2 * mag.mean()
    return MatArray(mag > thr, "logical")


# ------------------------------------------------------- computational geometry #


@builtin("convhull", category="geometry", min_in=2, max_in=2)
def m_convhull(x, y):
    """2-D convex hull (Andrew monotone chain), 1-based closed index loop."""
    pts = np.stack([_np(x).reshape(-1), _np(y).reshape(-1)], axis=1)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    P = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def chain(indices):
        out: list = []
        for i in indices:
            while len(out) >= 2 and cross(P[out[-2]], P[out[-1]], P[i]) <= 0:
                out.pop()
            out.append(i)
        return out
    idxs = list(range(P.shape[0]))
    lower = chain(idxs)
    upper = chain(idxs[::-1])
    hull = lower[:-1] + upper[:-1]
    idx = order[hull]
    loop = np.append(idx, idx[0]) + 1
    return MatArray(loop.astype(np.float64).reshape(-1, 1), "double")


@builtin("polyarea", category="geometry", min_in=2, max_in=2)
def m_polyarea(x, y):
    hx = _np(x).reshape(-1)
    hy = _np(y).reshape(-1)
    return MatArray.scalar(abs(float(
        np.sum(hx * np.roll(hy, -1) - np.roll(hx, -1) * hy) / 2)))


@builtin("inpolygon", category="geometry", min_in=4, max_in=4)
def m_inpolygon(xq, yq, xv, yv):
    qx = _np(xq).reshape(-1)
    qy = _np(yq).reshape(-1)
    px = _np(xv).reshape(-1)
    py = _np(yv).reshape(-1)
    n = px.size
    out = np.zeros(qx.size, dtype=bool)
    for k in range(qx.size):
        c = False
        j = n - 1
        for i in range(n):
            if ((py[i] > qy[k]) != (py[j] > qy[k])) and \
                    (qx[k] < (px[j] - px[i]) * (qy[k] - py[i]) /
                     (py[j] - py[i]) + px[i]):
                c = not c
            j = i
        out[k] = c
    return MatArray(out.reshape(xq.host().shape), "logical")


@builtin("delaunay", category="geometry", min_in=2, max_in=2)
def m_delaunay(x, y):
    from scipy.spatial import Delaunay
    pts = np.stack([_np(x).reshape(-1), _np(y).reshape(-1)], axis=1)
    tri = Delaunay(pts)
    return MatArray((tri.simplices + 1).astype(np.float64), "double")


# ------------------------------------------------------------------ misc ----- #


@builtin("nextpow2", category="math/elementwise", min_in=1, max_in=1)
def m_nextpow2(x):
    h = np.abs(_np(x))
    with np.errstate(divide="ignore"):
        out = np.ceil(np.log2(np.maximum(h, 1e-300)))
    out = np.where(h == 0, 0, out)
    return MatArray(out, "double")


@builtin("pow2", category="math/elementwise", min_in=1, max_in=2)
def m_pow2(a, b=None):
    if b is None:
        return MatArray(2.0 ** _np(a), "double")
    return MatArray(_np(a) * 2.0 ** _np(b), "double")


@builtin("flintmax", category="constants", max_in=1)
def m_flintmax(cls=None):
    if cls is not None and text_of(cls) == "single":
        return MatArray(np.full((1, 1), 2.0 ** 24, np.float32), "single")
    return MatArray.scalar(2.0 ** 53)


@builtin("unwrap", category="math/signal", min_in=1, max_in=1)
def m_unwrap(x):
    return MatArray(np.unwrap(_np(x).reshape(-1)).reshape(x.host().shape),
                    "double")


@builtin("deconv", category="math/poly", min_in=2, max_in=2, pass_nargout=True)
def m_deconv(b, a, nargout=1):
    bv = _np(b).reshape(-1)
    q, r = np.polydiv(bv, _np(a).reshape(-1))
    # MATLAB pads the remainder to length(b) with leading zeros
    r = np.atleast_1d(r)
    if r.size < bv.size:
        r = np.concatenate([np.zeros(bv.size - r.size), r])
    res = [MatArray(np.atleast_1d(q).reshape(1, -1), "double"),
           MatArray(r.reshape(1, -1), "double")]
    return res[:max(1, nargout)]


@builtin("deblank", category="strings", min_in=1, max_in=1)
def m_deblank(s):
    return MatArray.char_from_str(text_of(s).rstrip())


@builtin("strvcat", category="strings", min_in=1, max_in=None)
def m_strvcat(*args):
    rows = [text_of(a) for a in args if text_of(a)]
    w = max((len(r) for r in rows), default=0)
    out = np.zeros((len(rows), w), dtype=np.uint32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = [ord(c) for c in r]
        out[i, len(r):] = ord(" ")
    return MatArray(out, "char")


@builtin("polyeig", category="math/poly", min_in=2, max_in=None)
def m_polyeig(*mats):
    """Polynomial eigenvalues det(A0 + l A1 + ... + l^p Ap) = 0 via
    companion linearization."""
    As = [m.host().astype(np.float64) for m in mats]
    n = As[0].shape[0]
    p = len(As) - 1
    if p == 0:
        return MatArray(np.zeros((0, 1)), "double")
    N = n * p
    A = np.zeros((N, N))
    B = np.eye(N)
    A[:n * (p - 1), n:] = np.eye(n * (p - 1))[:, :n * (p - 1)]
    A[:n * (p - 1), n:n + n * (p - 1)] = np.eye(n * (p - 1))
    for k in range(p):
        A[n * (p - 1):, n * k:n * (k + 1)] = -As[k]
    B[n * (p - 1):, n * (p - 1):] = As[p]
    vals = np.linalg.eigvals(np.linalg.solve(B, A)) if \
        np.linalg.cond(B) < 1e12 else np.linalg.eigvals(np.linalg.pinv(B) @ A)
    vals = np.sort_complex(vals)
    if np.allclose(vals.imag, 0):
        vals = vals.real
    return MatArray(np.asarray(vals).reshape(-1, 1), "double")
