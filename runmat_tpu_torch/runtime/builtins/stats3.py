"""Copy of runmat_tpu/runtime/builtins/stats3.py in the PyTorch port.

Statistics batch 3: the full two-parameter distribution family
(chi2/F/beta/gamma/exponential/uniform/lognormal/Rayleigh/Weibull/geometric
pdf+cdf+inv), multivariate normal density, classical hypothesis tests
(ttest/anova1/ranksum/signrank), PCA, and cross-covariance/autocorrelation.

Extends the reference's stats surface (runmat-runtime/src/builtins/stats/ —
normal/t/chi2/binomial/weibull families, ttest2/kstest) to the complete
MATLAB Statistics-toolbox distribution grid. Distribution math rides host
scipy.special exactly like stats2.py (the reference links system libm the
same way); everything is elementwise-broadcastable.
"""

from __future__ import annotations

import numpy as np
from scipy import special as sp

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, StructArray,
                       fortran_ravel, is_text, text_of)
from ..registry import builtin
from .common import scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _fd(v, default: float) -> np.ndarray | float:
    return _f(v) if v is not None else default


def _out(r, *protos) -> MatArray:
    cls = "single" if any(getattr(p, "mclass", "") == "single"
                          for p in protos) else "double"
    return MatArray(np.atleast_2d(np.asarray(r, dtype=np.float64)), cls)


# ------------------------------------------------------------------- chi2 --- #

@builtin("chi2pdf", category="stats/dist", min_in=2, max_in=2)
def m_chi2pdf(x, v):
    hx, hv = _f(x), _f(v)
    with np.errstate(all="ignore"):
        r = np.exp((hv / 2 - 1) * np.log(np.maximum(hx, 0)) - hx / 2
                   - sp.gammaln(hv / 2) - (hv / 2) * np.log(2.0))
    r = np.where(hx < 0, 0.0, r)
    return _out(r, x)


@builtin("chi2inv", category="stats/dist", min_in=2, max_in=2)
def m_chi2inv(p, v):
    return _out(2.0 * sp.gammaincinv(_f(v) / 2.0, _f(p)), p)


# ---------------------------------------------------------------------- F --- #

@builtin("fpdf", category="stats/dist", min_in=3, max_in=3)
def m_fpdf(x, v1, v2):
    hx, a, b = _f(x), _f(v1), _f(v2)
    with np.errstate(all="ignore"):
        lg = (a / 2) * np.log(a / b) + (a / 2 - 1) * np.log(np.maximum(hx, 0)) \
            - ((a + b) / 2) * np.log1p(a * np.maximum(hx, 0) / b) \
            - sp.betaln(a / 2, b / 2)
        r = np.exp(lg)
    return _out(np.where(hx < 0, 0.0, r), x)


@builtin("fcdf", category="stats/dist", min_in=3, max_in=3)
def m_fcdf(x, v1, v2):
    hx, a, b = np.maximum(_f(x), 0), _f(v1), _f(v2)
    return _out(sp.betainc(a / 2, b / 2, a * hx / (a * hx + b)), x)


@builtin("finv", category="stats/dist", min_in=3, max_in=3)
def m_finv(p, v1, v2):
    a, b = _f(v1), _f(v2)
    ib = sp.betaincinv(a / 2, b / 2, _f(p))
    with np.errstate(divide="ignore"):
        return _out(b * ib / (a * (1 - ib)), p)


# ------------------------------------------------------------------- beta --- #

@builtin("betapdf", category="stats/dist", min_in=3, max_in=3)
def m_betapdf(x, a, b):
    hx, ha, hb = _f(x), _f(a), _f(b)
    inside = (hx >= 0) & (hx <= 1)
    with np.errstate(all="ignore"):
        r = np.exp((ha - 1) * np.log(np.maximum(hx, 1e-300))
                   + (hb - 1) * np.log(np.maximum(1 - hx, 1e-300))
                   - sp.betaln(ha, hb))
    return _out(np.where(inside, r, 0.0), x)


@builtin("betacdf", category="stats/dist", min_in=3, max_in=3)
def m_betacdf(x, a, b):
    return _out(sp.betainc(_f(a), _f(b), np.clip(_f(x), 0.0, 1.0)), x)


@builtin("betainv", category="stats/dist", min_in=3, max_in=3)
def m_betainv(p, a, b):
    return _out(sp.betaincinv(_f(a), _f(b), _f(p)), p)


# ------------------------------------------------------------------ gamma --- #

@builtin("gampdf", category="stats/dist", min_in=2, max_in=3)
def m_gampdf(x, a, b=None):
    hx, ha, hb = _f(x), _f(a), _fd(b, 1.0)
    with np.errstate(all="ignore"):
        r = np.exp((ha - 1) * np.log(np.maximum(hx, 0)) - hx / hb
                   - sp.gammaln(ha) - ha * np.log(hb))
    return _out(np.where(hx < 0, 0.0, r), x)


@builtin("gamcdf", category="stats/dist", min_in=2, max_in=3)
def m_gamcdf(x, a, b=None):
    return _out(sp.gammainc(_f(a), np.maximum(_f(x), 0) / _fd(b, 1.0)), x)


@builtin("gaminv", category="stats/dist", min_in=2, max_in=3)
def m_gaminv(p, a, b=None):
    return _out(_fd(b, 1.0) * sp.gammaincinv(_f(a), _f(p)), p)


# ------------------------------------------------------------ exponential --- #

@builtin("exppdf", category="stats/dist", min_in=1, max_in=2)
def m_exppdf(x, mu=None):
    hx, hm = _f(x), _fd(mu, 1.0)
    with np.errstate(all="ignore"):
        r = np.exp(-hx / hm) / hm
    return _out(np.where(hx < 0, 0.0, r), x)


@builtin("expcdf", category="stats/dist", min_in=1, max_in=2)
def m_expcdf(x, mu=None):
    return _out(-np.expm1(-np.maximum(_f(x), 0) / _fd(mu, 1.0)), x)


@builtin("expinv", category="stats/dist", min_in=1, max_in=2)
def m_expinv(p, mu=None):
    return _out(-_fd(mu, 1.0) * np.log1p(-_f(p)), p)


# ---------------------------------------------------------------- uniform --- #

@builtin("unifpdf", category="stats/dist", min_in=1, max_in=3)
def m_unifpdf(x, a=None, b=None):
    hx, ha, hb = _f(x), _fd(a, 0.0), _fd(b, 1.0)
    return _out(np.where((hx >= ha) & (hx <= hb), 1.0 / (hb - ha), 0.0), x)


@builtin("unifcdf", category="stats/dist", min_in=1, max_in=3)
def m_unifcdf(x, a=None, b=None):
    ha, hb = _fd(a, 0.0), _fd(b, 1.0)
    return _out(np.clip((_f(x) - ha) / (hb - ha), 0.0, 1.0), x)


@builtin("unifinv", category="stats/dist", min_in=1, max_in=3)
def m_unifinv(p, a=None, b=None):
    ha, hb = _fd(a, 0.0), _fd(b, 1.0)
    return _out(ha + (hb - ha) * _f(p), p)


# -------------------------------------------------------------- lognormal --- #

@builtin("lognpdf", category="stats/dist", min_in=1, max_in=3)
def m_lognpdf(x, mu=None, sigma=None):
    hx, hm, hs = _f(x), _fd(mu, 0.0), _fd(sigma, 1.0)
    with np.errstate(all="ignore"):
        r = np.exp(-0.5 * ((np.log(np.maximum(hx, 1e-300)) - hm) / hs) ** 2) \
            / (np.maximum(hx, 1e-300) * hs * np.sqrt(2 * np.pi))
    return _out(np.where(hx <= 0, 0.0, r), x)


@builtin("logncdf", category="stats/dist", min_in=1, max_in=3)
def m_logncdf(x, mu=None, sigma=None):
    hx, hm, hs = _f(x), _fd(mu, 0.0), _fd(sigma, 1.0)
    with np.errstate(all="ignore"):
        z = (np.log(np.maximum(hx, 1e-300)) - hm) / hs
    return _out(np.where(hx <= 0, 0.0, 0.5 * sp.erfc(-z / np.sqrt(2))), x)


@builtin("logninv", category="stats/dist", min_in=1, max_in=3)
def m_logninv(p, mu=None, sigma=None):
    hm, hs = _fd(mu, 0.0), _fd(sigma, 1.0)
    z = -np.sqrt(2.0) * sp.erfcinv(2 * _f(p))
    return _out(np.exp(hm + hs * z), p)


# ---------------------------------------------------------------- rayleigh --- #

@builtin("raylpdf", category="stats/dist", min_in=1, max_in=2)
def m_raylpdf(x, b=None):
    hx, hb = _f(x), _fd(b, 1.0)
    r = hx / hb ** 2 * np.exp(-hx ** 2 / (2 * hb ** 2))
    return _out(np.where(hx < 0, 0.0, r), x)


@builtin("raylcdf", category="stats/dist", min_in=1, max_in=2)
def m_raylcdf(x, b=None):
    hx, hb = np.maximum(_f(x), 0), _fd(b, 1.0)
    return _out(-np.expm1(-hx ** 2 / (2 * hb ** 2)), x)


@builtin("raylinv", category="stats/dist", min_in=1, max_in=2)
def m_raylinv(p, b=None):
    return _out(_fd(b, 1.0) * np.sqrt(-2 * np.log1p(-_f(p))), p)


# ---------------------------------------------------------------- weibull --- #

@builtin("wblpdf", category="stats/dist", min_in=1, max_in=3)
def m_wblpdf(x, a=None, b=None):
    hx, ha, hb = _f(x), _fd(a, 1.0), _fd(b, 1.0)
    with np.errstate(all="ignore"):
        t = np.maximum(hx, 0) / ha
        r = (hb / ha) * t ** (hb - 1) * np.exp(-t ** hb)
    return _out(np.where(hx < 0, 0.0, r), x)


@builtin("wblcdf", category="stats/dist", min_in=1, max_in=3)
def m_wblcdf(x, a=None, b=None):
    hx, ha, hb = np.maximum(_f(x), 0), _fd(a, 1.0), _fd(b, 1.0)
    return _out(-np.expm1(-(hx / ha) ** hb), x)


# --------------------------------------------------------------- geometric --- #

@builtin("geopdf", category="stats/dist", min_in=2, max_in=2)
def m_geopdf(x, p):
    hx, hp = np.floor(_f(x)), _f(p)
    with np.errstate(all="ignore"):
        r = hp * (1 - hp) ** hx
    return _out(np.where(hx < 0, 0.0, r), x)


@builtin("geocdf", category="stats/dist", min_in=2, max_in=2)
def m_geocdf(x, p):
    hx, hp = np.floor(_f(x)), _f(p)
    return _out(np.where(hx < 0, 0.0, -np.expm1(np.log1p(-hp) * (hx + 1))), x)


# ---------------------------------------------------------------- poissinv --- #

@builtin("poissinv", category="stats/dist", min_in=2, max_in=2)
def m_poissinv(p, lam):
    hp, hl = np.broadcast_arrays(np.atleast_1d(_f(p)), np.atleast_1d(_f(lam)))
    out = np.zeros(hp.shape)
    it = np.nditer(hp, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        pi, li = hp[idx], hl[idx]
        if not (0 <= pi <= 1) or li < 0:
            out[idx] = np.nan
            continue
        if pi == 1:
            out[idx] = np.inf
            continue
        k = max(int(li), 0)
        # walk to the smallest k with cdf(k) >= p (cdf via gammaincc)
        while sp.gammaincc(k + 1, li) < pi:
            k += 1
        while k > 0 and sp.gammaincc(k, li) >= pi:
            k -= 1
        out[idx] = k
    return _out(out.reshape(np.atleast_2d(hp).shape), p)


# ------------------------------------------------------------------ mvnpdf --- #

@builtin("mvnpdf", category="stats/dist", min_in=1, max_in=3)
def m_mvnpdf(x, mu=None, sigma=None):
    hx = np.atleast_2d(_f(x))
    d = hx.shape[1]
    hm = np.zeros(d) if mu is None else fortran_ravel(_f(mu))
    hs = np.eye(d) if sigma is None else np.atleast_2d(_f(sigma))
    if hs.shape == (1, d) or hs.shape == (d, 1) or (d == 1 and hs.size == 1):
        hs = np.diag(fortran_ravel(hs))
    dx = hx - hm
    L = np.linalg.cholesky(hs)
    z = np.linalg.solve(L, dx.T)
    q = np.sum(z ** 2, axis=0)
    logdet = 2 * np.sum(np.log(np.diag(L)))
    r = np.exp(-0.5 * (q + d * np.log(2 * np.pi) + logdet))
    return _out(r.reshape(-1, 1), x)


# -------------------------------------------------------- hypothesis tests --- #

def _t_cdf(x, v):
    ib = sp.betainc(v / 2.0, 0.5, v / (v + x ** 2))
    return np.where(x >= 0, 1 - 0.5 * ib, 0.5 * ib)


def _t_inv(p, v):
    lo = np.minimum(p, 1 - p)
    b = sp.betaincinv(v / 2.0, 0.5, np.maximum(2 * lo, 1e-300))
    x = np.sqrt(v * (1 - b) / np.maximum(b, 1e-300))
    return np.where(p < 0.5, -x, np.where(p > 0.5, x, 0.0))


@builtin("ttest", category="stats/tests", min_in=1, max_in=6,
         pass_nargout=True)
def m_ttest(x, *rest, nargout=1):
    """One-sample (or paired, when a same-size y is given) two-sided t-test.
    [h, p, ci, stats] = ttest(x[, m][, 'Alpha', a])."""
    hx = fortran_ravel(_f(x))
    rest = list(rest)
    m = 0.0
    alpha = 0.05
    if rest and not is_text(rest[0]):
        other = fortran_ravel(_f(rest.pop(0)))
        if other.size == hx.size and other.size > 1:
            hx = hx - other          # paired test
        else:
            m = float(other.reshape(-1)[0])
    tail = "both"
    while len(rest) >= 2 and is_text(rest[0]):
        key = text_of(rest[0]).lower()
        if key == "alpha":
            alpha = scalar_num(rest[1], "Alpha")
        elif key == "tail":
            tail = text_of(rest[1]).lower()
            if tail not in ("both", "right", "left"):
                raise bad_arg("Tail",
                              "Tail must be 'both', 'right' or 'left'.")
        else:
            # unknown name-value pairs must error, not silently produce a
            # two-sided answer for a one-sided question (ADVICE r4 #2)
            raise bad_arg("ttest", f"Unrecognized option '{key}'.")
        rest = rest[2:]
    hx = hx[~np.isnan(hx)]
    n = hx.size
    if n < 2:
        raise bad_arg("ttest", "Not enough data.")
    sd = float(np.std(hx, ddof=1))
    se = sd / np.sqrt(n)
    t = (float(np.mean(hx)) - m) / se
    df = n - 1
    if tail == "both":
        p = float(2 * (1 - _t_cdf(np.abs(np.array(t)), float(df))))
        tcrit = float(_t_inv(np.array(1 - alpha / 2), float(df)))
        ci = np.array([[np.mean(hx) - tcrit * se],
                       [np.mean(hx) + tcrit * se]])
    elif tail == "right":
        p = float(1 - _t_cdf(np.array(t), float(df)))
        tcrit = float(_t_inv(np.array(1 - alpha), float(df)))
        ci = np.array([[np.mean(hx) - tcrit * se], [np.inf]])
    else:                                    # left
        p = float(_t_cdf(np.array(t), float(df)))
        tcrit = float(_t_inv(np.array(1 - alpha), float(df)))
        ci = np.array([[-np.inf], [np.mean(hx) + tcrit * se]])
    outs = [MatArray.logical_scalar(p < alpha), MatArray.scalar(p),
            MatArray(ci, "double"),
            StructArray.scalar({"tstat": MatArray.scalar(t),
                                "df": MatArray.scalar(float(df)),
                                "sd": MatArray.scalar(sd)})]
    return outs[:max(1, nargout)]


@builtin("anova1", category="stats/tests", min_in=1, max_in=3,
         pass_nargout=True)
def m_anova1(y, group=None, displayopt=None, nargout=1):
    """One-way ANOVA p-value: columns are groups, or a group vector labels
    rows. Returns [p, tbl] (display is always headless)."""
    hy = _f(y)
    groups = []
    if group is None or (is_text(group)):
        if hy.ndim == 1 or 1 in hy.shape:
            raise bad_arg("anova1", "Matrix input required without groups.")
        groups = [hy[:, j] for j in range(hy.shape[1])]
    else:
        yv = fortran_ravel(hy)
        if isinstance(group, (CellArray, StringArray)):
            labs = [text_of(e) if not isinstance(e, str) else e
                    for e in (group.data.reshape(-1, order="F"))]
        else:
            labs = [float(g) for g in fortran_ravel(_f(group))]
        uniq = list(dict.fromkeys(labs))
        groups = [yv[np.array([l == u for l in labs])] for u in uniq]
    groups = [g[~np.isnan(g)] for g in groups]
    k = len(groups)
    n = sum(g.size for g in groups)
    gm = np.concatenate(groups).mean()
    ssb = sum(g.size * (g.mean() - gm) ** 2 for g in groups)
    ssw = sum(((g - g.mean()) ** 2).sum() for g in groups)
    dfb, dfw = k - 1, n - k
    msb, msw = ssb / dfb, ssw / dfw
    F = msb / msw if msw > 0 else np.inf
    p = float(1 - sp.betainc(dfb / 2, dfw / 2, dfb * F / (dfb * F + dfw)))
    outs = [MatArray.scalar(p)]
    if nargout >= 2:
        rows = [["Source", "SS", "df", "MS", "F", "Prob>F"],
                ["Groups", ssb, dfb, msb, F, p],
                ["Error", ssw, dfw, msw, "", ""],
                ["Total", ssb + ssw, dfb + dfw, "", "", ""]]
        data = np.empty((4, 6), dtype=object)
        for i, row in enumerate(rows):
            for j, cell in enumerate(row):
                data[i, j] = MatArray.char_from_str(cell) if \
                    isinstance(cell, str) else MatArray.scalar(float(cell))
        outs.append(CellArray(data))
    return outs[:max(1, nargout)]


def _tiedrank(v: np.ndarray) -> tuple:
    order = np.argsort(v, kind="stable")
    ranks = np.empty(v.size)
    sv = v[order]
    i = 0
    tie_adj = 0.0
    while i < v.size:
        j = i
        while j + 1 < v.size and sv[j + 1] == sv[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        t = j - i + 1
        tie_adj += t ** 3 - t
        i = j + 1
    return ranks, tie_adj


@builtin("ranksum", category="stats/tests", min_in=2, max_in=2,
         pass_nargout=True)
def m_ranksum(x, y, nargout=1):
    """Wilcoxon rank-sum (Mann-Whitney) two-sided p via the tie-corrected
    normal approximation."""
    hx = fortran_ravel(_f(x))
    hy = fortran_ravel(_f(y))
    hx, hy = hx[~np.isnan(hx)], hy[~np.isnan(hy)]
    nx, ny = hx.size, hy.size
    ranks, tie_adj = _tiedrank(np.concatenate([hx, hy]))
    w = ranks[:nx].sum()
    n = nx + ny
    mu = nx * (n + 1) / 2.0
    var = nx * ny / 12.0 * ((n + 1) - tie_adj / (n * (n - 1)))
    z = (w - mu - 0.5 * np.sign(w - mu)) / np.sqrt(var) if var > 0 else 0.0
    p = float(sp.erfc(abs(z) / np.sqrt(2)))
    outs = [MatArray.scalar(p), MatArray.logical_scalar(p < 0.05)]
    return outs[:max(1, nargout)]


@builtin("signrank", category="stats/tests", min_in=1, max_in=2,
         pass_nargout=True)
def m_signrank(x, y=None, nargout=1):
    """Wilcoxon signed-rank two-sided p via the normal approximation."""
    hx = fortran_ravel(_f(x))
    if y is not None:
        hx = hx - fortran_ravel(_f(y))
    hx = hx[~np.isnan(hx)]
    hx = hx[hx != 0]
    n = hx.size
    if n == 0:
        return [MatArray.scalar(1.0)][:max(1, nargout)]
    ranks, tie_adj = _tiedrank(np.abs(hx))
    wp = ranks[hx > 0].sum()
    mu = n * (n + 1) / 4.0
    var = n * (n + 1) * (2 * n + 1) / 24.0 - tie_adj / 48.0
    z = (wp - mu - 0.5 * np.sign(wp - mu)) / np.sqrt(var) if var > 0 else 0.0
    p = float(sp.erfc(abs(z) / np.sqrt(2)))
    outs = [MatArray.scalar(p), MatArray.logical_scalar(p < 0.05)]
    return outs[:max(1, nargout)]


# --------------------------------------------------------------------- pca --- #

@builtin("pca", category="stats", min_in=1, max_in=3, pass_nargout=True)
def m_pca(x, *opts, nargout=1):
    """[coeff, score, latent, tsquared, explained, mu] = pca(X): principal
    components via SVD of the centered data (MATLAB default 'svd'
    algorithm, rows = observations)."""
    hx = np.atleast_2d(_f(x))
    n, d = hx.shape
    centered = True
    opts = list(opts)
    while len(opts) >= 2 and is_text(opts[0]):
        if text_of(opts[0]).lower() == "centered":
            c = opts[1]
            centered = bool(c.host().reshape(-1)[0]) if isinstance(c, MatArray) \
                else text_of(c).lower() in ("on", "true")
        opts = opts[2:]
    mu = hx.mean(axis=0) if centered else np.zeros(d)
    xc = hx - mu
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    dof = max(n - (1 if centered else 0), 1)
    latent = s ** 2 / dof
    k = min(n - (1 if centered else 0), d) if n > 1 else min(n, d)
    k = max(k, 0)
    coeff = vt.T[:, :k]
    # sign convention: largest |component| positive
    for j in range(coeff.shape[1]):
        jmax = np.argmax(np.abs(coeff[:, j]))
        if coeff[jmax, j] < 0:
            coeff[:, j] = -coeff[:, j]
            u[:, j] = -u[:, j]
    score = u[:, :k] * s[:k]
    latent = latent[:k].reshape(-1, 1)
    outs = [MatArray(coeff, "double"), MatArray(score, "double"),
            MatArray(latent, "double")]
    if nargout >= 4:
        with np.errstate(all="ignore"):
            t2 = np.sum((score / np.sqrt(latent.reshape(-1))) ** 2, axis=1)
        outs.append(MatArray(t2.reshape(-1, 1), "double"))
    if nargout >= 5:
        tot = latent.sum()
        expl = 100.0 * latent / tot if tot > 0 else latent * 0
        outs.append(MatArray(expl, "double"))
    if nargout >= 6:
        outs.append(MatArray(mu.reshape(1, -1), "double"))
    return outs[:max(1, nargout)]


# ---------------------------------------------------- xcov / autocorr ------ #

@builtin("xcov", category="stats", min_in=1, max_in=4, pass_nargout=True)
def m_xcov(x, *rest, nargout=1):
    """Cross-covariance: xcorr of the demeaned inputs, full MATLAB surface
    xcov(x), xcov(x,y), xcov(__,maxlag), xcov(__,scaleopt). A scalar
    trailing numeric is MAXLAG, never a second signal (ADVICE r4 #1:
    demeaning a scalar maxlag to 0 silently zeroed every output)."""
    from .fft_signal import _xcorr_args, xcorr_impl
    sig, maxlag, scale = _xcorr_args(rest)
    va = fortran_ravel(_f(x))
    va = va - va.mean()
    vb = None
    if sig is not None:
        vb = fortran_ravel(_f(sig))
        vb = vb - vb.mean()
    r = xcorr_impl(va, vb, maxlag, scale)
    ml = (r.size - 1) // 2
    outs = [MatArray(r.reshape(1, -1), "double"),
            MatArray(np.arange(-ml, ml + 1, dtype=np.float64).reshape(1, -1),
                     "double")]
    return outs[:max(1, nargout)]


@builtin("autocorr", category="stats", min_in=1, max_in=2, pass_nargout=True)
def m_autocorr(x, numlags=None, nargout=1):
    """Sample autocorrelation function at lags 0..numLags (default
    min(20, n-1))."""
    v = fortran_ravel(_f(x))
    n = v.size
    nl = int(scalar_num(numlags, "numLags")) if numlags is not None \
        else min(20, n - 1)
    vc = v - v.mean()
    denom = float(np.dot(vc, vc))
    acf = np.array([np.dot(vc[:n - k], vc[k:]) / denom
                    for k in range(nl + 1)])
    lags = np.arange(nl + 1, dtype=np.float64)
    outs = [MatArray(acf.reshape(-1, 1), "double"),
            MatArray(lags.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]
