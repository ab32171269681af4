"""Copy of runmat_tpu/runtime/builtins/stats2.py in the PyTorch port.

Statistics batch 2: probability distributions, hypothesis tests, ranking,
sampling, and summary extras.

Reference parity: runmat-runtime/src/builtins/stats/{summary,random,hist} —
normpdf/normcdf/norminv, t/chi2/binomial/weibull distributions, the generic
pdf/cdf/icdf/random dispatch, corr (Pearson/Spearman/Kendall), tiedrank,
tabulate, isoutlier/filloutliers, ecdf, onehot{en,de}code, kstest/ttest2,
gamrnd/trnd/unidrnd/wblrnd, randsample/datasample/bootstrp, lhsdesign,
dividerand, statset/statget, histcounts2. Distribution math uses host
scipy.special (the reference links system LAPACK/libm the same way); draws
consume the session Philox stream so `rng(seed)` reproducibility holds.
"""

from __future__ import annotations

import numpy as np
from scipy import special as sp

from ...errors import MatError, bad_arg
from ...ops import ctrng as philox
from ...values import (MatArray, StringArray, StructArray, fortran_ravel,
                       is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _out(r, *protos) -> MatArray:
    cls = "single" if any(p.mclass == "single" for p in protos
                          if isinstance(p, MatArray)) else "double"
    return MatArray(np.asarray(r, dtype=np.float64), cls)


# ------------------------------------------------------------- normal family #

def _norm_pdf(x, mu, sig):
    return np.exp(-0.5 * ((x - mu) / sig) ** 2) / (sig * np.sqrt(2 * np.pi))


def _norm_cdf(x, mu, sig):
    return 0.5 * sp.erfc(-(x - mu) / (sig * np.sqrt(2.0)))


def _norm_inv(p, mu, sig):
    return mu - sig * np.sqrt(2.0) * sp.erfcinv(2 * p)


@builtin("normpdf", category="stats/dist", min_in=1, max_in=3)
def m_normpdf(x, mu=None, sigma=None):
    m = _f(mu) if mu is not None else 0.0
    s = _f(sigma) if sigma is not None else 1.0
    return _out(_norm_pdf(_f(x), m, s), x)


@builtin("normcdf", category="stats/dist", min_in=1, max_in=3)
def m_normcdf(x, mu=None, sigma=None):
    m = _f(mu) if mu is not None else 0.0
    s = _f(sigma) if sigma is not None else 1.0
    return _out(_norm_cdf(_f(x), m, s), x)


@builtin("norminv", category="stats/dist", min_in=1, max_in=3)
def m_norminv(p, mu=None, sigma=None):
    m = _f(mu) if mu is not None else 0.0
    s = _f(sigma) if sigma is not None else 1.0
    return _out(_norm_inv(_f(p), m, s), p)


# ----------------------------------------------------------- t / chi2 / etc. #

def _t_cdf(x, v):
    ib = sp.betainc(v / 2.0, 0.5, v / (v + x ** 2))
    return np.where(x >= 0, 1 - 0.5 * ib, 0.5 * ib)


def _t_inv(p, v):
    # invert via the incomplete-beta inverse
    lo = np.minimum(p, 1 - p)
    b = sp.betaincinv(v / 2.0, 0.5, 2 * lo)
    x = np.sqrt(v * (1 - b) / np.maximum(b, 1e-300))
    return np.where(p < 0.5, -x, np.where(p > 0.5, x, 0.0))


@builtin("tpdf", category="stats/dist", min_in=2, max_in=2)
def m_tpdf(x, v):
    hx, hv = _f(x), _f(v)
    c = np.exp(sp.gammaln((hv + 1) / 2) - sp.gammaln(hv / 2)) / np.sqrt(hv * np.pi)
    return _out(c * (1 + hx ** 2 / hv) ** (-(hv + 1) / 2), x)


@builtin("tcdf", category="stats/dist", min_in=2, max_in=2)
def m_tcdf(x, v):
    return _out(_t_cdf(_f(x), _f(v)), x)


@builtin("tinv", category="stats/dist", min_in=2, max_in=2)
def m_tinv(p, v):
    return _out(_t_inv(_f(p), _f(v)), p)


@builtin("chi2cdf", category="stats/dist", min_in=2, max_in=2)
def m_chi2cdf(x, v):
    return _out(sp.gammainc(_f(v) / 2.0, np.maximum(_f(x), 0) / 2.0), x)


@builtin("binocdf", category="stats/dist", min_in=3, max_in=3)
def m_binocdf(x, n, p):
    hx = np.floor(_f(x))
    hn, hp = _f(n), _f(p)
    r = sp.betainc(np.maximum(hn - hx, 1e-300), hx + 1, 1 - hp)
    r = np.where(hx >= hn, 1.0, np.where(hx < 0, 0.0, r))
    return _out(r, x)


@builtin("poisspdf", category="stats/dist", min_in=2, max_in=2)
def m_poisspdf(x, lam):
    hx, hl = _f(x), _f(lam)
    k = np.round(hx)
    valid = (hx == k) & (k >= 0)
    kk = np.clip(k, 0, None)
    r = np.where(valid,
                 np.exp(kk * np.log(np.maximum(hl, 1e-300)) - hl
                        - sp.gammaln(kk + 1)), 0.0)
    return _out(r, x)


@builtin("poisscdf", category="stats/dist", min_in=2, max_in=2)
def m_poisscdf(x, lam):
    hx, hl = _f(x), _f(lam)
    k = np.floor(hx)
    r = sp.gammaincc(np.maximum(k, 0) + 1, hl)
    return _out(np.where(k < 0, 0.0, r), x)


@builtin("binopdf", category="stats/dist", min_in=3, max_in=3)
def m_binopdf(x, n, p):
    """Binomial pmf via gammaln (exact for integer x in range, 0 outside)."""
    hx, hn, hp = _f(x), _f(n), _f(p)
    k = np.round(hx)
    valid = (hx == k) & (k >= 0) & (k <= hn)
    kk = np.clip(k, 0, None)
    logc = sp.gammaln(hn + 1) - sp.gammaln(kk + 1) - sp.gammaln(hn - kk + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = np.where(kk > 0, kk * np.log(hp), 0.0) + \
            np.where(hn - kk > 0, (hn - kk) * np.log1p(-hp), 0.0)
    r = np.where(valid, np.exp(logc + logp), 0.0)
    return _out(r, x)


@builtin("binoinv", category="stats/dist", min_in=3, max_in=3)
def m_binoinv(y, n, p):
    """Smallest k with binocdf(k) >= y (vector-scan; n is modest)."""
    hy = np.atleast_1d(_f(y)).astype(np.float64)
    nn = int(np.asarray(_f(n)).reshape(-1)[0])
    pp = float(np.asarray(_f(p)).reshape(-1)[0])
    ks = np.arange(nn + 1)
    logc = sp.gammaln(nn + 1) - sp.gammaln(ks + 1) - sp.gammaln(nn - ks + 1)
    with np.errstate(divide="ignore"):
        pmf = np.exp(logc + np.where(ks > 0, ks * np.log(pp), 0.0)
                     + np.where(nn - ks > 0, (nn - ks) * np.log1p(-pp), 0.0))
    cdf = np.cumsum(pmf)
    out = np.array([float(ks[np.searchsorted(cdf, v - 1e-12)])
                    if v <= cdf[-1] else float(nn)
                    for v in hy.reshape(-1)])
    return _out(out.reshape(hy.shape), y)


@builtin("wblinv", category="stats/dist", min_in=1, max_in=3)
def m_wblinv(p, a=None, b=None):
    ha = _f(a) if a is not None else 1.0
    hb = _f(b) if b is not None else 1.0
    return _out(ha * (-np.log1p(-_f(p))) ** (1.0 / hb), p)


# ----------------------------------------------- generic distribution dispatch #

_DISTS = {
    "normal": {"np": 2,
               "pdf": lambda x, mu=0.0, sig=1.0: _norm_pdf(x, mu, sig),
               "cdf": lambda x, mu=0.0, sig=1.0: _norm_cdf(x, mu, sig),
               "icdf": lambda p, mu=0.0, sig=1.0: _norm_inv(p, mu, sig)},
    "exponential": {"np": 1,
                    "pdf": lambda x, mu=1.0: np.where(x >= 0, np.exp(-x / mu) / mu, 0.0),
                    "cdf": lambda x, mu=1.0: np.where(x >= 0, -np.expm1(-x / mu), 0.0),
                    "icdf": lambda p, mu=1.0: -mu * np.log1p(-p)},
    "uniform": {"np": 2,
                "pdf": lambda x, a=0.0, b=1.0: np.where((x >= a) & (x <= b), 1.0 / (b - a), 0.0),
                "cdf": lambda x, a=0.0, b=1.0: np.clip((x - a) / (b - a), 0, 1),
                "icdf": lambda p, a=0.0, b=1.0: a + p * (b - a)},
    "weibull": {"np": 2,
                "pdf": lambda x, a=1.0, b=1.0: np.where(
                    x >= 0, b / a * (x / a) ** (b - 1) * np.exp(-(x / a) ** b), 0.0),
                "cdf": lambda x, a=1.0, b=1.0: np.where(x >= 0, -np.expm1(-(x / a) ** b), 0.0),
                "icdf": lambda p, a=1.0, b=1.0: a * (-np.log1p(-p)) ** (1.0 / b)},
    "gamma": {"np": 2,
              "pdf": lambda x, a=1.0, b=1.0: np.where(
                  x > 0, x ** (a - 1) * np.exp(-x / b) / (sp.gamma(a) * b ** a), 0.0),
              "cdf": lambda x, a=1.0, b=1.0: sp.gammainc(a, np.maximum(x, 0) / b),
              "icdf": lambda p, a=1.0, b=1.0: b * sp.gammaincinv(a, p)},
    "lognormal": {"np": 2,
                  "pdf": lambda x, mu=0.0, sig=1.0: np.where(
                      x > 0, _norm_pdf(np.log(np.maximum(x, 1e-300)), mu, sig) / np.maximum(x, 1e-300), 0.0),
                  "cdf": lambda x, mu=0.0, sig=1.0: np.where(
                      x > 0, _norm_cdf(np.log(np.maximum(x, 1e-300)), mu, sig), 0.0),
                  "icdf": lambda p, mu=0.0, sig=1.0: np.exp(_norm_inv(p, mu, sig))},
    "poisson": {"np": 1,
                "pdf": lambda x, lam=1.0: np.exp(-lam + x * np.log(lam) - sp.gammaln(x + 1)),
                "cdf": lambda x, lam=1.0: sp.gammaincc(np.floor(x) + 1, lam),
                "icdf": None},
    "tlocationscale": None,
}
_DIST_ALIASES = {"norm": "normal", "exp": "exponential", "unif": "uniform",
                 "wbl": "weibull", "gam": "gamma", "logn": "lognormal",
                 "poiss": "poisson"}


def _dist_eval(kind: str, name, x, params):
    dname = text_of(name).lower()
    dname = _DIST_ALIASES.get(dname, dname)
    d = _DISTS.get(dname)
    if d is None or d.get(kind) is None:
        raise bad_arg(kind, f"Unsupported distribution '{text_of(name)}'.")
    ps = [_f(p) for p in params]
    return _out(d[kind](_f(x), *ps), x)


@builtin("pdf", category="stats/dist", min_in=2)
def m_pdf(name, x, *params):
    return _dist_eval("pdf", name, x, params)


@builtin("cdf", category="stats/dist", min_in=2)
def m_cdf(name, x, *params):
    return _dist_eval("cdf", name, x, params)


@builtin("icdf", category="stats/dist", min_in=2)
def m_icdf(name, p, *params):
    return _dist_eval("icdf", name, p, params)


@builtin("random", category="stats/dist", min_in=1, pass_ctx=True)
def m_random(name, *args, ctx=None):
    """random(distname, A, [B], [sz...]) via inverse-CDF over the session
    Philox stream."""
    dname = text_of(name).lower()
    dname = _DIST_ALIASES.get(dname, dname)
    d = _DISTS.get(dname)
    if d is None or d.get("icdf") is None:
        raise bad_arg("random", f"Unsupported distribution '{text_of(name)}'.")
    nparam = d["np"]
    params = [_f(a) for a in args[:nparam]]
    size_args = args[nparam:]
    if size_args:
        dims = [scalar_int(a, "size") for a in size_args]
        if len(dims) == 1:
            dims = [dims[0], dims[0]]
    else:
        dims = list(np.broadcast(*[np.empty(p.shape) for p in params]).shape) \
            if params else [1, 1]
        if len(dims) < 2:
            dims = [1, 1] if not dims else [dims[0], 1]
    n = int(np.prod(dims))
    u = philox.host_rand(ctx.session.rng, n, "double")
    r = d["icdf"](u.reshape(dims, order="F"), *[np.broadcast_to(p, dims) if p.size > 1 else p
                                                for p in params])
    return MatArray(np.asarray(r), "double")


@builtin("fitdist", category="stats/dist", min_in=2, max_in=2)
def m_fitdist(x, name):
    """Fit a distribution by MLE/moments; returns a struct with the MATLAB
    prob-distribution object's public fields."""
    h = fortran_ravel(_f(x))
    h = h[np.isfinite(h)]
    dname = text_of(name).lower()
    dname = _DIST_ALIASES.get(dname, dname)
    if dname == "normal":
        mu, sig = float(np.mean(h)), float(np.std(h, ddof=1))
        fields = {"mu": mu, "sigma": sig}
    elif dname == "exponential":
        fields = {"mu": float(np.mean(h))}
    elif dname == "lognormal":
        lg = np.log(h[h > 0])
        fields = {"mu": float(np.mean(lg)), "sigma": float(np.std(lg, ddof=1))}
    elif dname == "weibull":
        # method-of-moments seed + a few Newton steps on the MLE equation
        lx = np.log(h[h > 0])
        k = 1.2 / max(np.std(lx), 1e-9)
        for _ in range(30):
            xk = h ** k
            num = (xk * np.log(h)).sum() / xk.sum() - 1.0 / k - lx.mean()
            den = (xk * np.log(h) ** 2).sum() / xk.sum() - \
                ((xk * np.log(h)).sum() / xk.sum()) ** 2 + 1.0 / k ** 2
            k -= num / den
        lam = (np.mean(h ** k)) ** (1.0 / k)
        fields = {"A": float(lam), "B": float(k)}
    elif dname == "gamma":
        m, v = np.mean(h), np.var(h, ddof=1)
        fields = {"a": float(m * m / v), "b": float(v / m)}
    else:
        raise bad_arg("fitdist", f"Unsupported distribution '{text_of(name)}'.")
    out = {"DistributionName": StringArray.scalar(dname)}
    for k2, v2 in fields.items():
        out[k2] = MatArray.scalar(v2)
    return StructArray.scalar(out)


# ------------------------------------------------------------ summary extras #

@builtin("rms", category="stats", min_in=1, max_in=2)
def m_rms(x, dim=None):
    h = _f(x)
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    return _out(np.sqrt(np.mean(h * h, axis=ax, keepdims=True)), x)


@builtin("rmse", category="stats", min_in=2, max_in=3)
def m_rmse(f, y, dim=None):
    hf, hy = np.broadcast_arrays(_f(f), _f(y))
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if hf.shape[0] != 1 else 1)
    return _out(np.sqrt(np.mean((hf - hy) ** 2, axis=ax, keepdims=True)), f, y)


@builtin("geomean", category="stats", min_in=1, max_in=2)
def m_geomean(x, dim=None):
    h = _f(x)
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    return _out(np.exp(np.mean(np.log(h), axis=ax, keepdims=True)), x)


@builtin("harmmean", category="stats", min_in=1, max_in=2)
def m_harmmean(x, dim=None):
    h = _f(x)
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    return _out(1.0 / np.mean(1.0 / h, axis=ax, keepdims=True), x)


@builtin("tiedrank", category="stats", min_in=1, max_in=1)
def m_tiedrank(x):
    h = _f(x)
    vec = h.ndim == 2 and 1 in h.shape

    def rank1(v):
        order = np.argsort(v, kind="stable")
        ranks = np.empty(v.size)
        ranks[order] = np.arange(1, v.size + 1)
        # average ties
        sv = v[order]
        i = 0
        while i < v.size:
            j = i
            while j + 1 < v.size and sv[j + 1] == sv[i]:
                j += 1
            if j > i:
                ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
            i = j + 1
        return ranks

    if vec:
        flat = rank1(h.reshape(-1, order="F"))
        return MatArray(flat.reshape(h.shape, order="F"), "double")
    out = np.empty_like(h)
    for c in range(h.shape[1]):
        out[:, c] = rank1(h[:, c])
    return MatArray(out, "double")


@builtin("tabulate", category="stats", min_in=1, max_in=1)
def m_tabulate(x):
    h = fortran_ravel(_f(x))
    vals, counts = np.unique(h[~np.isnan(h)], return_counts=True)
    pct = counts / max(h.size, 1) * 100.0
    return MatArray(np.column_stack([vals, counts.astype(np.float64), pct]), "double")


def _outlier_mask(h: np.ndarray, method: str, thr: float | None) -> np.ndarray:
    if method == "median":
        med = np.nanmedian(h)
        mad = np.nanmedian(np.abs(h - med))
        c = -1 / (np.sqrt(2) * sp.erfcinv(1.5))  # ~1.4826
        t = (thr if thr is not None else 3.0) * c * mad
        return np.abs(h - med) > t
    if method == "mean":
        mu, sd = np.nanmean(h), np.nanstd(h)
        return np.abs(h - mu) > (thr if thr is not None else 3.0) * sd
    if method == "quartiles":
        q1, q3 = np.nanpercentile(h, [25, 75])
        iqr = q3 - q1
        w = thr if thr is not None else 1.5
        return (h < q1 - w * iqr) | (h > q3 + w * iqr)
    raise bad_arg("isoutlier", f"Unknown method '{method}'.")


@builtin("isoutlier", category="stats", min_in=1, pass_nargout=True)
def m_isoutlier(x, *rest, nargout=1):
    method = "median"
    thr = None
    i = 0
    rest = list(rest)
    while i < len(rest):
        if is_text(rest[i]):
            t = text_of(rest[i]).lower()
            if t == "thresholdfactor":
                thr = scalar_num(rest[i + 1], "ThresholdFactor")
                i += 2
                continue
            method = t
        i += 1
    mask = _outlier_mask(_f(x), method, thr)
    return MatArray(mask, "logical")


@builtin("filloutliers", category="stats", min_in=2, pass_nargout=True)
def m_filloutliers(x, fill, *rest, nargout=1):
    h = _f(x).copy()
    method = text_of(rest[0]).lower() if rest and is_text(rest[0]) else "median"
    mask = _outlier_mask(h, method, None)
    fm = text_of(fill).lower() if is_text(fill) else None
    if fm is None:
        h[mask] = scalar_num(fill, "fill")
    elif fm == "center":
        h[mask] = np.nanmedian(h[~mask])
    elif fm in ("previous", "next", "nearest", "linear", "clip"):
        if fm == "clip":
            lo, hi = np.nanmin(h[~mask]), np.nanmax(h[~mask])
            h[mask] = np.clip(h[mask], lo, hi)
        else:
            idx = np.arange(h.size).reshape(h.shape)
            flat, fidx, fmask = h.reshape(-1, order="F"), idx.reshape(-1, order="F"), mask.reshape(-1, order="F")
            good = ~fmask
            if good.sum():
                flat[fmask] = np.interp(fidx[fmask].astype(float),
                                        fidx[good].astype(float), flat[good])
            h = flat.reshape(h.shape, order="F")
    else:
        raise bad_arg("filloutliers", f"Unknown fill '{fm}'.")
    out = MatArray(h, "double")
    if nargout <= 1:
        return out
    return [out, MatArray(mask, "logical")]


@builtin("ecdf", category="stats", min_in=1, max_in=1, pass_nargout=True)
def m_ecdf(x, nargout=1):
    h = np.sort(fortran_ravel(_f(x)))
    h = h[~np.isnan(h)]
    n = h.size
    f = np.arange(1, n + 1) / n
    fv = np.concatenate([[0.0], f]).reshape(-1, 1)
    xv = np.concatenate([[h[0] if n else 0.0], h]).reshape(-1, 1)
    if nargout <= 1:
        return MatArray(fv, "double")
    return [MatArray(fv, "double"), MatArray(xv, "double")]


@builtin("dummyvar", category="stats", min_in=1, max_in=1)
def m_dummyvar(g):
    h = fortran_ravel(_f(g)).astype(np.int64)
    k = int(h.max()) if h.size else 0
    out = np.zeros((h.size, k))
    out[np.arange(h.size), h - 1] = 1.0
    return MatArray(out, "double")


@builtin("onehotencode", category="stats", min_in=2, max_in=2)
def m_onehotencode(x, dim):
    h = _f(x)
    d = scalar_int(dim, "dim")
    flat = fortran_ravel(h).astype(np.int64)
    k = int(flat.max()) if flat.size else 0
    oh = np.zeros((flat.size, k))
    oh[np.arange(flat.size), flat - 1] = 1.0
    if d == 1:
        return MatArray(oh.T.copy(), "double")
    return MatArray(oh, "double")


@builtin("onehotdecode", category="stats", min_in=3, max_in=3)
def m_onehotdecode(p, classes, dim):
    h = _f(p)
    d = scalar_int(dim, "dim") - 1
    idx = np.argmax(h, axis=d)
    cls = fortran_ravel(_f(classes))
    vals = cls[idx]
    return MatArray(np.expand_dims(vals, d), "double")


@builtin("kstest", category="stats", min_in=1, max_in=1, pass_nargout=True)
def m_kstest(x, nargout=1):
    """One-sample KS test against the standard normal at alpha=0.05."""
    h = np.sort(fortran_ravel(_f(x)))
    h = h[~np.isnan(h)]
    n = h.size
    cdf = _norm_cdf(h, 0.0, 1.0)
    d_plus = np.max(np.arange(1, n + 1) / n - cdf) if n else 0.0
    d_minus = np.max(cdf - np.arange(0, n) / n) if n else 0.0
    d = max(d_plus, d_minus)
    lam = (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n)) * d if n else 0.0
    j = np.arange(1, 101)
    pval = float(2 * np.sum((-1) ** (j - 1) * np.exp(-2 * (j * lam) ** 2)))
    pval = min(max(pval, 0.0), 1.0)
    hyp = MatArray.logical_scalar(pval < 0.05)
    if nargout <= 1:
        return hyp
    return [hyp, MatArray.scalar(pval), MatArray.scalar(float(d))]


@builtin("ttest2", category="stats", min_in=2, max_in=2, pass_nargout=True)
def m_ttest2(x, y, nargout=1):
    hx, hy = fortran_ravel(_f(x)), fortran_ravel(_f(y))
    hx, hy = hx[~np.isnan(hx)], hy[~np.isnan(hy)]
    nx, ny = hx.size, hy.size
    sp2 = ((nx - 1) * np.var(hx, ddof=1) + (ny - 1) * np.var(hy, ddof=1)) / (nx + ny - 2)
    t = (np.mean(hx) - np.mean(hy)) / np.sqrt(sp2 * (1 / nx + 1 / ny))
    v = nx + ny - 2
    pval = float(2 * (1 - _t_cdf(abs(t), v)))
    hyp = MatArray.logical_scalar(pval < 0.05)
    if nargout <= 1:
        return hyp
    return [hyp, MatArray.scalar(pval),
            StructArray.scalar({"tstat": MatArray.scalar(float(t)),
                                "df": MatArray.scalar(float(v)),
                                "sd": MatArray.scalar(float(np.sqrt(sp2)))})][:nargout]


# -------------------------------------------------------------- correlations #

@builtin("corr", category="stats", min_in=1, pass_nargout=True)
def m_corr(x, *rest, nargout=1):
    kind = "pearson"
    ys = None
    i = 0
    rest = list(rest)
    while i < len(rest):
        if is_text(rest[i]):
            if text_of(rest[i]).lower() == "type" and i + 1 < len(rest):
                kind = text_of(rest[i + 1]).lower()
                i += 2
                continue
            kind = text_of(rest[i]).lower()
            i += 1
            continue
        ys = rest[i]
        i += 1
    hx = _f(x)
    if hx.ndim == 2 and 1 in hx.shape:
        hx = hx.reshape(-1, 1)
    hy = None
    if ys is not None:
        hy = _f(ys)
        if hy.ndim == 2 and 1 in hy.shape:
            hy = hy.reshape(-1, 1)

    def transform(m):
        if kind == "spearman":
            out = np.empty_like(m, dtype=np.float64)
            for c in range(m.shape[1]):
                col = m[:, c]
                order = np.argsort(col, kind="stable")
                r = np.empty(col.size)
                r[order] = np.arange(1, col.size + 1)
                sv = col[order]
                i0 = 0
                while i0 < col.size:
                    j0 = i0
                    while j0 + 1 < col.size and sv[j0 + 1] == sv[i0]:
                        j0 += 1
                    if j0 > i0:
                        r[order[i0:j0 + 1]] = (i0 + j0 + 2) / 2.0
                    i0 = j0 + 1
                out[:, c] = r
            return out
        return m

    if kind == "kendall":
        def ktau(a, b):
            n = a.size
            num = 0
            for i1 in range(n - 1):
                s = np.sign(a[i1 + 1:] - a[i1]) * np.sign(b[i1 + 1:] - b[i1])
                num += s.sum()
            return num / (n * (n - 1) / 2)
        cols_x = hx.shape[1]
        cols_y = hy.shape[1] if hy is not None else cols_x
        src_y = hy if hy is not None else hx
        R = np.empty((cols_x, cols_y))
        for a in range(cols_x):
            for b in range(cols_y):
                R[a, b] = ktau(hx[:, a], src_y[:, b])
        return MatArray(R, "double")

    tx = transform(hx)
    if hy is None:
        R = np.corrcoef(tx, rowvar=False)
        R = np.atleast_2d(R)
    else:
        ty = transform(hy)
        full = np.corrcoef(np.hstack([tx, ty]), rowvar=False)
        R = np.atleast_2d(full)[:tx.shape[1], tx.shape[1]:]
    return MatArray(R, "double")


@builtin("corrcov", category="stats", min_in=1, max_in=1)
def m_corrcov(c):
    h = _f(c)
    s = np.sqrt(np.diag(h))
    return MatArray(h / np.outer(s, s), "double")


@builtin("cov2corr", category="stats", min_in=1, max_in=1, pass_nargout=True)
def m_cov2corr(c, nargout=1):
    h = _f(c)
    s = np.sqrt(np.diag(h))
    R = h / np.outer(s, s)
    if nargout <= 1:
        return MatArray(R, "double")
    return [MatArray(s.reshape(1, -1), "double"), MatArray(R, "double")]


# ---------------------------------------------------------------- sampling #

@builtin("gamrnd", category="stats/random", min_in=2, pass_ctx=True)
def m_gamrnd(a, b, *size_args, ctx=None):
    ha, hb = _f(a), _f(b)
    if size_args:
        dims = [scalar_int(s, "size") for s in size_args]
        if len(dims) == 1:
            dims = [dims[0], dims[0]]
    else:
        dims = list(np.broadcast(ha, hb).shape) or [1, 1]
    n = int(np.prod(dims))
    u = philox.host_rand(ctx.session.rng, n, "double")
    shape = np.broadcast_to(ha, dims).reshape(-1, order="F") if ha.size > 1 else \
        np.full(n, float(ha.reshape(-1)[0]))
    scale = np.broadcast_to(hb, dims).reshape(-1, order="F") if hb.size > 1 else \
        np.full(n, float(hb.reshape(-1)[0]))
    vals = scale * sp.gammaincinv(shape, u)
    return MatArray(vals.reshape(dims, order="F"), "double")


@builtin("trnd", category="stats/random", min_in=1, pass_ctx=True)
def m_trnd(v, *size_args, ctx=None):
    hv = _f(v)
    dims = ([scalar_int(s, "size") for s in size_args] or list(hv.shape))
    if len(dims) == 1:
        dims = [dims[0], dims[0]]
    n = int(np.prod(dims))
    u = philox.host_rand(ctx.session.rng, n, "double")
    dof = np.broadcast_to(hv, dims).reshape(-1, order="F") if hv.size > 1 else \
        np.full(n, float(hv.reshape(-1)[0]))
    vals = _t_inv(u, dof)
    return MatArray(vals.reshape(dims, order="F"), "double")


@builtin("unidrnd", category="stats/random", min_in=1, pass_ctx=True)
def m_unidrnd(nmax, *size_args, ctx=None):
    hi = scalar_int(nmax, "N")
    dims = [scalar_int(s, "size") for s in size_args] or [1, 1]
    if len(dims) == 1:
        dims = [dims[0], dims[0]]
    n = int(np.prod(dims))
    u = philox.host_rand(ctx.session.rng, n, "double")
    vals = np.floor(u * hi) + 1
    return MatArray(vals.reshape(dims, order="F"), "double")


@builtin("wblrnd", category="stats/random", min_in=2, pass_ctx=True)
def m_wblrnd(a, b, *size_args, ctx=None):
    ha, hb = scalar_num(a, "A"), scalar_num(b, "B")
    dims = [scalar_int(s, "size") for s in size_args] or [1, 1]
    if len(dims) == 1:
        dims = [dims[0], dims[0]]
    n = int(np.prod(dims))
    u = philox.host_rand(ctx.session.rng, n, "double")
    vals = ha * (-np.log1p(-u)) ** (1.0 / hb)
    return MatArray(vals.reshape(dims, order="F"), "double")


@builtin("randsample", category="stats/random", min_in=2, max_in=4, pass_ctx=True)
def m_randsample(pop, k, replace=None, w=None, ctx=None):
    kk = scalar_int(k, "k")
    hp = fortran_ravel(_f(pop))
    if hp.size == 1:
        hp = np.arange(1, int(hp[0]) + 1, dtype=np.float64)
    rep = bool(replace.is_true()) if replace is not None else False
    nn = hp.size
    if w is not None:
        hw = fortran_ravel(_f(w))
        p = hw / hw.sum()
        cum = np.cumsum(p)
        u = philox.host_rand(ctx.session.rng, kk, "double")
        idx = np.searchsorted(cum, u)
        return MatArray(hp[np.minimum(idx, nn - 1)].reshape(-1, 1), "double")
    if rep:
        u = philox.host_rand(ctx.session.rng, kk, "double")
        idx = np.minimum((u * nn).astype(np.int64), nn - 1)
    else:
        if kk > nn:
            raise MatError("stats:randsample:SampleTooLarge",
                           "K must not exceed the population size without replacement.")
        u = philox.host_rand(ctx.session.rng, nn, "double")
        idx = np.argsort(u, kind="stable")[:kk]
    return MatArray(hp[idx].reshape(-1, 1), "double")


@builtin("datasample", category="stats/random", min_in=2, max_in=2, pass_ctx=True)
def m_datasample(data, k, ctx=None):
    kk = scalar_int(k, "k")
    h = data.host()
    n = h.shape[0] if h.ndim == 2 and h.shape[0] > 1 else h.size
    u = philox.host_rand(ctx.session.rng, kk, "double")
    idx = np.minimum((u * n).astype(np.int64), n - 1)
    if h.ndim == 2 and h.shape[0] > 1:
        return MatArray(h[idx, :], data.mclass)
    flat = h.reshape(-1, order="F")[idx]
    return MatArray(flat.reshape(-1, 1), data.mclass)


@builtin("bootstrp", category="stats/random", min_in=3, pass_ctx=True)
def m_bootstrp(nboot, f, data, *more, ctx=None):
    """bootstrp(nboot, fn, d1, d2, ...): resample rows jointly across all
    data args (MATLAB passes each resampled arg to fn)."""
    nb = scalar_int(nboot, "nboot")
    h = _f(data)
    flat = fortran_ravel(h)
    n = flat.size
    rows = []
    from ...values import FunctionHandle
    extra = [fortran_ravel(_f(m)) for m in more]
    for ex in extra:
        if ex.size != n:
            raise bad_arg("bootstrp",
                          "Nonscalar data inputs must have the same "
                          "number of rows.")
    for _ in range(nb):
        u = philox.host_rand(ctx.session.rng, n, "double")
        idx = np.minimum((u * n).astype(np.int64), n - 1)
        samps = [MatArray(flat[idx].reshape(-1, 1), "double")]
        for ex in extra:
            samps.append(MatArray(ex[idx].reshape(-1, 1), "double"))
        r = ctx.interp.call_value(f, samps, 1, ctx.frame) if isinstance(f, FunctionHandle) \
            else ctx.interp.call_named(text_of(f), samps, 1, ctx.frame)
        rows.append(fortran_ravel(_f(r[0])))
    return MatArray(np.vstack([r.reshape(1, -1) for r in rows]), "double")


@builtin("lhsdesign", category="stats/random", min_in=2, max_in=2, pass_ctx=True)
def m_lhsdesign(n, p, ctx=None):
    nn, pp = scalar_int(n, "n"), scalar_int(p, "p")
    out = np.empty((nn, pp))
    for c in range(pp):
        u = philox.host_rand(ctx.session.rng, nn, "double")
        perm = np.argsort(philox.host_rand(ctx.session.rng, nn, "double"), kind="stable")
        out[:, c] = (perm + u) / nn
    return MatArray(out, "double")


@builtin("dividerand", category="stats/random", min_in=1, max_in=4, pass_ctx=True,
         pass_nargout=True)
def m_dividerand(q, tr=None, va=None, te=None, ctx=None, nargout=1):
    n = scalar_int(q, "Q")
    fr = [scalar_num(tr, "train") if tr is not None else 0.7,
          scalar_num(va, "val") if va is not None else 0.15,
          scalar_num(te, "test") if te is not None else 0.15]
    tot = sum(fr)
    fr = [f / tot for f in fr]
    u = philox.host_rand(ctx.session.rng, n, "double")
    perm = np.argsort(u, kind="stable") + 1
    n_tr = int(round(fr[0] * n))
    n_va = int(round(fr[1] * n))
    parts = [perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:]]
    outs = [MatArray(p.astype(np.float64).reshape(1, -1), "double") for p in parts]
    return outs[:max(1, nargout)]


# ----------------------------------------------------------- options structs #

@builtin("statset", category="stats", min_in=0)
def m_statset(*args):
    fields = {"Display": MatArray.char_from_str("off"),
              "MaxIter": MatArray.scalar(100.0),
              "TolFun": MatArray.scalar(1e-6),
              "TolX": MatArray.scalar(1e-6)}
    i = 0
    args = list(args)
    if args and isinstance(args[0], StructArray):
        base = args.pop(0)
        for k in base.fields:
            fields[k] = base.get_scalar_field(k)
    while i + 1 < len(args):
        fields[text_of(args[i])] = args[i + 1]
        i += 2
    return StructArray.scalar(fields)


@builtin("statget", category="stats", min_in=2, max_in=3)
def m_statget(opts, name, default=None):
    key = text_of(name)
    if isinstance(opts, StructArray) and key in opts.fields:
        return opts.get_scalar_field(key)
    return default if default is not None else MatArray.empty()


@builtin("histcounts2", category="stats", min_in=2, pass_nargout=True)
def m_histcounts2(x, y, *rest, nargout=1):
    hx, hy = fortran_ravel(_f(x)), fortran_ravel(_f(y))
    ok = np.isfinite(hx) & np.isfinite(hy)
    hx, hy = hx[ok], hy[ok]
    nb = [None, None]
    if rest and not is_text(rest[0]):
        b = rest[0]
        hb = _f(b)
        if hb.size == 1:
            nb = [int(hb.reshape(-1)[0])] * 2
        if len(rest) > 1 and not is_text(rest[1]):
            nb[1] = int(_f(rest[1]).reshape(-1)[0])
    bins_x = nb[0] or max(int(np.ceil(np.sqrt(hx.size))), 1)
    bins_y = nb[1] or bins_x
    counts, ex, ey = np.histogram2d(hx, hy, bins=[bins_x, bins_y])
    outs = [MatArray(counts, "double"), MatArray(ex.reshape(1, -1), "double"),
            MatArray(ey.reshape(1, -1), "double")]
    return outs[:max(1, nargout)]


@builtin("zscore", category="stats", min_in=1, max_in=2)
def m_zscore(x, flag=None):
    """zscore(X[, flag]): flag 0 (default) uses N-1; 1 uses N."""
    h = _f(x)
    ddof = 1
    if flag is not None and float(_f(flag).reshape(-1)[0]) == 1.0:
        ddof = 0
    if h.ndim == 2 and 1 in h.shape:
        mu = h.mean()
        sd = h.std(ddof=ddof) or 1.0
        return _out((h - mu) / sd, x)
    ax = 0
    mu = h.mean(axis=ax, keepdims=True)
    sd = h.std(axis=ax, ddof=ddof, keepdims=True)
    sd = np.where(sd == 0, 1.0, sd)
    return _out((h - mu) / sd, x)
