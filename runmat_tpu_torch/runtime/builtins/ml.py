"""Copy of runmat_tpu/runtime/builtins/ml.py in the PyTorch port.

Machine-learning statistics batch: clustering, nearest neighbors, distance
matrices, regression fits, classification, cross-validation, embeddings.

Reference parity: runmat-runtime/src/builtins/stats/ml/{kmeans,knnsearch,
pdist,pdist2,squareform,linkage,confusionmat,cvpartition,crossvalind,classify,
fitlm,regress,ridge,lasso,mnrfit,tsne,perfcurve,fitctree,fitclinear,bayesopt,
optimizableVariable,test,training}.rs. Distance/cluster kernels use host
scipy/numpy; draws consume the session Philox stream for `rng` parity.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...ops import ctrng as philox
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, fortran_ravel, is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num
from .ode_optim import _callf


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


_METRICS = {
    "euclidean": "euclidean", "squaredeuclidean": "sqeuclidean",
    "cityblock": "cityblock", "chebychev": "chebyshev", "cosine": "cosine",
    "correlation": "correlation", "hamming": "hamming", "jaccard": "jaccard",
    "minkowski": "minkowski", "seuclidean": "seuclidean",
    "mahalanobis": "mahalanobis", "spearman": None,
}


@builtin("pdist", category="stats/ml", min_in=1, max_in=2)
def m_pdist(x, metric=None):
    from scipy.spatial import distance as sd
    m = _METRICS.get(text_of(metric).lower() if metric is not None else "euclidean",
                     "euclidean")
    return MatArray(sd.pdist(_f(x), m).reshape(1, -1), "double")


@builtin("pdist2", category="stats/ml", min_in=2, max_in=3)
def m_pdist2(x, y, metric=None):
    from scipy.spatial import distance as sd
    m = _METRICS.get(text_of(metric).lower() if metric is not None else "euclidean",
                     "euclidean")
    return MatArray(sd.cdist(_f(x), _f(y), m), "double")


@builtin("squareform", category="stats/ml", min_in=1, max_in=1)
def m_squareform(v):
    from scipy.spatial import distance as sd
    h = _f(v)
    if h.ndim == 2 and 1 in h.shape:
        return MatArray(sd.squareform(fortran_ravel(h)), "double")
    return MatArray(sd.squareform(h, checks=False).reshape(1, -1), "double")


@builtin("linkage", category="stats/ml", min_in=1, max_in=2)
def m_linkage(x, method=None):
    from scipy.cluster import hierarchy as sh
    meth = text_of(method).lower() if method is not None else "single"
    h = _f(x)
    # a ROW vector is a condensed pdist output; a column is n observations
    condensed = h.ndim == 2 and h.shape[0] == 1 and h.shape[1] > 1
    Z = sh.linkage(fortran_ravel(h) if condensed else h, method=meth)
    # MATLAB linkage: first two columns are 1-based cluster indices
    out = Z[:, :3].copy()
    out[:, :2] += 1
    return MatArray(out, "double")


@builtin("knnsearch", category="stats/ml", min_in=2, max_in=3, pass_nargout=True)
def m_knnsearch(x, y, *rest, nargout=1):
    from scipy.spatial import cKDTree
    k = 1
    rest = list(rest)
    i = 0
    while i < len(rest):
        if is_text(rest[i]) and text_of(rest[i]).lower() == "k" and i + 1 < len(rest):
            k = scalar_int(rest[i + 1], "K")
            i += 2
            continue
        i += 1
    tree = cKDTree(_f(x))
    d, idx = tree.query(_f(y), k=k)
    idx = np.atleast_2d(idx.astype(np.float64) + 1)
    d = np.atleast_2d(d)
    if idx.shape[0] == 1 and _f(y).shape[0] > 1:
        idx, d = idx.T, d.T
    if nargout <= 1:
        return MatArray(idx, "double")
    return [MatArray(idx, "double"), MatArray(d, "double")]


@builtin("kmeans", category="stats/ml", min_in=2, pass_ctx=True, pass_nargout=True)
def m_kmeans(x, k, *rest, ctx=None, nargout=1):
    """Lloyd's algorithm with k-means++ seeding off the session RNG."""
    h = _f(x)
    kk = scalar_int(k, "k")
    n = h.shape[0]
    # k-means++ init
    u = philox.host_rand(ctx.session.rng, kk * 2 + 1, "double")
    centers = [h[int(u[0] * n) % n]]
    for j in range(1, kk):
        d2 = np.min([((h - c) ** 2).sum(axis=1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-300)
        cum = np.cumsum(p)
        centers.append(h[np.searchsorted(cum, u[j])])
    C = np.array(centers)
    idx = np.zeros(n, dtype=int)
    for _ in range(100):
        D = ((h[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        new_idx = D.argmin(axis=1)
        if (new_idx == idx).all() and _ > 0:
            break
        idx = new_idx
        for j in range(kk):
            pts = h[idx == j]
            if pts.size:
                C[j] = pts.mean(axis=0)
    D = ((h[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
    sumd = np.array([D[idx == j, j].sum() for j in range(kk)])
    outs = [MatArray((idx + 1.0).reshape(-1, 1), "double"),
            MatArray(C, "double"),
            MatArray(sumd.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("confusionmat", category="stats/ml", min_in=2, max_in=2, pass_nargout=True)
def m_confusionmat(truth, pred, nargout=1):
    t = fortran_ravel(_f(truth))
    p = fortran_ravel(_f(pred))
    labels = np.unique(np.concatenate([t, p]))
    k = labels.size
    lut = {v: i for i, v in enumerate(labels)}
    C = np.zeros((k, k))
    for a, b in zip(t, p):
        C[lut[a], lut[b]] += 1
    if nargout <= 1:
        return MatArray(C, "double")
    return [MatArray(C, "double"), MatArray(labels.reshape(-1, 1), "double")]


# ------------------------------------------------------------ cvpartition --- #

@builtin("cvpartition", category="stats/ml", min_in=2, pass_ctx=True)
def m_cvpartition(n, kind, arg=None, ctx=None):
    nn = scalar_int(n, "n")
    kd = text_of(kind).lower()
    u = philox.host_rand(ctx.session.rng, nn, "double")
    perm = np.argsort(u, kind="stable")
    if kd == "kfold":
        k = scalar_int(arg, "k") if arg is not None else 10
        fold = np.zeros(nn, dtype=int)
        for i, pi in enumerate(perm):
            fold[pi] = i % k + 1
        return StructArray.scalar({
            "Type": MatArray.char_from_str("kfold"),
            "NumObservations": MatArray.scalar(float(nn)),
            "NumTestSets": MatArray.scalar(float(k)),
            "_fold": MatArray(fold.astype(np.float64).reshape(-1, 1), "double"),
        })
    if kd == "holdout":
        frac = scalar_num(arg, "p") if arg is not None else 0.1
        ntest = max(1, int(round(frac * nn)))
        mask = np.zeros(nn, dtype=bool)
        mask[perm[:ntest]] = True
        return StructArray.scalar({
            "Type": MatArray.char_from_str("holdout"),
            "NumObservations": MatArray.scalar(float(nn)),
            "NumTestSets": MatArray.scalar(1.0),
            "TestSize": MatArray.scalar(float(ntest)),
            "TrainSize": MatArray.scalar(float(nn - ntest)),
            "_test": MatArray(mask.reshape(-1, 1), "logical"),
        })
    raise bad_arg("cvpartition", f"Unknown partition type '{kd}'.")


@builtin("test", category="stats/ml", min_in=1, max_in=2)
def m_test(c, fold=None):
    if not isinstance(c, StructArray) or "Type" not in c.fields:
        raise bad_arg("test", "Expected a cvpartition.")
    if "_test" in c.fields:
        return c.get_scalar_field("_test")
    f = c.get_scalar_field("_fold").host().reshape(-1)
    k = scalar_int(fold, "fold") if fold is not None else 1
    return MatArray((f == k).reshape(-1, 1), "logical")


@builtin("training", category="stats/ml", min_in=1, max_in=2)
def m_training(c, fold=None):
    mask = m_test(c, fold).host()
    return MatArray(~mask, "logical")


@builtin("crossvalind", category="stats/ml", min_in=2, max_in=3, pass_ctx=True,
         pass_nargout=True)
def m_crossvalind(kind, n, arg=None, ctx=None, nargout=1):
    kd = text_of(kind).lower()
    nn = scalar_int(n, "n")
    u = philox.host_rand(ctx.session.rng, nn, "double")
    perm = np.argsort(u, kind="stable")
    if kd == "kfold":
        k = scalar_int(arg, "k") if arg is not None else 5
        fold = np.zeros(nn)
        for i, pi in enumerate(perm):
            fold[pi] = i % k + 1
        return MatArray(fold.reshape(-1, 1), "double")
    if kd == "holdout":
        frac = scalar_num(arg, "p") if arg is not None else 0.5
        ntest = int(round(frac * nn))
        mask = np.zeros(nn, dtype=bool)
        mask[perm[:ntest]] = True
        train = MatArray((~mask).reshape(-1, 1), "logical")
        testm = MatArray(mask.reshape(-1, 1), "logical")
        return [train, testm][:max(1, nargout)]
    if kd == "leaveout":
        idx = np.zeros(nn)
        idx[perm[0]] = 1
        return MatArray(idx.reshape(-1, 1), "logical")
    raise bad_arg("crossvalind", f"Unknown method '{kd}'.")


# ------------------------------------------------------------- regressions --- #

@builtin("regress", category="stats/ml", min_in=2, max_in=2, pass_nargout=True)
def m_regress(y, X, nargout=1):
    hy, hx = _f(y).reshape(-1, 1), _f(X)
    b, _res, _rank, _sv = np.linalg.lstsq(hx, hy, rcond=None)
    out = MatArray(b, "double")
    if nargout <= 1:
        return out
    r = hy - hx @ b
    return [out, MatArray(np.zeros((b.size, 2)), "double"), MatArray(r, "double")][:nargout]


@builtin("ridge", category="stats/ml", min_in=3, max_in=4)
def m_ridge(y, X, k, scaled=None):
    hy = _f(y).reshape(-1)
    hx = _f(X)
    lam = fortran_ravel(_f(k))
    mu, sd = hx.mean(axis=0), hx.std(axis=0, ddof=1)
    sd[sd == 0] = 1.0
    Z = (hx - mu) / sd
    ym = hy.mean()
    out = np.empty((hx.shape[1], lam.size))
    for j, l in enumerate(lam):
        b = np.linalg.solve(Z.T @ Z + l * np.eye(Z.shape[1]), Z.T @ (hy - ym))
        out[:, j] = b
    unscale = scaled is not None and float(_f(scaled).reshape(-1)[0]) == 0.0
    if unscale:
        rows = out / sd[:, None]
        icpt = ym - mu @ rows
        out = np.vstack([icpt, rows])
    return MatArray(out, "double")


@builtin("lasso", category="stats/ml", min_in=2, pass_nargout=True)
def m_lasso(X, y, *rest, nargout=1):
    """Coordinate-descent lasso over a small lambda path."""
    hx, hy = _f(X), _f(y).reshape(-1)
    lam_vals = None
    i = 0
    rest = list(rest)
    while i < len(rest):
        if is_text(rest[i]) and text_of(rest[i]).lower() == "lambda" and i + 1 < len(rest):
            lam_vals = fortran_ravel(_f(rest[i + 1]))
            i += 2
            continue
        i += 1
    n, p = hx.shape
    mu, sd = hx.mean(axis=0), hx.std(axis=0, ddof=1)
    sd[sd == 0] = 1.0
    Z = (hx - mu) / sd
    ym = hy.mean()
    yc = hy - ym
    lam_max = np.abs(Z.T @ yc).max() / n
    if lam_vals is None:
        lam_vals = lam_max * np.logspace(0, -3, 20)
    B = np.zeros((p, lam_vals.size))
    b = np.zeros(p)
    col_sq = (Z ** 2).sum(axis=0)
    for j, lam in enumerate(sorted(lam_vals, reverse=True)):
        for _ in range(200):
            b_old = b.copy()
            for c in range(p):
                r = yc - Z @ b + Z[:, c] * b[c]
                rho = Z[:, c] @ r
                b[c] = np.sign(rho) * max(abs(rho) - n * lam, 0) / max(col_sq[c], 1e-12)
            if np.abs(b - b_old).max() < 1e-9:
                break
        B[:, j] = b / sd
    order = np.argsort(-np.asarray(sorted(lam_vals, reverse=True)))
    fitinfo = StructArray.scalar({
        "Lambda": MatArray(np.asarray(sorted(lam_vals, reverse=True)).reshape(1, -1),
                           "double"),
        "Intercept": MatArray((ym - mu @ (B)).reshape(1, -1), "double"),
    })
    if nargout <= 1:
        return MatArray(B, "double")
    return [MatArray(B, "double"), fitinfo]


@builtin("fitlm", category="stats/ml", min_in=2, max_in=2)
def m_fitlm(X, y):
    hx, hy = _f(X), _f(y).reshape(-1, 1)
    A = np.hstack([np.ones((hx.shape[0], 1)), hx])
    b, _r, _rank, _sv = np.linalg.lstsq(A, hy, rcond=None)
    pred = A @ b
    resid = hy - pred
    sse = float((resid ** 2).sum())
    sst = float(((hy - hy.mean()) ** 2).sum())
    r2 = 1 - sse / max(sst, 1e-300)
    n, p = A.shape
    mse = sse / max(n - p, 1)
    return StructArray.scalar({
        "Coefficients": MatArray(b, "double"),
        "Rsquared": StructArray.scalar({"Ordinary": MatArray.scalar(r2)}),
        "RMSE": MatArray.scalar(float(np.sqrt(mse))),
        "NumObservations": MatArray.scalar(float(n)),
        "Residuals": MatArray(resid, "double"),
        "Fitted": MatArray(pred, "double"),
    })


@builtin("mnrfit", category="stats/ml", min_in=2, max_in=2)
def m_mnrfit(X, y):
    """Binary/multinomial logistic regression via Newton iterations."""
    hx = _f(X)
    hy = fortran_ravel(_f(y)).astype(int)
    classes = np.unique(hy)
    A = np.hstack([np.ones((hx.shape[0], 1)), hx])
    if classes.size == 2:
        t = (hy == classes[0]).astype(np.float64)  # MATLAB models P(category 1)
        w = np.zeros(A.shape[1])
        for _ in range(50):
            z = A @ w
            p = 1 / (1 + np.exp(-z))
            W = p * (1 - p) + 1e-9
            g = A.T @ (t - p)
            H = (A * W[:, None]).T @ A
            step = np.linalg.solve(H, g)
            w += step
            if np.abs(step).max() < 1e-10:
                break
        return MatArray(w.reshape(-1, 1), "double")
    raise bad_arg("mnrfit", "Only binary responses are supported.")


# ---------------------------------------------------------- classification --- #

@builtin("classify", category="stats/ml", min_in=3, max_in=3)
def m_classify(sample, training_x, group):
    """Linear discriminant analysis (MATLAB default 'linear')."""
    hs, hx = _f(sample), _f(training_x)
    g = fortran_ravel(_f(group))
    classes = np.unique(g)
    means = np.array([hx[g == c].mean(axis=0) for c in classes])
    resid = np.vstack([hx[g == c] - means[i] for i, c in enumerate(classes)])
    cov = (resid.T @ resid) / max(hx.shape[0] - classes.size, 1)
    icov = np.linalg.pinv(cov)
    scores = np.empty((hs.shape[0], classes.size))
    for i in range(classes.size):
        d = hs - means[i]
        scores[:, i] = -0.5 * np.einsum("ij,jk,ik->i", d, icov, d)
    return MatArray(classes[scores.argmax(axis=1)].reshape(-1, 1), "double")


class TreeModel:
    __slots__ = ("nodes", "shared")
    mclass = "ClassificationTree"

    def __init__(self, nodes):
        self.nodes = nodes  # list of dicts: leaf{class} | split{var,thr,l,r}
        self.shared = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(X.shape[0])
        for i in range(X.shape[0]):
            n = 0
            while "class" not in self.nodes[n]:
                nd = self.nodes[n]
                n = nd["l"] if X[i, nd["var"]] < nd["thr"] else nd["r"]
            out[i] = self.nodes[n]["class"]
        return out


def _gini(y: np.ndarray) -> float:
    _vals, counts = np.unique(y, return_counts=True)
    p = counts / y.size
    return 1.0 - (p * p).sum()


def _grow_tree(X, y, nodes, depth, max_depth=10, min_leaf=1):
    me = len(nodes)
    nodes.append({})
    classes, counts = np.unique(y, return_counts=True)
    if classes.size == 1 or depth >= max_depth or y.size <= min_leaf:
        nodes[me] = {"class": float(classes[counts.argmax()])}
        return me
    best = None
    base = _gini(y)
    for var in range(X.shape[1]):
        vals = np.unique(X[:, var])
        for thr in (vals[:-1] + vals[1:]) / 2:
            left = X[:, var] < thr
            if not left.any() or left.all():
                continue
            gain = base - (left.mean() * _gini(y[left])
                           + (1 - left.mean()) * _gini(y[~left]))
            if best is None or gain > best[0]:
                best = (gain, var, thr)
    if best is None or best[0] <= 1e-12:
        nodes[me] = {"class": float(classes[counts.argmax()])}
        return me
    _g, var, thr = best
    left = X[:, var] < thr
    l = _grow_tree(X[left], y[left], nodes, depth + 1, max_depth, min_leaf)
    r = _grow_tree(X[~left], y[~left], nodes, depth + 1, max_depth, min_leaf)
    nodes[me] = {"var": var, "thr": thr, "l": l, "r": r}
    return me


@builtin("fitctree", category="stats/ml", min_in=2, max_in=2)
def m_fitctree(X, y):
    nodes: list = []
    _grow_tree(_f(X), fortran_ravel(_f(y)), nodes, 0)
    return TreeModel(nodes)


class LinearModel:
    __slots__ = ("w", "b", "classes", "shared")
    mclass = "ClassificationLinear"

    def __init__(self, w, b, classes):
        self.w, self.b, self.classes = w, b, classes
        self.shared = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        s = X @ self.w + self.b
        return np.where(s > 0, self.classes[1], self.classes[0])


@builtin("fitclinear", category="stats/ml", min_in=2, max_in=2)
def m_fitclinear(X, y):
    """Binary linear classifier (logistic, Newton-iterated)."""
    hx = _f(X)
    hy = fortran_ravel(_f(y))
    classes = np.unique(hy)
    if classes.size != 2:
        raise bad_arg("fitclinear", "Binary classification only.")
    t = (hy == classes[1]).astype(np.float64)
    A = np.hstack([np.ones((hx.shape[0], 1)), hx])
    w = np.zeros(A.shape[1])
    for _ in range(50):
        p = 1 / (1 + np.exp(-(A @ w)))
        W = p * (1 - p) + 1e-9
        g = A.T @ (t - p) - 1e-6 * w
        H = (A * W[:, None]).T @ A + 1e-6 * np.eye(A.shape[1])
        step = np.linalg.solve(H, g)
        w += step
        if np.abs(step).max() < 1e-10:
            break
    return LinearModel(w[1:], w[0], classes)


@builtin("perfcurve", category="stats/ml", min_in=3, max_in=3, pass_nargout=True)
def m_perfcurve(labels, scores, pos, nargout=1):
    y = fortran_ravel(_f(labels))
    s = fortran_ravel(_f(scores))
    p = float(_f(pos).reshape(-1)[0])
    ispos = y == p
    order = np.argsort(-s, kind="stable")
    tp = np.cumsum(ispos[order])
    fp = np.cumsum(~ispos[order])
    P, N = max(ispos.sum(), 1), max((~ispos).sum(), 1)
    tpr = np.concatenate([[0.0], tp / P])
    fpr = np.concatenate([[0.0], fp / N])
    auc = float(np.trapezoid(tpr, fpr))
    outs = [MatArray(fpr.reshape(-1, 1), "double"),
            MatArray(tpr.reshape(-1, 1), "double"),
            MatArray(np.concatenate([[np.inf], s[order]]).reshape(-1, 1), "double"),
            MatArray.scalar(auc)]
    return outs[:max(1, nargout)]


# -------------------------------------------------------------- embeddings --- #

@builtin("tsne", category="stats/ml", min_in=1, pass_ctx=True)
def m_tsne(x, *rest, ctx=None):
    """Exact t-SNE (small-n): perplexity-calibrated P, KL gradient descent."""
    X = _f(x)
    n = X.shape[0]
    perplexity = min(30.0, max((n - 1) / 3.0, 2.0))
    D = ((X[:, None, :] - X[None, :, :]) ** 2).sum(axis=2)
    P = np.zeros((n, n))
    target = np.log(perplexity)
    for i in range(n):
        beta_lo, beta_hi, beta = 1e-20, 1e20, 1.0
        Di = np.delete(D[i], i)
        for _ in range(50):
            w = np.exp(-Di * beta)
            sw = max(w.sum(), 1e-300)
            H = np.log(sw) + beta * (Di * w).sum() / sw
            if abs(H - target) < 1e-5:
                break
            if H > target:
                beta_lo = beta
                beta = beta * 2 if beta_hi > 1e19 else (beta + beta_hi) / 2
            else:
                beta_hi = beta
                beta = beta / 2 if beta_lo < 1e-19 else (beta + beta_lo) / 2
        row = np.exp(-D[i] * beta)
        row[i] = 0.0
        P[i] = row / max(row.sum(), 1e-300)
    P = (P + P.T) / (2 * n)
    P = np.maximum(P, 1e-12)
    u = philox.host_randn(ctx.session.rng, n * 2, "double")
    Y = np.asarray(u).reshape(n, 2) * 1e-4
    lr = max(n / 12.0, 5.0)  # MATLAB-style n/early_exaggeration heuristic
    gains = np.ones_like(Y)
    vel = np.zeros_like(Y)
    for it in range(500):
        num = 1 / (1 + ((Y[:, None, :] - Y[None, :, :]) ** 2).sum(axis=2))
        np.fill_diagonal(num, 0.0)
        Q = np.maximum(num / max(num.sum(), 1e-300), 1e-12)
        PQ = (P * (4.0 if it < 100 else 1.0)) - Q
        grad = 4 * ((PQ * num)[:, :, None] * (Y[:, None, :] - Y[None, :, :])).sum(axis=1)
        gains = np.where(np.sign(grad) != np.sign(vel), gains + 0.2, gains * 0.8)
        gains = np.maximum(gains, 0.01)
        vel = (0.5 if it < 100 else 0.8) * vel - lr * gains * grad
        Y += vel
        Y -= Y.mean(axis=0)
    return MatArray(Y, "double")


# ---------------------------------------------------------------- bayesopt --- #

@builtin("optimizableVariable", category="stats/ml", min_in=2, max_in=2)
def m_optimizable_variable(name, range_):
    r = fortran_ravel(_f(range_))
    return StructArray.scalar({
        "Name": MatArray.char_from_str(text_of(name)),
        "Range": MatArray(r.reshape(1, -1), "double"),
    })


@builtin("bayesopt", category="stats/ml", min_in=2, pass_ctx=True)
def m_bayesopt(f, vars_, *rest, ctx=None):
    """Sequential random-search optimizer over optimizableVariables (the
    surrogate-model refinement of the reference is approximated by dense
    random sampling off the session RNG)."""
    if isinstance(vars_, CellArray):
        var_list = [e for e in vars_.data.reshape(-1, order="F")]
    elif isinstance(vars_, StructArray) and not vars_.is_scalar:
        var_list = []
        for i in range(vars_.size):
            var_list.append(StructArray.scalar(
                {k: vars_.fields[k].reshape(-1)[i] for k in vars_.fields}))
    else:
        var_list = [vars_]
    names = [v.get_scalar_field("Name").to_str() for v in var_list]
    ranges = [fortran_ravel(_f(v.get_scalar_field("Range"))) for v in var_list]
    n_iter = 30
    best_val, best_x = np.inf, None
    for _ in range(n_iter):
        u = philox.host_rand(ctx.session.rng, len(names), "double")
        xs = {nm: r[0] + ui * (r[1] - r[0]) for nm, r, ui in zip(names, ranges, u)}
        arg = StructArray.scalar({nm: MatArray.scalar(v) for nm, v in xs.items()})
        r = _callf(ctx, f, [arg])
        val = float(r.host().reshape(-1)[0])
        if val < best_val:
            best_val, best_x = val, xs
    return StructArray.scalar({
        "XAtMinObjective": StructArray.scalar(
            {nm: MatArray.scalar(v) for nm, v in (best_x or {}).items()}),
        "MinObjective": MatArray.scalar(best_val),
        "NumObjectiveEvaluations": MatArray.scalar(float(n_iter)),
    })


# predict() works on the model objects above

@builtin("predict", category="stats/ml", min_in=2, max_in=2)
def m_predict_model(model, X):
    if isinstance(model, (TreeModel, LinearModel)):
        return MatArray(model.predict(_f(X)).reshape(-1, 1), "double")
    from .dl_layers import DlNetwork
    if isinstance(model, DlNetwork):
        return MatArray(model.predict_np(_f(X)).astype(np.float64), "double")
    # defer to the deep-learning predict for Layers-struct models
    from .dl_builtins import m_predict as dl_predict
    return dl_predict(model, X)
