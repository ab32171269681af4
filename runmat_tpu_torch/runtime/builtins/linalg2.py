"""Copy of runmat_tpu/runtime/builtins/linalg2.py in the PyTorch port.

Linear-algebra batch 2: vecnorm, mpower function form, paged ops, rref,
eigs, lscov, symrcm, and the `decomposition` object.

Reference parity: runmat-runtime/src/builtins/math/linalg/{vecnorm,mpower,
pagemtimes,pagetranspose,rref,eigs,lscov,symrcm,decomposition}.rs. The
decomposition object reuses the generic operator protocol in
runtime/dispatch.py (`_mat_binop_`), standing in for the reference's dotted
method builtins (decomposition.mldivide etc.).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import MatArray, fortran_ravel, is_text, text_of
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


@builtin("vecnorm", category="math/linalg", min_in=1, max_in=3)
def m_vecnorm(x, p=None, dim=None):
    h = x.host()
    h = h.astype(np.complex128) if h.dtype.kind == "c" else h.astype(np.float64)
    pp = scalar_num(p, "p") if p is not None and not is_text(p) else \
        (np.inf if p is not None and text_of(p).lower() == "inf" else 2.0)
    ax = (scalar_int(dim, "dim") - 1) if dim is not None else (0 if h.shape[0] != 1 else 1)
    a = np.abs(h)
    if np.isinf(pp):
        r = a.max(axis=ax, keepdims=True)
    elif pp == 1:
        r = a.sum(axis=ax, keepdims=True)
    elif pp == 2:
        r = np.sqrt((a * a).sum(axis=ax, keepdims=True))
    else:
        r = (a ** pp).sum(axis=ax, keepdims=True) ** (1.0 / pp)
    return MatArray(np.real(r), "single" if x.mclass == "single" else "double")


@builtin("mpower", category="math/linalg", min_in=2, max_in=2)
def m_mpower(a, b):
    from ..dispatch import mpower
    return mpower(a, b)


def _page_view(h: np.ndarray) -> np.ndarray:
    """(m, n, ...pages) -> (pages, m, n) stacked view."""
    if h.ndim == 2:
        return h[None, :, :]
    m, n = h.shape[0], h.shape[1]
    return np.moveaxis(h.reshape(m, n, -1, order="F"), -1, 0)


@builtin("pagemtimes", category="math/linalg", min_in=2, max_in=4)
def m_pagemtimes(a, *rest):
    """pagemtimes(A, B) or pagemtimes(A, transpA, B, transpB): batched matmul
    per trailing page. On TPU this is one einsum over the page dimension."""
    if len(rest) == 1:
        b = rest[0]
        ta = tb = "none"
    elif len(rest) == 3:
        ta = text_of(rest[0]).lower()
        b = rest[1]
        tb = text_of(rest[2]).lower()
    else:
        raise bad_arg("pagemtimes", "Expected pagemtimes(A,B) or pagemtimes(A,transpA,B,transpB).")
    if ta not in ("none", "transpose", "ctranspose") or \
            tb not in ("none", "transpose", "ctranspose"):
        raise bad_arg("pagemtimes", "transp must be 'none', 'transpose' or 'ctranspose'.")
    from .linalg import _dev_eng
    eng = _dev_eng(a, b)
    if eng is not None and a.size and b.size:
        out = eng.linalg("pagemtimes", [a, b], (ta, tb))
        if out is not None:
            return out[0]
    ha, hb = a.host(), b.host()
    is_c = ha.dtype.kind == "c" or hb.dtype.kind == "c"
    ha = ha.astype(np.complex128 if is_c else np.float64)
    hb = hb.astype(np.complex128 if is_c else np.float64)
    pa, pb = _page_view(ha), _page_view(hb)

    def tr(p, mode):
        if mode in ("transpose",):
            return np.swapaxes(p, 1, 2)
        if mode in ("ctranspose",):
            return np.conj(np.swapaxes(p, 1, 2))
        return p

    pa, pb = tr(pa, ta), tr(pb, tb)
    if pa.shape[0] == 1 and pb.shape[0] > 1:
        pa = np.broadcast_to(pa, (pb.shape[0],) + pa.shape[1:])
    if pb.shape[0] == 1 and pa.shape[0] > 1:
        pb = np.broadcast_to(pb, (pa.shape[0],) + pb.shape[1:])
    r = pa @ pb
    npages = r.shape[0]
    out_shape = (r.shape[1], r.shape[2]) if npages == 1 else \
        (r.shape[1], r.shape[2]) + (ha.shape[2:] if ha.ndim > 2 else hb.shape[2:])
    out = np.moveaxis(r, 0, -1).reshape(out_shape, order="F") if npages > 1 else r[0]
    out_class = "single" if "single" in (a.mclass, b.mclass) else "double"
    if out_class == "single":
        out = out.astype(np.complex64 if is_c else np.float32)
    return MatArray(out, out_class)


@builtin("pagetranspose", category="math/linalg", min_in=1, max_in=1)
def m_pagetranspose(a):
    h = a.host()
    if h.ndim == 2:
        return MatArray(h.T.copy(), a.mclass)
    p = _page_view(h)
    r = np.swapaxes(p, 1, 2)
    out = np.moveaxis(r, 0, -1).reshape((r.shape[1], r.shape[2]) + h.shape[2:], order="F")
    return MatArray(out, a.mclass)


def _page_out(r: np.ndarray, pshape: tuple, mclass: str) -> MatArray:
    """(pages, m, n) -> MatArray (m, n, *pshape) in F order."""
    if not pshape:
        return MatArray(r[0], mclass)
    out = np.moveaxis(r, 0, -1).reshape((r.shape[1], r.shape[2]) + tuple(pshape),
                                        order="F")
    return MatArray(out, mclass)


def _pages_np(x) -> tuple:
    h = x.host()
    h = h.astype(np.complex128 if h.dtype.kind == "c" else np.float64)
    return _page_view(h), (h.shape[2:] if h.ndim > 2 else ())


def _out_class(*xs) -> str:
    return "single" if any(x.mclass == "single" for x in xs) else "double"


@builtin("pagectranspose", category="math/linalg", min_in=1, max_in=1)
def m_pagectranspose(a):
    """Per-page complex-conjugate transpose (batched on device)."""
    from .linalg import _dev_eng
    eng = _dev_eng(a)
    if eng is not None and a.size:
        out = eng.linalg("pagectranspose", [a], (True,))
        if out is not None:
            return out[0]
    p, ps = _pages_np(a)
    return _page_out(np.conj(np.swapaxes(p, 1, 2)), ps, a.mclass)


@builtin("pageinv", category="math/linalg", min_in=1, max_in=1)
def m_pageinv(a):
    """Per-page matrix inverse; one batched device LU instead of a host
    loop (≙ provider pagefun hooks, backend/wgpu/provider/ops/linalg/
    pagefun.rs)."""
    if len(a.shape) < 2 or a.shape[0] != a.shape[1]:
        raise MatError("MATLAB:pageinv:inputMustBeSquare",
                       "Each page must be square.")
    from .linalg import _dev_eng
    eng = _dev_eng(a)
    if eng is not None and a.size:
        out = eng.linalg("pageinv", [a], ())
        if out is not None:
            return out[0]
    p, ps = _pages_np(a)
    return _page_out(np.linalg.inv(p), ps, _out_class(a))


@builtin("pagemldivide", category="math/linalg", min_in=2, max_in=2)
def m_pagemldivide(a, b):
    """Per-page A\\B. Square pages ride the batched device solve; general
    shapes fall back to per-page host lstsq."""
    from .linalg import _dev_eng
    sq = len(a.shape) >= 2 and a.shape[0] == a.shape[1]
    eng = _dev_eng(a, b)
    if eng is not None and sq and a.size and b.size:
        out = eng.linalg("pagesolve", [a, b], ())
        if out is not None:
            return out[0]
    pa, psa = _pages_np(a)
    pb, psb = _pages_np(b)
    if pa.shape[0] == 1 and pb.shape[0] > 1:
        pa = np.broadcast_to(pa, (pb.shape[0],) + pa.shape[1:])
    if pb.shape[0] == 1 and pa.shape[0] > 1:
        pb = np.broadcast_to(pb, (pa.shape[0],) + pb.shape[1:])
    if sq:
        r = np.linalg.solve(pa, pb)
    else:
        r = np.stack([np.linalg.lstsq(pa[i], pb[i], rcond=None)[0]
                      for i in range(pa.shape[0])])
    return _page_out(r, psa or psb, _out_class(a, b))


@builtin("pagenorm", category="math/linalg", min_in=1, max_in=2)
def m_pagenorm(a, p=None):
    """Per-page matrix norm: 2 (default), 1, Inf, or 'fro'."""
    if p is None:
        ordv = 2
    elif is_text(p):
        w = text_of(p).lower()
        if w != "fro":
            raise bad_arg("pagenorm", "Expected a norm order of 1, 2, Inf or 'fro'.")
        ordv = "fro"
    else:
        v = float(p.host().reshape(-1)[0].real)
        # only +Inf maps to the inf-norm; -Inf must reject (ADVICE r4 #3)
        ordv = np.inf if np.isinf(v) and v > 0 else \
            (int(v) if np.isfinite(v) else v)
        if ordv not in (1, 2, np.inf):
            raise bad_arg("pagenorm", "Expected a norm order of 1, 2, Inf or 'fro'.")
    from .linalg import _dev_eng
    eng = _dev_eng(a)
    if eng is not None and a.size:
        out = eng.linalg("pagenorm", [a], (ordv,), out_class=_out_class(a))
        if out is not None:
            return out[0]
    pv, ps = _pages_np(a)
    r = np.linalg.norm(pv, ord=ordv, axis=(1, 2))
    out = r.reshape((1, 1) + tuple(ps), order="F") if ps else r.reshape(1, 1)
    return MatArray(out, _out_class(a))


@builtin("pagesvd", category="math/linalg", min_in=1, max_in=2,
         pass_nargout=True)
def m_pagesvd(a, econ=None, nargout=1):
    """Per-page SVD: S = pagesvd(X) or [U,S,V] = pagesvd(X[, 'econ'])."""
    economy = econ is not None and is_text(econ) and \
        text_of(econ).lower() in ("econ", "vector")
    pv, ps = _pages_np(a)
    oc = _out_class(a)
    if nargout <= 1:
        s = np.linalg.svd(pv, compute_uv=False)
        out = s[:, :, None]  # (pages, k, 1)
        r = np.moveaxis(out, 0, -1).reshape((out.shape[1], 1) + tuple(ps),
                                            order="F") if ps else out[0]
        return MatArray(r, oc)
    u, s, vh = np.linalg.svd(pv, full_matrices=not economy)
    k = s.shape[1]
    m, n = pv.shape[1], pv.shape[2]
    smat = np.zeros((pv.shape[0], u.shape[2], vh.shape[1]), dtype=pv.dtype)
    for i in range(k):
        smat[:, i, i] = s[:, i]
    v = np.conj(np.swapaxes(vh, 1, 2))
    return [_page_out(u, ps, oc), _page_out(smat.real, ps, oc),
            _page_out(v, ps, oc)][:max(1, nargout)]


@builtin("pagelu", category="math/linalg", min_in=1, max_in=2,
         pass_nargout=True)
def m_pagelu(a, outform=None, nargout=1):
    """Per-page LU: [L,U] (psychologically lower), [L,U,P] permutation
    matrices, or [L,U,p] pivot vectors with pagelu(X,'vector')."""
    import scipy.linalg as sla
    vector = outform is not None and is_text(outform) and \
        text_of(outform).lower() == "vector"
    pv, ps = _pages_np(a)
    oc = _out_class(a)
    Ls, Us, Ps = [], [], []
    for i in range(pv.shape[0]):
        pm, l, u = sla.lu(pv[i])
        Ls.append(l)
        Us.append(u)
        Ps.append(pm.T)  # P with P*A = L*U
    L, U, P = np.stack(Ls), np.stack(Us), np.stack(Ps)
    if nargout <= 2:
        # psychologically-lower: fold the permutation into L
        PL = np.swapaxes(P, 1, 2) @ L
        return [_page_out(PL, ps, oc), _page_out(U, ps, oc)][:max(1, nargout)]
    if vector:
        piv = np.argmax(P, axis=2).astype(np.float64) + 1.0
        pvec = piv[:, :, None]
        pr = np.moveaxis(pvec, 0, -1).reshape((pvec.shape[1], 1) + tuple(ps),
                                              order="F") if ps else pvec[0]
        return [_page_out(L, ps, oc), _page_out(U, ps, oc), MatArray(pr, "double")]
    return [_page_out(L, ps, oc), _page_out(U, ps, oc), _page_out(P, ps, oc)]


@builtin("rref", category="math/linalg", min_in=1, max_in=2, pass_nargout=True)
def m_rref(a, tol=None, nargout=1):
    h = _f(a).copy()
    m, n = h.shape
    t = scalar_num(tol, "tol") if tol is not None else \
        max(m, n) * np.finfo(float).eps * (np.max(np.abs(h)) if h.size else 0.0)
    pivots = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        piv = r + int(np.argmax(np.abs(h[r:, c])))
        if np.abs(h[piv, c]) <= t:
            h[r:, c] = 0.0
            continue
        h[[r, piv], :] = h[[piv, r], :]
        h[r, :] = h[r, :] / h[r, c]
        mask = np.ones(m, dtype=bool)
        mask[r] = False
        h[mask, :] -= np.outer(h[mask, c], h[r, :])
        pivots.append(c + 1)
        r += 1
    out = MatArray(h, "double")
    if nargout <= 1:
        return out
    return [out, MatArray(np.array(pivots, dtype=np.float64).reshape(1, -1), "double")]


@builtin("eigs", category="math/linalg", min_in=1, max_in=3, pass_nargout=True)
def m_eigs(a, k=None, sigma=None, nargout=1):
    """k extremal eigenvalues. Dense path: full eig then select; sparse path:
    scipy ARPACK (host helper, like the reference's system LAPACK)."""
    from ...sparse import SparseMatrix
    kk = scalar_int(k, "k") if k is not None else 6
    which = "lm"
    if sigma is not None and is_text(sigma):
        which = text_of(sigma).lower()
    if isinstance(a, SparseMatrix):
        import scipy.sparse as sps
        import scipy.sparse.linalg as spl
        S = a.to_scipy()
        kk = min(kk, a.m - 2) if a.m > 2 else 1
        w_map = {"lm": "LM", "sm": "SM", "la": "LA", "sa": "SA",
                 "largestabs": "LM", "smallestabs": "SM",
                 "largestreal": "LR", "smallestreal": "SR"}
        vals, vecs = spl.eigs(S, k=kk, which=w_map.get(which, "LM"))
        small = which in ("sm", "smallestabs", "sa", "smallestreal")
        key = np.abs(vals) if small else -np.abs(vals)
        order = np.argsort(key, kind="stable")
        vals, vecs = vals[order], vecs[:, order]
    else:
        h = _f(a)
        sym = np.allclose(h, h.T, atol=1e-12)
        if sym:
            w, v = np.linalg.eigh(h)
        else:
            w, v = np.linalg.eig(h)
        if which in ("lm", "largestabs"):
            order = np.argsort(-np.abs(w), kind="stable")
        elif which in ("sm", "smallestabs"):
            order = np.argsort(np.abs(w), kind="stable")
        elif which in ("la", "largestreal"):
            order = np.argsort(-np.real(w), kind="stable")
        elif which in ("sa", "smallestreal"):
            order = np.argsort(np.real(w), kind="stable")
        else:
            order = np.argsort(-np.abs(w), kind="stable")
        kk = min(kk, w.size)
        vals, vecs = w[order[:kk]], v[:, order[:kk]]
    if np.max(np.abs(np.imag(vals)), initial=0.0) < 1e-300:
        vals, vecs = np.real(vals), np.real(vecs)
    if nargout <= 1:
        return MatArray(vals.reshape(-1, 1), "double")
    return [MatArray(vecs, "double"), MatArray(np.diag(vals), "double")]


@builtin("lscov", category="math/linalg", min_in=2, max_in=3, pass_nargout=True)
def m_lscov(a, b, w=None, nargout=1):
    ha, hb = _f(a), _f(b)
    if hb.ndim == 2 and hb.shape[1] != 1 and hb.shape[0] == 1:
        hb = hb.T
    if w is not None:
        hw = fortran_ravel(_f(w))
        sw = np.sqrt(hw).reshape(-1, 1)
        ha2, hb2 = ha * sw, hb * sw
    else:
        ha2, hb2 = ha, hb
    x, res, rank, sv = np.linalg.lstsq(ha2, hb2, rcond=None)
    out = MatArray(x, "double")
    if nargout <= 1:
        return out
    # stdx: sqrt of diag of inv(A'A) * mse
    dof = max(ha.shape[0] - rank, 1)
    r = hb2 - ha2 @ x
    mse = float((r * r).sum() / dof)
    cov = np.linalg.pinv(ha2.T @ ha2) * mse
    stdx = np.sqrt(np.maximum(np.diag(cov), 0)).reshape(-1, 1)
    return [out, MatArray(stdx, "double"), MatArray.scalar(mse)][:nargout]


@builtin("symrcm", category="math/linalg", min_in=1, max_in=1)
def m_symrcm(a):
    """Reverse Cuthill-McKee ordering (bandwidth-reducing permutation)."""
    from ...sparse import SparseMatrix
    if isinstance(a, SparseMatrix):
        import scipy.sparse as sps
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        S = sps.csr_matrix(a.to_scipy())
    else:
        import scipy.sparse as sps
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        S = sps.csr_matrix(_f(a) != 0)
    perm = reverse_cuthill_mckee(S, symmetric_mode=True)
    return MatArray(perm.astype(np.float64).reshape(1, -1) + 1, "double")


# ----------------------------------------------------------- decomposition --- #

class DecompValue:
    """Matrix decomposition object: factor once, solve many (dA\\b).

    ≙ reference decomposition builtins (math/linalg/decomposition*.rs). The
    factorization is host LAPACK; repeated solves reuse the factors.
    """

    __slots__ = ("kind", "factors", "a_shape", "shared")
    mclass = "decomposition"

    def __init__(self, kind, factors, a_shape):
        self.kind = kind
        self.factors = factors
        self.a_shape = a_shape
        self.shared = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def solve(self, b: np.ndarray, transposed: bool = False) -> np.ndarray:
        import scipy.linalg as sla
        if self.kind == "lu":
            lu, piv = self.factors
            return sla.lu_solve((lu, piv), b, trans=1 if transposed else 0)
        if self.kind == "chol":
            c, lower = self.factors
            return sla.cho_solve((c, lower), b)
        if self.kind == "qr":
            q, r = self.factors
            if transposed:
                # A' x = b  =>  x = Q (R')^{-1} b
                y = sla.solve_triangular(r, b, trans=1)
                return q @ y
            return sla.solve_triangular(r, q.T @ b)
        raise MatError("MATLAB:decomposition:unknown", f"Unknown kind {self.kind}")

    def _mat_binop_(self, op, other, swapped):
        hb = other.host().astype(np.float64) if isinstance(other, MatArray) else None
        if hb is None:
            return NotImplemented
        if op == "mldivide" and not swapped:
            return MatArray(self.solve(hb), "double")
        if op == "mrdivide" and swapped:
            # b / dA  =  (dA' \ b')'
            return MatArray(self.solve(hb.T, transposed=True).T.copy(), "double")
        if op == "mtimes":
            raise MatError("MATLAB:decomposition:NoMtimes",
                           "Multiplication is not defined for decomposition objects; "
                           "use the original matrix.")
        return NotImplemented


@builtin("decomposition", category="math/linalg", min_in=1, max_in=2)
def m_decomposition(a, kind=None):
    import scipy.linalg as sla
    h = _f(a)
    if h.ndim != 2 or h.shape[0] != h.shape[1]:
        k = "qr"
    else:
        k = text_of(kind).lower() if kind is not None else "auto"
    if k == "auto":
        sym = np.allclose(h, h.T, atol=1e-12)
        if sym:
            try:
                c = sla.cho_factor(h)
                return DecompValue("chol", c, h.shape)
            except Exception:
                pass
        k = "lu"
    if k in ("lu", "ldl"):
        return DecompValue("lu", sla.lu_factor(h), h.shape)
    if k in ("chol", "cholesky"):
        return DecompValue("chol", sla.cho_factor(h), h.shape)
    if k == "qr":
        q, r = np.linalg.qr(h)
        return DecompValue("qr", (q, r), h.shape)
    raise bad_arg("decomposition", f"Unknown decomposition type '{k}'.")


@builtin("isIllConditioned", category="math/linalg", min_in=1, max_in=1)
def m_is_ill_conditioned(d):
    if isinstance(d, DecompValue) and d.kind == "lu":
        lu, _ = d.factors
        diag = np.abs(np.diag(lu))
        if diag.size and diag.min() > 0:
            return MatArray.logical_scalar(bool(diag.max() / diag.min() > 1e12))
        return MatArray.logical_scalar(True)
    return MatArray.logical_scalar(False)


# ------------------------------------- sparse spectral/norm estimators --- #

@builtin("svds", category="math/linalg", min_in=1, max_in=3,
         pass_nargout=True)
def m_svds(a, k=None, sigma=None, nargout=1):
    """k largest (or 'smallest') singular values / factors. Sparse path:
    ARPACK via the scipy host helper; dense: full SVD then select."""
    from ...sparse import SparseMatrix
    kk = scalar_int(k, "k") if k is not None else 6
    smallest = sigma is not None and is_text(sigma) and \
        text_of(sigma).lower() in ("smallest", "smallestabs", "sm")
    if isinstance(a, SparseMatrix) and min(a.m, a.n) > 2:
        import scipy.sparse.linalg as spl
        kk = min(kk, min(a.m, a.n) - 1)
        u, s, vt = spl.svds(a.to_scipy(), k=kk,
                            which="SM" if smallest else "LM")
        order = np.argsort(s if smallest else -s, kind="stable")
        u, s, vt = u[:, order], s[order], vt[order]
    else:
        h = a.to_matarray().host().astype(np.float64) \
            if isinstance(a, SparseMatrix) else _f(a)
        u, s, vt = np.linalg.svd(h, full_matrices=False)
        if smallest:
            u, s, vt = u[:, ::-1], s[::-1], vt[::-1]
        kk = min(kk, s.size)
        u, s, vt = u[:, :kk], s[:kk], vt[:kk]
    if nargout <= 1:
        return MatArray(s.reshape(-1, 1), "double")
    return [MatArray(u, "double"), MatArray(np.diag(s), "double"),
            MatArray(vt.T, "double")]


@builtin("condest", category="math/linalg", min_in=1, max_in=2)
def m_condest(a, t=None):
    """1-norm condition estimate: norm1(A) * est(norm1(inv(A))) via the
    Hager/Higham one-norm estimator (scipy host helper on sparse LU)."""
    from ...sparse import SparseMatrix
    if isinstance(a, SparseMatrix):
        import scipy.sparse.linalg as spl
        S = a.to_scipy().tocsc()
        if S.shape[0] != S.shape[1]:
            raise bad_arg("condest", "Matrix must be square.")
        n1 = abs(S).sum(axis=0).max() if S.nnz else 0.0
        try:
            lu = spl.splu(S)
            import scipy.sparse.linalg as _spl
            op = _spl.LinearOperator(S.shape, matvec=lu.solve,
                                     rmatvec=lambda v: lu.solve(v, trans="T"))
            inv1 = _spl.onenormest(op)
        except RuntimeError:
            return MatArray.scalar(np.inf)
        return MatArray.scalar(float(n1 * inv1))
    h = _f(a)
    if h.shape[0] != h.shape[1]:
        raise bad_arg("condest", "Matrix must be square.")
    try:
        inv = np.linalg.inv(h)
    except np.linalg.LinAlgError:
        return MatArray.scalar(np.inf)
    return MatArray.scalar(
        float(np.abs(h).sum(axis=0).max() * np.abs(inv).sum(axis=0).max()))


@builtin("sprandsym", category="math/sparse", min_in=1, max_in=2,
         pass_ctx=True)
def m_sprandsym(n_or_s, density=None, ctx=None):
    """sprandsym(n, density): random symmetric sparse; sprandsym(S):
    symmetric with the sparsity structure of S."""
    from ...sparse import SparseMatrix
    from ...ops import ctrng
    if isinstance(n_or_s, SparseMatrix):
        S = n_or_s
        vals = ctrng.host_rand(ctx.session.rng, S.data.size, "double") * 2 - 1
        A = SparseMatrix(S.m, S.n, S.indptr, S.rowind, vals).to_matarray()
        h = A.host()
        out = np.tril(h) + np.tril(h, -1).T
        return SparseMatrix.from_dense(out)
    n = scalar_int(n_or_s, "n")
    d = float(density.host().reshape(-1)[0]) if density is not None else 0.1
    nnz_target = max(1, int(round(d * n * n)))
    m = (nnz_target + 1) // 2
    draws = ctrng.host_rand(ctx.session.rng, 3 * m, "double")
    ii = np.minimum((draws[:m] * n).astype(np.int64), n - 1)
    jj = np.minimum((draws[m:2 * m] * n).astype(np.int64), n - 1)
    vv = draws[2 * m:] * 2 - 1
    lower = np.where(ii >= jj, True, False)
    r = np.where(lower, ii, jj)
    c = np.where(lower, jj, ii)
    dense = np.zeros((n, n))
    dense[r, c] = vv
    out = np.tril(dense) + np.tril(dense, -1).T
    return SparseMatrix.from_dense(out)


@builtin("tensorprod", category="math/linalg", min_in=2, max_in=6)
def m_tensorprod(a, b, *rest):
    """tensorprod(A, B, dimA, dimB) contracted product; tensorprod(A, B)
    outer product; 'all' contracts every dimension (inner product)."""
    ha = a.host().astype(np.float64)
    hb = b.host().astype(np.float64)
    if rest and is_text(rest[0]) and text_of(rest[0]).lower() == "all":
        if ha.shape != hb.shape:
            raise bad_arg("tensorprod", "Inputs must match for 'all'.")
        return MatArray.scalar(float((ha * hb).sum()))
    if not rest:
        out = np.tensordot(ha, hb, axes=0)
        return MatArray(out if out.ndim >= 2 else out.reshape(1, -1),
                        "double")
    dim_a = fortran_ravel(rest[0].host()).astype(np.int64) - 1
    dim_b = fortran_ravel(rest[1].host()).astype(np.int64) - 1 \
        if len(rest) > 1 else dim_a
    out = np.tensordot(ha, hb, axes=(list(dim_a), list(dim_b)))
    if out.ndim < 2:
        out = out.reshape((1, -1) if out.ndim else (1, 1))
    return MatArray(out, "double")
