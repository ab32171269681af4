"""Copy of runmat_tpu/runtime/builtins/itersolve.py in the PyTorch port.

Iterative sparse solvers: pcg / bicgstab / gmres / ichol.

Reference parity: the reference routes FEA solves through a preconditioned
solver stack (runmat-analysis/fea/src/solve/{linear,preconditioner.rs},
runtime_tensor_solver) and MATLAB exposes the classic iterative family.
MATLAB semantics: [x, flag, relres, iter, resvec] outputs, default
tol=1e-6, maxit=min(n,20); flag 0 = converged, 1 = maxit reached,
4 = breakdown. Preconditioners accept a matrix (applied as M\\r) or a
function handle returning M\\r.

Matvecs ride the device for device-resident/sparse operands via the accel
engine's dense path; the Krylov recurrences are host-side (tiny vectors of
coefficients dominate nothing — the matvec is the FLOPs)."""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...sparse import SparseMatrix
from ...values import (FunctionHandle, MatArray, fortran_ravel, is_text,
                       text_of)
from ..registry import builtin


def _scipy_csr(A: SparseMatrix):
    import scipy.sparse as sp
    ii, jj, vv = A.triplets()
    return sp.csr_matrix((vv.astype(np.float64), (ii, jj)),
                         shape=(A.m, A.n))


def _matvec_of(A):
    if isinstance(A, SparseMatrix):
        if A.m != A.n:
            raise bad_arg("pcg", "Matrix must be square.")
        S = _scipy_csr(A)
        return (lambda x: S @ x), A.n
    if isinstance(A, MatArray):
        h = A.host().astype(np.float64)
        if h.ndim != 2 or h.shape[0] != h.shape[1]:
            raise bad_arg("pcg", "Matrix must be square.")
        return (lambda x: h @ x), h.shape[0]
    if isinstance(A, FunctionHandle):
        raise bad_arg("pcg", "Function-handle operators need an explicit "
                             "size; pass the matrix instead.")
    raise bad_arg("pcg", "Expected a matrix.")


def _precond_of(M, ctx, n):
    """Preconditioner application r -> M \\ r (matrix or function handle).
    A triangular sparse M (e.g. the ichol factor) uses a sparse triangular
    sweep; general matrices factor once."""
    if M is None:
        return lambda r: r
    if isinstance(M, FunctionHandle):
        def apply_fh(r):
            out = ctx.interp.call_value(
                M, [MatArray(r.reshape(-1, 1), "double")], 1, ctx.frame)
            v = out[0] if isinstance(out, list) else out
            return fortran_ravel(v.host().astype(np.float64))
        return apply_fh
    if isinstance(M, SparseMatrix):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        S = _scipy_csr(M).tocsc()
        lower = (sp.triu(S, k=1).nnz == 0)
        upper = (sp.tril(S, k=-1).nnz == 0)
        if lower or upper:
            Scsr = S.tocsr()
            return lambda r: spla.spsolve_triangular(Scsr, r, lower=lower)
        lu = spla.splu(S)
        return lambda r: lu.solve(r)
    if isinstance(M, MatArray):
        h = M.host().astype(np.float64)
        if h.size == 0:
            return lambda r: r
        return lambda r: np.linalg.solve(h, r)
    return lambda r: r


def _args_common(b, tol, maxit, n):
    bv = fortran_ravel(b.host().astype(np.float64))
    if bv.size != n:
        raise bad_arg("pcg", "Right-hand side size mismatch.")
    t = float(tol.host().reshape(-1)[0]) if tol is not None else 1e-6
    mi = int(maxit.host().reshape(-1)[0]) if maxit is not None \
        else min(n, 20)
    return bv, t, mi


def _outs(x, flag, relres, it, resvec, nargout):
    outs = [MatArray(x.reshape(-1, 1), "double"),
            MatArray.scalar(float(flag)),
            MatArray.scalar(float(relres)),
            MatArray.scalar(float(it)),
            MatArray(np.asarray(resvec, np.float64).reshape(-1, 1),
                     "double")]
    return outs[:max(1, nargout)]


@builtin("pcg", category="math/sparse", min_in=2, max_in=7,
         pass_nargout=True, pass_ctx=True)
def m_pcg(A, b, tol=None, maxit=None, M1=None, M2=None, x0=None,
          ctx=None, nargout=1):
    """Preconditioned conjugate gradient (≙ MATLAB pcg; FEA solve stack
    preconditioner.rs). M1/M2 compose as M = M1*M2."""
    mv, n = _matvec_of(A)
    bv, t, mi = _args_common(b, tol, maxit, n)
    p1 = _precond_of(M1, ctx, n)
    p2 = _precond_of(M2, ctx, n)
    prec = lambda r: p2(p1(r))
    x = fortran_ravel(x0.host().astype(np.float64)) if x0 is not None \
        else np.zeros(n)
    nb = np.linalg.norm(bv)
    if nb == 0:
        return _outs(np.zeros(n), 0, 0.0, 0, [0.0], nargout)
    r = bv - mv(x)
    z = prec(r)
    p = z.copy()
    rz = float(r @ z)
    resvec = [np.linalg.norm(r)]
    flag, it = 1, mi
    for k in range(1, mi + 1):
        Ap = mv(p)
        pAp = float(p @ Ap)
        if pAp <= 0 or not np.isfinite(pAp):
            flag, it = 4, k - 1
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        resvec.append(np.linalg.norm(r))
        if resvec[-1] <= t * nb:
            flag, it = 0, k
            break
        z = prec(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return _outs(x, flag, resvec[-1] / nb, it, resvec, nargout)


@builtin("bicgstab", category="math/sparse", min_in=2, max_in=7,
         pass_nargout=True, pass_ctx=True)
def m_bicgstab(A, b, tol=None, maxit=None, M1=None, M2=None, x0=None,
               ctx=None, nargout=1):
    """BiCGSTAB for unsymmetric systems (≙ MATLAB bicgstab)."""
    mv, n = _matvec_of(A)
    bv, t, mi = _args_common(b, tol, maxit, n)
    p1 = _precond_of(M1, ctx, n)
    p2 = _precond_of(M2, ctx, n)
    prec = lambda r: p2(p1(r))
    x = fortran_ravel(x0.host().astype(np.float64)) if x0 is not None \
        else np.zeros(n)
    nb = np.linalg.norm(bv)
    if nb == 0:
        return _outs(np.zeros(n), 0, 0.0, 0, [0.0], nargout)
    r = bv - mv(x)
    r0 = r.copy()
    rho = alpha = omega = 1.0
    v = p = np.zeros(n)
    resvec = [np.linalg.norm(r)]
    flag, it = 1, mi
    for k in range(1, mi + 1):
        rho_new = float(r0 @ r)
        if abs(rho_new) < 1e-300:
            flag, it = 4, k - 1
            break
        beta = (rho_new / rho) * (alpha / omega) if k > 1 else 0.0
        p = r + beta * (p - omega * v) if k > 1 else r.copy()
        ph = prec(p)
        v = mv(ph)
        denom = float(r0 @ v)
        if abs(denom) < 1e-300:
            flag, it = 4, k - 1
            break
        alpha = rho_new / denom
        s = r - alpha * v
        if np.linalg.norm(s) <= t * nb:
            x = x + alpha * ph
            resvec.append(np.linalg.norm(s))
            flag, it = 0, k
            break
        sh = prec(s)
        tv = mv(sh)
        tt = float(tv @ tv)
        omega = float(tv @ s) / tt if tt > 0 else 0.0
        x = x + alpha * ph + omega * sh
        r = s - omega * tv
        resvec.append(np.linalg.norm(r))
        rho = rho_new
        if resvec[-1] <= t * nb:
            flag, it = 0, k
            break
        if omega == 0.0:
            flag, it = 4, k
            break
    return _outs(x, flag, resvec[-1] / nb, it, resvec, nargout)


@builtin("gmres", category="math/sparse", min_in=2, max_in=8,
         pass_nargout=True, pass_ctx=True)
def m_gmres(A, b, restart=None, tol=None, maxit=None, M1=None, M2=None,
            x0=None, ctx=None, nargout=1):
    """Restarted GMRES (≙ MATLAB gmres): Arnoldi + Givens least squares;
    gmres(A,b,[],tol,maxit) runs unrestarted."""
    mv, n = _matvec_of(A)
    rst = None
    if restart is not None and restart.size:
        rst = int(restart.host().reshape(-1)[0])
    bv, t, mi_outer = _args_common(b, tol, maxit, n)
    if tol is None:
        t = 1e-6
    if maxit is None:
        mi_outer = min(n, 10)
    m = rst if rst else min(n, mi_outer if rst is None else 10)
    if rst is None:
        m, mi_outer = min(n, mi_outer * 1), 1   # unrestarted: m = maxit
    p1 = _precond_of(M1, ctx, n)
    p2 = _precond_of(M2, ctx, n)
    prec = lambda r: p2(p1(r))
    x = fortran_ravel(x0.host().astype(np.float64)) if x0 is not None \
        else np.zeros(n)
    nb = np.linalg.norm(bv)
    if nb == 0:
        return _outs(np.zeros(n), 0, 0.0, 0, [0.0], nargout)
    resvec = []
    flag = 1
    inner_done = 0
    outer_done = 0
    for outer in range(mi_outer):
        r = prec(bv - mv(x))
        beta = np.linalg.norm(r)
        if outer == 0:
            resvec.append(beta)
        if beta <= t * nb:
            flag = 0
            break
        Q = np.zeros((n, m + 1))
        H = np.zeros((m + 1, m))
        Q[:, 0] = r / beta
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        k_used = 0
        for k in range(m):
            w = prec(mv(Q[:, k]))
            for i in range(k + 1):
                H[i, k] = Q[:, i] @ w
                w = w - H[i, k] * Q[:, i]
            H[k + 1, k] = np.linalg.norm(w)
            if H[k + 1, k] > 1e-300:
                Q[:, k + 1] = w / H[k + 1, k]
            # apply previous Givens rotations
            for i in range(k):
                tmp = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = tmp
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k] = H[k, k] / d if d else 1.0
            sn[k] = H[k + 1, k] / d if d else 0.0
            H[k, k] = d
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            resvec.append(abs(g[k + 1]))
            if abs(g[k + 1]) <= t * nb:
                break
        y = np.linalg.solve(np.triu(H[:k_used, :k_used]), g[:k_used]) \
            if k_used else np.zeros(0)
        x = x + Q[:, :k_used] @ y
        inner_done = k_used
        outer_done = outer + 1
        if resvec[-1] <= t * nb:
            flag = 0
            break
    relres = resvec[-1] / nb
    outs = [MatArray(x.reshape(-1, 1), "double"),
            MatArray.scalar(float(flag)),
            MatArray.scalar(float(relres)),
            MatArray(np.array([[float(outer_done), float(inner_done)]]),
                     "double"),
            MatArray(np.asarray(resvec, np.float64).reshape(-1, 1),
                     "double")]
    return outs[:max(1, nargout)]


@builtin("ichol", category="math/sparse", min_in=1, max_in=2)
def m_ichol(A, opts=None):
    """Zero-fill incomplete Cholesky IC(0): lower-triangular L with the
    sparsity of tril(A), L*L' ~= A (≙ MATLAB ichol; the FEA stack's
    preconditioner factory)."""
    if not isinstance(A, SparseMatrix):
        if isinstance(A, MatArray):
            A = SparseMatrix.from_dense(A.host().astype(np.float64))
        else:
            raise bad_arg("ichol", "Expected a sparse matrix.")
    if A.m != A.n:
        raise bad_arg("ichol", "Matrix must be square.")
    n = A.n
    ii, jj, vv = A.triplets()
    # column-compressed lower triangle
    mask = ii >= jj
    ii, jj, vv = ii[mask], jj[mask], vv[mask].astype(np.float64)
    order = np.lexsort((ii, jj))
    ii, jj, vv = ii[order], jj[order], vv[order]
    colptr = np.searchsorted(jj, np.arange(n + 1))
    cols = [dict() for _ in range(n)]      # column j -> {row: L[row, j]}
    row_entries = [[] for _ in range(n)]   # row k -> [(j, L[k, j])]
    for k in range(n):
        s, e = colptr[k], colptr[k + 1]
        rows = ii[s:e]
        vals = vv[s:e].copy()
        if rows.size == 0 or rows[0] != k:
            raise MatError("MATLAB:ichol:ZeroPivot",
                           "Nonpositive pivot encountered.")
        # subtract contributions of previous columns j holding L[k, j]
        for j, ljk in row_entries[k]:
            cj = cols[j]
            for t, rk in enumerate(rows):
                l_rj = cj.get(rk)
                if l_rj is not None:
                    vals[t] -= l_rj * ljk
        d = vals[0]
        if d <= 0 or not np.isfinite(d):
            raise MatError("MATLAB:ichol:ZeroPivot",
                           "Nonpositive pivot encountered.")
        d = np.sqrt(d)
        vals[0] = d
        vals[1:] /= d
        ck = cols[k]
        for t, rk in enumerate(rows):
            ck[int(rk)] = vals[t]
            row_entries[int(rk)].append((k, vals[t]))
    li, lj, lv = [], [], []
    for j, cj in enumerate(cols):
        for r, v in cj.items():
            li.append(r)
            lj.append(j)
            lv.append(v)
    return SparseMatrix.from_triplets(np.array(li, np.int64),
                                      np.array(lj, np.int64),
                                      np.array(lv, np.float64), n, n)


@builtin("ilu", category="math/linalg", min_in=1, max_in=2, pass_nargout=True)
def m_ilu(A, setup=None, nargout=1):
    """Zero-fill incomplete LU, type 'nofill' (ILU(0)): L unit-lower and U
    upper with the sparsity pattern of A (≙ MATLAB ilu; reference
    preconditioner factory, runmat-analysis/fea/src/solve/
    preconditioner.rs). One output returns L + U - speye(n) like MATLAB."""
    from ...fea.solvers import ilu0
    if not isinstance(A, SparseMatrix):
        if isinstance(A, MatArray):
            A = SparseMatrix.from_dense(A.host().astype(np.float64))
        else:
            raise bad_arg("ilu", "Expected a sparse matrix.")
    if setup is not None:
        from ...values import StructArray
        if isinstance(setup, StructArray):
            t = setup.get_scalar_field("type") \
                if hasattr(setup, "get_scalar_field") else None
            ttxt = text_of(t).lower() if t is not None and is_text(t) else \
                "nofill"
            if ttxt not in ("nofill",):
                raise MatError("MATLAB:ilu:UnsupportedType",
                               f"ilu type '{ttxt}' is not supported "
                               f"(only 'nofill').")
    L, U = ilu0(A)

    def to_sm(S):
        C = S.tocoo()
        return SparseMatrix.from_triplets(
            C.row.astype(np.int64), C.col.astype(np.int64),
            C.data.astype(np.float64), S.shape[0], S.shape[1])

    if nargout <= 1:
        import scipy.sparse as sp
        n = L.shape[0]
        return to_sm((L + U - sp.eye(n)).tocsr())
    outs = [to_sm(L), to_sm(U)]
    if nargout >= 3:
        import scipy.sparse as sp
        outs.append(to_sm(sp.eye(L.shape[0], format="csr")))
    return outs[:nargout]
