"""Copy of runmat_tpu/fea/solvers.py in the PyTorch port.

FEA solver depth: preconditioners, Newton line search, transient
integrators.

Reference parity: runmat-analysis/fea/src/solve/{linear w/ preconditioners,
nonlinear, transient} and fea/src/solve/preconditioner.rs. The reference
ships a preconditioner factory (jacobi/IC0/ILU0/SSOR), Newton with line
search for the nonlinear pipeline, and Newmark/HHT time integration; this
module provides the TPU-build equivalents on the SparseMatrix/CSR layer.
The per-iteration triangular solves are host-side (latency-bound, tiny);
the O(N) matvecs ride the device CG path in sparse.py when large.
"""

from __future__ import annotations

import numpy as np

from ..errors import MatError


# --------------------------------------------------------------------------- #
# preconditioners
# --------------------------------------------------------------------------- #

def _csr_of(A):
    import scipy.sparse as sp
    ii, jj, vv = A.triplets()
    return sp.csr_matrix((vv.astype(np.float64), (ii, jj)),
                         shape=(A.m, A.n))


def ilu0(A):
    """Zero-fill ILU (nofill): L unit-lower, U upper, sparsity of A
    (≙ MATLAB ilu type='nofill'; fea preconditioner factory ILU0).
    Row-IKJ over the CSR pattern."""
    import scipy.sparse as sp
    S = _csr_of(A).tocsr()
    n = S.shape[0]
    if S.shape[0] != S.shape[1]:
        raise MatError("MATLAB:ilu:SquareMatrix", "Matrix must be square.")
    indptr, indices, data = S.indptr, S.indices, S.data.astype(np.float64)
    # row dict views for O(1) U[k, j] lookup
    rows = [dict(zip(indices[indptr[i]:indptr[i + 1]].tolist(),
                     range(indptr[i], indptr[i + 1])))
            for i in range(n)]
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        for t in range(s, e):
            k = indices[t]
            if k >= i:
                break
            dk = rows[k].get(k)
            if dk is None or data[dk] == 0.0:
                raise MatError("MATLAB:ilu:ZeroPivot",
                               "Zero pivot encountered.")
            lik = data[t] / data[dk]
            data[t] = lik
            rk = rows[k]
            for t2 in range(t + 1, e):
                j = cols_i[t2 - s]
                p = rk.get(j)
                if p is not None:
                    data[t2] -= lik * data[p]
        if rows[i].get(i) is None:
            raise MatError("MATLAB:ilu:ZeroPivot",
                           "Zero pivot encountered (structurally).")
    LU = sp.csr_matrix((data, indices.copy(), indptr.copy()), shape=(n, n))
    L = sp.tril(LU, k=-1, format="csr") + sp.eye(n, format="csr")
    U = sp.triu(LU, k=0, format="csr")
    return L, U


def ilu0_apply(L, U):
    """Returns M^{-1} r = U \\ (L \\ r) via two sparse triangular solves."""
    import scipy.sparse.linalg as spla

    def apply(r):
        y = spla.spsolve_triangular(L, r, lower=True, unit_diagonal=True)
        return spla.spsolve_triangular(U, y, lower=False)
    return apply


def ssor_apply(A, omega: float = 1.2):
    """SSOR preconditioner application for SPD A:
    M = (D/w + L) * (w/(2-w))^-1 * D^-1 * (D/w + L)^T; M^{-1} r via a
    forward and a backward triangular sweep (≙ preconditioner.rs SSOR)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    if not (0.0 < omega < 2.0):
        raise MatError("RunMat:fea:badOmega",
                       "SSOR relaxation must be in (0, 2).")
    S = _csr_of(A)
    d = S.diagonal()
    if np.any(d <= 0):
        raise MatError("RunMat:fea:badDiagonal",
                       "SSOR needs a positive diagonal.")
    Dw = sp.diags(d / omega)
    Lo = sp.tril(S, k=-1, format="csr")
    lower = (Dw + Lo).tocsr()
    upper = lower.T.tocsr()
    scale = (2.0 - omega) / omega

    def apply(r):
        y = spla.spsolve_triangular(lower, r, lower=True)
        y = y * d * scale
        return spla.spsolve_triangular(upper, y, lower=False)
    return apply


def make_preconditioner(A, kind: str = "jacobi", omega: float = 1.2):
    """Preconditioner factory: 'jacobi' | 'ssor' | 'ilu0' | 'ic0' | 'none'
    (≙ runmat-analysis/fea/src/solve/preconditioner.rs)."""
    kind = (kind or "jacobi").lower()
    if kind in ("none", ""):
        return lambda r: r
    if kind == "jacobi":
        d = _csr_of(A).diagonal()
        inv = 1.0 / np.where(d == 0, 1.0, d)
        return lambda r: inv * r
    if kind == "ssor":
        return ssor_apply(A, omega)
    if kind == "ilu0":
        L, U = ilu0(A)
        return ilu0_apply(L, U)
    if kind in ("ic0", "ichol"):
        from ..runtime.builtins.itersolve import m_ichol
        Lm = m_ichol(A)
        import scipy.sparse.linalg as spla
        Ls = _csr_of(Lm)
        Ut = Ls.T.tocsr()

        def apply(r):
            y = spla.spsolve_triangular(Ls, r, lower=True)
            return spla.spsolve_triangular(Ut, y, lower=False)
        return apply
    raise MatError("RunMat:fea:badPreconditioner",
                   f"Unknown preconditioner '{kind}'.")


def pcg(A, b, precond="jacobi", tol=1e-10, maxit=None, omega=1.2,
        callback=None):
    """Preconditioned CG on the CSR matvec with the factory preconditioners.
    Returns (x, iterations). Raises on non-convergence."""
    S = _csr_of(A)
    M = make_preconditioner(A, precond, omega)
    n = S.shape[0]
    maxit = maxit or 4 * n
    x = np.zeros(n)
    r = np.asarray(b, np.float64).reshape(-1).copy()
    nb = float(np.linalg.norm(r)) or 1.0
    z = M(r)
    p = z.copy()
    rz = float(r @ z)
    for it in range(1, maxit + 1):
        Ap = S @ p
        denom = float(p @ Ap)
        if denom <= 0:
            raise MatError("RunMat:fea:notSPD",
                           "CG breakdown: matrix is not positive definite.")
        alpha = rz / denom
        x += alpha * p
        r -= alpha * Ap
        res = float(np.linalg.norm(r)) / nb
        if callback is not None:
            callback(it, res)
        if res < tol:
            return x, it
        z = M(r)
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise MatError("RunMat:fea:noConvergence",
                   f"PCG did not converge in {maxit} iterations.")


# --------------------------------------------------------------------------- #
# Newton with Armijo line search (nonlinear pipeline)
# --------------------------------------------------------------------------- #

def newton_solve(residual, jacobian_solve, u0, tol=1e-8, maxit=25,
                 armijo_c=1e-4, min_step=2.0 ** -10):
    """Damped Newton: u <- u + a*d with Armijo backtracking on ||r||
    (≙ fea/src/solve/nonlinear line search). `residual(u) -> r`,
    `jacobian_solve(u, r) -> d` solves J(u) d = r. Returns
    (u, info{iterations, line_search_cuts, residual_norm, converged})."""
    u = np.asarray(u0, np.float64).copy()
    r = residual(u)
    rn = float(np.linalg.norm(r))
    r0 = rn or 1.0
    cuts = 0
    for it in range(1, maxit + 1):
        if rn / r0 < tol or rn < tol:
            return u, {"iterations": it - 1, "line_search_cuts": cuts,
                       "residual_norm": rn, "converged": True}
        d = jacobian_solve(u, r)
        a = 1.0
        while a >= min_step:
            u_try = u + a * d
            r_try = residual(u_try)
            rn_try = float(np.linalg.norm(r_try))
            if rn_try <= (1.0 - armijo_c * a) * rn:
                break
            a *= 0.5
            cuts += 1
        else:
            return u, {"iterations": it, "line_search_cuts": cuts,
                       "residual_norm": rn, "converged": False}
        u, r, rn = u_try, r_try, rn_try
    converged = rn / r0 < tol or rn < tol
    return u, {"iterations": maxit, "line_search_cuts": cuts,
               "residual_norm": rn, "converged": converged}


# --------------------------------------------------------------------------- #
# Newmark-beta / HHT-alpha time integration (structural dynamics)
# --------------------------------------------------------------------------- #

def newmark_hht(K, mdiag, f_of_t, u0, v0, t_end, dt, beta=0.25, gamma=0.5,
                alpha=0.0, store_every=1):
    """Integrate M a + K u = f(t) with HHT-alpha (alpha=0 -> Newmark-beta).
    alpha in [-1/3, 0]; gamma = 1/2 - alpha, beta = (1 - alpha)^2 / 4 give
    the standard dissipative family (≙ fea/src/solve/transient).
    K: SparseMatrix (free dofs), mdiag: lumped mass diagonal, f_of_t(t) ->
    load vector. Returns dict with u/v/a histories (downsampled)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    if not (-1.0 / 3.0 - 1e-12 <= alpha <= 1e-12):
        raise MatError("RunMat:fea:badAlpha",
                       "HHT alpha must lie in [-1/3, 0].")
    S = _csr_of(K)
    n = S.shape[0]
    m = np.asarray(mdiag, np.float64).reshape(-1)
    if np.any(m <= 0):
        raise MatError("RunMat:fea:badMass", "Lumped mass must be positive.")
    M = sp.diags(m)
    u = np.asarray(u0, np.float64).copy()
    v = np.asarray(v0, np.float64).copy()
    a = (f_of_t(0.0) - S @ u) / m
    steps = max(1, int(round(t_end / dt)))
    # effective operator is constant: prefactor once
    A_eff = (M / (beta * dt * dt) + (1.0 + alpha) * S).tocsc()
    lu = spla.splu(A_eff)
    us, vs, ts = [u.copy()], [v.copy()], [0.0]
    t = 0.0
    for k in range(1, steps + 1):
        t_new = k * dt
        f_mid = (1.0 + alpha) * f_of_t(t_new) - alpha * f_of_t(t)
        pred_u = u + dt * v + dt * dt * (0.5 - beta) * a
        rhs = f_mid + m * pred_u / (beta * dt * dt) + alpha * (S @ u)
        u_new = lu.solve(rhs)
        a_new = (u_new - pred_u) / (beta * dt * dt)
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        u, v, a, t = u_new, v_new, a_new, t_new
        if k % store_every == 0 or k == steps:
            us.append(u.copy())
            vs.append(v.copy())
            ts.append(t)
    return {"u": np.stack(us), "v": np.stack(vs),
            "t": np.asarray(ts), "steps": steps}
