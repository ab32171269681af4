"""Copy of runmat_tpu/fea/pipelines.py in the PyTorch port.

The six FEA pipelines (≙ runmat-analysis/fea/src/lib.rs:16-21).

Each pipeline takes a TetMesh + material/BC spec and returns a result dict of
numpy arrays. Solves route through SparseMatrix.solve — device CG for large
symmetric systems (runmat_tpu/sparse.py).
"""

from __future__ import annotations

import numpy as np

from ..errors import MatError
from .assembly import (apply_dirichlet, assemble_diffusion,
                       assemble_elasticity)
from .mesh import TetMesh


def _expand(u_free: np.ndarray, free: np.ndarray, u_fixed: np.ndarray):
    u = u_fixed.copy()
    u[free] = u_free
    return u


def run_linear_static(mesh: TetMesh, E: float, nu: float,
                      fixed_nodes: np.ndarray, forces: dict) -> dict:
    """forces: {node_index: (fx, fy, fz)} point loads (consistent units)."""
    K, _ = assemble_elasticity(mesh, E, nu)
    n = 3 * mesh.n_nodes
    f = np.zeros(n)
    for node, vec in forces.items():
        f[3 * int(node):3 * int(node) + 3] += np.asarray(vec, np.float64)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    Kff, ff, free, u_fix = apply_dirichlet(K, f, fixed_dofs)
    u_free = Kff.solve(ff.reshape(-1, 1)).reshape(-1)
    u = _expand(u_free, free, u_fix)
    disp = u.reshape(-1, 3)
    # recovered result fields (≙ post/fields.rs recover_result_fields)
    from .post import structural_fields
    out = {"displacement": disp,
           "max_displacement": float(np.abs(disp).max()),
           "dofs": n}
    out.update(structural_fields(mesh, disp, E, nu, K=K, f_applied=f,
                                 fixed_dofs=fixed_dofs))
    return out


def run_modal(mesh: TetMesh, E: float, nu: float, rho: float,
              fixed_nodes: np.ndarray, n_modes: int = 4) -> dict:
    """Lowest natural frequencies of K x = w^2 M x (lumped mass)."""
    K, mdiag = assemble_elasticity(mesh, E, nu, rho=rho)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    f0 = np.zeros(3 * mesh.n_nodes)
    Kff, _, free, _ = apply_dirichlet(K, f0, fixed_dofs)
    m = mdiag[free]
    nd = free.size
    if nd <= 3000:
        Kd = Kff.to_dense()
        # symmetric generalized eig via mass scaling: M^-1/2 K M^-1/2
        s = 1.0 / np.sqrt(m)
        A = Kd * s[:, None] * s[None, :]
        w2 = np.sort(np.linalg.eigvalsh((A + A.T) / 2))[:n_modes]
    else:
        w2 = _subspace_smallest(Kff, m, n_modes)
    w2 = np.maximum(w2, 0)
    freqs = np.sqrt(w2) / (2 * np.pi)
    return {"frequencies_hz": freqs, "n_modes": len(freqs)}


def _subspace_smallest(Kff, m, k):
    """Subspace iteration with CG inner solves (large models)."""
    nd = Kff.n
    rng = np.random.default_rng(0)
    V = rng.standard_normal((nd, k + 4))
    for _ in range(30):
        W = Kff.solve(m[:, None] * V)
        # M-orthonormalize
        G = W.T @ (m[:, None] * W)
        L = np.linalg.cholesky(G + 1e-12 * np.eye(G.shape[0]))
        V = np.linalg.solve(L, W.T).T
    Kv = np.stack([Kff.matmul(V[:, i]).reshape(-1) for i in range(V.shape[1])],
                  axis=1)
    A = V.T @ Kv
    B = V.T @ (m[:, None] * V)
    w2, _ = np.linalg.eig(np.linalg.solve(B, A))
    return np.sort(np.real(w2))[:k]


def run_thermal(mesh: TetMesh, k: float, fixed: dict, heat: float = 0.0) -> dict:
    """Steady conduction: fixed = {node_index: temperature}."""
    K, _ = assemble_diffusion(mesh, k)
    n = mesh.n_nodes
    f = np.full(n, float(heat))
    nodes = np.asarray(sorted(fixed), dtype=np.int64)
    temps = np.asarray([fixed[i] for i in sorted(fixed)], dtype=np.float64)
    Kff, ff, free, u_fix = apply_dirichlet(K, f, nodes, temps)
    t_free = Kff.solve(ff.reshape(-1, 1)).reshape(-1)
    T = _expand(t_free, free, u_fix)
    from .post import heat_flux, nodal_average
    q = heat_flux(mesh, T, k)
    return {"temperature": T, "max_temperature": float(T.max()),
            "flux": q, "nodal_flux": nodal_average(mesh, q),
            "min_temperature": float(T.min())}


def run_transient(mesh: TetMesh, k: float, rho_c: float, fixed: dict,
                  T0: float, t_end: float, dt: float) -> dict:
    """Implicit-Euler transient conduction."""
    K, cdiag = assemble_diffusion(mesh, k, rho_c=rho_c)
    n = mesh.n_nodes
    nodes = np.asarray(sorted(fixed), dtype=np.int64)
    temps = np.asarray([fixed[i] for i in sorted(fixed)], dtype=np.float64)
    T = np.full(n, float(T0))
    T[nodes] = temps
    f0 = np.zeros(n)
    Kff, _, free, u_fix = apply_dirichlet(K, f0, nodes, temps)
    cf = cdiag[free]
    # system matrix (C/dt + K_ff) is constant: build once
    ii, jj, vv = Kff.triplets()
    from ..sparse import SparseMatrix
    diag_idx = np.arange(free.size, dtype=np.int64)
    A = SparseMatrix.from_triplets(
        np.concatenate([ii, diag_idx]), np.concatenate([jj, diag_idx]),
        np.concatenate([vv, cf / dt]), free.size, free.size)
    # constant coupling term from fixed temperatures
    f_bc = np.zeros(n)
    ki, kj, kv = K.triplets()
    mask = np.ones(n, dtype=bool)
    mask[nodes] = False
    cross = mask[ki] & ~mask[kj]
    np.subtract.at(f_bc, ki[cross], kv[cross] * u_fix[kj[cross]])
    steps = max(1, int(round(t_end / dt)))
    history = [T.copy()]
    for _ in range(steps):
        rhs = cf / dt * T[free] + f_bc[free]
        T_free = A.solve(rhs.reshape(-1, 1)).reshape(-1)
        T = _expand(T_free, free, u_fix)
        history.append(T.copy())
    return {"temperature": T, "history": np.stack(history),
            "steps": steps}


def run_nonlinear(mesh: TetMesh, E: float, nu: float,
                  fixed_nodes: np.ndarray, forces: dict,
                  n_increments: int = 5, eps_yield: float = None,
                  hardening: float = 0.1, tol: float = 1e-9) -> dict:
    """Newton with Armijo line search over a bilinear (deformation-theory
    secant) material (≙ runmat-analysis/fea/src/solve/nonlinear + line
    search): equivalent strain e = ||eps||, secant modulus scale
    s(e) = 1 for e <= eps_yield, (ey + h (e - ey)) / e beyond — giving a
    bilinear stress-strain with tangent fraction `hardening`. With
    eps_yield=None the material is linear and Newton converges in one
    step. Load is applied in `n_increments` steps, each solved by
    fea.solvers.newton_solve."""
    from .assembly import _grads_and_vols
    from .solvers import newton_solve

    n = 3 * mesh.n_nodes
    f_total = np.zeros(n)
    for node, vec in forces.items():
        f_total[3 * int(node):3 * int(node) + 3] += \
            np.asarray(vec, np.float64)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    grads, vol, _ = _grads_and_vols(mesh)
    M = mesh.n_tets
    dofs = (3 * mesh.tets[:, :, None] + np.arange(3)[None, None, :]) \
        .reshape(M, 12)
    B = np.zeros((M, 6, 12))
    for a in range(4):
        gx, gy, gz = grads[:, a, 0], grads[:, a, 1], grads[:, a, 2]
        c = 3 * a
        B[:, 0, c] = gx
        B[:, 1, c + 1] = gy
        B[:, 2, c + 2] = gz
        B[:, 3, c] = gy
        B[:, 3, c + 1] = gx
        B[:, 4, c + 1] = gz
        B[:, 4, c + 2] = gy
        B[:, 5, c] = gz
        B[:, 5, c + 2] = gx

    def _eq_strain(u_full: np.ndarray) -> np.ndarray:
        eps = np.einsum("mab,mb->ma", B, u_full[dofs])       # (M, 6)
        # engineering-shear halves for the tensor norm
        w = np.array([1.0, 1, 1, 0.5, 0.5, 0.5])
        return np.sqrt(np.einsum("ma,a,ma->m", eps, w, eps))

    def secant_scale(u_full: np.ndarray) -> np.ndarray:
        if eps_yield is None:
            return np.ones(M)
        e = _eq_strain(u_full)
        s = np.ones(M)
        over = e > eps_yield
        s[over] = (eps_yield + hardening * (e[over] - eps_yield)) / e[over]
        return s

    def K_of(u_full: np.ndarray):
        K, _ = assemble_elasticity(mesh, E, nu,
                                   escale=secant_scale(u_full))
        return K

    def K_tangent(u_full: np.ndarray):
        """Consistent tangent of f_int(u) = sum_e vol B' s(e) D eps:
        d(s D eps)/d eps = s D + (D eps) (ds/deps)', with
        ds/deps = ey (h - 1) / e^3 * W eps beyond yield — the exact
        rank-one term that makes Newton quadratic near the solution."""
        if eps_yield is None:
            return K_of(u_full)
        from .assembly import elasticity_D as _eD
        from .assembly import _grads_and_vols as _gv
        eps = np.einsum("mab,mb->ma", B, u_full[dofs])
        w = np.array([1.0, 1, 1, 0.5, 0.5, 0.5])
        e = np.sqrt(np.einsum("ma,a,ma->m", eps, w, eps))
        s = np.ones(M)
        over = e > eps_yield
        s[over] = (eps_yield + hardening * (e[over] - eps_yield)) / e[over]
        D = _eD(E, nu)
        Ke = np.einsum("mia,ij,mjb,m->mab", B, D, B, vol * s,
                       optimize=True)
        coef = np.zeros(M)
        coef[over] = eps_yield * (hardening - 1.0) / e[over] ** 3
        sig = np.einsum("ij,mj->mi", D, eps)             # D eps
        ga = np.einsum("mia,mi->ma", B, sig)             # B'(D eps)
        gb = np.einsum("mia,mi->ma", B, eps * w[None, :])  # B'(W eps)
        Ke += (coef * vol)[:, None, None] * \
            ga[:, :, None] * gb[:, None, :]
        ii = np.repeat(dofs, 12, axis=1).reshape(-1)
        jj = np.tile(dofs, (1, 12)).reshape(-1)
        from ..sparse import SparseMatrix
        return SparseMatrix.from_triplets(ii, jj, Ke.reshape(-1), n, n)

    u_full = np.zeros(n)
    total_iters = 0
    total_cuts = 0
    info = {"converged": True, "residual_norm": 0.0}
    for inc in range(1, n_increments + 1):
        f_inc = f_total * (inc / n_increments)

        K0 = K_of(u_full)
        Kff, ff, free, u_fix = apply_dirichlet(K0, f_inc, fixed_dofs)

        def residual(u_free):
            uf = _expand(u_free, free, u_fix)
            K = K_of(uf)
            ii, jj, vv = K.triplets()
            f_int = np.zeros(n)
            np.add.at(f_int, ii, vv * uf[jj])
            return (f_inc - f_int)[free]

        def jacobian_solve(u_free, r):
            uf = _expand(u_free, free, u_fix)
            Kff_u, _, _, _ = apply_dirichlet(K_tangent(uf), f_inc,
                                             fixed_dofs)
            return Kff_u.solve(r.reshape(-1, 1)).reshape(-1)

        u_free, info = newton_solve(residual, jacobian_solve, u_full[free],
                                    tol=tol)
        u_full = _expand(u_free, free, u_fix)
        total_iters += info["iterations"]
        total_cuts += info["line_search_cuts"]
    disp = u_full.reshape(-1, 3)
    from .post import structural_fields
    out = {"displacement": disp,
           "max_displacement": float(np.abs(disp).max()),
           "increments": n_increments,
           "newton_iterations": total_iters,
           "line_search_cuts": total_cuts,
           "residual_norm": info["residual_norm"],
           "converged": bool(info["converged"])}
    out.update(structural_fields(mesh, disp, E, nu))
    return out


def run_dynamics(mesh: TetMesh, E: float, nu: float, rho: float,
                 fixed_nodes: np.ndarray, forces: dict, t_end: float,
                 dt: float, beta: float = 0.25, gamma: float = 0.5,
                 alpha: float = 0.0, store_every: int = 1) -> dict:
    """Structural dynamics M a + K u = f via Newmark-beta / HHT-alpha
    (≙ fea/src/solve/transient integrators). Step load applied at t=0;
    alpha=0 gives the non-dissipative trapezoidal Newmark, alpha<0 adds
    controlled high-frequency dissipation (gamma/beta follow the standard
    HHT family when left at defaults)."""
    from .solvers import newmark_hht

    K, mdiag = assemble_elasticity(mesh, E, nu, rho=rho)
    n = 3 * mesh.n_nodes
    f = np.zeros(n)
    for node, vec in forces.items():
        f[3 * int(node):3 * int(node) + 3] += np.asarray(vec, np.float64)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    Kff, ff, free, u_fix = apply_dirichlet(K, f, fixed_dofs)
    if alpha != 0.0:
        gamma = 0.5 - alpha
        beta = (1.0 - alpha) ** 2 / 4.0
    res = newmark_hht(Kff, mdiag[free], lambda t: ff, np.zeros(free.size),
                      np.zeros(free.size), t_end, dt, beta=beta,
                      gamma=gamma, alpha=alpha, store_every=store_every)
    u_hist = np.zeros((res["u"].shape[0], n))
    u_hist[:, free] = res["u"]
    u_hist[:, np.asarray(fixed_dofs)] = 0.0
    return {"t": res["t"], "displacement_history": u_hist,
            "displacement": u_hist[-1].reshape(-1, 3),
            "steps": res["steps"],
            "max_displacement": float(np.abs(u_hist).max())}


def run_thermomechanical(mesh: TetMesh, E: float, nu: float, alpha: float,
                         k: float, fixed_nodes: np.ndarray,
                         fixed_temp: dict, T_ref: float = 0.0,
                         heat: float = 0.0) -> dict:
    """One-way thermo-mechanical coupling (≙ the reference's coupling
    physics, runmat-analysis/fea/src/physics/coupling): steady conduction
    gives the temperature field, element thermal strains
    eps_th = alpha (T - T_ref) [1 1 1 0 0 0] become consistent nodal
    loads f = sum_e B' D eps_th vol, and the elasticity solve runs under
    those loads."""
    from .assembly import _grads_and_vols, elasticity_D

    th = run_thermal(mesh, k, fixed_temp, heat=heat)
    T = th["temperature"]
    grads, vol, _ = _grads_and_vols(mesh)
    M = mesh.n_tets
    B = np.zeros((M, 6, 12))
    for a in range(4):
        gx, gy, gz = grads[:, a, 0], grads[:, a, 1], grads[:, a, 2]
        c = 3 * a
        B[:, 0, c] = gx
        B[:, 1, c + 1] = gy
        B[:, 2, c + 2] = gz
        B[:, 3, c] = gy
        B[:, 3, c + 1] = gx
        B[:, 4, c + 1] = gz
        B[:, 4, c + 2] = gy
        B[:, 5, c] = gz
        B[:, 5, c + 2] = gx
    D = elasticity_D(E, nu)
    dT = T[mesh.tets].mean(axis=1) - T_ref            # (M,)
    eps_th = np.zeros((M, 6))
    eps_th[:, :3] = alpha * dT[:, None]
    fe = np.einsum("mia,ij,mj,m->ma", B, D, eps_th, vol,
                   optimize=True)                      # (M, 12)
    f = np.zeros(3 * mesh.n_nodes)
    dofs = (3 * mesh.tets[:, :, None] + np.arange(3)[None, None, :]) \
        .reshape(M, 12)
    np.add.at(f, dofs.reshape(-1), fe.reshape(-1))

    K, _ = assemble_elasticity(mesh, E, nu)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    Kff, ff, free, u_fix = apply_dirichlet(K, f, fixed_dofs)
    u_free = Kff.solve(ff.reshape(-1, 1)).reshape(-1)
    u = _expand(u_free, free, u_fix).reshape(-1, 3)
    return {"temperature": T, "displacement": u,
            "max_temperature": th["max_temperature"],
            "max_displacement": float(np.abs(u).max())}


def run_electromagnetic(mesh: TetMesh, eps: float, fixed: dict) -> dict:
    """Electrostatics: Laplace solve for potential with fixed electrodes;
    E-field from potential gradients."""
    res = run_thermal(mesh, eps, fixed)
    V = res["temperature"]
    from .assembly import _grads_and_vols
    grads, vol, _ = _grads_and_vols(mesh)
    Ee = -np.einsum("mai,ma->mi", grads, V[mesh.tets])
    return {"potential": V, "efield": Ee,
            "max_field": float(np.linalg.norm(Ee, axis=1).max())}


# --------------------------------------------------------------------------- #
# linear buckling and harmonic (frequency-response) pipelines
# --------------------------------------------------------------------------- #

def assemble_geometric(mesh: TetMesh, sigma: np.ndarray):
    """Geometric (stress) stiffness Kg from element Cauchy stress (M, 6)
    Voigt rows: Kg[3a+d, 3b+d] = V_e * g_a^T S g_b per element, the linear-
    tet initial-stress matrix. (New analysis capability over the reference's
    six pipelines; assembly mirrors assemble_elasticity.)"""
    from ..sparse import SparseMatrix
    from .assembly import _grads_and_vols
    grads, vol, _ = _grads_and_vols(mesh)
    M = mesh.n_tets
    s = np.asarray(sigma, np.float64)
    S = np.empty((M, 3, 3))
    S[:, 0, 0], S[:, 1, 1], S[:, 2, 2] = s[:, 0], s[:, 1], s[:, 2]
    S[:, 0, 1] = S[:, 1, 0] = s[:, 3]
    S[:, 1, 2] = S[:, 2, 1] = s[:, 4]
    S[:, 0, 2] = S[:, 2, 0] = s[:, 5]
    kg = np.einsum("mai,mij,mbj,m->mab", grads, S, grads, vol,
                   optimize=True)                        # (M, 4, 4)
    Ke = np.zeros((M, 12, 12))
    for d in range(3):
        Ke[:, d::3, d::3] = kg
    dofs = (3 * mesh.tets[:, :, None] + np.arange(3)[None, None, :]) \
        .reshape(M, 12)
    ii = np.repeat(dofs, 12, axis=1).reshape(-1)
    jj = np.tile(dofs, (1, 12)).reshape(-1)
    return SparseMatrix.from_triplets(ii, jj, Ke.reshape(-1),
                                      3 * mesh.n_nodes, 3 * mesh.n_nodes)


def run_buckling(mesh: TetMesh, E: float, nu: float,
                 fixed_nodes: np.ndarray, forces: dict,
                 n_modes: int = 4) -> dict:
    """Linear (eigenvalue) buckling: pre-stress static solve, geometric
    stiffness from the element stress state, then K phi = -lambda Kg phi on
    the free dofs. lambda are load multipliers: lambda * applied load =
    critical load (exact scale invariance: doubling the load halves
    lambda)."""
    from .post import element_stress
    static = run_linear_static(mesh, E, nu, fixed_nodes, forces)
    sigma = element_stress(mesh, static["displacement"].reshape(-1), E, nu) \
        if "stress" not in static else static["stress"]
    K, _ = assemble_elasticity(mesh, E, nu)
    Kg = assemble_geometric(mesh, sigma)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    n = 3 * mesh.n_nodes
    zero = np.zeros(n)
    Kff, _, free, _ = apply_dirichlet(K, zero, fixed_dofs)
    Gff, _, _, _ = apply_dirichlet(Kg, zero, fixed_dofs)
    nd = free.size
    if nd <= 3000:
        Kd = Kff.to_dense()
        Gd = -Gff.to_dense()
        L = np.linalg.cholesky((Kd + Kd.T) / 2 + 1e-9 * np.eye(nd)
                               * float(np.abs(Kd).max()))
        X = np.linalg.solve(L, (Gd + Gd.T) / 2)
        A = np.linalg.solve(L, X.T)
        mu = np.sort(np.linalg.eigvalsh((A + A.T) / 2))[::-1]
    else:
        mu = _subspace_largest_pencil(Kff, Gff, n_modes)
    mu = mu[mu > 1e-12][:n_modes]
    factors = 1.0 / mu
    return {"load_factors": factors,
            "critical_load_factor": float(factors[0]) if factors.size
            else np.inf,
            "n_modes": int(factors.size)}


def _subspace_largest_pencil(Kff, Gff, k: int):
    """Largest eigenvalues of K^-1 (-Kg) by subspace iteration (CG inner
    solves; mirrors _subspace_smallest)."""
    nd = Kff.n
    rng = np.random.default_rng(0)
    V = rng.standard_normal((nd, k + 4))
    for _ in range(30):
        GV = np.stack([-Gff.matmul(V[:, i]).reshape(-1)
                       for i in range(V.shape[1])], axis=1)
        W = Kff.solve(GV)
        Q, _ = np.linalg.qr(W)
        V = Q
    KV = np.stack([Kff.matmul(V[:, i]).reshape(-1)
                   for i in range(V.shape[1])], axis=1)
    GV = np.stack([-Gff.matmul(V[:, i]).reshape(-1)
                   for i in range(V.shape[1])], axis=1)
    A = V.T @ GV
    Bm = V.T @ KV
    mu = np.real(np.linalg.eigvals(np.linalg.solve(Bm, A)))
    return np.sort(mu)[::-1]


def _modes_with_vectors(Kff, m: np.ndarray, k: int):
    """Lowest-k modes of K x = w^2 M x with M-normalized vectors."""
    nd = Kff.n
    s = 1.0 / np.sqrt(m)
    if nd <= 3000:
        Kd = Kff.to_dense()
        A = Kd * s[:, None] * s[None, :]
        w2, Y = np.linalg.eigh((A + A.T) / 2)
        w2, Y = w2[:k], Y[:, :k]
        V = Y * s[:, None]                   # back to physical coords
        return np.maximum(w2, 0), V
    rng = np.random.default_rng(0)
    V = rng.standard_normal((nd, k + 4))
    for _ in range(30):
        W = Kff.solve(m[:, None] * V)
        G = W.T @ (m[:, None] * W)
        L = np.linalg.cholesky(G + 1e-12 * np.eye(G.shape[0]))
        V = np.linalg.solve(L, W.T).T
    Kv = np.stack([Kff.matmul(V[:, i]).reshape(-1) for i in range(V.shape[1])],
                  axis=1)
    A = V.T @ Kv
    B = V.T @ (m[:, None] * V)
    w2, Y = np.linalg.eig(np.linalg.solve(B, A))
    order = np.argsort(np.real(w2))[:k]
    w2 = np.real(w2[order])
    V = np.real(V @ Y[:, order])
    # M-normalize
    nrm = np.sqrt(np.einsum("ik,i,ik->k", V, m, V))
    return np.maximum(w2, 0), V / nrm[None, :]


def run_harmonic(mesh: TetMesh, E: float, nu: float, rho: float,
                 fixed_nodes: np.ndarray, forces: dict,
                 freqs_hz: np.ndarray, damping: float = 0.02,
                 n_modes: int = 20, probe_node: int = None) -> dict:
    """Steady-state harmonic response by modal superposition: FRF of
    (K - w^2 M + 2 i zeta w wk M) over a frequency sweep with constant
    modal damping ratio `damping`. Returns per-frequency peak displacement
    amplitude and the complex response at `probe_node` (defaults to the
    largest-amplitude loaded node)."""
    K, mdiag = assemble_elasticity(mesh, E, nu, rho=rho)
    n = 3 * mesh.n_nodes
    f = np.zeros(n)
    for node, vec in forces.items():
        f[3 * int(node):3 * int(node) + 3] += np.asarray(vec, np.float64)
    fixed_dofs = (3 * np.asarray(fixed_nodes, np.int64)[:, None]
                  + np.arange(3)[None, :]).reshape(-1)
    Kff, ff, free, _ = apply_dirichlet(K, f, fixed_dofs)
    m = mdiag[free]
    k = min(n_modes, free.size)
    w2, V = _modes_with_vectors(Kff, m, k)
    wk = np.sqrt(np.maximum(w2, 1e-300))
    gen_f = V.T @ ff                                    # modal forces
    w = 2 * np.pi * np.asarray(freqs_hz, np.float64).reshape(-1)
    # (F, K) modal FRF denominators
    den = (w2[None, :] - (w ** 2)[:, None]
           + 2j * damping * wk[None, :] * w[:, None])
    q = gen_f[None, :] / den                            # (F, K)
    U = q @ V.T                                         # (F, nd) complex
    # static correction (mode-acceleration residual): the truncated higher
    # modes respond quasi-statically, so add K^-1 f minus the retained
    # modes' static part — exact static limit at w -> 0
    u_static = Kff.solve(ff.reshape(-1, 1)).reshape(-1)
    resid = u_static - V @ (gen_f / np.maximum(w2, 1e-300))
    U = U + resid[None, :]
    amp = np.abs(U)
    peak = amp.max(axis=1)
    if probe_node is None and forces:
        probe_node = int(next(iter(forces)))
    probe = None
    if probe_node is not None:
        pd = 3 * int(probe_node) + np.arange(3)
        cols = np.searchsorted(free, pd)
        ok = (cols < free.size) & (free[np.minimum(cols, free.size - 1)] == pd)
        probe = np.zeros((w.size, 3), dtype=complex)
        probe[:, ok] = U[:, cols[ok]]
    return {"frequencies_hz": np.asarray(freqs_hz, np.float64).reshape(-1),
            "peak_amplitude": peak,
            "probe_complex": probe,
            "probe_amplitude": None if probe is None else np.abs(probe),
            "modal_frequencies_hz": wk / (2 * np.pi),
            "n_modes": int(k)}
