"""Copy of runmat_tpu/fea/post.py in the PyTorch port.

FEA post-processing: stress/strain recovery, von Mises, reactions.

Reference parity: runmat-analysis/fea/src/post/fields.rs
recover_result_fields — strain/stress per element from the displacement
solution, element + nodal-averaged von Mises, strain-energy density and
total strain energy, reaction forces at constrained dofs, residual norm;
thermal gradient/flux recovery for the scalar pipelines. All recoveries
here are single batched einsums over the whole mesh (TPU-friendly shape:
no per-element Python loop), mirroring the assembly module's style.
"""

from __future__ import annotations

import numpy as np

from .assembly import _grads_and_vols, elasticity_D
from .mesh import TetMesh


def element_strain(mesh: TetMesh, u: np.ndarray) -> np.ndarray:
    """Engineering strain per element (M, 6) in Voigt order
    [exx eyy ezz gxy gyz gzx] from nodal displacements u (N, 3)."""
    grads, _vol, _ = _grads_and_vols(mesh)
    ue = np.asarray(u, np.float64).reshape(-1, 3)[mesh.tets]    # (M,4,3)
    # du_i/dx_j = sum_a grads[m,a,j] * ue[m,a,i]
    g = np.einsum("maj,mai->mij", grads, ue)                     # (M,3,3)
    eps = np.empty((mesh.n_tets, 6))
    eps[:, 0] = g[:, 0, 0]
    eps[:, 1] = g[:, 1, 1]
    eps[:, 2] = g[:, 2, 2]
    eps[:, 3] = g[:, 0, 1] + g[:, 1, 0]
    eps[:, 4] = g[:, 1, 2] + g[:, 2, 1]
    eps[:, 5] = g[:, 2, 0] + g[:, 0, 2]
    return eps


def element_stress(mesh: TetMesh, u: np.ndarray, E: float,
                   nu: float) -> np.ndarray:
    """Cauchy stress per element (M, 6) Voigt [sxx syy szz sxy syz szx]."""
    return element_strain(mesh, u) @ elasticity_D(E, nu).T


def von_mises(sigma: np.ndarray) -> np.ndarray:
    """Von Mises equivalent stress from Voigt stress rows (…, 6)."""
    s = np.asarray(sigma, np.float64)
    sx, sy, sz, txy, tyz, tzx = (s[..., i] for i in range(6))
    return np.sqrt(0.5 * ((sx - sy) ** 2 + (sy - sz) ** 2 + (sz - sx) ** 2)
                   + 3.0 * (txy ** 2 + tyz ** 2 + tzx ** 2))


def principal_stresses(sigma: np.ndarray) -> np.ndarray:
    """Principal stresses (M, 3) descending, batched symmetric eig."""
    s = np.asarray(sigma, np.float64)
    T = np.empty(s.shape[:-1] + (3, 3))
    T[..., 0, 0] = s[..., 0]
    T[..., 1, 1] = s[..., 1]
    T[..., 2, 2] = s[..., 2]
    T[..., 0, 1] = T[..., 1, 0] = s[..., 3]
    T[..., 1, 2] = T[..., 2, 1] = s[..., 4]
    T[..., 0, 2] = T[..., 2, 0] = s[..., 5]
    w = np.linalg.eigvalsh(T)
    return w[..., ::-1]


def nodal_average(mesh: TetMesh, elem_vals: np.ndarray) -> np.ndarray:
    """Volume-weighted element->node averaging (stress recovery;
    ≙ recover_nodal_averaged_scalar). elem_vals (M,) or (M, C)."""
    _g, vol, _ = _grads_and_vols(mesh)
    ev = np.asarray(elem_vals, np.float64)
    scalar = ev.ndim == 1
    if scalar:
        ev = ev[:, None]
    num = np.zeros((mesh.n_nodes, ev.shape[1]))
    den = np.zeros(mesh.n_nodes)
    for a in range(4):
        np.add.at(num, mesh.tets[:, a], ev * vol[:, None])
        np.add.at(den, mesh.tets[:, a], vol)
    out = num / np.maximum(den, 1e-300)[:, None]
    return out[:, 0] if scalar else out


def strain_energy_density(eps: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    """0.5 * eps : sigma per element (engineering-shear Voigt pairs off
    the factor correctly: gxy*sxy already counts both tensor components)."""
    return 0.5 * np.einsum("...i,...i->...", eps, sigma)


def total_strain_energy(mesh: TetMesh, eps: np.ndarray,
                        sigma: np.ndarray) -> float:
    _g, vol, _ = _grads_and_vols(mesh)
    return float((strain_energy_density(eps, sigma) * vol).sum())


def reaction_forces(K, u: np.ndarray, f_applied: np.ndarray,
                    fixed_dofs: np.ndarray) -> np.ndarray:
    """Reactions r = (K u - f_applied) at the constrained dofs
    (≙ recover_reaction_force over apply_k_unconstrained)."""
    r = np.asarray(
        K.matmul(np.asarray(u, np.float64).reshape(-1, 1))).reshape(-1) \
        - np.asarray(f_applied, np.float64).reshape(-1)
    out = np.zeros_like(r)
    fd = np.asarray(fixed_dofs, np.int64)
    out[fd] = r[fd]
    return out


def heat_flux(mesh: TetMesh, T: np.ndarray, k: float) -> np.ndarray:
    """Element heat flux q = -k grad(T), (M, 3)."""
    grads, _vol, _ = _grads_and_vols(mesh)
    Te = np.asarray(T, np.float64).reshape(-1)[mesh.tets]       # (M,4)
    g = np.einsum("maj,ma->mj", grads, Te)
    return -k * g


def structural_fields(mesh: TetMesh, u: np.ndarray, E: float, nu: float,
                      K=None, f_applied=None,
                      fixed_dofs=None) -> dict:
    """The full recovered-field dict for a structural solve
    (≙ recover_result_fields' field list, minus beam/shell rows)."""
    eps = element_strain(mesh, u)
    sig = eps @ elasticity_D(E, nu).T
    vm = von_mises(sig)
    out = {
        "strain": eps,
        "stress": sig,
        "von_mises": vm,
        "nodal_von_mises": nodal_average(mesh, vm),
        "principal": principal_stresses(sig),
        "strain_energy_density": strain_energy_density(eps, sig),
        "total_strain_energy": total_strain_energy(mesh, eps, sig),
    }
    if K is not None and f_applied is not None and fixed_dofs is not None:
        out["reactions"] = reaction_forces(K, u, f_applied,
                                           fixed_dofs).reshape(-1, 3)
    return out
