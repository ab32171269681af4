"""Copy of runmat_tpu/accel/eig_qr.py in the PyTorch port: the general
(nonsymmetric) real eigenproblem on the active device.

The JAX module runs the dense real-Schur pipeline as one jitted program in
real float64 arithmetic; here each step is torch ops or one of the three
hand-written kernels of `csrc/eig_qr.cu` (`ops/eig_qr.py`, whose plain
versions a CPU tensor takes):

1. `balance`/`balance_d`: 8 sweeps of off-diagonal row and column 1-norms
   and an exact power-of-two scale (torch ops; `torch.round` rounds half
   to even as `jnp.round` does, and log2 is log(x) / log(2) as jnp's).
2. `hessenberg`/`hessenberg_q`: the Householder reduction (eig_hess).
3. `francis_qr`/`francis_qr_z`: the implicit double-shift QR iteration
   with deflation, exceptional shifts every 10 stalls and the 40 n + 100
   safeguard (eig_francis, the whole loop in one launch).
4. `eig_values`: the eigenvalues read off the quasi-triangular matrix
   (torch ops). Returns (wr, wi, ok): ok False when the iteration hit the
   safeguard (the builtin then takes its counted host fallback).
5. `trevc` (eig_trevc) and `eig_full`: [V, D] as V = D_bal Q Z Y, with the
   products of `torch.matmul` and unit-norm columns.

The eigenvalues come back in the Francis iteration's deflation order, the
JAX package's, not LAPACK's. The matrix is padded by 3 rows and columns of
zeros for the iteration, as in the JAX module; the padding is only read.
"""

from __future__ import annotations

import math

import torch

from ..ops import eig_qr as kernels

_LN2 = math.log(2.0)
_F64 = torch.float64


def hessenberg(A: torch.Tensor) -> torch.Tensor:
    """A reduced to upper Hessenberg form by Householder similarities."""
    return kernels.hessenberg(A, with_q=False)[0]


def hessenberg_q(A: torch.Tensor):
    """(H, Q) with A = Q H Q'."""
    return kernels.hessenberg(A, with_q=True)


def francis_qr(H: torch.Tensor, n: int, max_iters: int):
    """Francis QR on the (n+3) x (n+3) padded Hessenberg H: (H, ok)."""
    H, _, ok = francis_qr_z(H, n, max_iters, with_z=False)
    return H, ok


def francis_qr_z(H: torch.Tensor, n: int, max_iters: int,
                 with_z: bool = True):
    """Francis QR with the Schur vectors Z (H_in = Z T Z'), Z padded like
    H (None unless `with_z`): (T, Z, ok), ok a bool tensor on H's
    device."""
    T, Z, info = kernels.francis(H, n, max_iters, with_z)
    return T, Z, info[0] != 0


def _balance_step(A: torch.Tensor) -> torch.Tensor:
    """One sweep's power-of-two scales f: A' = A * (f[None, :] / f[:, None])."""
    d = torch.abs(torch.diagonal(A))
    r = torch.sum(torch.abs(A), dim=1) - d       # off-diagonal row norms
    c = torch.sum(torch.abs(A), dim=0) - d       # off-diagonal column norms
    ok = (r > 0) & (c > 0)
    e = torch.round(0.5 * (torch.log(torch.where(ok, r / c, 1.0)) / _LN2))
    return torch.exp2(torch.clamp(e, -60.0, 60.0))


def balance(A: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Parlett-Reinsch-style balancing D^-1 A D with power-of-two scales
    (simultaneous fixed sweeps), as MATLAB's eig balances by default."""
    for _ in range(iters):
        f = _balance_step(A)
        A = A * (f[None, :] / f[:, None])
    return A


def balance_d(A: torch.Tensor, iters: int = 8):
    """(A', d) with A' = D^-1 A D, D = diag(d): the scale maps Schur
    vectors back, V = D V'."""
    dtot = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        f = _balance_step(A)
        A = A * (f[None, :] / f[:, None])
        dtot = dtot * f
    return A, dtot


def _read_off(d, sup, sub, n: int):
    """(wr, wi, is2, prev2) of the 1x1 and 2x2 diagonal blocks given the
    diagonal d, superdiagonal sup and subdiagonal sub (each n long, the
    last of sub 0): a nonzero sub[i] starts a 2x2 block [a b; c d] at
    (i, i+1), whose eigenvalues come from the quadratic formula."""
    zero1 = torch.zeros(1, dtype=d.dtype, device=d.device)
    is2 = sub != 0.0
    dd = torch.cat([d[1:], zero1])
    mean = 0.5 * (d + dd)
    half = 0.5 * (d - dd)
    disc = half * half + sup * sub
    rt = torch.sqrt(torch.abs(disc))
    real_pair = disc >= 0
    wr1 = torch.where(real_pair, mean + rt, mean)
    wr2 = torch.where(real_pair, mean - rt, mean)
    wi1 = torch.where(real_pair, 0.0, rt)
    wi2 = torch.where(real_pair, 0.0, -rt)
    prev2 = torch.cat([torch.zeros(1, dtype=torch.bool, device=d.device),
                       is2[:-1]])
    wr = torch.where(is2, wr1, torch.where(prev2, 0.0, d))
    wi = torch.where(is2, wi1, 0.0)
    # the second member of each block overwrites its own slot
    wr = torch.where(prev2, torch.cat([zero1, wr2[:-1]]), wr)
    wi = torch.where(prev2, torch.cat([zero1, wi2[:-1]]), wi)
    return wr, wi, is2, prev2


def _quasi_eigs(T: torch.Tensor, n: int):
    """(wr, wi, is2, prev2) read off an n x n quasi-triangular block."""
    zero1 = torch.zeros(1, dtype=T.dtype, device=T.device)
    d = torch.diagonal(T)[:n]
    sup = torch.diagonal(T, 1)[:n]
    if sup.shape[0] < n:                 # unpadded n x n input
        sup = torch.cat([sup, torch.zeros(n - sup.shape[0], dtype=T.dtype,
                                          device=T.device)])
    sub = torch.cat([torch.diagonal(T, -1)[:n - 1], zero1])
    return _read_off(d, sup, sub, n)


def trevc(T, wr, wi, is2, prev2):
    """Right eigenvectors of the real quasi-triangular T (dtrevc analog) in
    split re/im planes: (Yr, Yi) with T Y = Y diag(w)."""
    return kernels.trevc(T, wr, wi, is2, prev2)


def _padded(H: torch.Tensor, n: int) -> torch.Tensor:
    Hp = torch.zeros((n + 3, n + 3), dtype=_F64, device=H.device)
    Hp[:n, :n] = H
    return Hp


def eig_full(A: torch.Tensor):
    """[V, D] = eig(A): balance -> Hessenberg(Q) -> Francis QR(Z) ->
    quasi-triangular eigenvectors -> V = D_bal Q Z Y, columns of unit
    norm. Returns (Vr, Vi, wr, wi, ok) in split planes."""
    n = A.shape[0]
    dev = A.device
    one = torch.ones((), dtype=torch.bool, device=dev)
    if n == 0:
        z = torch.zeros(0, dtype=_F64, device=dev)
        zz = torch.zeros((0, 0), dtype=_F64, device=dev)
        return zz, zz, z, z, one
    if n == 1:
        o = torch.ones((1, 1), dtype=_F64, device=dev)
        return o, o * 0.0, A.reshape(-1).to(_F64), \
            torch.zeros(1, dtype=_F64, device=dev), one
    Ab, dbal = balance_d(A.to(_F64))
    Hh, Q = hessenberg_q(Ab)
    Hp, Zp, ok = francis_qr_z(_padded(Hh, n), n, max_iters=40 * n + 100)
    T = Hp[:n, :n].contiguous()
    Z = Zp[:n, :n]
    wr, wi, is2, prev2 = _quasi_eigs(T, n)
    Yr, Yi = trevc(T, wr, wi, is2, prev2)
    QZ = Q @ Z
    Vr = dbal[:, None] * (QZ @ Yr)
    Vi = dbal[:, None] * (QZ @ Yi)
    nrm = torch.sqrt(torch.sum(Vr * Vr + Vi * Vi, dim=0))
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return Vr / nrm, Vi / nrm, wr, wi, ok


def eig_values(A: torch.Tensor):
    """Eigenvalues of a square real matrix: (wr, wi, ok), read off the
    quasi-triangular matrix in the iteration's order."""
    n = A.shape[0]
    dev = A.device
    one = torch.ones((), dtype=torch.bool, device=dev)
    if n == 0:
        z = torch.zeros(0, dtype=_F64, device=dev)
        return z, z, one
    if n == 1:
        return A.reshape(-1), torch.zeros(1, dtype=_F64, device=dev), one
    A = balance(A.to(_F64))
    Hp, ok = francis_qr(_padded(hessenberg(A), n), n, max_iters=40 * n + 100)
    d = torch.diagonal(Hp)[:n]
    sup = torch.diagonal(Hp, 1)[:n]          # H[i, i+1]
    sub = torch.cat([torch.diagonal(Hp, -1)[:n - 1],
                     torch.zeros(1, dtype=_F64, device=dev)])
    wr, wi, _, _ = _read_off(d, sup, sub, n)
    return wr, wi, ok
