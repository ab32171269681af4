"""The port's sparse matrices and device CG against the JAX package, on the
CPU (`runmat_tpu_torch/sparse.py`, `runmat_tpu_torch/ops/spcg.py`).

* `spcg.spmv` on a CPU tensor (its plain version) against the JAX
  package's BCOO matvec built as `runmat_tpu/sparse.py:249-252` builds it,
  on seeded matrices with empty rows and columns, summed duplicate
  triplets and triangles that differ in the last bits: bit-equal, since
  both add each row's products in ascending column order from 0.
* `SparseMatrix._cg_device` under the port's `TorchEngine("cpu")` (the
  plain CG, `spcg.plain_cg`) against `runmat_tpu.sparse.SparseMatrix.
  _cg_device` under `JaxEngine("cpu")`: x within 1e-8 of the largest
  entry (the two sum their dot products in other orders) and each
  column's residual at most 1e-10 of its norm(b) (the loop's own test).
* `A\\b` through both packages' sessions, and `solve`'s routing: n <= 2048
  dense, a symmetric A to CG, an unsymmetric one dense up to 8192 and to
  bicgstab above, the FEA stiffness (whose triangles differ by more than
  `np.allclose` admits) to bicgstab in both.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from runmat_tpu import accel as jaccel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.sparse import SparseMatrix as JaxSparse
from runmat_tpu_torch import accel as taccel
from runmat_tpu_torch.accel.engine import TorchEngine
from runmat_tpu_torch.ops import spcg
from runmat_tpu_torch.sparse import SparseMatrix

from torch_both import close, run_both

X_TOL = 1e-8            # of the largest entry of x
RESIDUAL_TOL = 1e-10    # of norm(b), the loop's stopping test


@pytest.fixture
def engines():
    """Activate JaxEngine("cpu") and TorchEngine("cpu"); restore after."""
    jprev, tprev = jaccel.active_engine(), taccel.active_engine()
    jeng, teng = JaxEngine(platform="cpu"), TorchEngine("cpu")
    jaccel.set_engine(jeng)
    taccel.set_engine(teng)
    yield jeng, teng
    jaccel.set_engine(jprev)
    taccel.set_engine(tprev)


def _triplets(case: str, seed: int):
    rng = np.random.default_rng(seed)
    if case == "empty rows and columns":
        n, k = 400, 900
        ii = rng.integers(0, n, k)
        jj = rng.integers(0, n, k)
        keep = (ii % 7 != 3) & (jj % 5 != 1)      # rows and columns empty
        return n, ii[keep], jj[keep], rng.standard_normal(keep.sum())
    if case == "duplicates":
        n = 300
        ii = np.repeat(rng.integers(0, n, 500), 3)
        jj = np.repeat(rng.integers(0, n, 500), 3)
        return n, ii, jj, rng.standard_normal(ii.size)
    if case == "triangles differ in the last bits":
        n = 350
        i = rng.integers(0, n, 1200)
        j = rng.integers(0, n, 1200)
        v = rng.standard_normal(1200)
        vt = v * (1 + 4 * np.finfo(float).eps * rng.standard_normal(1200))
        return n, np.concatenate([i, j]), np.concatenate([j, i]), \
            np.concatenate([v, vt])
    if case == "a long row":
        n = 5000
        ii = np.concatenate([np.full(4500, 17), rng.integers(0, n, 3000)])
        jj = np.concatenate([rng.permutation(n)[:4500],
                             rng.integers(0, n, 3000)])
        return n, ii, jj, rng.standard_normal(ii.size)
    raise AssertionError(case)


def _csr(A) -> tuple:
    """A's CSR as the port's device path builds it: the CSC of A'."""
    t = A.transpose()
    return (torch.from_numpy(t.indptr.astype(np.int64)),
            torch.from_numpy(t.rowind.astype(np.int32)),
            torch.from_numpy(t.data.astype(np.float64)))


def _bcoo_matvec(A: JaxSparse, p: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    jax.config.update("jax_enable_x64", True)
    ii, jj, vv = A.triplets()
    B = jsparse.BCOO((jnp.asarray(vv), jnp.stack([jnp.asarray(ii),
                                                  jnp.asarray(jj)], axis=1)),
                     shape=(A.m, A.n))
    return np.asarray(B @ jnp.asarray(p))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["empty rows and columns", "duplicates",
                                  "triangles differ in the last bits",
                                  "a long row"])
def test_spmv_equals_the_jax_bcoo_matvec(case, seed):
    n, ii, jj, vv = _triplets(case, seed)
    p = np.random.default_rng(seed + 10).standard_normal(n)
    want = _bcoo_matvec(JaxSparse.from_triplets(ii, jj, vv, n, n), p)
    got = spcg.spmv(*_csr(SparseMatrix.from_triplets(ii, jj, vv, n, n)),
                    torch.from_numpy(p))
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)


def test_spmv_refuses_what_the_kernel_does_not_take():
    rowptr, col, val = _csr(SparseMatrix.from_triplets([0, 1], [1, 0],
                                                       [1.0, 2.0], 2, 2))
    p = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError):
        spcg.spmv(rowptr, col.long(), val, p)
    with pytest.raises(ValueError):
        spcg.spmv(rowptr, col, val, p.float())
    with pytest.raises(ValueError):
        spcg.spmv(rowptr, col, val, torch.ones(3, dtype=torch.float64))


def _poisson(N: int) -> tuple:
    """The five-point stencil of sparse_poisson.m, as triplets."""
    n = N * N
    parts = []
    for off, v in ((-N, -1.0), (-1, -1.0), (0, 4.0), (1, -1.0), (N, -1.0)):
        j = np.arange(max(0, off), min(n, n + off))
        parts.append((j - off, j, np.full(j.size, v)))
    return n, *(np.concatenate(a) for a in zip(*parts))


def _spd(n: int, seed: int) -> tuple:
    """A seeded symmetric, diagonally dominant sparse matrix."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, 6 * n)
    j = rng.integers(0, n, 6 * n)
    v = rng.uniform(-1, 1, 6 * n)
    d = np.arange(n)
    return n, np.concatenate([i, j, d]), np.concatenate([j, i, d]), \
        np.concatenate([v, v, np.full(n, 14.0)])


def _residuals(n, ii, jj, vv, x, b) -> np.ndarray:
    S = sps.csr_matrix((vv, (ii, jj)), shape=(n, n))
    b2 = b.reshape(n, -1)
    return np.linalg.norm(S @ x.reshape(n, -1) - b2, axis=0) / \
        np.linalg.norm(b2, axis=0)


@pytest.mark.parametrize("system,cols", [("poisson 60^2", 1),
                                         ("spd 2500", 1),
                                         ("poisson 60^2", 2)])
def test_cg_matches_the_jax_device_cg(engines, system, cols):
    n, ii, jj, vv = _poisson(60) if system.startswith("poisson") \
        else _spd(2500, 3)
    b = np.random.default_rng(cols).standard_normal((n, cols))
    want = JaxSparse.from_triplets(ii, jj, vv, n, n)._cg_device(b)
    got = SparseMatrix.from_triplets(ii, jj, vv, n, n)._cg_device(b)
    assert got.shape == want.shape == b.shape
    assert np.abs(got - want).max() <= X_TOL * np.abs(want).max()
    assert (_residuals(n, ii, jj, vv, got, b) <= RESIDUAL_TOL).all()
    _, teng = engines
    # one upload each of the CSR's three arrays, invd and each column of b;
    # a copy back of each column's x
    assert teng.stats["uploads"] == 4 + cols
    assert teng.stats["gathers"] == cols


def test_cg_zero_column_returns_zero_without_an_iteration(engines):
    n, ii, jj, vv = _poisson(50)
    b = np.zeros((n, 2))
    b[:, 1] = 1.0
    x = SparseMatrix.from_triplets(ii, jj, vv, n, n)._cg_device(b)
    assert np.array_equal(x[:, 0], np.zeros(n))
    rowptr, col, val = _csr(SparseMatrix.from_triplets(ii, jj, vv, n, n))
    xz, k = spcg.cg(rowptr, col, val, torch.zeros(n, dtype=torch.float64),
                    torch.ones(n, dtype=torch.float64))
    assert k == 0 and not xz.any()


def test_cg_zero_diagonal_and_maxit_match_the_jax_loop(engines):
    # a zero on the diagonal takes 1 in invd (sparse.py:240-244); three
    # iterations of an indefinite system, as the JAX loop stops at maxit
    n, ii, jj, vv = _spd(2100, 5)
    vv = np.where((ii == jj) & (ii == 7), 0.0, vv)
    b = np.random.default_rng(2).standard_normal(n)
    want = JaxSparse.from_triplets(ii, jj, vv, n, n)._cg_device(b, maxit=3)
    A = SparseMatrix.from_triplets(ii, jj, vv, n, n)
    got = A._cg_device(b, maxit=3)
    assert np.abs(got - want).max() <= X_TOL * np.abs(want).max()
    rowptr, col, val = _csr(A)
    invd = torch.from_numpy(1.0 / np.where(A.to_dense().diagonal() == 0, 1.0,
                                           A.to_dense().diagonal()))
    _, k = spcg.cg(rowptr, col, val, torch.from_numpy(b), invd, maxit=3)
    assert k == 3


def test_backslash_through_both_sessions():
    b = run_both("N = 60; n = N^2; e = ones(n, 1);"
                 " A = spdiags([-e -e 4*e -e -e], [-N -1 0 1 N], n, n);"
                 " b = (1 + sin((1:n)' * pi / N)) / (N + 1)^2;",
                 "x = A \\ b; s = sum(x);")
    close(b, ["x", "s"], X_TOL)


def test_sparse_poisson_script_matches_the_jax_package():
    src = open("runmat_tpu_torch/workloads/sparse_poisson.m").read()
    b = run_both("N = 48;", src)
    assert b.jr.output.splitlines()[-1].startswith("RESULT_ok POISSON=")
    close(b, ["x"], X_TOL)
    want = float(b.jr.output.split("POISSON=")[1])
    got = float(b.tr.output.split("POISSON=")[1])
    assert abs(got - want) <= X_TOL * abs(want)


def _tridiagonal(n: int, lo: float, hi: float):
    d = np.arange(n)
    return (np.concatenate([d, d[1:], d[:-1]]),
            np.concatenate([d, d[:-1], d[1:]]),
            np.concatenate([np.full(n, 4.0), np.full(n - 1, lo),
                            np.full(n - 1, hi)]))


@pytest.mark.parametrize("n,lo,hi,route", [
    (2048, -1.0, -1.0, "dense"), (2049, -1.0, -1.0, "cg"),
    (3000, -0.5, -1.5, "dense"), (8193, -0.5, -1.5, "bicgstab")])
def test_solve_routes_as_the_jax_package(engines, monkeypatch, n, lo, hi,
                                         route):
    ii, jj, vv = _tridiagonal(n, lo, hi)
    b = np.random.default_rng(0).standard_normal(n)
    xs = []
    seen = []
    bicgstab = spla.bicgstab
    monkeypatch.setattr(spla, "bicgstab", lambda *a, **k:
                        seen.append("bicgstab") or bicgstab(*a, **k))
    for cls in (JaxSparse, SparseMatrix):
        seen.clear()
        monkeypatch.setattr(cls, "_cg_device",
                            lambda self, bb, *a, _cg=cls._cg_device, **k:
                            seen.append("cg") or _cg(self, bb, *a, **k))
        xs.append(cls.from_triplets(ii, jj, vv, n, n).solve(b))
        assert seen == ([] if route == "dense" else [route]), (cls, seen)
    assert np.abs(xs[1] - xs[0]).max() <= X_TOL * np.abs(xs[0]).max()


def test_fea_stiffness_goes_to_bicgstab_in_both(monkeypatch):
    # the assembled K and K' differ by ~1e-5 on entries of ~1.6e11, more
    # than np.allclose's absolute 1e-8: not symmetric to _is_symmetric
    from runmat_tpu.fea import assembly as jasm
    from runmat_tpu.fea.mesh import box_mesh as jbox
    from runmat_tpu_torch.fea import assembly as tasm
    from runmat_tpu_torch.fea.mesh import box_mesh as tbox
    systems = []
    for box, asm in ((jbox, jasm), (tbox, tasm)):
        mesh = box((10.0, 1.0, 1.0), (60, 6, 6))
        K, _ = asm.assemble_elasticity(mesh, 210e9, 0.3)
        fixed = np.nonzero(mesh.nodes[:, 0] < 1e-12)[0]
        dofs = (3 * fixed[:, None] + np.arange(3)).reshape(-1)
        Kff, ff, _, _ = asm.apply_dirichlet(K, np.ones(K.n), dofs)
        assert Kff.n == 8820 and Kff.nnz == 367398
        assert not Kff._is_symmetric()
        systems.append((Kff, ff))
    (jk, jf), (tk, tf) = systems
    for name in ("indptr", "rowind", "data"):
        assert np.array_equal(getattr(tk, name), getattr(jk, name)), name
    calls = []
    monkeypatch.setattr(spla, "bicgstab", lambda S, bb, **k: calls.append(
        (S.shape, k["rtol"])) or (np.zeros_like(bb), 0))
    for K, f in systems:
        K.solve(f.reshape(-1, 1))
    assert calls == [((8820, 8820), 1e-10)] * 2

