"""The order in which the sparse CG kernels sum, modelled in torch ops on
the CPU (`runmat_tpu_torch/ops/spcg.py`: `ordered_sum`, `ordered_dot`,
`plain_cg(..., ordered=True)`).

* `ordered_sum` against the kernels' order written out as a loop over
  Python floats (each tile's tree of THREADS values, the last tile padded
  with 0.0; then lane t adds the partials of tiles t, t + THREADS, ...
  from 0.0, and the tree over the lanes): bit for bit,
  on seeded values over twelve decades at lengths that fill no tile, one
  tile, one tile and one value, 16 tiles and 4097 tiles (lane 0 holding
  17 partials, the others 16).
* `ordered_dot` within 1e-15 relative of `np.dot` on positive inputs.
* `plain_cg(..., ordered=True)`, the model the kernels' x and k equal bit
  for bit on the card, against `runmat_tpu.sparse.SparseMatrix._cg_device`
  under `JaxEngine("cpu")`: x within `spbench.X_TOL` of the largest entry
  (the JAX loop's vdots sum in XLA's order), the residual at most 1e-10 of
  norm(b); a zero b is done before the first iteration, and maxit stops it.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from runmat_tpu import accel as jaccel
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.sparse import SparseMatrix as JaxSparse
from runmat_tpu_torch import spbench
from runmat_tpu_torch.ops import spcg
from runmat_tpu_torch.sparse import SparseMatrix

LENGTHS = [1, 255, 256, 257, 4096, 256 * 4096 + 3]


def _tree(values: list) -> float:
    """block_sum: at s = 128, ..., 1, sh[t] = sh[t] + sh[t + s], t < s."""
    sh = list(values)
    s = spcg.THREADS // 2
    while s:
        for t in range(s):
            sh[t] = sh[t] + sh[t + s]
        s //= 2
    return sh[0]


def _kernel_order(v: np.ndarray) -> float:
    T = spcg.THREADS
    n = v.size
    nb = max(1, -(-n // T))
    vals = v.tolist() + [0.0] * (nb * T - n)
    parts = [_tree(vals[b * T:(b + 1) * T]) for b in range(nb)]
    lanes = []
    for t in range(T):
        acc = 0.0
        for j in range(t, nb, T):
            acc = acc + parts[j]
        lanes.append(acc)
    return _tree(lanes)


@pytest.mark.parametrize("n", LENGTHS)
def test_ordered_sum_is_the_kernels_order_bit_for_bit(n):
    rng = np.random.default_rng(n)
    v = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    got = spcg.ordered_sum(torch.from_numpy(v))
    assert got.dim() == 0 and got.dtype == torch.float64
    assert float(got) == _kernel_order(v)


@pytest.mark.parametrize("n", LENGTHS)
def test_ordered_dot_is_close_to_np_dot(n):
    rng = np.random.default_rng(100 + n)
    a, b = rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n)
    got = float(spcg.ordered_dot(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(np.dot(a, b))
    assert abs(got - want) <= 1e-15 * want


@pytest.fixture
def jax_engine():
    prev = jaccel.active_engine()
    jaccel.set_engine(JaxEngine(platform="cpu"))
    yield
    jaccel.set_engine(prev)


def _system(name: str) -> tuple:
    """(n, ii, jj, vv): the five-point stencil on a 60^2 grid, or a seeded
    symmetric, diagonally dominant matrix of 2500 rows."""
    if name == "poisson 60^2":
        N = 60
        n = N * N
        parts = []
        for off, v in ((-N, -1.0), (-1, -1.0), (0, 4.0), (1, -1.0),
                       (N, -1.0)):
            j = np.arange(max(0, off), min(n, n + off))
            parts.append((j - off, j, np.full(j.size, v)))
        return n, *(np.concatenate(a) for a in zip(*parts))
    rng = np.random.default_rng(3)
    n = 2500
    i, j = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    v = rng.uniform(-1, 1, 6 * n)
    d = np.arange(n)
    return n, np.concatenate([i, j, d]), np.concatenate([j, i, d]), \
        np.concatenate([v, v, np.full(n, 14.0)])


def _csr(n, ii, jj, vv) -> tuple:
    """A's CSR as the port's device path builds it: the CSC of A'."""
    return spbench.csr_of(SparseMatrix.from_triplets(ii, jj, vv, n, n),
                          torch.device("cpu"))


@pytest.mark.parametrize("name", ["poisson 60^2", "spd 2500"])
def test_ordered_cg_matches_the_jax_device_cg(jax_engine, name):
    n, ii, jj, vv = _system(name)
    b = np.random.default_rng(7).standard_normal(n)
    want = JaxSparse.from_triplets(ii, jj, vv, n, n)._cg_device(b)
    rowptr, col, val = _csr(n, ii, jj, vv)
    invd = spbench.inverse_diagonal(rowptr, col, val)
    x, k = spcg.plain_cg(rowptr, col, val, torch.from_numpy(b), invd,
                         ordered=True)
    got = x.numpy()
    assert k > 0 and got.shape == want.shape
    assert np.abs(got - want).max() <= spbench.X_TOL * np.abs(want).max()
    S = sps.csr_matrix((vv, (ii, jj)), shape=(n, n))
    assert np.linalg.norm(S @ got - b) <= spbench.RESIDUAL_TOL * \
        np.linalg.norm(b)
    # the plain loop's x (torch.dot, the CPU route) is another order's
    xp, kp = spcg.plain_cg(rowptr, col, val, torch.from_numpy(b), invd)
    assert abs(kp - k) <= 1
    assert np.abs(xp.numpy() - got).max() <= spbench.X_TOL * \
        np.abs(want).max()


def test_ordered_cg_zero_b_and_maxit():
    n, ii, jj, vv = _system("spd 2500")
    rowptr, col, val = _csr(n, ii, jj, vv)
    invd = spbench.inverse_diagonal(rowptr, col, val)
    x, k = spcg.plain_cg(rowptr, col, val, torch.zeros(n, dtype=torch.float64),
                         invd, ordered=True)
    assert k == 0 and not x.any()
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    x3, k3 = spcg.plain_cg(rowptr, col, val, b, invd, maxit=3, ordered=True)
    xp3, _ = spcg.plain_cg(rowptr, col, val, b, invd, maxit=3)
    assert k3 == 3
    assert (x3 - xp3).abs().max() <= 1e-12 * xp3.abs().max()
