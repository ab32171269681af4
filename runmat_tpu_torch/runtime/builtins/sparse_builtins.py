"""Copy of runmat_tpu/runtime/builtins/sparse_builtins.py in the PyTorch port.

Sparse builtin family: sparse/full/speye/spdiags/sprand/... and helpers.

Reference parity: the SparseTensor builtins
(crates/runmat-builtins/src/lib.rs:439-441 and runmat-runtime sparse ops).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...sparse import SparseMatrix
from ...values import MatArray
from ..registry import builtin


def _ints(v) -> np.ndarray:
    return v.host().astype(np.float64).reshape(-1).astype(np.int64)


@builtin("sparse", category="math/sparse", min_in=1, max_in=6)
def m_sparse(*args):
    if len(args) == 1:
        a = args[0]
        if isinstance(a, SparseMatrix):
            return a
        return SparseMatrix.from_dense(a.host().astype(np.float64), "double")
    if len(args) == 2:
        m, n = (int(_ints(a)[0]) for a in args)
        return SparseMatrix(m, n, np.zeros(n + 1, np.int64),
                            np.zeros(0, np.int64), np.zeros(0))
    ii = _ints(args[0]) - 1
    jj = _ints(args[1]) - 1
    vv = args[2].host().astype(np.float64).reshape(-1)
    if len(args) >= 5:
        m, n = int(_ints(args[3])[0]), int(_ints(args[4])[0])
    else:
        m = int(ii.max()) + 1 if ii.size else 0
        n = int(jj.max()) + 1 if jj.size else 0
    if ii.size and (ii.min() < 0 or jj.min() < 0):
        raise bad_arg("sparse", "Index into matrix must be positive.")
    return SparseMatrix.from_triplets(ii, jj, vv, m, n)


@builtin("full", category="math/sparse", min_in=1, max_in=1)
def m_full(a):
    if isinstance(a, SparseMatrix):
        return a.to_matarray()
    return a


@builtin("issparse", category="math/sparse", min_in=1, max_in=1)
def m_issparse(a):
    return MatArray.logical_scalar(isinstance(a, SparseMatrix))


@builtin("speye", category="math/sparse", min_in=1, max_in=2)
def m_speye(m, n=None):
    mm = int(_ints(m)[0])
    nn = int(_ints(n)[0]) if n is not None else mm
    k = min(mm, nn)
    idx = np.arange(k, dtype=np.int64)
    return SparseMatrix.from_triplets(idx, idx, np.ones(k), mm, nn)


@builtin("spones", category="math/sparse", min_in=1, max_in=1)
def m_spones(a):
    if not isinstance(a, SparseMatrix):
        a = SparseMatrix.from_dense(a.host())
    return a.map_nonzeros(lambda d: np.ones_like(d))


@builtin("spalloc", category="math/sparse", min_in=3, max_in=3)
def m_spalloc(m, n, nz):
    return SparseMatrix(int(_ints(m)[0]), int(_ints(n)[0]),
                        np.zeros(int(_ints(n)[0]) + 1, np.int64),
                        np.zeros(0, np.int64), np.zeros(0))


@builtin("sprand", category="math/sparse", min_in=2, max_in=3, pass_ctx=True)
def m_sprand(m, n=None, density=None, ctx=None):
    if isinstance(m, SparseMatrix) and n is None:
        from ...ops import ctrng
        vals = ctrng.host_rand(ctx.session.rng, m.nnz, "double")
        return m.map_nonzeros(lambda d: vals)
    mm, nn = int(_ints(m)[0]), int(_ints(n)[0])
    dens = float(density.host().reshape(-1)[0]) if density is not None else 0.1
    k = int(round(mm * nn * dens))
    from ...ops import ctrng
    u = ctrng.host_rand(ctx.session.rng, 2 * k + k, "double")
    ii = np.minimum((u[:k] * mm).astype(np.int64), mm - 1)
    jj = np.minimum((u[k:2 * k] * nn).astype(np.int64), nn - 1)
    vv = u[2 * k:]
    return SparseMatrix.from_triplets(ii, jj, vv, mm, nn)


@builtin("spdiags", category="math/sparse", min_in=1, max_in=4,
         pass_nargout=True)
def m_spdiags(B, d=None, m=None, n=None, nargout=1):
    if m is None:
        # extraction forms: [Bd, d] = spdiags(A) / Bd = spdiags(A, d)
        if isinstance(B, SparseMatrix):
            ha = B.to_dense()
        else:
            ha = B.host().astype(np.float64)
        if ha.ndim != 2:
            raise bad_arg("spdiags", "Expected a matrix.")
        mm0, nn0 = ha.shape
        if d is None:
            ds = np.array(sorted(
                dk for dk in range(-(mm0 - 1), nn0)
                if np.any(np.diagonal(ha, dk))), dtype=np.int64)
        else:
            ds = _ints(d)
        p = min(mm0, nn0)
        out = np.zeros((p, ds.size))
        for col, dk in enumerate(ds):
            j = np.arange(max(0, dk), min(nn0, mm0 + dk), dtype=np.int64)
            i = j - dk
            # MATLAB row placement: column index j when m >= n, row index i
            # when m < n (doc: spdiags extraction alignment)
            out[(j if mm0 >= nn0 else i), col] = ha[i, j]
        Bd = MatArray(out, "double")
        if nargout >= 2:
            return [Bd, MatArray(ds.astype(np.float64).reshape(-1, 1),
                                 "double")]
        return Bd
    hb = B.host().astype(np.float64)
    if hb.ndim == 1:
        hb = hb.reshape(-1, 1)
    ds = _ints(d)
    mm = int(_ints(m)[0])
    nn = int(_ints(n)[0])
    ii_all, jj_all, vv_all = [], [], []
    for col, dk in enumerate(ds):
        j = np.arange(max(0, dk), min(nn, mm + dk), dtype=np.int64)
        i = j - dk
        # MATLAB reads the diagonal values from rows matching the COLUMN index
        vals = hb[j if mm >= nn else j, col] if hb.shape[0] >= j.size + int(max(0, dk)) \
            else hb[np.clip(j, 0, hb.shape[0] - 1), col]
        vals = hb[np.clip(j, 0, hb.shape[0] - 1), col]
        keep = vals != 0
        ii_all.append(i[keep])
        jj_all.append(j[keep])
        vv_all.append(vals[keep])
    ii = np.concatenate(ii_all) if ii_all else np.zeros(0, np.int64)
    jj = np.concatenate(jj_all) if jj_all else np.zeros(0, np.int64)
    vv = np.concatenate(vv_all) if vv_all else np.zeros(0)
    return SparseMatrix.from_triplets(ii, jj, vv, mm, nn)


@builtin("nonzeros", category="math/sparse", min_in=1, max_in=1)
def m_nonzeros(a):
    if isinstance(a, SparseMatrix):
        ii, jj, vv = a.triplets()
        order = np.lexsort((ii, jj))
        return MatArray(vv[order].reshape(-1, 1), "double")
    h = a.host()
    flat = h.reshape(-1, order="F")
    return MatArray(flat[flat != 0].reshape(-1, 1).astype(np.float64), "double")
