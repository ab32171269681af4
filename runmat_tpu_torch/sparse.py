"""Copy of runmat_tpu/sparse.py in the PyTorch port.

Sparse matrices: CSC storage with MATLAB semantics.

Reference parity: Value::SparseTensor — CSC matrices
(crates/runmat-builtins/src/lib.rs:439-441) and the sparse builtin family.

TPU-first notes: the host representation is CSC (column-major, like MATLAB);
large solves and matvecs lower to a jax BCOO matmul / CG iteration on device
(jax.experimental.sparse), where XLA turns the gather-scatter into efficient
TPU code. Elementwise ops between sparse operands stay sparse; any op with a
dense operand densifies (MATLAB's rule for +, elementwise fns of nonzero
preserving ops keep sparsity).

In the port, `_cg_device` runs the same Jacobi-preconditioned CG on the
active TorchEngine's device through `ops/spcg.py`: on a card the
hand-written kernels of `csrc/spcg.cu` over a CSR of A (the CSC of A',
built once a solve), K iterations a captured CUDA graph, the host reading
the done flag once a chunk; on the CPU the same loop's plain PyTorch
version. With no engine active, the host CG below runs, as in the JAX
package.
"""

from __future__ import annotations

import time

import numpy as np

from .errors import MatError
from .values import MatArray


class SparseMatrix:
    """CSC sparse double (or logical) matrix."""

    __slots__ = ("m", "n", "indptr", "rowind", "data", "mclass", "shared")

    def __init__(self, m: int, n: int, indptr, rowind, data, mclass="double"):
        self.m = int(m)
        self.n = int(n)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.rowind = np.asarray(rowind, dtype=np.int64)
        self.data = np.asarray(data)
        self.mclass = mclass
        self.shared = False

    def to_scipy(self):
        """scipy.sparse CSC view (host helper bridges: ARPACK eigs/svds,
        csgraph orderings — the system-LAPACK analog)."""
        import scipy.sparse as sps
        return sps.csc_matrix((self.data, self.rowind, self.indptr),
                              shape=(self.m, self.n))

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_dense(h: np.ndarray, mclass="double") -> "SparseMatrix":
        h = np.asarray(h)
        if h.ndim != 2:
            h = h.reshape(1, -1) if h.ndim < 2 else h.reshape(h.shape[0], -1)
        m, n = h.shape
        indptr = [0]
        rows = []
        vals = []
        for j in range(n):
            nz = np.nonzero(h[:, j])[0]
            rows.append(nz)
            vals.append(h[nz, j])
            indptr.append(indptr[-1] + nz.size)
        rowind = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        data = np.concatenate(vals) if vals else np.zeros(0, h.dtype)
        return SparseMatrix(m, n, indptr, rowind, data, mclass)

    @staticmethod
    def from_triplets(ii, jj, vv, m, n) -> "SparseMatrix":
        ii = np.asarray(ii, dtype=np.int64)
        jj = np.asarray(jj, dtype=np.int64)
        vv = np.asarray(vv, dtype=np.float64)
        if vv.size == 1 and ii.size > 1:
            vv = np.full(ii.size, vv.reshape(-1)[0])
        order = np.lexsort((ii, jj))
        ii, jj, vv = ii[order], jj[order], vv[order]
        # duplicates accumulate (MATLAB rule)
        if ii.size:
            key = jj * np.int64(m) + ii
            uniq, inv = np.unique(key, return_inverse=True)
            acc = np.zeros(uniq.size, dtype=np.float64)
            np.add.at(acc, inv, vv)
            ii = (uniq % m).astype(np.int64)
            jj = (uniq // m).astype(np.int64)
            vv = acc
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, jj + 1, 1)
        indptr = np.cumsum(indptr)
        return SparseMatrix(m, n, indptr, ii, vv)

    # -- basics ---------------------------------------------------------------

    @property
    def shape(self) -> tuple:
        return (self.m, self.n)

    @property
    def size(self) -> int:
        return self.m * self.n

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def copy(self) -> "SparseMatrix":
        return SparseMatrix(self.m, self.n, self.indptr.copy(),
                            self.rowind.copy(), self.data.copy(), self.mclass)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n),
                       dtype=self.data.dtype if self.data.size else np.float64)
        for j in range(self.n):
            s, e = self.indptr[j], self.indptr[j + 1]
            out[self.rowind[s:e], j] = self.data[s:e]
        return out

    def to_matarray(self) -> MatArray:
        return MatArray(self.to_dense().astype(
            np.float64 if self.mclass == "double" else np.bool_), self.mclass)

    def triplets(self):
        jj = np.repeat(np.arange(self.n, dtype=np.int64),
                       np.diff(self.indptr))
        return self.rowind.copy(), jj, self.data.copy()

    def transpose(self) -> "SparseMatrix":
        ii, jj, vv = self.triplets()
        return SparseMatrix.from_triplets(jj, ii, vv, self.n, self.m)

    def map_nonzeros(self, fn) -> "SparseMatrix":
        out = self.copy()
        out.data = fn(out.data)
        return out

    def prune(self) -> "SparseMatrix":
        """Drop stored zeros."""
        ii, jj, vv = self.triplets()
        keep = vv != 0
        return SparseMatrix.from_triplets(ii[keep], jj[keep], vv[keep],
                                          self.m, self.n)

    # -- arithmetic ------------------------------------------------------------

    def _binary_sparse(self, other: "SparseMatrix", fn) -> "SparseMatrix":
        if self.shape != other.shape:
            raise MatError("MATLAB:dimagree", "Matrix dimensions must agree.")
        ia, ja, va = self.triplets()
        ib, jb, vb = other.triplets()
        ka = ja * np.int64(self.m) + ia
        kb = jb * np.int64(self.m) + ib
        keys = np.union1d(ka, kb)
        a = np.zeros(keys.size)
        b = np.zeros(keys.size)
        a[np.searchsorted(keys, ka)] = va
        b[np.searchsorted(keys, kb)] = vb
        vv = fn(a, b)
        keep = vv != 0
        return SparseMatrix.from_triplets((keys % self.m)[keep],
                                          (keys // self.m)[keep], vv[keep],
                                          self.m, self.n)

    def matmul(self, other) -> np.ndarray:
        """Sparse @ dense -> dense (column-by-column accumulate)."""
        B = np.asarray(other, dtype=np.float64)
        if B.ndim == 1:
            B = B.reshape(-1, 1)
        if self.n != B.shape[0]:
            raise MatError("MATLAB:innerdim",
                           "Incorrect dimensions for matrix multiplication.")
        out = np.zeros((self.m, B.shape[1]))
        for j in range(self.n):
            s, e = self.indptr[j], self.indptr[j + 1]
            if e > s:
                out[self.rowind[s:e], :] += self.data[s:e, None] * B[j, :]
        return out

    def spmm(self, other: "SparseMatrix") -> "SparseMatrix":
        ii, jj, vv = [], [], []
        for j in range(other.n):
            s, e = other.indptr[j], other.indptr[j + 1]
            col = np.zeros(self.m)
            for k in range(s, e):
                kk = other.rowind[k]
                sa, ea = self.indptr[kk], self.indptr[kk + 1]
                col[self.rowind[sa:ea]] += self.data[sa:ea] * other.data[k]
            nz = np.nonzero(col)[0]
            ii.append(nz)
            jj.append(np.full(nz.size, j, dtype=np.int64))
            vv.append(col[nz])
        ii = np.concatenate(ii) if ii else np.zeros(0, np.int64)
        jj = np.concatenate(jj) if jj else np.zeros(0, np.int64)
        vv = np.concatenate(vv) if vv else np.zeros(0)
        return SparseMatrix.from_triplets(ii, jj, vv, self.m, other.n)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """A \\ b. Small systems densify; large symmetric systems run CG on
        the accel device via a BCOO matvec (TPU path); large unsymmetric
        fall back to dense with a size guard."""
        if self.m != self.n:
            # least squares via dense QR
            return np.linalg.lstsq(self.to_dense(), b, rcond=None)[0]
        if self.n <= 2048:
            return np.linalg.solve(self.to_dense(), b)
        if self._is_symmetric():
            return self._cg_device(b)
        if self.n <= 8192:
            return np.linalg.solve(self.to_dense(), b)
        # large unsymmetric: Jacobi-preconditioned BiCGSTAB over the scipy
        # CSR matvec (≙ the reference FEA solve stack's iterative fallback)
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
        ii, jj, vv = self.triplets()
        S = sp.csr_matrix((vv.astype(np.float64), (ii, jj)),
                          shape=(self.m, self.n))
        d = S.diagonal()
        M = sp.diags(1.0 / np.where(d == 0, 1.0, d))
        bb = np.asarray(b, dtype=np.float64)
        one_d = bb.ndim == 1
        bb = bb.reshape(self.n, -1)
        out = np.empty_like(bb)
        for c in range(bb.shape[1]):
            x, info = spla.bicgstab(S, bb[:, c], M=M, rtol=1e-10,
                                    maxiter=10 * self.n)
            if info != 0:
                raise MatError("MATLAB:sparse:solverFailed",
                               f"Iterative solve did not converge "
                               f"(info={info}).")
            out[:, c] = x
        return out[:, 0] if one_d else out

    def _is_symmetric(self) -> bool:
        t = self.transpose()
        if t.nnz != self.nnz:
            return False
        return (np.array_equal(t.indptr, self.indptr)
                and np.array_equal(t.rowind, self.rowind)
                and np.allclose(t.data, self.data))

    def _cg_device(self, b: np.ndarray, tol=1e-10, maxit=None) -> np.ndarray:
        """Conjugate gradient with Jacobi preconditioning, on the active
        engine's device (`ops/spcg.cg`), one column of b at a time; each
        solution is copied back to the host."""
        from .accel import active_engine
        eng = active_engine()
        ii, jj, vv = self.triplets()
        diag = np.ones(self.n)
        dmask = ii == jj
        diag_idx = ii[dmask]
        diag[diag_idx] = vv[dmask]
        inv_d = 1.0 / np.where(diag == 0, 1.0, diag)
        if eng is not None:
            from .ops import spcg
            # the CSC of A' is the CSR of A; A' differs from A where the
            # two triangles differ within _is_symmetric's tolerance
            csr = self.transpose()
            bb = b.reshape(self.n, -1)
            cols = []
            with eng.lock:
                rowptr, col, val, invd = (eng.to_device(np.ascontiguousarray(
                    h, dtype=dt)) for h, dt in (
                        (csr.indptr, np.int64),
                        (csr.rowind, np.int32),
                        (csr.data, np.float64), (inv_d, np.float64)))
                for c in range(bb.shape[1]):
                    bv = eng.to_device(np.ascontiguousarray(bb[:, c],
                                                            dtype=np.float64))
                    t0 = time.perf_counter()
                    x, k = spcg.cg(rowptr, col, val, bv, invd, tol,
                                   maxit or 10 * self.n, cache=eng.spcg_cache,
                                   count_read=lambda nbytes: eng.count_sync(
                                       nbytes, "cg"))
                    eng.record_launch("sparse_cg", ["cg"],
                                      (time.perf_counter() - t0) * 1e3,
                                      int(x.nbytes))
                    eng.launch_log[-1].update(n=self.n, nnz=csr.nnz,
                                              iterations=k)
                    eng.stats["gathers"] += 1
                    eng.stats["gather_bytes"] += int(x.nbytes)
                    cols.append(x.cpu().numpy())
            return np.stack(cols, axis=1).reshape(b.shape)
        # no engine active: the host CG, the JAX package's route for a
        # session without acceleration
        bb = b.reshape(self.n, -1)
        cols = []
        for c in range(bb.shape[1]):
            x = np.zeros(self.n)
            r = bb[:, c].astype(np.float64)
            z = inv_d * r
            p = z.copy()
            rz = r @ z
            for _ in range(maxit or 10 * self.n):
                Ap = self.matmul(p).reshape(-1)
                alpha = rz / (p @ Ap)
                x += alpha * p
                r -= alpha * Ap
                if np.linalg.norm(r) <= tol * np.linalg.norm(bb[:, c]):
                    break
                z = inv_d * r
                rz_new = r @ z
                p = z + (rz_new / rz) * p
                rz = rz_new
            cols.append(x)
        return np.stack(cols, axis=1).reshape(b.shape)
