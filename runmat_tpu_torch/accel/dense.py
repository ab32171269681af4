"""DenseOps: the eager dispatcher behind `TorchEngine.linalg` and
`TorchEngine.dense.call`.

Port of `runmat_tpu/accel/dense.py:43-225` on torch tensors. A call looks up
the builder of its kind, brings every operand to the device in its logical
MATLAB shape and the work dtype (complex64/complex128 where an operand is
complex), runs the builder eagerly and returns its tensors;
`TorchEngine.linalg` wraps them as leaf nodes. `compiles`/`cache_hits`
count each call under JaxEngine DenseOps' key (kind, shapes, dtype, opts),
as it counts its jitted builders, so both engines count alike. There is no
warmup record and no failure memo: a failing builder raises, and no kind is
ever sent to the host for good.

A kind without a builder here returns None before it touches an operand, so
the builtin takes its host path; that is counted as a host fallback when an
operand is on the device.

Builders (kind -> (engine, opts) -> fn(*tensors)):
  * `diff`, `trapz`, `movwin`, `sort`, `unique`, `setop`, `mode`,
    `accumarray` and `ismember` are plain torch, as the JAX package leaves
    them to XLA; `histcounts` runs on the hand-written kernel of
    `ops/histogram.py`;
  * the dense linear algebra goes through `torch.linalg` (cuSOLVER on a
    card), as the JAX package's goes through `jnp.linalg`: `solve`,
    `lstsq` (economy QR and a triangular solve), `inv`, `pinv`, `det`,
    `chol` (factor and flag), `qr`, `svd`, `eigh`, `eig_qr` and
    `eig_full` (LAPACK's eigenvalues and vectors in JaxEngine's
    `(wr, wi, flags)` and plane-stack contracts, not its Francis QR),
    `lu`, `trisolve`, `trace`, `ishermitian`, `norm`, `rank`;
  * `fft`, `fft2`, `hilbert` and `spectrogram` through `torch.fft`
    (cuFFT); `conv1`, `conv2` and `fir` through `torch.nn.functional`
    convolutions (cuDNN), with float32 convolutions in true FP32 (TF32 off
    around the call); `iir` on the hand-written kernel of `ops/iir.py`.
Each keeps its JAX builder's output contract (tuple arity, shapes), so the
copied builtins use them unchanged. `spectrogram` returns its result on
the host, as the builtin reads it with `np.asarray` there (a counted
gather), and `eig_full` its flags (a counted read).

The general eigenproblem (`eig_qr`, `eig_full`) is cuSOLVER's geev on
the card under torch 2.11 with CUDA 12.8: the Hessenberg reduction and the
QR sweeps are card kernels, steered from the host through a few hundred
small copies inside the call (`linalgbench.eig_where` lists them).

Waits for the card: torch.linalg's `_ex` forms (`cholesky_ex`, `inv_ex`,
`solve_ex`, `lu_factor_ex`) do not check LAPACK's `info` on the host. The
calls without such a form (`svd`/`svdvals`, `eigh`/`eigvalsh`,
`eig`/`eigvals`) wait inside torch; each such call is counted in
`stats["syncs"]` with its kind in `eng.sync_reasons`, so that every wait is
named (`runmat_tpu_torch/syncs.py` holds the count to the waits torch sees).

The sort family keeps the JAX builders' semantics (`dense.py:534-559`,
755-943), not their padded static shapes: each NaN is its own value and
sorts last ascending, -0 equals 0, ties keep their order, indices come back
1-based in double. The one value read back is a result's length
(`TorchEngine.read_scalar`; accumarray reads its smallest and largest
subscript together, `count_sync`, and raises MATLAB's error for one
outside 1..n); the keys are made canonical (one NaN, +0) first, because a
card's radix sort orders by bit pattern. No builder calls a torch op that
reads a device value back inside torch (`torch.bincount` reads the min and
max of its input, `torch.isin` runs `unique` on a large test set) unless
the wait is counted as above.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..ops import histogram, iir
from ..values import MatArray, normalize_shape
from .lazy import LazyNode

_WORK = {np.dtype(np.float32): torch.float32,
         np.dtype(np.float64): torch.float64,
         np.dtype(np.complex64): torch.complex64,
         np.dtype(np.complex128): torch.complex128}
_NUMPY = {torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64),
          torch.complex64: np.dtype(np.complex64),
          torch.complex128: np.dtype(np.complex128),
          torch.int64: np.dtype(np.int64), torch.bool: np.dtype(np.bool_)}


class DenseOps:
    def __init__(self, eng):
        self.eng = eng
        self._keys: set = set()     # (kind, shapes, dtype, opts) seen

    def work_dtype(self, *xs: MatArray) -> np.dtype:
        """double->f64, single->f32; complex rides the numpy dtype."""
        dts = []
        for x in xs:
            base = np.float32 if x.mclass == "single" else np.float64
            if x.is_complex:
                base = np.complex64 if x.mclass == "single" else np.complex128
            dts.append(np.dtype(base))
        return np.result_type(*dts) if dts else np.dtype(np.float64)

    def _mat(self, x: MatArray, dt: np.dtype) -> torch.Tensor:
        """A MatArray as a device tensor of `dt` in its logical shape."""
        if x.on_device:
            arr = self.eng.materialize(x.dev)
            lshape = tuple(x.dev.shape)
        else:
            h = x.host()
            if x.mclass in ("logical", "char") or h.dtype.kind in "iu":
                h = h.astype(np.float64)
            arr = self.eng.to_device(h)
            lshape = tuple(h.shape)
        if tuple(arr.shape) != lshape:
            arr = arr.reshape(lshape)
        return arr.to(_WORK[dt])

    def _leaf(self, arr: torch.Tensor, mclass: str, lshape=None) -> MatArray:
        eng = self.eng
        shape = normalize_shape(lshape if lshape is not None else arr.shape)
        from .engine import phys_shape
        ps = phys_shape(shape)
        if tuple(arr.shape) != ps:
            arr = arr.reshape(ps)
        node = LazyNode(eng, "leaf", [], (), shape, _NUMPY[arr.dtype],
                             value=arr)
        node.dispatch_id = eng.dispatch_seq
        return MatArray.from_device(node, mclass)

    def _leaf_cplx(self, planes: torch.Tensor, mclass: str,
                   lshape: tuple) -> MatArray:
        """A (2,)+shape stack of real and imaginary planes as a complex
        device leaf (JaxEngine's native-complex branch of `_leaf_cplx`)."""
        return self._leaf(torch.complex(planes[0], planes[1]), mclass,
                          lshape=lshape)

    def call(self, kind: str, xs: list, opts: tuple = ()) -> Optional[list]:
        """Run `kind` on the device. Returns tensors in logical shapes (a
        numpy array where the builtin reads the result on the host), or
        None when the port has no builder for it (the caller's host path)."""
        eng = self.eng
        build = _BUILDERS.get(kind)
        if build is None:
            eng._declines(kind, f"{kind} not ported (A7)", *xs)
            return None
        dt = self.work_dtype(*xs)
        args = [self._mat(x, dt) for x in xs]
        key = (kind, tuple(tuple(a.shape) for a in args), str(dt), opts)
        if key in self._keys:
            eng.stats["cache_hits"] += 1
        else:
            self._keys.add(key)
            eng.stats["compiles"] += 1
        t0 = time.perf_counter()
        out = build(eng, opts)(*args)
        ms = (time.perf_counter() - t0) * 1e3
        if not isinstance(out, tuple):
            out = (out,)
        # a conjugate view (`mH`, an inverse FFT) as a tensor of its own
        out = tuple(o.resolve_conj() if isinstance(o, torch.Tensor) else o
                    for o in out)
        eng.record_launch("linalg", [kind], ms, sum(int(o.nbytes) for o in out))
        eng.stats["dispatches"] += 1
        eng.dispatch_seq += 1
        return list(out)


# --------------------------------------------------------------------------- #
# builders: kind -> (engine, opts) -> fn(*tensors in logical shapes)
# --------------------------------------------------------------------------- #

def _b_diff(eng, opts):
    """diff of order n along an axis (`dense.py:868`)."""
    n, axis = opts

    def f(a):
        return torch.diff(a, n=n, dim=axis)
    return f


def _b_trapz(eng, opts):
    """Trapezoidal integration along an axis, optional sample points, in
    jnp.trapezoid's form: 0.5 * sum(dx * (y[1:] + y[:-1])) over the axis
    moved last (`dense.py:879`)."""
    axis, with_x = opts

    def integrate(y, dx):
        y = torch.movedim(y, axis, -1)
        return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1)

    if with_x:
        def f(x, y):
            return integrate(y, torch.diff(x.reshape(-1)))
        return f

    def f(y):
        return integrate(y, 1.0)
    return f


def _b_movwin(eng, opts):
    """Moving-window sum/mean/max/min of a vector (`dense.py:1035`). MATLAB
    centring: window [i - floor(k/2), i + ceil(k/2) - 1], shrinking at the
    ends; mean divides by the valid count."""
    kind, w = opts
    pad = (w // 2, (w - 1) // 2)

    def windows(v, fill):
        return torch.nn.functional.pad(v, pad, value=fill).unfold(0, w, 1)

    def f(x):
        xv = x.reshape(-1)
        if kind in ("sum", "mean"):
            s = windows(xv, 0.0).sum(-1)
            if kind == "mean":
                s = s / windows(torch.ones_like(xv), 0.0).sum(-1)
            return s.reshape(x.shape)
        if kind == "max":
            return windows(xv, float("-inf")).amax(-1).reshape(x.shape)
        return windows(xv, float("inf")).amin(-1).reshape(x.shape)
    return f


def _b_histcounts(eng, opts):
    """histcounts over explicit edges (`dense.py:946`). Every call goes to
    the histogram kernel, whatever the bin count: search mode in the work
    dtype, or the direct index when the builtin stamped affine edges and the
    work dtype is f32. Counts come back in the work dtype, as the JAX
    builder's `.astype(x.dtype)`."""
    affine = opts[0] if opts else None

    def f(x, edges):
        counts = histogram.histcounts(
            x.reshape(-1), edges.reshape(-1),
            affine if x.dtype == torch.float32 else None)
        return counts.to(x.dtype)
    return f


def _key(v):
    """Sort and membership key: one NaN (it sorts last) and +0 for -0,
    so that a radix sort and `torch.isin` see MATLAB's equalities."""
    return torch.where(torch.isnan(v), torch.full_like(v, float("nan")),
                       v + 0.0)


def _fvec(a):
    """F-order sequence of a logical-shape tensor."""
    return a.permute(*reversed(range(a.ndim))).reshape(-1) if a.ndim > 1 \
        else a.reshape(-1)


def _compact(eng, keep, *vals):
    """The entries of each of `vals` where `keep` holds, in order. Their
    count is read back once; the gather itself needs no further sync."""
    n = int(eng.read_scalar(keep.sum()))
    pos = torch.cumsum(keep, 0) - 1
    dest = torch.where(keep, pos, torch.full_like(pos, n))
    src = torch.arange(keep.numel(), device=keep.device)
    at = torch.empty(n + 1, dtype=torch.int64, device=keep.device)
    at = at.scatter(0, dest, src)[:n]
    return [v[at] for v in vals]


def _isin(a, b):
    """torch.isin(a, b) without a read-back: b sorted, a looked up by a
    binary search. The search runs over b with its NaNs (sorted last) read
    as +Inf, since a NaN in the sequence misleads it; the match is then
    tested against b itself, so NaN finds nothing (NaN != NaN) and +Inf
    finds only +Inf, as in isin."""
    sb = torch.sort(b.reshape(-1)).values
    if sb.numel() == 0:
        return torch.zeros_like(a, dtype=torch.bool)
    keys = torch.where(torch.isnan(sb), torch.full_like(sb, float("inf")),
                       sb)
    pos = torch.searchsorted(keys, a.contiguous()).clamp_(
        max=sb.numel() - 1)
    return sb[pos] == a


def _groups(v):
    """Stable sort of v by key: (sorted order, first-of-group mask, group
    id per sorted element)."""
    sk, si = torch.sort(_key(v), stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]          # NaN != NaN: each its own group
    return si, first, torch.cumsum(first, 0) - 1


def _unique_core(eng, v, stable: bool):
    """(u, ia, ic) of a flat vector, 0-based: u sorted (or by first
    appearance), ia first occurrences, ic with v == u[ic]."""
    si, first, g = _groups(v)
    (ia,) = _compact(eng, first, si)
    ic = torch.empty_like(si).scatter(0, si, g)
    if stable:
        order = torch.argsort(ia)
        ia = ia[order]
        rank = torch.empty_like(order).scatter(
            0, order, torch.arange(order.numel(), device=order.device))
        ic = rank[ic]
    return v[ia], ia, ic


def _b_sort(eng, opts):
    """Stable sort along an axis (`dense.py:534`): descending is the
    ascending sort of the axis-reversed array, mapped back, so NaN comes
    first and ties keep their order."""
    axis, descend, want_idx = opts

    def f(a):
        n = a.shape[axis]
        b = torch.flip(a, (axis,)) if descend else a
        _, idx = torch.sort(_key(b), dim=axis, stable=True)
        if descend:
            idx = torch.flip((n - 1) - idx, (axis,))
        vals = torch.take_along_dim(a, idx, dim=axis)
        if want_idx:
            return vals, (idx + 1).to(torch.float64)
        return vals
    return f


def _b_unique(eng, opts):
    """unique with [U, ia, ic], 1-based indices in double (`dense.py:789`)."""
    (stable,) = opts

    def f(a):
        u, ia, ic = _unique_core(eng, _fvec(a), stable)
        return u, (ia + 1).to(torch.float64), (ic + 1).to(torch.float64)
    return f


def _b_setop(eng, opts):
    """union/intersect/setdiff/setxor (`dense.py:803`): unique passes and
    membership. NaN is never a member of anything, so it stays in setdiff
    and setxor and leaves intersect. Returns (values,) or (values, ia)."""
    op, stable = opts

    def f(a, b):
        va, vb = _fvec(a), _fvec(b)
        if op in ("union", "setxor"):
            u, _, _ = _unique_core(eng, torch.cat([va, vb]),
                                   stable and op == "union")
            if op == "union":
                return (u,)
            ku = _key(u)
            keep = torch.isnan(u) | (_isin(ku, _key(va)) ^ _isin(ku, _key(vb)))
            return tuple(_compact(eng, keep, u))
        ua, ia, _ = _unique_core(eng, va, stable)
        member = _isin(_key(ua), _key(vb))
        keep = member if op == "intersect" else ~member
        return tuple(_compact(eng, keep, ua, (ia + 1).to(torch.float64)))
    return f


def _b_mode(eng, opts):
    """Vector mode (`dense.py:895`): the most frequent non-NaN value, the
    smallest of a tie (the first group in sorted order); NaN when there is
    none. A group's count is found by a binary search for its end among the
    sorted group ids: a scatter-add puts every atomic on one of a few
    addresses when there are few groups, and a running minimum over 2^26
    values is one slow sequential scan on a card."""
    def f(a):
        v = _fvec(a)
        si, first, g = _groups(v)
        pos = torch.arange(v.numel(), device=v.device)
        count = torch.searchsorted(g, g, right=True) - pos
        sv = v[si]
        score = torch.where(first & ~torch.isnan(sv), count,
                            torch.full_like(pos, -1))
        # a one-element index: torch reads a 0-d index tensor back
        return sv[torch.argmax(score).reshape(1)].reshape(())
    return f


# accumarray's partial sums: at most this many (copies x bins) cells
_ACCUM_CELLS = 1 << 24


def _b_accumarray(eng, opts):
    """accumarray(subs, vals, [n 1]) with @sum (`dense.py:917`). The
    smallest and largest subscript are read back together, once (counted),
    and one outside 1..n raises MATLAB's error (the JAX scatter drops or
    wraps it; a card would fault on it). The sums are a scatter-add into
    up to 4096 interleaved copies of the n bins, element i into copy
    i mod copies, then summed over the copies: a scatter-add into n
    addresses alone queues its atomics when n is small (26.3 ms for 2^26
    values into 49 bins on an H100 80GB HBM3), and `torch.bincount` reads
    its input's min and max back inside torch. Sums in float64, as
    bincount's."""
    (out_n,) = opts

    def f(subs, vals):
        idx = subs.reshape(-1).to(torch.int64) - 1
        v = vals.reshape(-1)
        if v.shape[0] == 1:
            v = v.expand(idx.shape)
        if idx.numel():
            ends = torch.stack([idx.min(), idx.max()])
            eng.count_sync(int(ends.nbytes))
            lo, hi = ends.tolist()
            _check_subs(lo, hi, out_n)
        copies = max(1, min(4096, _ACCUM_CELLS // max(out_n, 1)))
        lane = torch.arange(idx.numel(), device=idx.device) % copies
        acc = torch.zeros(copies * out_n, dtype=torch.float64,
                          device=idx.device)
        acc.index_add_(0, lane * out_n + idx, v.to(torch.float64))
        return acc.view(copies, out_n).sum(0).to(v.dtype)
    return f


def _check_subs(lo: int, hi: int, n: int) -> None:
    """MATLAB's accumarray errors for 0-based subscripts lo..hi into n."""
    from ..errors import MatError
    if lo < 0:
        raise MatError("MATLAB:accumarray:nonPosSubs",
                       "First input SUBS must contain positive integer "
                       "subscripts.")
    if hi >= n:
        raise MatError("MATLAB:accumarray:subsExceedSz",
                       "First input SUBS and third input SZ must satisfy "
                       "ALL(MAX(SUBS)<=SZ).")


def _b_ismember(eng, opts):
    """The membership mask of a in b (`dense.py:932`), in a's shape."""
    def f(a, b):
        return _isin(_key(a), _key(b.reshape(-1)))
    return f


@contextlib.contextmanager
def tf32(on: bool, backend: str = "matmul"):
    """TF32 on or off for float32 work on the card inside the block only:
    cuBLAS products (`backend` "matmul") or cuDNN convolutions ("conv"),
    through torch's `fp32_precision` or, before it, `allow_tf32`. torch
    turns TF32 on for convolutions by default; the port's float32
    convolutions run with it off."""
    if backend == "matmul":
        new = old = torch.backends.cuda.matmul
    else:
        new, old = getattr(torch.backends.cudnn, "conv", None), \
            torch.backends.cudnn
    if hasattr(new, "fp32_precision"):
        holder, attr, value = new, "fp32_precision", "tf32" if on else "ieee"
    else:
        holder, attr, value = old, "allow_tf32", on
    prev = getattr(holder, attr)
    setattr(holder, attr, value)
    try:
        yield
    finally:
        setattr(holder, attr, prev)


# --------------------------------------------------------------------------- #
# dense linear algebra (`runmat_tpu/accel/dense.py:232-330, 384-406,
# 518-532, 562-610`)
# --------------------------------------------------------------------------- #

# The waits for the card inside each torch.linalg call that has no `_ex`
# form (it reads LAPACK's `info`, or steers geev from the host), as
# torch's sync debug mode counts them for torch 2.11 on an H100
# (`python3 runmat_tpu_torch/syncs.py` holds every script's count).
_TORCH_WAITS = {"svdvals": 2, "svd": 2, "eigvalsh": 1, "eigh": 1,
                "eigvals": 2, "eig": 3}


def _waits(eng, kind: str, call: str, out: torch.Tensor) -> None:
    """Count the waits of torch.linalg's `call` on the card, named by the
    builder's `kind`."""
    if out.is_cuda:
        for _ in range(_TORCH_WAITS[call]):
            eng.count_sync(4, kind)


def _host(eng, t: torch.Tensor) -> np.ndarray:
    """A result the builtin reads on the host, copied there and counted as
    a gather (the JAX builtin's `np.asarray` of the device array)."""
    eng.stats["gathers"] += 1
    eng.stats["gather_bytes"] += int(t.nbytes)
    return t.cpu().numpy()


def _b_solve(eng, opts):
    def f(a, b):
        return torch.linalg.solve_ex(a, b)[0]
    return f


def _b_lstsq(eng, opts):
    """Least squares by economy QR (`_b_lstsq`): m >= n, x = R \\ Q^H b;
    m < n, the minimum-norm x = Q (R^H \\ b) from the QR of A^H."""
    def f(a, b):
        m, n = a.shape
        if m >= n:
            q, r = torch.linalg.qr(a, mode="reduced")
            return torch.linalg.solve_triangular(r, q.mH @ b, upper=True)
        q, r = torch.linalg.qr(a.mH, mode="reduced")
        return q @ torch.linalg.solve_triangular(r.mH, b, upper=False)
    return f


def _b_inv(eng, opts):
    return lambda a: torch.linalg.inv_ex(a)[0]


def _svd(eng, kind: str, a: torch.Tensor, full: Optional[bool] = None):
    """Singular values (full is None) or (U, s, Vh), the wait counted."""
    if full is None:
        out = torch.linalg.svdvals(a)
        _waits(eng, kind, "svdvals", out)
        return out
    u, s, vh = torch.linalg.svd(a, full_matrices=full)
    _waits(eng, kind, "svd", s)
    return u, s, vh


def _b_pinv(eng, opts):
    """jnp.linalg.pinv's form: singular values above rcond * s_max
    inverted, the rest dropped."""
    rcond = opts[0] if opts else 1e-15

    def f(a):
        u, s, vh = _svd(eng, "pinv", a, full=False)
        keep = s > rcond * s[:1]
        sinv = torch.where(keep, 1.0 / s, torch.zeros_like(s))
        return (vh.mH * sinv.to(vh.dtype)) @ u.mH
    return f


def _b_det(eng, opts):
    """det as the product of the LU factor's diagonal with the pivots'
    sign, from `lu_factor_ex` (no read of `info`)."""
    def f(a):
        lu, piv, _ = torch.linalg.lu_factor_ex(a)
        n = a.shape[0]
        odd = (piv != torch.arange(1, n + 1, device=a.device,
                                   dtype=piv.dtype)).sum() % 2
        sign = 1 - 2 * odd.to(a.real.dtype if a.is_complex() else a.dtype)
        return torch.diagonal(lu).prod() * sign
    return f


def _b_chol(eng, opts):
    """(factor, not-positive-definite flag), `_b_chol`'s contract: the
    input symmetrised as jnp.linalg.cholesky symmetrises it; the flag is
    LAPACK's `info` (or a diagonal entry <= 0 or not finite) unless the
    input holds a NaN, and a failed factor is NaN, as JAX's is."""
    lower = bool(opts and opts[0] == "lower")

    def f(a):
        L, info = torch.linalg.cholesky_ex((a + a.mH) / 2)
        L = torch.where(info != 0, torch.full_like(L, float("nan")), L)
        d = torch.diagonal(L).real
        nan_in = torch.isnan(a).any()
        bad = ((info != 0) | (d <= 0).any() | ~torch.isfinite(d).all()) \
            & ~nan_in
        return (L if lower else L.mH), bad
    return f


def _b_qr(eng, opts):
    mode = "reduced" if (opts and opts[0] == "econ") else "complete"

    def f(a):
        return tuple(torch.linalg.qr(a, mode=mode))
    return f


def _b_svd(eng, opts):
    """('vals',) -> singular values; ('f3',)/('econ3',) -> MATLAB's
    (U, S, V)."""
    mode = opts[0] if opts else "vals"

    def f(a):
        if mode == "vals":
            return _svd(eng, "svd", a)
        u, s, vh = _svd(eng, "svd", a, full=(mode == "f3"))
        S = torch.zeros((u.shape[1], vh.shape[0]), dtype=s.dtype,
                        device=s.device)
        k = min(S.shape)
        S[range(k), range(k)] = s[:k]
        return u, S, vh.mH
    return f


def _b_eigh(eng, opts):
    """('vals',) -> ascending eigenvalues; () -> MATLAB's (V, D)."""
    vals_only = bool(opts and opts[0] == "vals")

    def f(a):
        if vals_only:
            w = torch.linalg.eigvalsh(a)
            _waits(eng, "eigh", "eigvalsh", w)
            return w
        w, v = torch.linalg.eigh(a)
        _waits(eng, "eigh", "eigh", w)
        return v, torch.diag(w)
    return f


def _eig(eng, kind: str, a: torch.Tensor, vectors: bool):
    """Eigenvalues (and vectors) of a real matrix, the waits counted."""
    if vectors:
        w, v = torch.linalg.eig(a)
        _waits(eng, kind, "eig", w)
        return w, v
    w = torch.linalg.eigvals(a)
    _waits(eng, kind, "eigvals", w)
    return w


def _flags(w: torch.Tensor) -> torch.Tensor:
    """[converged, has a complex pair] in float64: LAPACK's geev raises
    where JaxEngine's QR would report no convergence."""
    one = torch.ones((), dtype=torch.float64, device=w.device)
    return torch.stack([one, (w.imag != 0).any().to(torch.float64)])


def _b_eig_qr(eng, opts):
    """General real eigenvalues as `_b_eig_qr`'s (wr, wi, flags), columns
    of n; LAPACK's order, not the Francis QR's (compare sorted)."""
    def f(a):
        w = _eig(eng, "eig_qr", a.to(torch.float64), False)
        return (w.real.reshape(-1, 1).contiguous(),
                w.imag.reshape(-1, 1).contiguous(), _flags(w))
    return f


def _b_eig_full(eng, opts):
    """[V, D] of a real matrix as `_b_eig_full`'s plane stacks (2, n, n)
    and its flags, read on the host (the builtin reads them with
    `np.asarray`); V's columns have unit 2-norm, as MATLAB's."""
    def f(a):
        w, v = _eig(eng, "eig_full", a.to(torch.float64), True)
        V = torch.stack([v.real, v.imag])
        D = torch.stack([torch.diag(w.real), torch.diag(w.imag)])
        flags = _flags(w)
        eng.count_sync(int(flags.nbytes), "eig_full")
        return V, D, flags.cpu().numpy()
    return f


def _b_lu(eng, opts):
    """A = P L U from `lu_factor_ex` and `lu_unpack`. MATLAB's forms:
    '2out' -> (P L, U); '3out' -> (L, U, P^T) with P^T A = L U; '1out' ->
    the strictly lower L plus U."""
    mode = opts[0] if opts else "2out"

    def f(a):
        lu, piv, _ = torch.linalg.lu_factor_ex(a)
        p, l, u = torch.lu_unpack(lu, piv)
        if mode == "3out":
            return l, u, p.mT.contiguous()
        if mode == "1out":
            m, n = a.shape
            k = min(m, n)
            full = torch.zeros((m, n), dtype=a.dtype, device=a.device)
            full[:, :k] = torch.tril(l, -1)
            full[:k, :] += u[:k, :]
            return full
        return p @ l, u
    return f


def _b_trisolve(eng, opts):
    lower, trans = opts

    def f(a, b):
        aa = torch.tril(a) if lower else torch.triu(a)
        if trans:
            return torch.linalg.solve_triangular(aa.mH, b, upper=lower)
        return torch.linalg.solve_triangular(aa, b, upper=not lower)
    return f


def _b_trace(eng, opts):
    return lambda a: torch.diagonal(a).sum()


def _b_ishermitian(eng, opts):
    return lambda a: torch.all(a == a.mH)


def _sq_abs(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 as jnp computes abs(v) ** 2: the modulus, then its square."""
    av = torch.abs(v)
    return av * av


def _b_norm(eng, opts):
    """opts: (ord, is_vector), `_b_norm`'s MATLAB norm surface."""
    p, is_vec = opts

    def f(a):
        if is_vec:
            v = a.reshape(-1)
            if p in (2.0, "fro"):
                # 'fro' of a vector is its 2-norm (the JAX builder raises
                # there, and its failure memo sends `norm` to the host)
                return torch.sqrt(_sq_abs(v).sum())
            if p == np.inf:
                return torch.abs(v).amax()
            if p == -np.inf:
                return torch.abs(v).amin()
            if p == 1.0:
                return torch.abs(v).sum()
            return (torch.abs(v) ** p).sum() ** (1.0 / p)
        if p == "fro":
            return torch.sqrt(_sq_abs(a).sum())
        if p == 1.0:
            return torch.abs(a).sum(0).amax()
        if p == np.inf:
            return torch.abs(a).sum(1).amax()
        return _svd(eng, "norm", a).amax()   # the matrix 2-norm
    return f


def _b_rank(eng, opts):
    (tol,) = opts

    def f(a):
        s = _svd(eng, "rank", a)
        t = s[0] * max(a.shape) * torch.finfo(s.dtype).eps \
            if tol is None else tol
        return (s > t).sum().to(s.dtype)
    return f


# --------------------------------------------------------------------------- #
# FFT and signal filters (`dense.py:612-728, 985-1017`)
# --------------------------------------------------------------------------- #

def _b_fft(eng, opts):
    inverse, n, axis = opts

    def f(a):
        return (torch.fft.ifft if inverse else torch.fft.fft)(a, n=n,
                                                               dim=axis)
    return f


def _b_fft2(eng, opts):
    (inverse,) = opts

    def f(a):
        return torch.fft.ifft2(a) if inverse else torch.fft.fft2(a)
    return f


def _one_sided(npts: int, device) -> torch.Tensor:
    """The analytic signal's weights: 1 at DC (and Nyquist), 2 for the
    positive frequencies, 0 for the negative ones; made on the device."""
    k = torch.arange(npts, device=device)
    edge = (k == 0) | ((k == npts // 2) if npts % 2 == 0 else (k < 0))
    # (assignments into a slice or an element of a card tensor wait for it)
    return torch.where(edge, 1.0, torch.where(
        k < (npts + 1) // 2, 2.0, 0.0)).to(torch.float64)


def _b_hilbert(eng, opts):
    """Analytic signal by one-sided weighting between fft and ifft; its
    modulus for the envelope."""
    npts, envelope = opts

    def f(x):
        sp = torch.fft.fft(x.reshape(-1), npts)
        analytic = torch.fft.ifft(sp * _one_sided(npts, x.device))
        return torch.abs(analytic) if envelope else analytic
    return f


def _b_spectrogram(eng, opts):
    """STFT: frames of x by `unfold`, windowed, one batched fft, the first
    nbins bins, (nbins, nwin); returned on the host (see the module doc)."""
    nseg, hop, nf, nwin, nbins = opts

    def f(x, w):
        segs = x.reshape(-1).unfold(0, nseg, hop)[:nwin] * w.reshape(1, -1)
        S = torch.fft.fft(segs, nf, dim=1)[:, :nbins]
        return _host(eng, S.mT)
    return f


def _conv1d(x: torch.Tensor, k: torch.Tensor, lo: int, hi: int):
    """Correlation of the flat x, padded (lo, hi) with zeros, with k."""
    xp = torch.nn.functional.pad(x.reshape(1, 1, -1), (lo, hi))
    with tf32(False, "conv"):
        return torch.nn.functional.conv1d(xp, k.reshape(1, 1, -1))[0, 0]


def _b_conv1(eng, opts):
    """jnp.convolve(a, b, mode) of the flattened operands: the longer one
    slides, the other flipped; 'same' pads (k//2, k - k//2 - 1)."""
    (mode,) = opts

    def f(a, b):
        x, k = a.reshape(-1), b.reshape(-1)
        if x.numel() < k.numel():
            x, k = k, x
        m = k.numel()
        lo, hi = {"valid": (0, 0), "same": (m // 2, m - m // 2 - 1),
                  "full": (m - 1, m - 1)}[mode]
        return _conv1d(x, torch.flip(k, (0,)), lo, hi)
    return f


def _b_conv2(eng, opts):
    """2-D convolution: correlation with the doubly flipped kernel, padded
    per MATLAB's mode ('same' keeps the centred window)."""
    (mode,) = opts

    def f(a, b):
        kh, kw = b.shape
        if mode == "full":
            pad = (kw - 1, kw - 1, kh - 1, kh - 1)
        elif mode == "same":
            r0, c0 = (kh - 1) // 2, (kw - 1) // 2
            pad = (kw - 1 - c0, c0, kh - 1 - r0, r0)
        else:
            pad = (0, 0, 0, 0)
        ap = torch.nn.functional.pad(a[None, None], pad)
        with tf32(False, "conv"):
            return torch.nn.functional.conv2d(
                ap, torch.flip(b, (0, 1))[None, None])[0, 0]
    return f


def _b_fir(eng, opts):
    """filter(b, 1, x): the causal convolution's first n samples."""
    def f(x, b):
        nb = b.numel()
        return _conv1d(x, torch.flip(b.reshape(-1), (0,)), nb - 1, 0)
    return f


def _b_iir(eng, opts):
    """filter(b, a, x) in direct form II transposed from the state z0: the
    hand-written kernel of `ops/iir.py` on a card, its plain version (the
    scan's step) on the CPU."""
    def f(x, b, a, z0):
        return iir.iir(x.reshape(-1), b.reshape(-1), a.reshape(-1),
                       z0.reshape(-1))
    return f


# --------------------------------------------------------------------------- #
# pages, interpolation and selection (`dense.py:407-520, 730-751,
# 1019-1032`)
# --------------------------------------------------------------------------- #

def _page_stack(a):
    """(m, n, ...pages) -> ((pages, m, n), page shape): the pages in F
    order, as the JAX builders' `_page_stack` (`dense.py:407-413`) stacks
    them (a view where torch can)."""
    if a.ndim == 2:
        return a[None], ()
    ps = tuple(a.shape[2:])
    lead = tuple(range(a.ndim - 1, 1, -1))   # the last page dim varies slowest
    return a.permute(*lead, 0, 1).reshape(-1, a.shape[0], a.shape[1]), ps


def _page_unstack(r, ps):
    """(pages, m, n) -> (m, n, *ps), the inverse of `_page_stack`, laid
    out contiguous."""
    if not ps:
        return r[0].contiguous()
    k = len(ps)
    r = r.reshape(tuple(reversed(ps)) + tuple(r.shape[1:]))
    return r.permute(k, k + 1, *range(k - 1, -1, -1)).contiguous()


def _page_pair(pa, pb):
    """One page set broadcast against many (`dense.py:439-442`)."""
    if pa.shape[0] == 1 and pb.shape[0] > 1:
        pa = pa.expand((pb.shape[0],) + tuple(pa.shape[1:]))
    if pb.shape[0] == 1 and pa.shape[0] > 1:
        pb = pb.expand((pa.shape[0],) + tuple(pb.shape[1:]))
    return pa, pb


def _b_pagemtimes(eng, opts):
    """Batched page product with 'none'/'transpose'/'ctranspose' on each
    side: one batched product under the session's precision policy (a
    float32 product in true FP32 under "highest")."""
    from .engine import _matmul
    ta, tb = opts

    def tr(p, mode):
        if mode == "transpose":
            return p.transpose(1, 2)
        if mode == "ctranspose":
            return p.transpose(1, 2).conj()
        return p

    def f(a, b):
        (pa, psa), (pb, psb) = _page_stack(a), _page_stack(b)
        pa, pb = _page_pair(tr(pa, ta), tr(pb, tb))
        r = _matmul(pa, pb, eng.matmul_precision)
        if r.shape[0] == 1:
            return r[0]
        return _page_unstack(r, psa or psb)
    return f


@contextlib.contextmanager
def cusolver(t: torch.Tensor):
    """torch's cuSOLVER/cuBLAS route for the LU of a batch of card matrices
    inside the block. For a batch of small matrices (8192 pages of 32 x 32)
    torch 2.11's default takes MAGMA, whose batched LU waits for the card
    where torch's sync debug mode does not see it; cuBLAS's batched LU
    does not wait (`linalgbench.host_waits`, PERF.md)."""
    if not t.is_cuda:
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _b_pageinv(eng, opts):
    """Per-page inverse; a singular page gives Inf/NaN, as jnp.linalg.inv,
    with LAPACK's `info` left on the device."""
    def f(a):
        pa, ps = _page_stack(a)
        with cusolver(pa):
            return _page_unstack(torch.linalg.inv_ex(pa)[0], ps)
    return f


def _b_pagesolve(eng, opts):
    """Per-page A \\ B for square pages, one page set against many."""
    def f(a, b):
        (pa, psa), (pb, psb) = _page_stack(a), _page_stack(b)
        pa, pb = _page_pair(pa, pb)
        with cusolver(pa):
            return _page_unstack(torch.linalg.solve_ex(pa, pb)[0],
                                 psa or psb)
    return f


def _b_pagenorm(eng, opts):
    """Per-page matrix norm of ord 'fro', 1, 2 or inf, in jnp.linalg.norm's
    arithmetic; ord 2 is the largest singular value (its wait counted)."""
    from .engine import reshape_f
    (ordv,) = opts

    def f(a):
        pa, ps = _page_stack(a)
        if ordv == "fro":
            r = torch.sqrt((pa * pa.conj()).real.sum((1, 2)))
        elif ordv == 1:
            r = torch.abs(pa).sum(1).amax(1)
        elif ordv == np.inf:
            r = torch.abs(pa).sum(2).amax(1)
        else:
            r = _svd(eng, "pagenorm", pa).amax(1)
        return reshape_f(r, (1, 1) + ps) if ps else r.reshape(1, 1)
    return f


def _b_pagectranspose(eng, opts):
    """Per-page transpose, conjugated unless opts[0] is False."""
    conj = opts[0] if opts else True

    def f(a):
        pa, ps = _page_stack(a)
        r = pa.transpose(1, 2)
        return _page_unstack(r.conj() if conj else r, ps)
    return f


def _b_interp1lin(eng, opts):
    """Linear interp1 with NaN outside [x(1), x(end)]. The JAX builder takes
    each query's interval from a broadcast count, sum(q >= x), which is
    Nq * Nk compares; here the count is a binary search over the knots
    sorted (a NaN knot read as +Inf, so never counted below +Inf), which
    gives the same count for any knots: a query of +Inf does not count the
    NaN knots, a NaN query counts none. The interval is clipped to [0,
    n-2] and the knots and values gathered from the unsorted operands, and
    the lerp keeps the JAX builder's order of operations (not torch.lerp,
    which rounds otherwise for weights of 1/2 and more)."""
    def f(x, v, q):
        xv, vv, qv = x.reshape(-1), v.reshape(-1), q.reshape(-1)
        n = xv.numel()
        nan = torch.isnan(xv)
        keys = torch.sort(torch.where(nan, torch.full_like(xv, np.inf),
                                      xv)).values
        cnt = torch.searchsorted(keys, qv.contiguous(), right=True)
        cnt = cnt - torch.where(qv == np.inf, nan.sum(), 0)
        cnt = torch.where(torch.isnan(qv), 0, cnt)
        idx = torch.clamp(cnt - 1, 0, n - 2)
        x0, x1 = xv[idx], xv[idx + 1]
        v0, v1 = vv[idx], vv[idx + 1]
        r = v0 + (v1 - v0) * ((qv - x0) / (x1 - x0))
        oob = (qv < xv[0]) | (qv > xv[-1])
        return torch.where(oob, torch.full_like(r, np.nan), r).reshape(
            q.shape)
    return f


def _total_order(key):
    """Integers ordered as the floats of `key` in IEEE total order (-0 below
    +0), as lax.top_k compares them."""
    it = {torch.float32: torch.int32, torch.float64: torch.int64}[key.dtype]
    bits = key.view(it)
    return bits ^ ((bits >> (bits.element_size() * 8 - 1))
                   & torch.iinfo(it).max)


def _b_topk(eng, opts):
    """maxk/mink of a vector: the k largest of key = v (maxk) or -v (mink),
    a NaN key read as -Inf, in lax.top_k's order: descending in total
    order, ties to the lower index (a stable sort; torch.topk does not
    promise the tie order, which decides NaN against -Inf in maxk and
    against +Inf in mink)."""
    k, largest = opts

    def f(x):
        v = x.reshape(-1)
        key = v if largest else -v
        key = torch.where(torch.isnan(key), torch.full_like(key, -np.inf),
                          key)
        idx = torch.sort(_total_order(key), descending=True,
                         stable=True).indices[:k]
        return v[idx]
    return f


_BUILDERS = {"diff": _b_diff, "trapz": _b_trapz, "movwin": _b_movwin,
             "histcounts": _b_histcounts, "sort": _b_sort,
             "unique": _b_unique, "setop": _b_setop, "mode": _b_mode,
             "accumarray": _b_accumarray, "ismember": _b_ismember,
             "solve": _b_solve, "lstsq": _b_lstsq, "inv": _b_inv,
             "pinv": _b_pinv, "det": _b_det, "chol": _b_chol, "qr": _b_qr,
             "svd": _b_svd, "eigh": _b_eigh, "eig_qr": _b_eig_qr, "eig_full": _b_eig_full, "lu": _b_lu,
             "trisolve": _b_trisolve, "trace": _b_trace,
             "ishermitian": _b_ishermitian, "norm": _b_norm,
             "rank": _b_rank, "fft": _b_fft,
             "fft2": _b_fft2, "hilbert": _b_hilbert,
             "spectrogram": _b_spectrogram, "conv1": _b_conv1,
             "conv2": _b_conv2, "fir": _b_fir, "iir": _b_iir,
             "pagemtimes": _b_pagemtimes, "pageinv": _b_pageinv,
             "pagesolve": _b_pagesolve, "pagenorm": _b_pagenorm,
             "pagectranspose": _b_pagectranspose,
             "interp1lin": _b_interp1lin, "topk": _b_topk}
