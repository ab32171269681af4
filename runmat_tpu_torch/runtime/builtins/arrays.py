"""Copy of runmat_tpu/runtime/builtins/arrays.py in the PyTorch port.

Two things differ from the source:
* `_dev_structural` reports an exception of the device route to the engine
  (`note_fallback`, counted in `host_fallbacks` with its reason in the
  launch log) before the host path gathers the operand, where the source
  drops it silently;
* the host `reshape` and `squeeze` return a copy where numpy would return a
  view of the input (`_unshared`): the source's view let a later indexed
  write into the result change the input too (`A = reshape(x, 4, 2);
  A(1) = 99` changed x).

Array shape/manipulation builtins: size/reshape/permute/cat/repmat/find/...

Reference parity: runmat-runtime/src/builtins/array/{indexing,reshape,...}.
Column-major semantics throughout (Fortran-order reshape/linearization,
≙ Tensor column-major storage runmat-builtins/src/lib.rs:426-436).
"""

from __future__ import annotations

import numpy as np

from ... import dtypes
from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StringArray, StructArray,
                       fortran_ravel, fortran_reshape, normalize_shape, is_text,
                       text_of, shape_of, numel)
from ..concat import cat as concat_cat
from ..registry import builtin
from .common import scalar_int


def _data_like(x):
    if isinstance(x, MatArray):
        return x.host()
    if isinstance(x, (CellArray, StringArray)):
        return x.data
    raise bad_arg("array", f"Unsupported input of class {type(x).__name__}.")


def _rewrap(x, d: np.ndarray):
    if isinstance(x, MatArray):
        return MatArray(d, x.mclass)
    if isinstance(x, CellArray):
        return CellArray(d)
    if isinstance(x, StringArray):
        return StringArray(d)
    raise AssertionError


def _unshared(r: np.ndarray, d: np.ndarray) -> np.ndarray:
    """r, or a copy of it where it is a view of d's buffer: MATLAB values
    never share storage, and the VM writes in place into unshared ones."""
    return r.copy() if np.may_share_memory(r, d) else r


def _dev_structural(op, xs, static, out_shape):
    """Device route for structural array ops: stays in the lazy DAG (no
    gather) when any operand is device-resident."""
    if not all(isinstance(x, MatArray) for x in xs):
        return None
    if not any(x.on_device for x in xs):
        return None
    from ...accel import active_engine
    eng = active_engine()
    if eng is None:
        return None
    try:
        return eng.structural(op, xs, static, out_shape)
    except Exception as e:
        eng.note_fallback(op, f"{type(e).__name__}: {e}")
        return None


@builtin("size", category="array", min_in=1, pass_nargout=True)
def m_size(x, *dims, nargout=1):
    shape = shape_of(x)
    if dims:
        if len(dims) == 1 and isinstance(dims[0], MatArray) and dims[0].size > 1:
            idxs = [int(v) for v in dims[0].host().reshape(-1)]
        else:
            idxs = [scalar_int(d, "dim") for d in dims]
        vals = [float(shape[i - 1]) if i - 1 < len(shape) else 1.0 for i in idxs]
        if nargout <= 1:
            return MatArray(np.array(vals, dtype=np.float64).reshape(1, -1), "double")
        return [MatArray.scalar(v) for v in vals[:nargout]]
    if nargout <= 1:
        return MatArray(np.array(shape, dtype=np.float64).reshape(1, -1), "double")
    out = []
    for i in range(nargout):
        if i < nargout - 1:
            out.append(MatArray.scalar(float(shape[i]) if i < len(shape) else 1.0))
        else:
            rest = 1.0
            for d in shape[i:]:
                rest *= d
            out.append(MatArray.scalar(rest))
    return out


@builtin("numel", category="array", min_in=1, max_in=1)
def m_numel(x):
    return MatArray.scalar(float(numel(x)))


@builtin("length", category="array", min_in=1, max_in=1)
def m_length(x):
    s = shape_of(x)
    if numel(x) == 0:
        return MatArray.scalar(0.0)
    return MatArray.scalar(float(max(s)))


@builtin("ndims", category="array", min_in=1, max_in=1)
def m_ndims(x):
    return MatArray.scalar(float(len(shape_of(x))))


@builtin("reshape", category="array", min_in=2)
def m_reshape(x, *dims):
    # dims: sizes or [] placeholder (at most one)
    sizes: list = []
    if len(dims) == 1 and isinstance(dims[0], MatArray) and dims[0].size > 1:
        sizes = [int(v) for v in dims[0].host().reshape(-1)]
    else:
        for d in dims:
            if isinstance(d, MatArray) and d.size == 0:
                sizes.append(-1)
            else:
                sizes.append(scalar_int(d, "size"))
    n = numel(x)
    if sizes.count(-1) > 1:
        raise bad_arg("reshape", "Size can only contain one unknown dimension.")
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        if known == 0 or n % known != 0:
            raise bad_arg("reshape", "Product of known dimensions not divisible into numel.")
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise MatError("MATLAB:getReshapeDims:notSameNumel",
                       "To RESHAPE the number of elements must not change.")
    if isinstance(x, MatArray) and x.on_device:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            return eng.reshape(x, tuple(sizes))
    d = _data_like(x)
    return _rewrap(x, _unshared(fortran_reshape(d, normalize_shape(sizes)), d))


@builtin("permute", category="array", min_in=2, max_in=2)
def m_permute(x, order):
    p = [int(v) - 1 for v in order.host().reshape(-1)]
    if isinstance(x, MatArray) and x.on_device:
        nd = max(len(p), len(x.shape))
        exp = tuple(x.shape) + (1,) * (nd - len(x.shape))
        if sorted(p) == list(range(nd)):
            out_shape = tuple(exp[i] for i in p)
            out = _dev_structural("permuteL", [x], (tuple(p), exp),
                                  out_shape)
            if out is not None:
                return out
    d = _data_like(x)
    nd = max(len(p), d.ndim)
    while d.ndim < nd:
        d = d.reshape(d.shape + (1,))
    if sorted(p) != list(range(nd)):
        raise bad_arg("permute", "ORDER must be a permutation of 1:ndims(A).")
    return _rewrap(x, np.transpose(d, p).copy())


@builtin("ipermute", category="array", min_in=2, max_in=2)
def m_ipermute(x, order):
    p = [int(v) - 1 for v in order.host().reshape(-1)]
    inv = np.argsort(p) + 1
    return m_permute(x, MatArray(inv.reshape(1, -1).astype(np.float64), "double"))


@builtin("squeeze", category="array", min_in=1, max_in=1)
def m_squeeze(x):
    if isinstance(x, MatArray) and x.on_device:
        shape = x.shape
        if len(shape) <= 2:
            return x
        new_shape = normalize_shape(tuple(s for s in shape if s != 1))
        out = _dev_structural("reshapeF", [x], (tuple(new_shape),),
                              new_shape)
        if out is not None:
            return out
    d = _data_like(x)
    if d.ndim <= 2:
        return x
    new_shape = tuple(s for s in d.shape if s != 1)
    return _rewrap(x, _unshared(d.reshape(normalize_shape(new_shape)), d))


@builtin("repmat", category="array", min_in=2)
def m_repmat(x, *reps):
    if len(reps) == 1 and isinstance(reps[0], MatArray) and reps[0].size > 1:
        r = [int(v) for v in reps[0].host().reshape(-1)]
    elif len(reps) == 1:
        n = scalar_int(reps[0])
        r = [n, n]
    else:
        r = [scalar_int(v) for v in reps]
    if isinstance(x, MatArray) and x.on_device:
        exp = tuple(x.shape) + (1,) * max(0, len(r) - len(x.shape))
        rr = list(r) + [1] * (len(exp) - len(r))
        out_shape = tuple(s * m for s, m in zip(exp, rr))
        out = _dev_structural("tileL", [x], (tuple(rr), exp), out_shape)
        if out is not None:
            return out
    d = _data_like(x)
    while d.ndim < len(r):
        d = d.reshape(d.shape + (1,))
    while len(r) < d.ndim:
        r.append(1)
    return _rewrap(x, np.tile(d, r))


@builtin("cat", category="array", min_in=1)
def m_cat(dim, *parts):
    ax = scalar_int(dim, "dim") - 1
    ps = list(parts)
    if not ps:
        return MatArray.empty()
    # align ndim for axis >= current dims
    return concat_cat(ax, ps)


@builtin("horzcat", category="array", min_in=0)
def m_horzcat(*parts):
    return concat_cat(1, list(parts))


@builtin("vertcat", category="array", min_in=0)
def m_vertcat(*parts):
    return concat_cat(0, list(parts))


@builtin("flipud", category="array", min_in=1, max_in=1)
def m_flipud(x):
    out = _dev_structural("flipL", [x], (0,), getattr(x, "shape", None))
    if out is not None:
        return out
    return _rewrap(x, np.flip(_data_like(x), axis=0).copy())


@builtin("fliplr", category="array", min_in=1, max_in=1)
def m_fliplr(x):
    out = _dev_structural("flipL", [x], (1,), getattr(x, "shape", None))
    if out is not None:
        return out
    return _rewrap(x, np.flip(_data_like(x), axis=1).copy())


@builtin("flip", category="array", min_in=1, max_in=2)
def m_flip(x, dim=None):
    if isinstance(x, MatArray) and x.on_device:
        shape = x.shape
        ax = scalar_int(dim) - 1 if dim is not None else \
            (0 if shape[0] != 1 else 1)
        if 0 <= ax < len(shape):
            out = _dev_structural("flipL", [x], (ax,), shape)
            if out is not None:
                return out
    d = _data_like(x)
    ax = scalar_int(dim) - 1 if dim is not None else (0 if d.shape[0] != 1 else 1)
    return _rewrap(x, np.flip(d, axis=ax).copy())


@builtin("rot90", category="array", min_in=1, max_in=2)
def m_rot90(x, k=None):
    n = scalar_int(k) if k is not None else 1
    if isinstance(x, MatArray) and x.on_device and len(x.shape) == 2:
        shape = x.shape if n % 2 == 0 else (x.shape[1], x.shape[0])
        out = _dev_structural("rot90L", [x], (n % 4,), shape)
        if out is not None:
            return out
    return _rewrap(x, np.rot90(_data_like(x), n).copy())


@builtin("circshift", category="array", min_in=2, max_in=3)
def m_circshift(x, shift, dim=None):
    if isinstance(x, MatArray) and x.on_device:
        shape = x.shape
        if dim is not None:
            ax = scalar_int(dim) - 1
            if 0 <= ax < len(shape):
                out = _dev_structural("rollL", [x],
                                      (scalar_int(shift), ax), shape)
                if out is not None:
                    return out
        elif isinstance(shift, MatArray) and shift.size > 1:
            sh = tuple(int(v) for v in shift.host().reshape(-1))
            if len(sh) <= len(shape):
                out = _dev_structural("rollL", [x],
                                      (sh, tuple(range(len(sh)))), shape)
                if out is not None:
                    return out
        else:
            ax = 0 if shape[0] != 1 else 1
            out = _dev_structural("rollL", [x], (scalar_int(shift), ax),
                                  shape)
            if out is not None:
                return out
    d = _data_like(x)
    if dim is not None:
        return _rewrap(x, np.roll(d, scalar_int(shift), axis=scalar_int(dim) - 1))
    if isinstance(shift, MatArray) and shift.size > 1:
        sh = [int(v) for v in shift.host().reshape(-1)]
        return _rewrap(x, np.roll(d, sh, axis=tuple(range(len(sh)))))
    n = scalar_int(shift)
    ax = 0 if d.shape[0] != 1 else 1
    return _rewrap(x, np.roll(d, n, axis=ax))


@builtin("diag", category="array", min_in=1, max_in=2)
def m_diag(x, k=None):
    kk = scalar_int(k) if k is not None else 0
    h = x.host()
    if h.ndim == 2 and 1 in h.shape and h.size >= 1:
        v = h.reshape(-1)
        return MatArray(np.diag(v, kk), x.mclass)
    return MatArray(np.diag(h, kk).reshape(-1, 1), x.mclass)


@builtin("tril", category="array", min_in=1, max_in=2)
def m_tril(x, k=None):
    kk = scalar_int(k) if k is not None else 0
    if isinstance(x, MatArray) and x.on_device and len(x.shape) == 2:
        out = _dev_structural("trilL", [x], (kk,), x.shape)
        if out is not None:
            return out
    return MatArray(np.tril(x.host(), kk), x.mclass)


@builtin("triu", category="array", min_in=1, max_in=2)
def m_triu(x, k=None):
    kk = scalar_int(k) if k is not None else 0
    if isinstance(x, MatArray) and x.on_device and len(x.shape) == 2:
        out = _dev_structural("triuL", [x], (kk,), x.shape)
        if out is not None:
            return out
    return MatArray(np.triu(x.host(), kk), x.mclass)


@builtin("kron", category="array", min_in=2, max_in=2)
def m_kron(a, b):
    if isinstance(a, MatArray) and isinstance(b, MatArray) and \
            (a.on_device or b.on_device) and len(a.shape) == 2 and \
            len(b.shape) == 2 and not a.is_complex and not b.is_complex and \
            a.mclass in ("double", "single") and \
            b.mclass in ("double", "single"):
        out_shape = (a.shape[0] * b.shape[0], a.shape[1] * b.shape[1])
        out = _dev_structural("kronL", [a, b], (), out_shape)
        if out is not None:
            return out
    out_class = dtypes.combine_classes(a.mclass, b.mclass)
    # complex operands keep their imaginary parts (an f64 cast silently
    # discarded them)
    dt = np.complex128 if (a.is_complex or b.is_complex) else np.float64
    r = np.kron(a.host().astype(dt), b.host().astype(dt))
    if np.iscomplexobj(r):
        return MatArray(r, out_class)
    return MatArray(dtypes.cast_to_class(r, out_class), out_class)


@builtin("find", category="array", min_in=1, max_in=3, pass_nargout=True)
def m_find(x, n=None, direction=None, nargout=1):
    """find is inherently a device->host sync (the result SHAPE depends on the
    data, which XLA cannot express). For device operands the comparison mask
    is computed ON device (fused with any pending producer chain) and only the
    packed logical array crosses the link — 8x less transfer than gathering
    the payload (≙ provider find + download, api lib.rs find methods)."""
    if type(x).__name__ == "SparseMatrix":
        x = x.to_matarray()
    if isinstance(x, MatArray) and x.on_device and nargout <= 2 \
            and x.mclass != "logical":
        from ..dispatch import binary as _bin
        x = _bin("ne", x, MatArray.scalar(0.0))
    h = x.host()
    flat = fortran_ravel(h)
    idx = np.nonzero(flat != 0)[0]
    if direction is not None and text_of(direction) == "last":
        if n is not None:
            idx = idx[-scalar_int(n):]
    elif n is not None:
        idx = idx[:scalar_int(n)]
    is_row = h.ndim == 2 and h.shape[0] == 1 and h.shape[1] > 1
    def shape_out(v):
        a = np.asarray(v, dtype=np.float64)
        return MatArray(a.reshape(1, -1) if is_row else a.reshape(-1, 1), "double")
    if nargout <= 1:
        return shape_out(idx + 1)
    rows, cols = np.unravel_index(idx, (h.shape[0], int(np.prod(h.shape[1:]))), order="F")
    out = [shape_out(rows + 1), shape_out(cols + 1)]
    if nargout >= 3:
        out.append(shape_out(flat[idx]))
    return out


@builtin("diff", category="array", min_in=1, max_in=3)
def m_diff(x, n=None, dim=None):
    if type(x).__name__ == "SymValue":
        from .symbolic import _diff
        return _diff(x, n, dim)
    if isinstance(x, MatArray) and x.on_device and not x.is_complex:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            order = scalar_int(n) if n is not None else 1
            shape = x.shape
            ax = scalar_int(dim) - 1 if dim is not None else \
                (0 if shape[0] != 1 else 1)
            if 0 <= ax < len(shape) and shape[ax] > order:
                out = eng.linalg("diff", [x], (order, ax),
                                 out_class=x.mclass if x.mclass in
                                 ("double", "single") else "double")
                if out is not None:
                    return out[0]
    h = x.host()
    order = scalar_int(n) if n is not None else 1
    ax = scalar_int(dim) - 1 if dim is not None else (0 if h.shape[0] != 1 else 1)
    acc = "double" if x.mclass in ("logical", "char") else x.mclass
    r = np.diff(h.astype(np.float64) if h.dtype.kind in "bu" else h, n=order, axis=ax)
    return MatArray(dtypes.cast_to_class(r, acc) if dtypes.is_integer_class(acc) else r, acc)


@builtin("sub2ind", category="array", min_in=2)
def m_sub2ind(sz, *subs):
    shape = tuple(int(v) for v in sz.host().reshape(-1))
    idxs = [s.host().astype(np.int64).reshape(-1) - 1 for s in subs]
    lin = np.ravel_multi_index(idxs, shape, order="F") + 1
    first = subs[0].host()
    return MatArray(lin.astype(np.float64).reshape(first.shape), "double")


@builtin("ind2sub", category="array", min_in=2, pass_nargout=True)
def m_ind2sub(sz, ind, nargout=1):
    shape = tuple(int(v) for v in sz.host().reshape(-1))
    ih = ind.host()
    lin = ih.astype(np.int64).reshape(-1) - 1
    n_out = max(nargout, 1)
    if n_out < len(shape):
        fold = 1
        for d in shape[n_out - 1:]:
            fold *= d
        shape = shape[:n_out - 1] + (fold,)
    subs = np.unravel_index(lin, shape, order="F")
    out = [MatArray(s.astype(np.float64).reshape(ih.shape) + 1, "double") for s in subs]
    return out[:n_out]


@builtin("meshgrid", category="array", min_in=1, max_in=3, pass_nargout=True)
def m_meshgrid(x, y=None, z=None, nargout=1):
    xv = x.host().reshape(-1)
    yv = y.host().reshape(-1) if y is not None else xv
    if z is None and y is None and nargout >= 3:
        # [X,Y,Z] = meshgrid(x): 3-D grid from the single vector
        z = x
    if z is None:
        X, Y = np.meshgrid(xv, yv)
        res = [MatArray(X.astype(np.float64), "double"), MatArray(Y.astype(np.float64), "double")]
        return res[:max(1, nargout)]
    zv = z.host().reshape(-1)
    X, Y, Z = np.meshgrid(xv, yv, zv)
    return [MatArray(X.astype(np.float64), "double"),
            MatArray(Y.astype(np.float64), "double"),
            MatArray(Z.astype(np.float64), "double")][:max(1, nargout)]


@builtin("ndgrid", category="array", min_in=1, pass_nargout=True)
def m_ndgrid(*args, nargout=1):
    vs = [a.host().reshape(-1) for a in args]
    if len(vs) == 1:
        vs = vs * max(nargout, 1)
    grids = np.meshgrid(*vs, indexing="ij")
    return [MatArray(g.astype(np.float64), "double") for g in grids][:max(1, nargout)]


@builtin("transpose", category="array", min_in=1, max_in=1)
def m_transpose(x):
    from ..dispatch import transpose
    return transpose(x)


@builtin("ctranspose", category="array", min_in=1, max_in=1)
def m_ctranspose(x):
    from ..dispatch import ctranspose
    return ctranspose(x)


@builtin("accumarray", category="array", min_in=2, max_in=4)
def m_accumarray(subs, vals, sz=None, fn=None):
    if fn is None and isinstance(vals, MatArray) and vals.on_device and \
            not vals.is_complex and isinstance(subs, MatArray) and \
            len(subs.shape) == 2 and subs.shape[1] == 1:
        from ...accel import active_engine
        eng = active_engine()
        if eng is not None:
            if sz is not None:
                n = int(sz.host().reshape(-1)[0])
            elif not subs.on_device:
                idx0 = subs.host().astype(np.int64).reshape(-1)
                n = int(idx0.max()) if idx0.size else 0   # subs are 1-based
            else:
                n = 0
            if n > 0:
                # one device scatter-add; only the output size is host-side
                out = eng.linalg("accumarray", [subs, vals], (n,),
                                 out_class="double")
                if out is not None:
                    return out[0]
    sh = subs.host().astype(np.int64)
    if sh.ndim == 2 and sh.shape[1] == 1:
        idx = sh.reshape(-1) - 1
        n = int(sz.host().reshape(-1)[0]) if sz is not None else (int(idx.max()) + 1 if idx.size else 0)
        if idx.size:
            # MATLAB's errors, on this path as on the device's (np.add.at
            # would wrap 0 onto the last element); the port's repair
            from ...accel.dense import _check_subs
            _check_subs(int(idx.min()), int(idx.max()), n)
        v = vals.host().astype(np.float64).reshape(-1)
        out = np.zeros(n, dtype=np.float64)
        np.add.at(out, idx, v if v.size > 1 else np.full(idx.shape, v[0] if v.size else 0.0))
        return MatArray(out.reshape(-1, 1), "double")
    raise bad_arg("accumarray", "Only column-subscript accumarray is supported for now.")


@builtin("linindex", category="array", min_in=2, max_in=2)
def m_linindex(x, idx):
    # internal helper (not a MATLAB builtin): A(idx) linear read
    from ...vm import indexing as IX
    return IX.read_paren(x, [idx])


@builtin("numArgumentsFromSubscript", category="array", min_in=0)
def m_nargs_from_subscript(*args):
    return MatArray.scalar(1.0)
