"""Copy of runmat_tpu/vm/indexing.py in the PyTorch port.

MATLAB subscript engine: paren/brace read & write, growing, deletion.

Reference parity: runmat-vm/src/indexing/{plan,read_slice,write_slice,
write_linear}.rs — the MATLAB indexing rules (1-based, end-arithmetic resolved
upstream, column-major linear order, implicit growth on paren-write, deletion
via `A(i) = []`). Host-side numpy implementation; device-resident arrays take a
slice fast path through the accel engine and otherwise gather
(≙ gather-and-retry, runmat-runtime/src/dispatcher.rs:67-200).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .. import dtypes
from ..errors import MatError, bad_index
from ..values import (CellArray, MatArray, OutputList, StringArray, StructArray,
                      fortran_ravel, fortran_reshape, normalize_shape)


class ColonMark:
    """Runtime marker for a bare ':' subscript."""
    __slots__ = ()


COLON = ColonMark()


# --------------------------------------------------------------------------- #
# subscript normalization
# --------------------------------------------------------------------------- #

def _sub_to_indices(arg, dim_size: int, allow_grow: bool) -> np.ndarray:
    """Convert one subscript to a 0-based int index vector (Fortran element
    order for array subscripts)."""
    if isinstance(arg, ColonMark):
        return np.arange(dim_size, dtype=np.int64)
    if isinstance(arg, MatArray):
        h = arg.host()
        if arg.mclass == "logical":
            flat = fortran_ravel(h)
            if flat.size > dim_size:
                # allowed if the extra entries are all false
                if flat[dim_size:].any() and not allow_grow:
                    raise bad_index("Index exceeds array bounds.")
            idx = np.nonzero(flat)[0].astype(np.int64)
            if not allow_grow and idx.size and idx[-1] >= dim_size:
                raise bad_index("Index exceeds array bounds.")
            return idx
        if h.dtype.kind == "c":
            raise MatError("MATLAB:badsubscript",
                           "Array indices must be positive integers or logical values.")
        flat = fortran_ravel(h).astype(np.float64)
        if flat.size and (np.any(flat < 1) or np.any(flat != np.floor(flat)) or np.any(~np.isfinite(flat))):
            raise MatError("MATLAB:badsubscript",
                           "Array indices must be positive integers or logical values.")
        idx = flat.astype(np.int64) - 1
        if not allow_grow and idx.size and idx.max() >= dim_size:
            raise bad_index(
                f"Index exceeds the number of array elements. Index must not exceed {dim_size}.")
        return idx
    raise MatError("MATLAB:badsubscript",
                   "Array indices must be positive integers or logical values.")


def _is_colon(arg) -> bool:
    return isinstance(arg, ColonMark)


def _folded_shape(shape: tuple[int, ...], nargs: int) -> tuple[int, ...]:
    """Shape seen by an nargs-subscript access: trailing dims fold into the last."""
    if nargs >= len(shape):
        return shape + (1,) * (nargs - len(shape))
    folded = 1
    for d in shape[nargs - 1:]:
        folded *= d
    return shape[:nargs - 1] + (folded,)


def _data_of(base):
    if isinstance(base, MatArray):
        return base.host()
    if isinstance(base, (CellArray, StringArray)):
        return base.data
    if type(base).__name__ in ("SymValue",):
        return base.exprs
    if type(base).__name__ in ("MatDatetime", "MatDuration"):
        # datetime64/timedelta64 arrays index like numerics (≙ the
        # registered datetime.subsref/duration.subsref method builtins,
        # runmat-runtime/src/builtins/datetime/mod.rs:2850)
        return base.data
    raise MatError("MATLAB:badsubscript", f"Cannot index value of class {type(base).__name__}.")


def _rewrap(base, data: np.ndarray):
    if isinstance(base, MatArray):
        return MatArray(data, base.mclass)
    if isinstance(base, CellArray):
        return CellArray(data)
    if isinstance(base, StringArray):
        return StringArray(data)
    if type(base).__name__ == "SymValue":
        return type(base)(data, data.shape)
    if type(base).__name__ in ("MatDatetime", "MatDuration"):
        return type(base)(data)
    raise AssertionError


# --------------------------------------------------------------------------- #
# read
# --------------------------------------------------------------------------- #

def read_paren(base, args: list):
    if type(base).__name__ == "MapValue":
        from ..values import text_of
        from ..errors import MatError as _ME
        key = text_of(args[0])
        if key not in base.store:
            raise _ME("MATLAB:Containers:Map:NoKey",
                      f"The given key is not present: '{key}'.")
        return base.store[key]
    if type(base).__name__ == "MatTable":
        if len(args) != 2:
            raise MatError("MATLAB:table:badSubscript",
                           "Tables require two subscripts: t(rows, vars).")
        return base.index_paren(args[0], args[1])
    if type(base).__name__ == "SparseMatrix":
        # v1 deviation: indexed reads of sparse matrices densify (MATLAB keeps
        # sparsity); values are identical
        base = base.to_matarray()
    """A(args) for array-like base. Returns same container class."""
    if isinstance(base, StructArray):
        return _read_struct_paren(base, args)
    eng_res = _try_device_read(base, args)
    if eng_res is not None:
        return eng_res
    data = _data_of(base)
    n = len(args)
    if n == 0:
        return base
    if n == 1:
        return _read_linear(base, data, args[0])

    shape = _folded_shape(data.shape, n)
    view = data.reshape(shape, order="F") if shape != data.shape else data
    idxs = []
    out_dims = []
    for k, a in enumerate(args):
        iv = _sub_to_indices(a, shape[k], allow_grow=False)
        idxs.append(iv)
        out_dims.append(iv.size)
    r = view[np.ix_(*idxs)]
    r = r.reshape(normalize_shape(tuple(out_dims)))
    return _rewrap(base, r.copy())


def _read_linear(base, data: np.ndarray, arg):
    if _is_colon(arg):
        return _rewrap(base, fortran_ravel(data).reshape(-1, 1).copy())
    flat = fortran_ravel(data)
    if isinstance(arg, MatArray) and arg.mclass == "logical":
        idx = _sub_to_indices(arg, data.size, allow_grow=False)
        picked = flat[idx]
        # logical-mask result orientation: row if base is a row vector
        if data.ndim == 2 and data.shape[0] == 1 and data.shape[1] > 1:
            return _rewrap(base, picked.reshape(1, -1))
        return _rewrap(base, picked.reshape(-1, 1))
    idx = _sub_to_indices(arg, data.size, allow_grow=False)
    picked = flat[idx]
    ih = arg.host() if isinstance(arg, MatArray) else None
    base_shape = data.shape
    is_vec = data.ndim == 2 and (base_shape[0] == 1 or base_shape[1] == 1)
    idx_is_vec = ih is not None and ih.ndim == 2 and (ih.shape[0] == 1 or ih.shape[1] == 1)
    if is_vec and idx_is_vec:
        # orientation follows the base vector
        out = picked.reshape(1, -1) if base_shape[0] == 1 else picked.reshape(-1, 1)
    elif ih is not None:
        out = fortran_reshape(picked, normalize_shape(ih.shape))
    else:
        out = picked.reshape(1, -1)
    return _rewrap(base, out.copy())


def _read_struct_paren(base: StructArray, args: list) -> StructArray:
    shape = base.shape
    if len(args) == 1:
        idx = _sub_to_indices(args[0], base.size, allow_grow=False)
        new_fields = {}
        for k, v in base.fields.items():
            new_fields[k] = fortran_ravel(v)[idx].reshape(-1, 1).copy()
        ns = normalize_shape((idx.size, 1))
        for k in new_fields:
            new_fields[k] = new_fields[k].reshape(ns)
        return StructArray(new_fields, ns)
    shape_f = _folded_shape(shape, len(args))
    idxs = [_sub_to_indices(a, shape_f[k], allow_grow=False) for k, a in enumerate(args)]
    dims = normalize_shape(tuple(iv.size for iv in idxs))
    new_fields = {}
    for k, v in base.fields.items():
        vv = v.reshape(shape_f, order="F") if shape_f != v.shape else v
        new_fields[k] = vv[np.ix_(*idxs)].reshape(dims).copy()
    return StructArray(new_fields, dims)


def read_brace(base, args: list):
    """c{args}: contents comma-list."""
    if type(base).__name__ == "MatTable":
        if len(args) != 2:
            raise MatError("MATLAB:table:badSubscript",
                           "Tables require two subscripts: t{rows, vars}.")
        return base.index_brace(args[0], args[1])
    if not isinstance(base, CellArray):
        raise MatError("MATLAB:cellRefFromNonCell",
                       "Brace indexing is only supported for cell arrays.")
    sub = read_paren(base, args)
    items = [sub.data.reshape(-1, order="F")[i] for i in range(sub.data.size)]
    return OutputList(items)


def _try_device_read(base, args):
    """Slice fast path for device-resident arrays (stays on device, lazily)."""
    if not (isinstance(base, MatArray) and base.on_device):
        return None
    from ..accel import active_engine
    eng = active_engine()
    if eng is None:
        return None
    r = eng.index_read(base, args)   # contiguous-slice fast path
    if r is None:
        # arbitrary numeric subscripts: lazy XLA gather (stays fused)
        r = eng.index_read_general(base, args)
    return r                          # None -> fall through to host gather


# --------------------------------------------------------------------------- #
# write
# --------------------------------------------------------------------------- #

def _grow_target_shape(shape: tuple[int, ...], idxs: list[np.ndarray], args) -> tuple[int, ...]:
    need = list(shape)
    for k, iv in enumerate(idxs):
        if _is_colon(args[k]):
            continue
        if iv.size:
            need[k] = max(need[k], int(iv.max()) + 1)
    return tuple(need)


def _grow(data: np.ndarray, new_shape: tuple[int, ...], fill) -> np.ndarray:
    out = np.full(new_shape, fill, dtype=data.dtype) if data.dtype != object else \
        np.empty(new_shape, dtype=object)
    if data.dtype == object:
        out.fill(None)
        flat = out.reshape(-1)
        for i in range(flat.size):
            if flat[i] is None:
                flat[i] = MatArray.empty()
    if data.size:
        sl = tuple(slice(0, s) for s in data.shape)
        out[sl] = data
    return out


def _coerce_write_classes(base: MatArray, rhs: MatArray) -> tuple[np.ndarray, np.ndarray, str]:
    """MATLAB assignment class rules: integer/logical-RHS-into-float-LHS keeps
    LHS class... except integers, which convert the whole array (documented
    MATLAB quirk); single/double keep LHS class; char into numeric converts."""
    bcls, rcls = base.mclass, rhs.mclass
    bh, rh = base.host(), rhs.host()
    if bcls == rcls:
        return bh, rh, bcls
    if dtypes.is_integer_class(rcls) and bcls in ("double", "single", "logical"):
        return dtypes.cast_to_class(bh, rcls), rh, rcls
    if dtypes.is_integer_class(bcls):
        return bh, dtypes.cast_to_class(rh, bcls), bcls
    if bcls == "char" and rcls in ("double", "single", "logical"):
        return dtypes.cast_to_class(bh.astype(np.float64), "double"), \
            dtypes.cast_to_class(rh, "double"), "double"
    if rcls == "char" and bcls in ("double", "single"):
        return bh, dtypes.cast_to_class(rh.astype(np.float64), bcls), bcls
    if bcls == "single" and rcls in ("double", "logical"):
        return bh, dtypes.cast_to_class(rh, "single"), "single"
    if bcls == "double" and rcls in ("single",):
        return bh, rh.astype(np.float64), "double"
    if bcls == "double" and rcls == "logical":
        return bh, rh.astype(np.float64), "double"
    if bcls == "logical" and rcls in ("double", "single"):
        return bh.astype(np.float64), dtypes.cast_to_class(rh, "double"), "double"
    if rcls == "char" and bcls == "logical":
        return bh.astype(np.float64), rh.astype(np.float64), "double"
    if bcls == "char" and rcls == "char":
        return bh, rh, "char"
    raise MatError("MATLAB:subsasgn:classMismatch",
                   f"Cannot assign {rcls} values into a {bcls} array.")


def _write_table_paren(base, args: list, rhs):
    """t(rows, vars) = [] (deletion) or = 1-row table/values (row assign)."""
    from ..tables import MatTable, _take_rows
    if len(args) != 2:
        raise MatError("MATLAB:table:badSubscript",
                       "Tables require two subscripts: t(rows, vars).")
    ri = base._row_indices(args[0])
    if _is_empty_literal(rhs):
        keep = np.setdiff1d(np.arange(base.height, dtype=np.int64), ri)
        return MatTable(list(base.varnames),
                        [_take_rows(c, keep) for c in base.cols])
    vi = base._var_indices(args[1])
    src = rhs
    new_cols = list(base.cols)
    for k, col_idx in enumerate(vi):
        col = new_cols[col_idx]
        if isinstance(src, MatTable):
            val = src.cols[k]
        else:
            h = np.atleast_2d(src.host())
            val = type(col)(h[:, k:k + 1].astype(col.host().dtype)
                            if isinstance(col, MatArray) else h[:, k:k + 1],
                            col.mclass) if isinstance(col, MatArray) else src
        if isinstance(col, MatArray):
            hc = col.host().copy()
            hv = val.host() if hasattr(val, "host") else np.asarray(val)
            hc[ri, ...] = hv.reshape(len(ri), -1)[:, :hc.shape[1] if hc.ndim > 1 else 1].reshape(hc[ri, ...].shape)
            new_cols[col_idx] = MatArray(hc, col.mclass)
        else:
            d = col.data.copy()
            vals = val.data if hasattr(val, "data") else None
            if vals is not None:
                d[ri, ...] = vals.reshape(len(ri), -1)
            new_cols[col_idx] = type(col)(d)
    return MatTable(list(base.varnames), new_cols)


def _is_empty_literal(rhs) -> bool:
    return isinstance(rhs, MatArray) and rhs.size == 0 and rhs.mclass == "double"


def write_paren(base, args: list, rhs, in_place: bool = False):
    if type(base).__name__ == "MapValue":
        from ..values import text_of
        base.store[text_of(args[0])] = rhs
        return base
    if hasattr(base, "_mat_paren_assign_"):
        return base._mat_paren_assign_(args, rhs)
    if type(base).__name__ == "MatTable":
        return _write_table_paren(base, args, rhs)
    if type(base).__name__ == "SparseMatrix":
        from ..sparse import SparseMatrix
        dense = base.to_matarray()
        if type(rhs).__name__ == "SparseMatrix":
            rhs = rhs.to_matarray()
        out = write_paren(dense, args, rhs)
        return SparseMatrix.from_dense(out.host())
    """A(args) = rhs. Returns the (possibly new) base value.

    in_place=True (VM passes it when the target binding is unshared — the
    copy-on-write discipline, ≙ reference value semantics with GC handles)
    allows mutating base's host buffer directly when no growth / class change
    is needed, avoiding a full-array copy per indexed write.
    """
    if _is_empty_literal(rhs) and not isinstance(rhs, CellArray):
        return _delete_elements(base, args)
    if type(base).__name__ in ("MatDatetime", "MatDuration"):
        return _write_timelike(base, args, rhs)
    if isinstance(base, StructArray) or isinstance(rhs, StructArray):
        return _write_struct_paren(base, args, rhs)
    if isinstance(base, CellArray):
        if not isinstance(rhs, CellArray):
            raise MatError("MATLAB:cellAssToNonCell",
                           "Conversion to cell from non-cell is not possible.")
        return _write_object_paren(base, args, rhs.data, CellArray)
    if isinstance(base, StringArray):
        rhs_s = _to_stringdata(rhs)
        return _write_object_paren(base, args, rhs_s, StringArray)

    if not isinstance(base, MatArray):
        raise MatError("MATLAB:badsubscript", "Cannot index this value.")
    if isinstance(rhs, StringArray):
        rhs = MatArray.char_from_str(rhs.item() or "")
    if not isinstance(rhs, MatArray):
        raise MatError("MATLAB:subsasgn:invalidRhs", "Invalid assignment value.")

    if base.on_device or rhs.on_device:
        from ..accel import active_engine
        eng = active_engine()
        if eng is not None:
            res = eng.index_write(base, args, rhs)
            if res is not None:
                return res

    bh, rh, out_class = _coerce_write_classes(base, rhs)
    # arrays gathered from device are read-only numpy buffers (device_get
    # returns a non-writable view); they must take the copy path
    can_inplace = in_place and out_class == base.mclass and bh is base._host \
        and not base.shared and bh.flags.writeable
    data = bh
    n = len(args)
    if n == 0:
        raise MatError("MATLAB:badsubscript", "Assignment needs subscripts.")
    if n == 1:
        out = _write_linear(data, args[0], rh, can_inplace)
        if out is data and can_inplace:
            return base
        return MatArray(out, out_class)

    shape = _folded_shape(data.shape, n)
    idxs = []
    for k, a in enumerate(args):
        iv = _sub_to_indices(a, shape[k], allow_grow=not _is_colon(a))
        idxs.append(iv)
    new_shape = _grow_target_shape(shape, idxs, args)
    grew = new_shape != shape
    wrote_in_place = False
    if grew:
        if shape != data.shape and len(shape) < len(data.shape):
            raise bad_index("Cannot grow folded trailing dimensions.")
        view = data.reshape(shape, order="F") if shape != data.shape else data
        fill = 0 if data.dtype.kind != "b" else False
        data = _grow(view, new_shape, fill)
        # re-resolve colon dims against grown shape
        idxs = [np.arange(new_shape[k], dtype=np.int64) if _is_colon(a) else idxs[k]
                for k, a in enumerate(args)]
    elif shape == data.shape and can_inplace:
        wrote_in_place = True  # mutate base buffer directly
    else:
        view = data.reshape(shape, order="F") if shape != data.shape else data
        data = view.copy() if shape != data.shape else data.copy()
    nelem = 1
    dims = [iv.size for iv in idxs]
    for d in dims:
        nelem *= d
    rflat = fortran_ravel(rh)
    # contiguous-slice fast path: all index vectors are arange runs
    writer = _slice_tuple_if_contiguous(idxs, args, data.shape)
    if rflat.size == 1:
        if writer is not None:
            data[writer] = rflat[0]
        else:
            data[np.ix_(*idxs)] = rflat[0]
    elif rflat.size == nelem:
        block = fortran_reshape(rflat, tuple(dims))
        if writer is not None:
            data[writer] = block
        else:
            data[np.ix_(*idxs)] = block
    else:
        raise MatError("MATLAB:subsasgn:dimmismatch",
                       "Unable to perform assignment because the size of the left side "
                       f"and the size of the right side ({rflat.size} elements) do not match.")
    if wrote_in_place:
        return base
    if not grew and len(args) < len(base.shape):
        # wrote through a folded view of the original shape
        data = data.reshape(base.shape, order="F") if data.shape != base.shape else data
    return MatArray(data.reshape(normalize_shape(data.shape)) if data.ndim < 2 else data, out_class)


def _slice_tuple_if_contiguous(idxs, args, shape):
    """Return a tuple of slices when every subscript is a contiguous
    ascending run (common in loops: A(b, r0:r1, :) = ...), enabling numpy's
    fast strided assignment instead of np.ix_ fancy indexing."""
    slices = []
    for k, iv in enumerate(idxs):
        if _is_colon(args[k]):
            slices.append(slice(None))
            continue
        if iv.size == 0:
            return None
        if iv.size == 1:
            s = int(iv[0])
            slices.append(slice(s, s + 1))
            continue
        start, stop = int(iv[0]), int(iv[-1])
        if stop - start + 1 == iv.size and np.all(np.diff(iv) == 1):
            slices.append(slice(start, stop + 1))
        else:
            return None
    return tuple(slices)


def _write_linear(data: np.ndarray, arg, rh: np.ndarray, can_inplace: bool = False) -> np.ndarray:
    size = data.size
    if _is_colon(arg):
        rflat = fortran_ravel(rh)
        if rflat.size not in (1, size):
            raise MatError("MATLAB:subsasgn:dimmismatch",
                           "Unable to perform assignment: size mismatch for A(:) = B.")
        out = data if can_inplace else data.copy()
        if rflat.size == 1:
            out[...] = rflat[0]
        else:
            out[...] = fortran_reshape(rflat, out.shape)
        return out
    idx = _sub_to_indices(arg, size, allow_grow=True)
    rflat = fortran_ravel(rh)
    if rflat.size not in (1, idx.size):
        raise MatError("MATLAB:subsasgn:dimmismatch",
                       "Unable to perform assignment because the left and right sides "
                       "have a different number of elements.")
    grow_to = int(idx.max()) + 1 if idx.size else 0
    if grow_to > size:
        # growth through linear indexing is only defined for empty or vector bases
        if size == 0:
            new = np.zeros((1, grow_to), dtype=data.dtype)
        elif data.ndim == 2 and data.shape[0] == 1:
            new = np.zeros((1, grow_to), dtype=data.dtype)
            new[0, :size] = data[0]
        elif data.ndim == 2 and data.shape[1] == 1:
            new = np.zeros((grow_to, 1), dtype=data.dtype)
            new[:size, 0] = data[:, 0]
        else:
            raise bad_index("Attempt to grow array along ambiguous dimension.")
        flat = fortran_ravel(new)
        flat[idx] = rflat if rflat.size != 1 else rflat[0]
        return fortran_reshape(flat, new.shape)
    out = data if can_inplace else data.copy()
    mi = np.unravel_index(idx, out.shape, order="F")
    out[mi] = rflat if rflat.size != 1 else rflat[0]
    return out


def _to_stringdata(rhs) -> np.ndarray:
    if isinstance(rhs, StringArray):
        return rhs.data
    if isinstance(rhs, MatArray) and rhs.mclass == "char":
        a = np.empty((1, 1), dtype=object)
        a[0, 0] = rhs.to_str()
        return a
    raise MatError("MATLAB:string:conversion", "Cannot assign this value into a string array.")


def _write_object_paren(base, args: list, rdata: np.ndarray, ctor):
    data = base.data
    n = len(args)
    if n == 1 and not _is_colon(args[0]):
        idx = _sub_to_indices(args[0], data.size, allow_grow=True)
        rflat = rdata.reshape(-1, order="F" if rdata.ndim > 1 else "C")
        if rflat.size not in (1, idx.size):
            raise MatError("MATLAB:subsasgn:dimmismatch", "Assignment size mismatch.")
        grow_to = int(idx.max()) + 1 if idx.size else 0
        if grow_to > data.size:
            if data.size == 0 or (data.ndim == 2 and data.shape[0] == 1):
                ns = (1, grow_to)
            elif data.ndim == 2 and data.shape[1] == 1:
                ns = (grow_to, 1)
            else:
                raise bad_index("Attempt to grow array along ambiguous dimension.")
            if data.dtype == object:
                new = np.empty(ns, dtype=object)
                fl = new.reshape(-1)
                filler = MatArray.empty() if ctor is CellArray else None
                for i in range(fl.size):
                    fl[i] = filler
            else:                 # datetime64/timedelta64: grow fills NaT
                new = np.full(ns, None, dtype=data.dtype)
                fl = new.reshape(-1)
            old = fortran_ravel(data)
            fl[:old.size] = old
            data = new
        else:
            data = data.copy()
        flat = fortran_ravel(data)
        for j, i in enumerate(idx):
            flat[i] = rflat[j if rflat.size > 1 else 0]
        return ctor(fortran_reshape(flat, data.shape))
    # multi-d / colon path
    shape = _folded_shape(data.shape, n) if n > 1 else data.shape
    idxs = [_sub_to_indices(a, shape[k] if n > 1 else data.size, allow_grow=True)
            for k, a in enumerate(args)]
    if n == 1:
        idxs = [np.arange(data.size, dtype=np.int64)]
        view = fortran_ravel(data.copy())
        rflat = fortran_ravel(rdata)
        if rflat.size == 1:
            view[:] = rflat[0]
        else:
            view[:] = rflat
        return ctor(fortran_reshape(view, data.shape))
    new_shape = _grow_target_shape(shape, idxs, args)
    view = data.reshape(shape, order="F") if shape != data.shape else data
    if new_shape != shape:
        data = _grow(view, new_shape, None)
        idxs = [np.arange(new_shape[k], dtype=np.int64) if _is_colon(a) else idxs[k]
                for k, a in enumerate(args)]
    else:
        data = view.copy()
    dims = [iv.size for iv in idxs]
    nelem = int(np.prod(dims)) if dims else 0
    rflat = fortran_ravel(rdata)
    if rflat.size == 1:
        data[np.ix_(*idxs)] = rflat[0]
    elif rflat.size == nelem:
        data[np.ix_(*idxs)] = fortran_reshape(rflat, tuple(dims))
    else:
        raise MatError("MATLAB:subsasgn:dimmismatch", "Assignment size mismatch.")
    return ctor(data)


def _write_timelike(base, args: list, rhs):
    """Indexed assignment into datetime/duration arrays: same-class values
    element-wise, NaN numerics coerce to NaT, growth fills NaT (≙ the
    registered datetime.subsasgn/duration.subsasgn method builtins)."""
    cls = type(base)
    if type(rhs).__name__ == cls.__name__:
        rdata = rhs.data.astype(base.data.dtype)
    elif isinstance(rhs, MatArray) and not rhs.is_complex \
            and rhs.host().size and np.isnan(rhs.host()).all():
        rdata = np.full(rhs.host().shape, None, dtype=base.data.dtype)
    else:
        kind = "datetime" if base.data.dtype.kind == "M" else "duration"
        raise MatError("MATLAB:subsasgn:classMismatch",
                       f"Cannot assign values of class "
                       f"{type(rhs).__name__} into a {kind} array.")
    return _write_object_paren(base, args, rdata, cls)


def _write_struct_paren(base, args: list, rhs):
    if not isinstance(rhs, StructArray):
        raise MatError("MATLAB:subsasgn:classMismatch",
                       "Cannot assign non-struct into struct array.")
    if not isinstance(base, StructArray):
        if isinstance(base, MatArray) and base.size == 0:
            base = StructArray({k: np.empty((0, 0), dtype=object) for k in rhs.fields}, (0, 0))
        else:
            raise MatError("MATLAB:subsasgn:classMismatch",
                           "Cannot assign struct into non-struct array.")
    # normalize fields across both
    all_fields = list(dict.fromkeys(list(base.fields) + list(rhs.fields)))
    shape = base.shape
    n = len(args)
    shape_f = _folded_shape(shape, n) if n > 1 else shape
    if n == 1:
        idx = _sub_to_indices(args[0], base.size, allow_grow=True)
        grow_to = int(idx.max()) + 1 if idx.size else 0
        new_fields = {}
        if grow_to > base.size:
            if base.size == 0 or (len(shape) == 2 and shape[0] <= 1):
                ns = (1, grow_to)
            elif len(shape) == 2 and shape[1] == 1:
                ns = (grow_to, 1)
            else:
                raise bad_index("Attempt to grow struct array along ambiguous dimension.")
        else:
            ns = shape
        for f in all_fields:
            cur = base.fields.get(f)
            arr = np.empty(ns, dtype=object)
            fl = arr.reshape(-1)
            for i in range(fl.size):
                fl[i] = MatArray.empty()
            if cur is not None and cur.size:
                fl[:cur.size] = fortran_ravel(cur)
            rv = rhs.fields.get(f)
            for j, i in enumerate(idx):
                if rv is not None:
                    fl[i] = fortran_ravel(rv)[j if rv.size > 1 else 0]
                else:
                    fl[i] = MatArray.empty()
            new_fields[f] = fortran_reshape(fl, ns)
        return StructArray(new_fields, ns)
    idxs = [_sub_to_indices(a, shape_f[k], allow_grow=True) for k, a in enumerate(args)]
    new_shape = _grow_target_shape(shape_f, idxs, args)
    new_fields = {}
    for f in all_fields:
        cur = base.fields.get(f)
        if cur is None:
            cur = np.empty(shape, dtype=object)
            fl = cur.reshape(-1)
            for i in range(fl.size):
                fl[i] = MatArray.empty()
        view = cur.reshape(shape_f, order="F") if shape_f != cur.shape else cur
        arr = _grow(view, new_shape, None) if new_shape != shape_f else view.copy()
        ii = [np.arange(new_shape[k], dtype=np.int64) if _is_colon(a) else idxs[k]
              for k, a in enumerate(args)]
        rv = rhs.fields.get(f)
        dims = [iv.size for iv in ii]
        if rv is None:
            arr[np.ix_(*ii)] = MatArray.empty()
        elif rv.size == 1:
            arr[np.ix_(*ii)] = fortran_ravel(rv)[0]
        else:
            arr[np.ix_(*ii)] = fortran_reshape(fortran_ravel(rv), tuple(dims))
        new_fields[f] = arr
    return StructArray(new_fields, new_shape)


def write_brace(base, args: list, rhs):
    """c{args} = rhs (single destination)."""
    if isinstance(base, MatArray) and base.size == 0:
        base = CellArray.empty()
    if not isinstance(base, CellArray):
        raise MatError("MATLAB:cellAssToNonCell",
                       "Brace assignment is only supported for cell arrays.")
    wrapped = np.empty((1, 1), dtype=object)
    wrapped[0, 0] = rhs
    return _write_object_paren(base, args, wrapped, CellArray)


# --------------------------------------------------------------------------- #
# deletion: A(args) = []
# --------------------------------------------------------------------------- #

def _delete_elements(base, args: list):
    if isinstance(base, StructArray):
        return _delete_struct(base, args)
    data = _data_of(base)
    n = len(args)
    if n == 1:
        if _is_colon(args[0]):
            empty = np.zeros((0, 0), dtype=data.dtype) if data.dtype != object else \
                np.empty((0, 0), dtype=object)
            return _rewrap(base, empty)
        idx = _sub_to_indices(args[0], data.size, allow_grow=False)
        keep = np.ones(data.size, dtype=bool)
        keep[idx] = False
        flat = fortran_ravel(data)[keep]
        if data.ndim == 2 and data.shape[1] == 1 and data.shape[0] > 1:
            return _rewrap(base, flat.reshape(-1, 1))
        return _rewrap(base, flat.reshape(1, -1))
    # multi-d deletion: exactly one non-colon subscript allowed
    non_colon = [k for k, a in enumerate(args) if not _is_colon(a)]
    if len(non_colon) != 1:
        raise MatError("MATLAB:subsdeldimmismatch",
                       "A null assignment can have only one non-colon index.")
    k = non_colon[0]
    shape = _folded_shape(data.shape, n)
    view = data.reshape(shape, order="F") if shape != data.shape else data
    idx = _sub_to_indices(args[k], shape[k], allow_grow=False)
    keep = np.ones(shape[k], dtype=bool)
    keep[idx] = False
    out = np.compress(keep, view, axis=k)
    return _rewrap(base, out.copy())


def _delete_struct(base: StructArray, args: list) -> StructArray:
    n = len(args)
    if n == 1 and not _is_colon(args[0]):
        idx = _sub_to_indices(args[0], base.size, allow_grow=False)
        keep = np.ones(base.size, dtype=bool)
        keep[idx] = False
        new_fields = {}
        for f, v in base.fields.items():
            flat = fortran_ravel(v)[keep]
            new_fields[f] = flat.reshape(1, -1) if base.shape[0] == 1 else flat.reshape(-1, 1)
        any_f = next(iter(new_fields.values()), np.empty((1, 0), dtype=object))
        return StructArray(new_fields, any_f.shape)
    raise MatError("MATLAB:subsdeldimmismatch", "Unsupported struct deletion form.")
