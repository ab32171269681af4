"""Copy of runmat_tpu/matio.py in the PyTorch port.

MAT-file v5 codec: read/write real MATLAB .mat files.

Reference parity: the mat-file io family (runmat-runtime/src/builtins/io/mat/).
Implements the Level-5 MAT-file container from the published format spec:
header, (optionally zlib-compressed) data elements, miMATRIX subelements
(array flags / dimensions / name / payload), column-major storage, small-data
element packing. Supported classes: double/single/int8..uint64 (real and
complex), logical, char, cell, struct (incl. struct arrays), sparse double.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .errors import MatError

# MAT data types
miINT8, miUINT8, miINT16, miUINT16, miINT32, miUINT32 = 1, 2, 3, 4, 5, 6
miSINGLE, miDOUBLE = 7, 9
miINT64, miUINT64 = 12, 13
miMATRIX, miCOMPRESSED, miUTF8, miUTF16 = 14, 15, 16, 17

# array classes
mxCELL, mxSTRUCT, mxOBJECT, mxCHAR, mxSPARSE = 1, 2, 3, 4, 5
mxDOUBLE, mxSINGLE = 6, 7
mxINT8, mxUINT8, mxINT16, mxUINT16, mxINT32, mxUINT32 = 8, 9, 10, 11, 12, 13
mxINT64, mxUINT64 = 14, 15

_NP_TO_MI = {
    np.dtype(np.float64): miDOUBLE, np.dtype(np.float32): miSINGLE,
    np.dtype(np.int8): miINT8, np.dtype(np.uint8): miUINT8,
    np.dtype(np.int16): miINT16, np.dtype(np.uint16): miUINT16,
    np.dtype(np.int32): miINT32, np.dtype(np.uint32): miUINT32,
    np.dtype(np.int64): miINT64, np.dtype(np.uint64): miUINT64,
    np.dtype(np.bool_): miUINT8,
}
_MI_TO_NP = {
    miDOUBLE: np.float64, miSINGLE: np.float32,
    miINT8: np.int8, miUINT8: np.uint8, miINT16: np.int16,
    miUINT16: np.uint16, miINT32: np.int32, miUINT32: np.uint32,
    miINT64: np.int64, miUINT64: np.uint64,
}
_CLASS_TO_MCLASS = {
    mxDOUBLE: "double", mxSINGLE: "single", mxINT8: "int8", mxUINT8: "uint8",
    mxINT16: "int16", mxUINT16: "uint16", mxINT32: "int32",
    mxUINT32: "uint32", mxINT64: "int64", mxUINT64: "uint64",
}
_MCLASS_TO_CLASS = {v: k for k, v in _CLASS_TO_MCLASS.items()}


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


def _element(mi: int, payload: bytes) -> bytes:
    if len(payload) <= 4:
        # small data element: packed tag
        return struct.pack("<HH", mi, len(payload)) + payload.ljust(4, b"\x00")
    return struct.pack("<II", mi, len(payload)) + payload + b"\x00" * _pad8(len(payload))


def _num_element(arr: np.ndarray) -> bytes:
    mi = _NP_TO_MI[arr.dtype if arr.dtype != np.bool_ else np.dtype(np.bool_)]
    data = arr.astype(np.uint8) if arr.dtype == np.bool_ else arr
    return _element(mi, np.ascontiguousarray(data).tobytes())


def _flags_dims_name(cls: int, dims, name: str, complex_=False, logical=False,
                     nzmax=0) -> bytes:
    flags = cls | (0x0800 if complex_ else 0) | (0x0200 if logical else 0)
    fl = _element(miUINT32, struct.pack("<II", flags, nzmax))
    dm = _element(miINT32, np.asarray(dims, np.int32).tobytes())
    nm = _element(miINT8, name.encode())
    return fl + dm + nm


def _matrix_element(body: bytes) -> bytes:
    return struct.pack("<II", miMATRIX, len(body)) + body


def write_var(name: str, value) -> bytes:
    """One variable -> a full miMATRIX element."""
    from .sparse import SparseMatrix
    from .values import CellArray, MatArray, StringArray, StructArray
    if isinstance(value, StringArray):
        # v5 has no native string class; save scalar as char, arrays as
        # cellstr (the conventional interchange form)
        if value.size == 1:
            value = MatArray.char_from_str(value.item() or "")
        else:
            data = np.empty(value.shape, dtype=object)
            flat_in = value.data.reshape(-1, order="F")
            flat_out = data.reshape(-1, order="F")
            for i in range(value.size):
                flat_out[i] = MatArray.char_from_str(flat_in[i] or "")
            value = CellArray(data)
    if isinstance(value, SparseMatrix):
        return _write_sparse(name, value)
    if isinstance(value, MatArray):
        return _write_numeric(name, value)
    if isinstance(value, CellArray):
        body = _flags_dims_name(mxCELL, value.shape, name)
        flat = value.data.reshape(-1, order="F")
        for i in range(value.size):
            body += write_var("", flat[i])
        return _matrix_element(body)
    if isinstance(value, StructArray):
        body = _flags_dims_name(mxSTRUCT, value.shape, name)
        fields = list(value.fields)
        body += _element(miINT32, struct.pack("<i", 32))
        names = b"".join(f.encode().ljust(32, b"\x00")[:32] for f in fields)
        body += _element(miINT8, names)
        n = max(1, value.size)
        for i in range(n):
            for f in fields:
                fv = value.fields[f].reshape(-1, order="F")[i] if value.size \
                    else MatArray.empty()
                body += write_var("", fv)
        return _matrix_element(body)
    raise MatError("MATLAB:save:unsupported",
                   f"Cannot save value of class {type(value).__name__}.")


def _write_numeric(name: str, value) -> bytes:
    h = value.host()
    if value.mclass == "char":
        body = _flags_dims_name(mxCHAR, h.shape, name)
        codes = h.astype(np.uint16)
        body += _element(miUINT16,
                         np.ascontiguousarray(codes, dtype="<u2")
                         .reshape(-1, order="F").tobytes())
        return _matrix_element(body)
    cls = _MCLASS_TO_CLASS.get(value.mclass, mxDOUBLE)
    logical = value.mclass == "logical"
    if logical:
        cls = mxUINT8
    cx = h.dtype.kind == "c"
    body = _flags_dims_name(cls, h.shape, name, complex_=cx, logical=logical)
    hf = np.asarray(h).reshape(-1, order="F")
    if cx:
        body += _num_element(np.ascontiguousarray(hf.real))
        body += _num_element(np.ascontiguousarray(hf.imag))
    else:
        body += _num_element(hf)
    return _matrix_element(body)


def _write_sparse(name: str, sp) -> bytes:
    body = _flags_dims_name(mxSPARSE, (sp.m, sp.n), name, nzmax=max(sp.nnz, 1))
    body += _element(miINT32, sp.rowind.astype(np.int32).tobytes())   # ir
    body += _element(miINT32, sp.indptr.astype(np.int32).tobytes())   # jc
    body += _num_element(sp.data.astype(np.float64))
    return _matrix_element(body)


def save_mat(path: str, variables: dict, compress: bool = True) -> None:
    header = b"MATLAB 5.0 MAT-file, Platform: runmat-tpu"
    header = header.ljust(116, b" ") + b"\x00" * 8 + struct.pack("<H", 0x0100) + b"IM"
    out = [header]
    for name, value in variables.items():
        elt = write_var(name, value)
        if compress:
            # miCOMPRESSED elements are NOT 8-byte padded (MATLAB/scipy
            # convention — readers advance by exactly 8+nbytes)
            comp = zlib.compress(elt)
            out.append(struct.pack("<II", miCOMPRESSED, len(comp)) + comp)
        else:
            out.append(elt)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ------------------------------------------------------------------- reading #


class _Cursor:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def read_element(self):
        """-> (mi_type, payload bytes)."""
        d = self.data
        p = self.pos
        ty = struct.unpack_from("<I", d, p)[0]
        if ty >> 16:     # small data element
            nb = ty >> 16
            ty &= 0xFFFF
            payload = d[p + 4:p + 4 + nb]
            self.pos = p + 8
        else:
            nb = struct.unpack_from("<I", d, p + 4)[0]
            payload = d[p + 8:p + 8 + nb]
            # compressed elements are unpadded; everything else aligns to 8
            self.pos = p + 8 + nb + (0 if ty == miCOMPRESSED else _pad8(nb))
        return ty, payload


def _read_numeric_payload(ty: int, payload: bytes) -> np.ndarray:
    if ty == miUTF8:
        return np.frombuffer(payload.decode().encode("utf-32-le"), np.uint32)
    if ty == miUTF16:
        return np.frombuffer(payload, "<u2").astype(np.uint32)
    return np.frombuffer(payload, _MI_TO_NP[ty])


def read_matrix(payload: bytes):
    """miMATRIX payload -> (name, runtime value)."""
    from .sparse import SparseMatrix
    from .values import CellArray, MatArray, StructArray, normalize_shape
    cur = _Cursor(payload)
    _, flags_raw = cur.read_element()
    flags, nzmax = struct.unpack_from("<II", flags_raw, 0)
    cls = flags & 0xFF
    is_complex = bool(flags & 0x0800)
    is_logical = bool(flags & 0x0200)
    _, dims_raw = cur.read_element()
    dims = tuple(int(v) for v in np.frombuffer(dims_raw, np.int32))
    _, name_raw = cur.read_element()
    name = name_raw.split(b"\x00")[0].decode() if name_raw else ""

    if cls == mxCELL:
        n = int(np.prod(dims)) if dims else 0
        data = np.empty(dims if len(dims) >= 2 else (1, max(n, 0)), dtype=object)
        flat = data.reshape(-1, order="F")
        for i in range(n):
            ty, sub = cur.read_element()
            _, v = read_matrix(sub)
            flat[i] = v
        return name, CellArray(data)
    if cls == mxSTRUCT:
        _, fl_raw = cur.read_element()       # field name length
        flen = struct.unpack_from("<i", fl_raw, 0)[0] or 32
        _, names_raw = cur.read_element()
        nf = len(names_raw) // flen
        fields = [names_raw[i * flen:(i + 1) * flen].split(b"\x00")[0].decode()
                  for i in range(nf)]
        n = int(np.prod(dims)) if dims else 1
        store = {f: np.empty(dims if len(dims) >= 2 else (1, 1), dtype=object)
                 for f in fields}
        for i in range(n):
            for f in fields:
                ty, sub = cur.read_element()
                _, v = read_matrix(sub)
                store[f].reshape(-1, order="F")[i] = v
        return name, StructArray(store, dims if len(dims) >= 2 else (1, 1))
    if cls == mxSPARSE:
        _, ir_raw = cur.read_element()
        _, jc_raw = cur.read_element()
        ty, re_raw = cur.read_element()
        ir = np.frombuffer(ir_raw, np.int32).astype(np.int64)
        jc = np.frombuffer(jc_raw, np.int32).astype(np.int64)
        vals = _read_numeric_payload(ty, re_raw).astype(np.float64)
        nnz = int(jc[-1]) if jc.size else 0
        return name, SparseMatrix(dims[0], dims[1], jc, ir[:nnz], vals[:nnz])
    if cls == mxCHAR:
        ty, raw = cur.read_element()
        codes = _read_numeric_payload(ty, raw).astype(np.uint32)
        arr = codes.reshape(dims, order="F") if len(dims) >= 2 else \
            codes.reshape(1, -1)
        return name, MatArray(np.ascontiguousarray(arr), "char")
    # numeric
    mclass = _CLASS_TO_MCLASS.get(cls, "double")
    ty, re_raw = cur.read_element()
    re = _read_numeric_payload(ty, re_raw)
    if is_complex:
        ty2, im_raw = cur.read_element()
        im = _read_numeric_payload(ty2, im_raw)
        vals = re.astype(np.complex128) + 1j * im.astype(np.complex128)
    else:
        target = np.dtype({"double": np.float64, "single": np.float32}.get(
            mclass, mclass if not is_logical else "uint8"))
        vals = re.astype(target) if re.dtype != target else re
    if is_logical:
        vals = vals.astype(np.bool_)
        mclass = "logical"
    shape = dims if len(dims) >= 2 else (1, max(vals.size, 0))
    arr = np.asarray(vals).reshape(shape, order="F")
    return name, MatArray(np.ascontiguousarray(arr), mclass)


def load_mat(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 128 or data[124:126] != struct.pack("<H", 0x0100):
        # some writers put version differently; verify endian marker instead
        if data[126:128] not in (b"IM", b"MI"):
            raise MatError("MATLAB:load:notBinaryMAT",
                           f"'{path}' is not a Level-5 MAT-file.")
    cur = _Cursor(data, 128)
    out = {}
    while not cur.eof():
        try:
            ty, payload = cur.read_element()
        except struct.error:
            break
        if ty == miCOMPRESSED:
            inner = zlib.decompress(payload)
            ity, ipayload = _Cursor(inner).read_element()
            if ity != miMATRIX:
                continue
            name, val = read_matrix(ipayload)
        elif ty == miMATRIX:
            name, val = read_matrix(payload)
        else:
            continue
        if name:
            out[name] = val
    return out


# --------------------------------------------------------------------------- #
# MAT v7.3: HDF5-based container (≙ MATLAB -v7.3; readable by h5py/MATLAB)
# --------------------------------------------------------------------------- #

def save_mat73(path: str, variables: dict) -> None:
    """Write a MATLAB 7.3 MAT-file: HDF5 with a 512-byte MATLAB userblock
    and per-dataset MATLAB_class attributes. Numeric arrays store transposed
    (v7.3 keeps C-order on disk; MATLAB shape = reversed dims)."""
    import h5py

    from .values import MatArray, StringArray, is_char

    with h5py.File(path, "w", userblock_size=512) as f:
        for name, v in variables.items():
            if isinstance(v, MatArray) and v.mclass == "char":
                ds = f.create_dataset(
                    name, data=v.host().astype("<u2").T)
                ds.attrs["MATLAB_class"] = np.bytes_("char")
                ds.attrs["MATLAB_int_decode"] = np.int32(2)
            elif isinstance(v, MatArray):
                h = v.host()
                if h.dtype.kind == "c":
                    dt = np.dtype([("real", "<f8"), ("imag", "<f8")])
                    packed = np.empty(h.T.shape, dtype=dt)
                    packed["real"] = np.real(h).T
                    packed["imag"] = np.imag(h).T
                    ds = f.create_dataset(name, data=packed)
                else:
                    ds = f.create_dataset(name, data=np.asarray(h).T)
                cls = {"logical": "logical"}.get(v.mclass, v.mclass)
                ds.attrs["MATLAB_class"] = np.bytes_(cls)
                if v.mclass == "logical":
                    ds.attrs["MATLAB_int_decode"] = np.int32(1)
            elif isinstance(v, StringArray) and v.size == 1:
                s = v.item() or ""
                ds = f.create_dataset(
                    name,
                    data=np.array([[ord(c) for c in s]], dtype="<u2").T
                    if s else np.zeros((0, 0), dtype="<u2"))
                ds.attrs["MATLAB_class"] = np.bytes_("char")
                ds.attrs["MATLAB_int_decode"] = np.int32(2)
            # other container types fall back to the v5 writer at the caller
    # MATLAB header in the userblock
    import time as _t
    header = (f"MATLAB 7.3 MAT-file, Platform: runmat-tpu, Created on: "
              f"{_t.strftime('%a %b %d %H:%M:%S %Y')} HDF5 schema 1.00 .")
    # Level-5 header layout: 116 text bytes, 8 subsystem-offset bytes
    # (116-123), version u16 0x0200 at 124-125, endian marker 'IM' at 126-127
    # (the same offsets the v5 writer uses at matio.py:161 and the loader
    # validates at matio.py:291-293).
    head = header.encode()[:116].ljust(116, b" ")
    head += b"\x00" * 8 + struct.pack("<H", 0x0200) + b"IM"
    with open(path, "r+b") as fb:
        fb.write(head.ljust(512, b"\x00"))


def load_mat73(path: str) -> dict:
    import h5py

    from . import dtypes as _dt
    from .values import MatArray

    out: dict = {}
    with h5py.File(path, "r") as f:
        for name in f:
            if name.startswith("#"):
                continue
            ds = f[name]
            if not hasattr(ds, "attrs"):
                continue
            cls = ds.attrs.get("MATLAB_class", b"double")
            cls = cls.decode() if isinstance(cls, bytes) else str(cls)
            data = np.asarray(ds)
            if data.dtype.names and set(data.dtype.names) >= {"real", "imag"}:
                arr = (data["real"] + 1j * data["imag"]).T
                out[name] = MatArray(arr, "double")
                continue
            arr = data.T if data.ndim >= 2 else data.reshape(1, -1)
            if cls == "char":
                out[name] = MatArray(arr.astype(np.uint32), "char")
            elif cls == "logical":
                out[name] = MatArray(arr.astype(bool), "logical")
            elif cls in ("double", "single", "int8", "int16", "int32", "int64",
                         "uint8", "uint16", "uint32", "uint64"):
                out[name] = MatArray(arr.astype(_dt.np_dtype(cls)), cls)
            else:
                out[name] = MatArray(arr.astype(np.float64), "double")
    return out


def is_mat73(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(128)
        return head.startswith(b"MATLAB 7.3")
    except OSError:
        return False
