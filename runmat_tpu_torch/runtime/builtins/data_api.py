"""Copy of runmat_tpu/runtime/builtins/data_api.py in the PyTorch port.

Cloud-ready dataset persistence (`data.*` + Dataset/DataArray/
DataTransaction objects).

Reference parity: runmat-runtime/src/builtins/io/data/mod.rs + src/data/ —
a dataset is a directory holding a JSON manifest (schema_version, dataset_id,
arrays, attrs, txn_sequence) and chunked binary array payloads; writes go
through transactions that bump the manifest sequence atomically. All file
access routes through the filesystem provider (runmat_tpu/fs.py), so the
same datasets work on the native, in-memory, and sandboxed filesystems.

Chunking: each array is split on a fixed chunk grid (`chunk_shape`,
defaulting to the full shape); chunk (i,j,...) lives at
`arrays/<name>/c_i_j....bin` as little-endian raw values — the analog of the
reference's DataChunkIndex payout layout.
"""

from __future__ import annotations

import json
import time
import uuid

import numpy as np

from ...errors import MatError, bad_arg
from ...fs import fs
from ...values import (CellArray, MatArray, StringArray, StructArray,
                       fortran_ravel, is_text, text_of)
from ..registry import builtin

_DTYPES = {"f64": np.float64, "f32": np.float32, "double": np.float64,
           "single": np.float32, "i32": np.int32, "i64": np.int64,
           "u8": np.uint8, "logical": np.bool_}
_DTYPE_NAMES = {np.dtype(np.float64): "f64", np.dtype(np.float32): "f32",
                np.dtype(np.int32): "i32", np.dtype(np.int64): "i64",
                np.dtype(np.uint8): "u8", np.dtype(np.bool_): "logical"}


def _err(msg: str) -> MatError:
    return MatError("RunMat:data:InvalidArgument", f"data: {msg}")


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _manifest_path(root: str) -> str:
    return root.rstrip("/") + "/manifest.json"


def _read_manifest(root: str) -> dict:
    try:
        return json.loads(fs().read_bytes(_manifest_path(root)).decode("utf-8"))
    except FileNotFoundError:
        raise _err(f"dataset not found at '{root}'")


def _write_manifest(root: str, m: dict) -> None:
    m["updated_at"] = _now()
    fs().write_bytes(_manifest_path(root),
                     json.dumps(m, indent=1, sort_keys=True).encode("utf-8"))


def _chunk_grid(shape, chunk):
    return [max(1, -(-s // c)) for s, c in zip(shape, chunk)]


def _chunk_path(root: str, name: str, idx) -> str:
    return root.rstrip("/") + f"/arrays/{name}/c_" + "_".join(map(str, idx)) + ".bin"


def _read_array(root: str, meta: dict) -> np.ndarray:
    dt = np.dtype(_DTYPES[meta["dtype"]])
    shape = tuple(meta["shape"])
    chunk = tuple(meta["chunk_shape"])
    out = np.zeros(shape, dtype=dt)
    grid = _chunk_grid(shape, chunk)
    for idx in np.ndindex(*grid):
        lo = [i * c for i, c in zip(idx, chunk)]
        hi = [min(l + c, s) for l, c, s in zip(lo, chunk, shape)]
        try:
            raw = fs().read_bytes(_chunk_path(root, meta["name"], idx))
        except FileNotFoundError:
            continue
        block = np.frombuffer(raw, dtype=dt).reshape(
            [h - l for l, h in zip(lo, hi)])
        out[tuple(slice(l, h) for l, h in zip(lo, hi))] = block
    return out


def _write_array(root: str, meta: dict, data: np.ndarray) -> None:
    dt = np.dtype(_DTYPES[meta["dtype"]])
    shape = tuple(meta["shape"])
    chunk = tuple(meta["chunk_shape"])
    data = np.asarray(data, dtype=dt).reshape(shape)
    fs().mkdir(root.rstrip("/") + f"/arrays/{meta['name']}")
    grid = _chunk_grid(shape, chunk)
    for idx in np.ndindex(*grid):
        lo = [i * c for i, c in zip(idx, chunk)]
        hi = [min(l + c, s) for l, c, s in zip(lo, chunk, shape)]
        block = np.ascontiguousarray(
            data[tuple(slice(l, h) for l, h in zip(lo, hi))])
        fs().write_bytes(_chunk_path(root, meta["name"], idx), block.tobytes())


def _json_attr(v):
    if isinstance(v, MatArray):
        if v.mclass == "char":
            return v.to_str()
        if v.size == 1:
            return float(v.host().reshape(-1)[0].real)
        return [float(x) for x in fortran_ravel(v.host().astype(np.float64))]
    if isinstance(v, StringArray) and v.size == 1:
        return v.item()
    return str(v)


def _attr_value(j):
    if isinstance(j, str):
        return MatArray.char_from_str(j)
    if isinstance(j, (int, float)):
        return MatArray.scalar(float(j))
    if isinstance(j, list):
        return MatArray(np.array(j, dtype=np.float64).reshape(1, -1), "double")
    return MatArray.empty()


# ------------------------------------------------------------------ objects --- #

class DataArrayValue:
    mclass = "DataArray"
    shared = False

    def __init__(self, root: str, meta: dict):
        self.root = root
        self.meta = meta

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        m = self.meta
        if fname == "name":
            return [MatArray.char_from_str(m["name"])]
        if fname == "dtype":
            return [MatArray.char_from_str(m["dtype"])]
        if fname == "shape":
            return [MatArray(np.array([m["shape"]], dtype=np.float64), "double")]
        if fname == "chunk_shape":
            return [MatArray(np.array([m["chunk_shape"]], dtype=np.float64),
                             "double")]
        if fname == "rank":
            return [MatArray.scalar(float(len(m["shape"])))]
        if fname == "codec":
            return [MatArray.char_from_str(m.get("codec", "raw"))]
        if fname == "fill":
            return [MatArray.scalar(float(m.get("fill", 0.0)))]
        if fname == "read":
            data = _read_array(self.root, m)
            cls = "double" if m["dtype"] in ("f64",) else \
                ("single" if m["dtype"] == "f32" else
                 {"i32": "int32", "i64": "int64", "u8": "uint8",
                  "logical": "logical"}.get(m["dtype"], "double"))
            return [MatArray(data.astype(
                np.float64 if cls == "double" else data.dtype), cls)]
        if fname in ("write", "resize"):
            raise _err(f"{fname} requires a transaction: use ds.begin()")
        return NotImplemented

    def _mat_get_field_(self, fname):
        r = self._mat_call_method_(None, None, fname, [], 1)
        if r is NotImplemented or fname in ("read",):
            return NotImplemented
        return r[0]


class DatasetValue:
    mclass = "Dataset"
    shared = False

    def __init__(self, root: str):
        self.root = root
        self.manifest = _read_manifest(root)

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        m = self.manifest
        if fname == "array":
            name = text_of(args[0])
            if name not in m["arrays"]:
                raise _err(f"no array '{name}' in dataset")
            return [DataArrayValue(self.root, m["arrays"][name])]
        if fname == "arrays":
            names = sorted(m["arrays"])
            data = np.empty((len(names), 1), dtype=object)
            for i, n in enumerate(names):
                data[i, 0] = MatArray.char_from_str(n)
            return [CellArray(data)]
        if fname == "has_array":
            return [MatArray.logical_scalar(text_of(args[0]) in m["arrays"])]
        if fname == "attrs":
            return [StructArray.scalar({k: _attr_value(v)
                                        for k, v in m["attrs"].items()})]
        if fname == "get_attr":
            key = text_of(args[0])
            if key not in m["attrs"]:
                raise _err(f"no attribute '{key}'")
            return [_attr_value(m["attrs"][key])]
        if fname in ("set_attr", "set_attrs"):
            if fname == "set_attr":
                m["attrs"][text_of(args[0])] = _json_attr(args[1])
            else:
                st = args[0]
                for k in st.fields:
                    m["attrs"][k] = _json_attr(st.get_scalar_field(k))
            _write_manifest(self.root, m)
            return [self]
        if fname == "id":
            return [MatArray.char_from_str(m["dataset_id"])]
        if fname == "path":
            return [MatArray.char_from_str(self.root)]
        if fname == "version":
            return [MatArray.scalar(float(m["txn_sequence"]))]
        if fname == "refresh":
            self.manifest = _read_manifest(self.root)
            return [self]
        if fname == "begin":
            return [DataTransactionValue(self)]
        if fname == "snapshot":
            snap_root = self.root.rstrip("/") + f".snap{m['txn_sequence']}"
            fs().copy(self.root, snap_root)
            return [MatArray.char_from_str(snap_root)]
        return NotImplemented

    def _mat_get_field_(self, fname):
        if fname in ("id", "path", "version", "attrs"):
            return self._mat_call_method_(None, None, fname, [], 1)[0]
        return NotImplemented


class DataTransactionValue:
    mclass = "DataTransaction"
    shared = False

    def __init__(self, ds: DatasetValue):
        self.ds = ds
        self.txn_id = uuid.uuid4().hex[:12]
        self.pending: list = []
        self.status = "open"

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _require_open(self):
        if self.status != "open":
            raise _err(f"transaction is {self.status}")

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "id":
            return [MatArray.char_from_str(self.txn_id)]
        if fname == "status":
            return [MatArray.char_from_str(self.status)]
        if fname == "abort":
            self._require_open()
            self.pending = []
            self.status = "aborted"
            return [self]
        if fname == "create_array":
            self._require_open()
            name = text_of(args[0])
            meta_struct = args[1]
            self.pending.append(("create", name, meta_struct))
            return [self]
        if fname == "delete_array":
            self._require_open()
            self.pending.append(("delete", text_of(args[0]), None))
            return [self]
        if fname == "write":
            self._require_open()
            self.pending.append(("write", text_of(args[0]), args[1]))
            return [self]
        if fname == "fill":
            self._require_open()
            self.pending.append(("fill", text_of(args[0]), args[1]))
            return [self]
        if fname == "resize":
            self._require_open()
            self.pending.append(("resize", text_of(args[0]), args[1]))
            return [self]
        if fname == "set_attr":
            self._require_open()
            self.pending.append(("attr", text_of(args[0]), args[1]))
            return [self]
        if fname == "set_attrs":
            self._require_open()
            st = args[0]
            for k in st.fields:
                self.pending.append(("attr", k, st.get_scalar_field(k)))
            return [self]
        if fname == "commit":
            self._require_open()
            root, m = self.ds.root, self.ds.manifest
            for kind, name, payload in self.pending:
                if kind == "create":
                    meta = _parse_array_meta(name, payload)
                    _write_array(root, meta,
                                 np.full(meta["shape"], meta.get("fill", 0.0)))
                    m["arrays"][name] = meta
                elif kind == "delete":
                    m["arrays"].pop(name, None)
                elif kind == "write":
                    meta = m["arrays"].get(name)
                    if meta is None:
                        raise _err(f"no array '{name}'")
                    _write_array(root, meta,
                                 payload.host().astype(np.float64))
                elif kind == "fill":
                    meta = m["arrays"].get(name)
                    v = float(payload.host().reshape(-1)[0])
                    _write_array(root, meta, np.full(meta["shape"], v))
                    meta["fill"] = v
                elif kind == "resize":
                    meta = m["arrays"].get(name)
                    old = _read_array(root, meta)
                    new_shape = [int(x) for x in
                                 fortran_ravel(payload.host().astype(np.float64))]
                    new = np.zeros(new_shape, dtype=old.dtype)
                    sl = tuple(slice(0, min(a, b))
                               for a, b in zip(old.shape, new_shape))
                    new[sl] = old[sl]
                    meta["shape"] = new_shape
                    _write_array(root, meta, new)
                elif kind == "attr":
                    m["attrs"][name] = _json_attr(payload)
            m["txn_sequence"] += 1
            _write_manifest(root, m)
            self.status = "committed"
            return [self]
        return NotImplemented


def _parse_array_meta(name: str, meta) -> dict:
    dtype = "f64"
    shape = [0, 0]
    chunk = None
    fill = 0.0
    if isinstance(meta, StructArray):
        if "dtype" in meta.fields:
            dtype = text_of(meta.get_scalar_field("dtype"))
        if "shape" in meta.fields:
            shape = [int(x) for x in fortran_ravel(
                meta.get_scalar_field("shape").host().astype(np.float64))]
        if "chunk_shape" in meta.fields:
            chunk = [int(x) for x in fortran_ravel(
                meta.get_scalar_field("chunk_shape").host().astype(np.float64))]
        if "fill" in meta.fields:
            fill = float(meta.get_scalar_field("fill").host().reshape(-1)[0])
    if dtype not in _DTYPES:
        raise _err(f"unknown dtype '{dtype}'")
    return {"name": name, "dtype": dtype, "shape": shape,
            "chunk_shape": chunk or shape or [1], "fill": fill, "codec": "raw"}


# ----------------------------------------------------------- data.* builtins --- #

@builtin("data_create", category="io/data", min_in=2)
def m_data_create(path, schema, *rest):
    root = text_of(path)
    if not isinstance(schema, StructArray) or "arrays" not in schema.fields:
        raise _err("schema must be a struct with an 'arrays' field")
    arrays_struct = schema.get_scalar_field("arrays")
    arrays = {}
    for name in arrays_struct.fields:
        meta = _parse_array_meta(name, arrays_struct.get_scalar_field(name))
        arrays[name] = meta
    manifest = {
        "schema_version": 1, "format": "runmat-data/1",
        "dataset_id": uuid.uuid4().hex, "name": None,
        "created_at": _now(), "updated_at": _now(),
        "arrays": arrays, "attrs": {}, "txn_sequence": 0,
    }
    fs().mkdir(root)
    _write_manifest(root, manifest)
    for meta in arrays.values():
        _write_array(root, meta, np.full(meta["shape"], meta.get("fill", 0.0)))
    return DatasetValue(root)


@builtin("data_open", category="io/data", min_in=1)
def m_data_open(path, *rest):
    return DatasetValue(text_of(path))


@builtin("data_exists", category="io/data", min_in=1, max_in=1)
def m_data_exists(path):
    return MatArray.logical_scalar(fs().is_file(_manifest_path(text_of(path))))


@builtin("data_delete", category="io/data", min_in=1, max_in=1)
def m_data_delete(path):
    fs().rmdir(text_of(path), recursive=True)
    return None


@builtin("data_copy", category="io/data", min_in=2, max_in=2)
def m_data_copy(src, dst):
    fs().copy(text_of(src), text_of(dst))
    ds = DatasetValue(text_of(dst))
    ds.manifest["dataset_id"] = uuid.uuid4().hex
    _write_manifest(ds.root, ds.manifest)
    return ds


@builtin("data_move", category="io/data", min_in=2, max_in=2)
def m_data_move(src, dst):
    fs().rename(text_of(src), text_of(dst))
    return DatasetValue(text_of(dst))


@builtin("data_list", category="io/data", min_in=1, max_in=1)
def m_data_list(root):
    base = text_of(root)
    names = [n for n in (fs().listdir(base) if fs().is_dir(base) else [])
             if fs().is_file(_manifest_path(base.rstrip("/") + "/" + n))]
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(sorted(names)):
        data[i, 0] = MatArray.char_from_str(n)
    return CellArray(data)


@builtin("data_inspect", category="io/data", min_in=1, max_in=1)
def m_data_inspect(path):
    m = _read_manifest(text_of(path))
    arr_fields = {}
    for name, meta in m["arrays"].items():
        arr_fields[name] = StructArray.scalar({
            "dtype": MatArray.char_from_str(meta["dtype"]),
            "shape": MatArray(np.array([meta["shape"]], dtype=np.float64),
                              "double"),
            "chunk_shape": MatArray(np.array([meta["chunk_shape"]],
                                             dtype=np.float64), "double"),
        })
    return StructArray.scalar({
        "dataset_id": MatArray.char_from_str(m["dataset_id"]),
        "txn_sequence": MatArray.scalar(float(m["txn_sequence"])),
        "arrays": StructArray.scalar(arr_fields),
        "attrs": StructArray.scalar({k: _attr_value(v)
                                     for k, v in m["attrs"].items()}),
    })


@builtin("data_export", category="io/data", min_in=2, max_in=2, pass_ctx=True)
def m_data_export(path, matpath, ctx=None):
    """Export all arrays of a dataset to a .mat file."""
    ds = DatasetValue(text_of(path))
    args = [matpath]
    names = sorted(ds.manifest["arrays"])
    for n in names:
        arr = ds._mat_call_method_(None, None, "array", [MatArray.char_from_str(n)], 1)[0]
        val = arr._mat_call_method_(None, None, "read", [], 1)[0]
        ctx.frame.vars[n] = val
        args.append(MatArray.char_from_str(n))
    ctx.interp.call_named("save", args, 0, ctx.frame)
    return None


@builtin("data_import", category="io/data", min_in=2, max_in=2, pass_ctx=True)
def m_data_import(path, source, ctx=None):
    """Import a struct (or .mat file) as a new dataset."""
    root = text_of(path)
    if is_text(source):
        loaded = ctx.interp.call_named("load", [source], 1, ctx.frame)[0]
    else:
        loaded = source
    if not isinstance(loaded, StructArray):
        raise _err("data.import: source must be a struct or .mat path")
    arrays = {}
    payloads = {}
    for name in loaded.fields:
        v = loaded.get_scalar_field(name)
        if not isinstance(v, MatArray):
            continue
        h = v.host().astype(np.float64)
        arrays[name] = {"name": name, "dtype": "f64",
                        "shape": list(h.shape), "chunk_shape": list(h.shape),
                        "fill": 0.0, "codec": "raw"}
        payloads[name] = h
    manifest = {
        "schema_version": 1, "format": "runmat-data/1",
        "dataset_id": uuid.uuid4().hex, "name": None,
        "created_at": _now(), "updated_at": _now(),
        "arrays": arrays, "attrs": {}, "txn_sequence": 0,
    }
    fs().mkdir(root)
    _write_manifest(root, manifest)
    for name, h in payloads.items():
        _write_array(root, arrays[name], h)
    return DatasetValue(root)


@builtin("commit", category="io/data", min_in=1, max_in=1)
def m_commit(tx):
    if not isinstance(tx, DataTransactionValue):
        raise bad_arg("commit", "Expected a DataTransaction.")
    return tx._mat_call_method_(None, None, "commit", [], 1)[0]


@builtin("data", category="io/data", max_in=0)
def m_data_namespace():
    """The data package namespace: data.create/open/... resolve through
    FunctionHandle fields (same mechanism as containers.Map)."""
    from ...values import FunctionHandle
    names = ("create", "open", "exists", "delete", "copy", "move", "list",
             "inspect", "export", "import")
    return StructArray.scalar({
        n: FunctionHandle("named", name=f"data_{n}") for n in names})
