"""Copy of runmat_tpu/dl/onnx.py in the PyTorch port.

ONNX model export/import: hand-rolled protobuf wire codec.

Reference parity: deep_learning/onnx.rs (ONNX import/export for the model
container). No onnx package exists in this environment, so the codec writes
the protobuf wire format directly from the public onnx.proto field numbers —
the supported graph subset is sequential Gemm/MatMul/Add/Relu/Sigmoid/
Softmax/Tanh chains (MLP-class models), float32 initializers via raw_data.
"""

from __future__ import annotations

import struct

import numpy as np

from ..errors import MatError

# --------------------------------------------------------------- wire writing #


def _varint(n: int) -> bytes:
    out = b""
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode())


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    out = b""
    for d in arr.shape:
        out += _f_varint(1, d)                    # dims
    out += _f_varint(2, 1)                        # data_type = FLOAT
    out += _f_str(8, name)                        # name
    out += _f_bytes(9, arr.tobytes())             # raw_data
    return out


def _node(op: str, inputs, outputs, attrs=None) -> bytes:
    out = b""
    for i in inputs:
        out += _f_str(1, i)
    for o in outputs:
        out += _f_str(2, o)
    out += _f_str(4, op)
    for (aname, aval) in (attrs or []):
        a = _f_str(1, aname)
        if isinstance(aval, int):
            a += _f_varint(3, aval) + _f_varint(20, 2)    # INT
        elif isinstance(aval, float):
            a += _tag(2, 5) + struct.pack("<f", aval) + _f_varint(20, 1)
        out += _f_bytes(5, a)
    return out


def export_onnx(layers: list, path: str, in_dim: int) -> None:
    """layers: list of dicts {'type': 'fc', 'W': (out,in), 'b': (out,1)} or
    {'type': 'relu'|'sigmoid'|'softmax'|'tanh'}."""
    nodes = b""
    inits = b""
    cur = "input"
    out_dim = in_dim
    k = 0
    for ly in layers:
        t = ly["type"]
        if t == "fc":
            W = np.asarray(ly["W"], np.float32)
            b = np.asarray(ly["b"], np.float32).reshape(-1)
            k += 1
            wn, bn, on = f"W{k}", f"b{k}", f"h{k}"
            inits += _f_bytes(5, _tensor(wn, W.T))       # Gemm: Y = X*W^T? use transB
            inits += _f_bytes(5, _tensor(bn, b))
            # Gemm(input, W, b) with transB=1 computes X @ W.T + b where W is
            # (out, in); we stored W.T so transB=0: Y = X @ (W.T)
            nodes += _f_bytes(1, _node("Gemm", [cur, wn, bn], [on]))
            cur = on
            out_dim = W.shape[0]
        elif t in ("relu", "sigmoid", "softmax", "tanh"):
            k += 1
            on = f"h{k}"
            opname = {"relu": "Relu", "sigmoid": "Sigmoid",
                      "softmax": "Softmax", "tanh": "Tanh"}[t]
            attrs = [("axis", 1)] if t == "softmax" else None
            nodes += _f_bytes(1, _node(opname, [cur], [on], attrs))
            cur = on
        else:
            raise MatError("MATLAB:onnx:unsupportedLayer",
                           f"Unsupported layer type '{t}'.")
    graph = nodes + inits
    graph += _f_str(2, "runmat_tpu_model")
    graph += _f_bytes(11, _value_info("input", ("N", in_dim)))
    graph += _f_bytes(12, _value_info(cur, ("N", out_dim)))
    # dynamic batch: encode the 'N' dim as dim_param instead
    model = _f_varint(1, 8)                              # ir_version
    model += _f_str(2, "runmat-tpu")                     # producer
    model += _f_bytes(7, graph)
    model += _f_bytes(8, _f_str(1, "") + _f_varint(2, 13))   # opset 13
    with open(path, "wb") as f:
        f.write(model)


def _value_info(name: str, shape) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _f_bytes(1, _f_str(2, d))             # dim_param
        else:
            dims += _f_bytes(1, _f_varint(1, int(d)))     # dim_value
    tshape = _f_bytes(2, dims)
    ttensor = _f_varint(1, 1) + tshape
    ttype = _f_bytes(1, ttensor)
    return _f_str(1, name) + _f_bytes(2, ttype)


# --------------------------------------------------------------- wire reading #


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def eof(self):
        return self.p >= len(self.d)

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.d[self.p]
            self.p += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def field(self):
        key = self.varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            return field, self.varint()
        if wire == 2:
            n = self.varint()
            v = self.d[self.p:self.p + n]
            self.p += n
            return field, v
        if wire == 5:
            v = self.d[self.p:self.p + 4]
            self.p += 4
            return field, v
        if wire == 1:
            v = self.d[self.p:self.p + 8]
            self.p += 8
            return field, v
        raise MatError("MATLAB:onnx:badWire", f"Unsupported wire type {wire}.")


def _parse_tensor(data: bytes):
    r = _Reader(data)
    dims = []
    name = ""
    raw = b""
    dtype = 1
    floats = []
    while not r.eof():
        f, v = r.field()
        if f == 1:
            dims.append(v)
        elif f == 2:
            dtype = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
        elif f == 4:
            # packed float_data
            floats = np.frombuffer(v, "<f4") if isinstance(v, bytes) else v
    if raw:
        arr = np.frombuffer(raw, "<f8" if dtype == 11 else "<f4").astype(np.float64)
    elif len(floats):
        arr = np.asarray(floats, np.float64)
    else:
        arr = np.zeros(0)
    return name, arr.reshape([int(d) for d in dims] or [-1])


def _parse_node(data: bytes):
    r = _Reader(data)
    ins, outs, op = [], [], ""
    while not r.eof():
        f, v = r.field()
        if f == 1:
            ins.append(v.decode())
        elif f == 2:
            outs.append(v.decode())
        elif f == 4:
            op = v.decode()
    return op, ins, outs


def import_onnx(path: str):
    """-> list of layer dicts (the export_onnx subset)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    graph = None
    while not r.eof():
        f_, v = r.field()
        if f_ == 7:
            graph = v
    if graph is None:
        raise MatError("MATLAB:onnx:noGraph", "No graph in ONNX file.")
    gr = _Reader(graph)
    nodes = []
    inits = {}
    while not gr.eof():
        f_, v = gr.field()
        if f_ == 1:
            nodes.append(_parse_node(v))
        elif f_ == 5:
            nm, arr = _parse_tensor(v)
            inits[nm] = arr
    layers = []
    for op, ins, outs in nodes:
        if op == "Gemm" or op == "MatMul":
            Wt = inits.get(ins[1])
            if Wt is None:
                raise MatError("MATLAB:onnx:dynamicWeight",
                               "Only initializer weights are supported.")
            b = inits.get(ins[2]).reshape(-1) if op == "Gemm" and \
                len(ins) > 2 else np.zeros(Wt.shape[1])
            layers.append({"type": "fc", "W": Wt.T.copy(),
                           "b": b.reshape(-1, 1)})
        elif op in ("Relu", "Sigmoid", "Softmax", "Tanh"):
            layers.append({"type": op.lower()})
        elif op in ("Add",):
            raise MatError("MATLAB:onnx:unsupportedNode",
                           "Standalone Add nodes are not supported (use Gemm).")
        else:
            raise MatError("MATLAB:onnx:unsupportedNode",
                           f"Unsupported ONNX op '{op}'.")
    return layers
