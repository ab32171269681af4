"""TorchEngine: the runmat_tpu engine contract on PyTorch tensors.

The host layers of `runmat_tpu` (front end, VM, builtins, `values.py`,
`session.py`) reach the device only through the methods the runtime calls on
`runmat_tpu.accel.active_engine()`. This engine answers them with torch
tensors on an explicit `torch.device`:

  * every call adds a node to the lazy DAG of `runmat_tpu.accel.lazy`, as
    under `JaxEngine`;
  * `materialize` turns the DAG into the same program tuples
    (`_build_program`) and runs them eagerly, op by op, freeing each
    intermediate after its last use;
  * random draws go through `ops.threefry.rng_draw`: the hand-written CUDA
    kernel on a card, its plain PyTorch version on the CPU.

Values are stored in their physical shape (`phys_shape`: scalars rank-0,
vectors rank-1) and in torch's row-major layout; the MATLAB column-major
order is applied where it is observable (`reshape_f`).

Methods outside this slice either decline through the runtime's route gates
(`route_linalg`, `route_fft`) or raise `NotImplementedError`. None of them
computes on the host while the value is claimed to be on the device.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Optional

import numpy as np
import torch

from runmat_tpu import dtypes
from runmat_tpu.accel.engine import _categorize, phys_shape
from runmat_tpu.accel.lazy import DEFAULT_FUSE_CAP, topo_order
from runmat_tpu.accel.residency import ResidencyPool
from runmat_tpu.errors import MatError
from runmat_tpu.ops import ctrng as philox
from runmat_tpu.values import MatArray, normalize_shape

from ..ops import table
from ..ops.threefry import rng_draw
from .lazy import TorchLazyNode

# median is left out: torch.median takes the lower middle value
_REDUCE_OPS = {"sum", "mean", "min", "max", "any", "all", "prod",
               "std0", "std1", "var0", "var1", "nnz"}

_DTYPES = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.int8, torch.int8), (np.int16, torch.int16),
    (np.int32, torch.int32), (np.int64, torch.int64),
    (np.uint8, torch.uint8), (np.uint16, torch.uint16),
    (np.uint32, torch.uint32), (np.uint64, torch.uint64),
    (np.float16, torch.float16), (np.float32, torch.float32),
    (np.float64, torch.float64))}


def torch_dtype(dt) -> torch.dtype:
    return _DTYPES[np.dtype(dt)]


def reshape_f(x: torch.Tensor, shape) -> torch.Tensor:
    """Column-major (MATLAB) reshape: flatten `x` in F-order and lay the
    sequence out F-order in `shape`. Returns a view where torch can."""
    flat = x.permute(*reversed(range(x.ndim))).reshape(-1) if x.ndim > 1 \
        else x.reshape(-1)
    shape = tuple(shape)
    if len(shape) <= 1:
        return flat.reshape(shape)
    return flat.reshape(shape[::-1]).permute(*reversed(range(len(shape))))


def _not_ported(method: str, item: str):
    raise NotImplementedError(
        f"runmat_tpu_torch: {method} not ported yet (ROADMAP {item})")


class TorchEngine:
    def __init__(self, device="cuda", auto_offload: Optional[bool] = None,
                 offload_threshold: Optional[int] = None):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available() or \
                    (device.index or 0) >= torch.cuda.device_count():
                raise MatError("parallel:gpu:device:NoDevice",
                               f"No CUDA device available for {device}.")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.platform = "gpu"
        elif device.type == "cpu":
            self.platform = "cpu"
        else:
            raise MatError("parallel:gpu:device:NoDevice",
                           f"Unsupported device {device}.")
        self.device = device
        # offload policy of JaxEngine (engine.py:133-154), without its
        # TPU calibration file
        env_auto = os.environ.get("RUNMAT_TPU_AUTO_OFFLOAD")
        if auto_offload is None:
            auto_offload = (env_auto == "1") if env_auto is not None else \
                self.platform != "cpu"
        self.auto_offload = bool(auto_offload)
        if offload_threshold is None:
            env_thr = os.environ.get("RUNMAT_TPU_OFFLOAD_THRESHOLD")
            offload_threshold = int(env_thr) if env_thr is not None else None
        self.offload_threshold = offload_threshold or 32768
        self.mesh = None
        self.supports_complex = False
        self.fuse_cap = int(os.environ.get("RUNMAT_TPU_FUSE_CAP",
                                           str(DEFAULT_FUSE_CAP)))
        # reset(gpuDevice) clears this; the eager executor caches nothing
        self._jit_cache: dict = {}
        self.stats = {"dispatches": 0, "compiles": 0, "cache_hits": 0,
                      "uploads": 0, "gathers": 0, "upload_bytes": 0,
                      "gather_bytes": 0, "host_fallbacks": 0,
                      "loop_folds": 0, "loop_bails": 0,
                      "while_not_ported": 0}
        self.category_stats: dict = {}
        self.launch_log = collections.deque(maxlen=64)
        self.dispatch_seq = 0
        self.gathered_seq = 0
        self.residency = ResidencyPool()

    # ------------------------------------------------------------- dtype policy

    def dtype_for(self, mclass: str, is_complex: bool = False):
        return np.dtype(dtypes.np_dtype(mclass, is_complex))

    # ------------------------------------------------------------ residency ops

    def to_device(self, h: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor in physical shape (always a copy)."""
        ps = phys_shape(h.shape)
        t = torch.from_numpy(np.array(h.reshape(ps), order="C"))
        self.stats["uploads"] += 1
        self.stats["upload_bytes"] += h.nbytes
        return t.to(self.device)

    def upload(self, x: MatArray, force_shard: bool = False) -> MatArray:
        if x.is_complex:
            _not_ported("complex upload", "A8")
        h = x.host()
        node = TorchLazyNode(self, "leaf", [], (), h.shape, h.dtype,
                             value=self.to_device(h))
        return MatArray.from_device(node, x.mclass)

    def _lift(self, x: MatArray, dt: np.dtype) -> TorchLazyNode:
        """MatArray -> DAG node. Host scalars become scalar parameters."""
        if x.on_device:
            return x.dev
        h = x._host
        if h.dtype.kind == "c":
            _not_ported("complex operands", "A8")
        if h.size == 1:
            return self._scalar_node(h.reshape(-1)[0], dt)
        return TorchLazyNode(self, "leaf", [], (), h.shape, h.dtype,
                             value=self.to_device(h))

    def _scalar_node(self, v, dt: np.dtype) -> TorchLazyNode:
        return TorchLazyNode(self, "scalar", [], (), (1, 1), dt, value=v)

    def _op(self, op: str, inputs: list, static: tuple, shape,
            dtype) -> TorchLazyNode:
        node = TorchLazyNode(self, op, inputs, static, shape, dtype)
        if node.n_ops > self.fuse_cap:
            self.materialize(node)
        return node

    # ------------------------------------------------------------------ routing

    def _declines(self, op: str, reason: str, *xs) -> bool:
        """A gate that keeps work on the host: counted as a host fallback
        when a device value has to come back for it."""
        if any(isinstance(x, MatArray) and x.on_device for x in xs):
            self.note_fallback(op, reason)
        return False

    def route_binary(self, op: str, a: MatArray, b: MatArray) -> bool:
        if a.is_complex or b.is_complex:
            return self._declines(op, "complex not ported (A8)", a, b)
        if op not in table.BINARY:
            return self._declines(op, "op not in the torch table", a, b)
        if a.on_device or b.on_device:
            return True
        if not self.auto_offload:
            return False
        if a.mclass not in ("double", "single", "logical") or \
                b.mclass not in ("double", "single", "logical"):
            return False
        return max(a.size, b.size) >= self.offload_threshold

    def route_unary(self, op: str, a: MatArray) -> bool:
        if a.is_complex:
            return self._declines(op, "complex not ported (A8)", a)
        if op not in table.UNARY:
            return self._declines(op, "op not in the torch table", a)
        if a.on_device:
            return True
        return (self.auto_offload and a.size >= self.offload_threshold
                and a.mclass in ("double", "single"))

    def route_matmul(self, a: MatArray, b: MatArray) -> bool:
        if a.is_complex or b.is_complex:
            return self._declines("matmul", "complex not ported (A8)", a, b)
        if a.on_device or b.on_device:
            return True
        return self.auto_offload and \
            min(a.size, b.size) >= self.offload_threshold

    def route_linalg(self, *xs) -> bool:
        return self._declines("linalg", "linalg not ported (A7)", *xs)

    def route_fft(self, x: MatArray) -> bool:
        return self._declines("fft", "fft not ported (A7)", x)

    def offload_creation(self, n: int) -> bool:
        return self.auto_offload and n >= self.offload_threshold

    def offload_rng(self, n: int) -> bool:
        return self.auto_offload and n >= self.offload_threshold

    # -------------------------------------------------------------- DAG nodes

    def _common_dtype(self, a: MatArray, b: MatArray) -> np.dtype:
        da = self.dtype_for(a.mclass if a.mclass not in ("logical", "char")
                            else "double")
        db = self.dtype_for(b.mclass if b.mclass not in ("logical", "char")
                            else "double")
        return np.result_type(da, db)

    def binary(self, op: str, a: MatArray, b: MatArray,
               out_class: str) -> MatArray:
        if op in table.COMPARE_OPS or op in table.LOGICAL_OPS:
            dt = np.dtype(np.bool_)
            work_dt = self._common_dtype(a, b)
        else:
            dt = work_dt = self.dtype_for(out_class)
        na = self._lift(a, work_dt)
        nb = self._lift(b, work_dt)
        from runmat_tpu.runtime.dispatch import (_broadcast_check,
                                                 matlab_broadcast_shape)
        _broadcast_check(na.shape, nb.shape)
        shape = matlab_broadcast_shape(na.shape, nb.shape)
        node = self._op("b:" + op, [na, nb], (str(work_dt),), shape, dt)
        out = MatArray.from_device(node, out_class)
        out.dl = getattr(a, "dl", False) or getattr(b, "dl", False)
        return out

    def unary(self, op: str, a: MatArray, out_class: str) -> MatArray:
        dt = np.dtype(np.bool_) if out_class == "logical" else \
            self.dtype_for(out_class)
        na = self._lift(a, dt)
        node = self._op("u:" + op, [na], (), na.shape, dt)
        out = MatArray.from_device(node, out_class)
        out.dl = getattr(a, "dl", False)
        return out

    def matmul(self, a: MatArray, b: MatArray, out_class: str) -> MatArray:
        dt = self.dtype_for(out_class)
        na = self._lift(a, dt)
        nb = self._lift(b, dt)
        if len(na.shape) != 2 or len(nb.shape) != 2 or \
                na.shape[1] != nb.shape[0]:
            raise MatError("MATLAB:innerdim",
                           "Incorrect dimensions for matrix multiplication.")
        node = self._op("matmul", [na, nb], (str(dt), "highest"),
                        (na.shape[0], nb.shape[1]), dt)
        return MatArray.from_device(node, out_class)

    def transpose(self, a: MatArray, conj: bool) -> MatArray:
        na = a.dev if a.on_device else self._lift(a, a.host().dtype)
        shape = (na.shape[1], na.shape[0]) if len(na.shape) == 2 else na.shape
        node = self._op("transpose", [na], (bool(conj),), shape, na.dtype)
        return MatArray.from_device(node, a.mclass)

    def convert(self, a: MatArray, out_class: str) -> MatArray:
        dt = self.dtype_for(out_class)
        na = a.dev
        node = self._op("cast", [na], (str(dt),), na.shape, dt)
        return MatArray.from_device(node, out_class)

    def reshape(self, a: MatArray, shape: tuple) -> MatArray:
        na = a.dev
        shape = normalize_shape(shape)
        node = self._op("reshapeF", [na], (tuple(shape),), shape, na.dtype)
        return MatArray.from_device(node, a.mclass)

    def reduce(self, op: str, x: MatArray, axes: tuple, keep_class: str,
               nan_mode) -> Optional[MatArray]:
        if op not in _REDUCE_OPS:
            self._declines("r:" + op, "reduction not ported", x)
            return None
        nx = x.dev
        dt = np.dtype(np.bool_) if op in ("any", "all") else \
            self.dtype_for(keep_class)
        axes = tuple(a for a in axes if a < len(nx.shape))
        shape = tuple(1 if i in axes else s for i, s in enumerate(nx.shape))
        node = self._op("r:" + op, [nx], (axes, nan_mode or "", str(dt)),
                        normalize_shape(shape), dt)
        out = MatArray.from_device(node, keep_class)
        out.dl = getattr(x, "dl", False)
        return out

    def random(self, kind: str, state: philox.PhiloxState, dims: tuple,
               mclass: str) -> MatArray:
        n = 1
        for d in dims:
            n *= d
        start = state.advance(philox.blocks_for(kind, n, mclass))
        lo = self._scalar_node(np.uint32(start & 0xFFFFFFFF),
                               np.dtype(np.uint32))
        hi = self._scalar_node(np.uint32((start >> 32) & 0xFFFFFFFF),
                               np.dtype(np.uint32))
        node = self._op("rng:" + kind, [lo, hi],
                        (state.key, n, tuple(normalize_shape(dims)), mclass),
                        normalize_shape(dims), self.dtype_for(mclass))
        return MatArray.from_device(node, mclass)

    def full(self, dims, value, mclass: str) -> MatArray:
        dt = self.dtype_for(mclass)
        shape = normalize_shape(dims)
        vn = self._scalar_node(np.asarray(value, dt).reshape(()), dt)
        node = self._op("c:full", [vn], (shape,), shape, dt)
        return MatArray.from_device(node, mclass)

    def linspace(self, start: float, stop: float, n: int,
                 mclass: str) -> MatArray:
        dt = self.dtype_for(mclass)
        sn = self._scalar_node(np.asarray(start, dt).reshape(()), dt)
        en = self._scalar_node(np.asarray(stop, dt).reshape(()), dt)
        node = self._op("c:linspace", [sn, en], (int(n),), (1, n), dt)
        return MatArray.from_device(node, mclass)

    # ------------------------------------------------------ indexing fast path

    def index_read(self, base: MatArray, args: list) -> Optional[MatArray]:
        """Colon, contiguous ranges and scalars; linear indexing over
        vectors (F-order) and `A(:)`. Anything else returns None."""
        from runmat_tpu.vm.indexing import ColonMark
        nb = base.dev
        shape = nb.shape
        if len(args) == 1 and len(shape) != 1:
            nonsing = [s for s in shape if s != 1]
            n = int(np.prod(shape))
            a = args[0]
            if len(nonsing) > 1:
                if isinstance(a, ColonMark):
                    node = self._op("reshapeF", [nb], ((n, 1),), (n, 1),
                                    nb.dtype)
                    return MatArray.from_device(node, base.mclass)
                return None
            if isinstance(a, ColonMark):
                start, stop = 0, n
            else:
                if not isinstance(a, MatArray) or a.on_device or \
                        a.mclass == "logical":
                    return None
                flat = a._host.reshape(-1)
                if flat.size == 0:
                    return None
                start = int(flat[0]) - 1
                stop = int(flat[-1])
                if flat.size != stop - start or start < 0 or stop > n or \
                        (flat.size > 1 and not np.all(np.diff(flat) == 1)):
                    return None
            if isinstance(a, ColonMark):
                out_shape = (n, 1)
            elif len(shape) == 2 and shape[0] == 1:
                out_shape = (1, stop - start)
            else:
                out_shape = (stop - start, 1)
            node = self._op("slice1", [nb], ((start, stop),), out_shape,
                            nb.dtype)
            return MatArray.from_device(node, base.mclass)
        if len(args) != len(shape):
            return None
        slices = []
        out_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                slices.append((0, shape[k]))
                out_shape.append(shape[k])
                continue
            if not isinstance(a, MatArray) or a.mclass == "logical" or \
                    a.on_device or a._host is None:
                return None
            flat = a._host.reshape(-1)
            if flat.size == 0:
                return None
            start = int(flat[0]) - 1
            stop = int(flat[-1])
            if flat.size != stop - start or start < 0 or stop > shape[k]:
                return None
            if flat.size > 1 and not np.all(np.diff(flat) == 1):
                return None
            slices.append((start, stop))
            out_shape.append(stop - start)
        node = self._op("slice", [nb], (tuple(slices),),
                        normalize_shape(out_shape), nb.dtype)
        return MatArray.from_device(node, base.mclass)

    # ------------------------------------------------- outside this slice

    def index_read_general(self, base, args):
        _not_ported("index_read_general", "A6")

    def index_write(self, base, args, rhs):
        _not_ported("index_write", "A6")

    def structural(self, op, xs, static, out_shape):
        _not_ported(f"structural {op}", "A6")

    def scan(self, op, x, axis, reverse, omitnan, keep_class):
        _not_ported(f"scan {op}", "A6")

    def sort(self, x, axis, descend, want_idx):
        _not_ported("sort", "A6")

    def unique(self, x, stable, want_idx):
        _not_ported("unique", "A6")

    def setop(self, op, a, b, stable=False, want_idx=False):
        _not_ported(f"setop {op}", "A6")

    def linalg(self, kind, xs, opts=(), out_class=None):
        _not_ported(f"linalg {kind}", "A7")

    def fft(self, x, n, dim, inverse):
        _not_ported("fft", "A7")

    # ------------------------------------------------------------ materialize

    def materialize(self, node: TorchLazyNode) -> torch.Tensor:
        """Run the DAG reachable from `node` eagerly. Workspace-pinned nodes
        of the same DAG get their values in the same pass."""
        if node.value is not None:
            return node.value
        order = topo_order(node)
        extra = [n for n in order
                 if n.pinned and n.value is None and n is not node]
        program = self._build_program(order)
        index = {id(n): i for i, n in enumerate(order)}
        out_idx = [index[id(node)]] + [index[id(n)] for n in extra]
        values = [np.asarray(n.value, dtype=n.dtype) if n.op == "scalar"
                  else n.value for n in order]
        t0 = time.perf_counter()
        results = self.run_program(program, values, out_idx)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["dispatches"] += 1
        self.dispatch_seq += 1
        ops = [n.op for n in order
               if n.value is None and n.op not in ("scalar", "leaf")]
        self.record_launch(_categorize(ops), ops, ms,
                           sum(int(r.nbytes) for r in results))
        for n, val in zip([node] + extra, results):
            n.value = val
            n.inputs = []
            n.n_ops = 0
            n.dispatch_id = self.dispatch_seq
        return results[0]

    def _build_program(self, order: list) -> list:
        """Program entries (op, static, dt, in_idx, in_shapes, out_shape),
        the JAX engine's real-valued format."""
        index = {id(n): i for i, n in enumerate(order)}
        program = []
        for n in order:
            if n.op == "scalar":
                program.append(("scalar", (), n.dtype, (), (), n.shape))
            elif n.value is not None:
                program.append(("__leaf__", (), n.dtype, (), (), n.shape))
            else:
                program.append((n.op, n.static, n.dtype,
                                tuple(index[id(i)] for i in n.inputs),
                                tuple(i.shape for i in n.inputs), n.shape))
        return program

    def run_program(self, program: list, values: list, out_idx: list) -> list:
        """Execute program entries in order. `values[i]` is the payload of a
        leaf or scalar entry (unused for ops). Each intermediate is dropped
        after its last consumer, so a long chain holds only what is live."""
        last_use = list(range(len(program)))
        for i, entry in enumerate(program):
            for j in entry[3]:
                last_use[j] = i
        keep = set(out_idx)
        env: list = [None] * len(program)
        for i, (op, static, dt, ins, in_shapes, out_shape) in \
                enumerate(program):
            if op in ("__leaf__", "scalar"):
                env[i] = values[i]
                continue
            env[i] = self._exec(op, static, dt, [env[j] for j in ins],
                                in_shapes, out_shape)
            for j in ins:
                if last_use[j] == i and j not in keep:
                    env[j] = None
        return [env[j] for j in out_idx]

    # --------------------------------------------------------------- executor

    _OPS = ("cast", "reshapeF", "transpose", "slice", "slice1", "c:full",
            "c:linspace", "matmul")

    def supports_op(self, op: str) -> bool:
        if op.startswith("b:"):
            return op[2:] in table.BINARY
        if op.startswith("u:"):
            return op[2:] in table.UNARY
        if op.startswith("r:"):
            return op[2:] in _REDUCE_OPS
        if op.startswith("rng:"):
            return op[4:] in ("rand", "randn")
        return op in self._OPS

    def _tensor(self, a, dt: np.dtype) -> torch.Tensor:
        """Operand as a tensor of `dt` on this device; scalar parameters
        arrive as host numpy values."""
        tdt = torch_dtype(dt)
        if isinstance(a, torch.Tensor):
            return a if a.dtype == tdt else a.to(tdt)
        return torch.tensor(np.asarray(a).astype(dt), device=self.device)

    def _to_phys(self, x: torch.Tensor, lshape: tuple) -> torch.Tensor:
        ps = phys_shape(tuple(lshape))
        return x if tuple(x.shape) == ps else x.reshape(ps)

    def _exec(self, op: str, static: tuple, dt: np.dtype, args: list,
              in_shapes: tuple = (), out_shape: tuple = ()):
        """One DAG op on physical tensors; in_shapes/out_shape are the
        logical MATLAB shapes for the ops that depend on orientation."""
        tdt = torch_dtype(dt)
        if op.startswith("rng:"):
            return self._exec_rng(op[4:], static, dt, args)
        # scalar parameters (host numpy values) become 0-d device tensors
        args = [a if isinstance(a, torch.Tensor)
                else self._tensor(a, np.asarray(a).dtype) for a in args]
        if op.startswith("b:"):
            name = op[2:]
            work_dt = np.dtype(static[0])
            # MATLAB integer arithmetic saturates: compute in f64, saturate
            int_sat = work_dt.kind in "iu" and name in table.INT_SAT_BINARY
            if int_sat:
                work_dt = np.dtype(np.float64)
            a = self._tensor(args[0], work_dt)
            b = self._tensor(args[1], work_dt)
            la, lb = in_shapes
            if a.ndim and b.ndim and tuple(la) != tuple(lb):
                a = a.reshape(la)
                b = b.reshape(lb)
                if a.ndim < b.ndim:
                    a = a.reshape(a.shape + (1,) * (b.ndim - a.ndim))
                elif b.ndim < a.ndim:
                    b = b.reshape(b.shape + (1,) * (a.ndim - b.ndim))
            r = table.BINARY[name](a, b)
            if int_sat:
                r = table.saturate_cast(r, tdt)
            if r.dtype != tdt:
                r = r.to(tdt)
            return self._to_phys(r, out_shape)
        if op.startswith("u:"):
            name = op[2:]
            a = args[0]
            if name not in ("isnan", "isinf", "isfinite", "logical_not"):
                a = self._tensor(a, dt)
            r = table.UNARY[name](a)
            return r if r.dtype == tdt else r.to(tdt)
        if op.startswith("r:"):
            return self._exec_reduce(op[2:], static, dt, args[0],
                                     in_shapes[0], out_shape)
        if op == "cast":
            return self._tensor(args[0], np.dtype(static[0]))
        if op == "matmul":
            la, lb = in_shapes
            a = self._tensor(args[0], dt).reshape(la)
            b = self._tensor(args[1], dt).reshape(lb)
            return self._to_phys(torch.matmul(a, b), out_shape)
        if op == "transpose":
            la = in_shapes[0]
            a = args[0]
            if not (len(la) == 2 and 1 in la) and a.ndim == 2:
                a = a.t()
            return self._to_phys(a, out_shape)
        if op == "reshapeF":
            return reshape_f(args[0], phys_shape(tuple(static[0])))
        if op == "slice":
            a = args[0].reshape(in_shapes[0])
            r = a[tuple(slice(s, e) for s, e in static[0])]
            return self._to_phys(r, out_shape)
        if op == "slice1":
            # linear F-order range of a vector: storage is the flat sequence
            start, stop = static[0]
            return args[0].reshape(-1)[start:stop]
        if op == "c:full":
            (shape,) = static
            v = self._tensor(args[0], dt).reshape(())
            return v.expand(phys_shape(tuple(shape))).contiguous()
        if op == "c:linspace":
            return self._linspace(args[0], args[1], static[0], dt)
        raise MatError("MATLAB:internal", f"Unknown device op '{op}'.")

    def _linspace(self, start, stop, n: int, dt: np.dtype) -> torch.Tensor:
        """jnp.linspace's formula: start*(1-s) + stop*s with s = i/(n-1),
        and the exact endpoint appended."""
        tdt = torch_dtype(dt)
        s0 = self._tensor(start, dt).reshape(())
        s1 = self._tensor(stop, dt).reshape(())
        if n <= 1:
            return s0.reshape(1)[:n]
        div = n - 1
        step = torch.arange(div, dtype=tdt, device=self.device) / div
        out = s0 * (1 - step) + s1 * step
        return torch.cat([out, s1.reshape(1)])

    def _exec_reduce(self, name: str, static: tuple, dt: np.dtype, x,
                     lshape: tuple = (), out_shape: tuple = ()):
        axes, nan_mode, _ = static
        axes = tuple(axes)
        # logical axes onto the physical tensor: a rank-1 vector reduces
        # over its one axis iff its non-singleton logical dim is reduced
        if lshape and tuple(x.shape) != tuple(lshape):
            if x.ndim == 0:
                axes = ()
            elif x.ndim == 1:
                nonsing = next((i for i, s in enumerate(lshape) if s != 1),
                               None)
                axes = (0,) if nonsing in axes else ()
            else:
                x = x.reshape(lshape)
        r = self._reduce_impl(name, axes, nan_mode, dt, x)
        return self._to_phys(r, out_shape) if out_shape else r

    def _reduce_impl(self, name: str, axes: tuple, nan_mode, dt: np.dtype,
                     x: torch.Tensor) -> torch.Tensor:
        if not axes:
            # torch reads an empty dim list as "every dim"; reducing over no
            # dim is reducing groups of one, so give each element its own
            # trailing axis of size one and reduce that
            return self._reduce_impl(name, (x.ndim,), nan_mode, dt,
                                     x.unsqueeze(-1)).squeeze(-1)
        tdt = torch_dtype(dt)
        omitnan = nan_mode in (True, "omitnan")
        isf = x.is_floating_point()
        if name == "sum":
            xx = torch.where(torch.isnan(x), torch.zeros_like(x), x) \
                if omitnan and isf else x
            if tdt.is_floating_point:
                xx = xx.to(tdt)
            return torch.sum(xx, dim=axes, keepdim=True).to(tdt)
        if name == "prod":
            xx = torch.where(torch.isnan(x), torch.ones_like(x), x) \
                if omitnan and isf else x
            # torch.prod takes one dim: move the reduced ones last, merged
            rest = [i for i in range(x.ndim) if i not in axes]
            kept = tuple(1 if i in axes else s for i, s in enumerate(x.shape))
            merged = xx.permute(*rest, *axes).reshape(
                *(x.shape[i] for i in rest), -1)
            return torch.prod(merged, dim=-1).reshape(kept).to(tdt)
        if name == "mean":
            if omitnan and isf:
                return torch.nanmean(x, dim=axes, keepdim=True).to(tdt)
            xx = x.to(tdt) if tdt.is_floating_point else x.to(torch.float64)
            return torch.mean(xx, dim=axes, keepdim=True).to(tdt)
        if name in ("min", "max"):
            f = torch.amin if name == "min" else torch.amax
            if nan_mode == "includenan" or not isf:
                return f(x, dim=axes, keepdim=True).to(tdt)
            # MATLAB's default: NaN only where the whole slice is NaN
            nan = torch.isnan(x)
            fill = float("inf") if name == "min" else float("-inf")
            r = f(torch.where(nan, torch.full_like(x, fill), x), dim=axes,
                  keepdim=True)
            allnan = torch.all(nan, dim=axes, keepdim=True)
            return torch.where(allnan, torch.full_like(r, float("nan")),
                               r).to(tdt)
        if name == "any":
            return torch.any(x != 0, dim=axes, keepdim=True)
        if name == "all":
            return torch.all(x != 0, dim=axes, keepdim=True)
        if name == "nnz":
            return torch.sum(x != 0, dim=axes, keepdim=True).to(tdt)
        if name in ("std0", "std1", "var0", "var1"):
            ddof = 0 if name.endswith("1") else 1
            xf = x.to(tdt)
            if omitnan:
                keep = ~torch.isnan(xf)
                zero = torch.zeros_like(xf)
                cnt = keep.sum(dim=axes, keepdim=True).to(tdt)
                mu = torch.where(keep, xf, zero).sum(dim=axes,
                                                     keepdim=True) / cnt
                d = torch.where(keep, xf - mu, zero)
                dof = cnt - ddof
                r = (d * d).sum(dim=axes, keepdim=True) / dof
                r = torch.where(dof > 0, r, torch.full_like(r, float("nan")))
            else:
                n = 1
                for i in axes:
                    n *= x.shape[i]
                d = xf - xf.mean(dim=axes, keepdim=True)
                r = (d * d).sum(dim=axes, keepdim=True) / (n - ddof)
            return (torch.sqrt(r) if name.startswith("std") else r).to(tdt)
        raise MatError("MATLAB:internal", f"Unknown reduce '{name}'.")

    def _exec_rng(self, kind: str, static: tuple, dt: np.dtype, args: list):
        key, n, shape, mclass = static
        lo, hi = (int(np.asarray(a)) for a in args)
        prec = torch.float32 if mclass == "single" else torch.float64
        vals = rng_draw(kind, key, (lo, hi), n, prec, self.device)
        tdt = torch_dtype(dt)
        if vals.dtype != tdt:
            vals = vals.to(tdt)
        return reshape_f(vals, phys_shape(tuple(shape)))

    # ----------------------------------------------------------- info/misc

    def record_launch(self, category: str, ops, ms: float,
                      out_bytes: int = 0) -> None:
        ent = self.category_stats.setdefault(category, [0, 0.0])
        ent[0] += 1
        ent[1] += ms
        self.launch_log.append({"cat": category, "ops": list(ops)[:16],
                                "n_ops": len(ops), "enqueue_ms": round(ms, 3),
                                "out_bytes": out_bytes})

    def note_fallback(self, kind: str, reason: str) -> None:
        self.stats["host_fallbacks"] += 1
        ent = self.category_stats.setdefault("host_fallback", [0, 0.0])
        ent[0] += 1
        self.launch_log.append({"cat": "host_fallback", "ops": [kind],
                                "n_ops": 1, "reason": reason[:160]})

    def memory_info(self) -> dict:
        if self.device.type != "cuda":
            return {"available": False, "bytes_in_use": 0, "bytes_limit": 0,
                    "devices": 1}
        return {"available": True,
                "bytes_in_use": int(torch.cuda.memory_allocated(self.device)),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    self.device).total_memory),
                "devices": 1}

    def device_info(self) -> dict:
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            return {"name": props.name, "platform": self.platform,
                    "count": torch.cuda.device_count(),
                    "memory": int(props.total_memory)}
        return {"name": "cpu", "platform": self.platform, "count": 1,
                "memory": 0}

    def telemetry(self) -> dict:
        return dict(self.stats)

    def fusion_snapshot(self) -> list:
        return []

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def block_until_ready(self, x: MatArray):
        if not x.on_device:
            return x
        self.materialize(x.dev)
        self.synchronize()
        node = x.dev
        if node.dispatch_id is not None:
            self.gathered_seq = max(self.gathered_seq, node.dispatch_id)
        return x
