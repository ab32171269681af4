"""TorchEngine: the engine contract of `runmat_tpu`'s JaxEngine on PyTorch
tensors.

The port's host layers (front end, VM, builtins, `values.py`, `session.py`,
copied from `runmat_tpu`) reach the device only through the methods the
runtime calls on `accel.active_engine()`. This engine answers them with
torch tensors on an explicit `torch.device`:

  * every call adds a node to the lazy DAG of `accel/lazy.py`, as under
    `JaxEngine`;
  * `materialize` turns the DAG into the same program tuples
    (`_build_program`) and runs them through a fusion plan (`accel/fuse.py`),
    cached in `_jit_cache` under the JAX package's key (the DAG's
    `structure_key` and its output positions) and counted in
    `stats["compiles"]`/`["cache_hits"]` as JaxEngine counts its `jax.jit`
    executables: each group of elementwise ops, optionally ending in a
    `sum`/`mean` and its epilogue, runs as one generated Triton kernel on a
    card (`ops/fused.py`; its plain version, the same entries through
    `_exec`, on the CPU), every other op eagerly through `_exec`
    (`stats["eager_ops"]`, `eager_by_op`), each intermediate freed after
    its last use. A materialize's launch-log entry names its generated
    kernels (`kernels`) and its eager ops with their reasons (`eager`);
    `fusion_snapshot` lists the cached plans. Nothing in a program waits for
    the card: a scalar parameter becomes a 0-d tensor filled on the device once
    per program (`_scalar`, a fill kernel with the value as its launch
    argument), an upload is an asynchronous copy from pinned memory, and no
    op reads a device value back inside torch (`index_fill_` and indexing
    with a 0-d index tensor would, so neither is used);
  * random draws go through `ops.threefry.rng_draw`: the hand-written CUDA
    kernel on a card, its plain PyTorch version on the CPU. A draw's counter
    is one int64 scalar node: a host int in `materialize`, a device tensor
    computed on the card in a folded loop (`accel/loops.py`);
  * `linalg` goes through `DenseOps` (`accel/dense.py`), whose `histcounts`
    runs on the hand-written histogram kernel (`ops/histogram.py`); `sort`,
    `unique` and `setop` go through it too, as under `JaxEngine`;
  * indexed reads and writes, the structural L-ops and `median` are DAG
    ops like the others, run by `_exec` in plain torch (`index_select`,
    `index_put_`, `torch.where`, `flip`/`roll`/`repeat`/`permute`/...).

Values are stored in their physical shape (`phys_shape`: scalars rank-0,
vectors rank-1) and in torch's row-major layout; the MATLAB column-major
order is applied where it is observable (`reshape_f`): every linear
(F-order) gather and scatter maps its indices onto the stored layout, and a
write returns a new tensor, never one that writes through its input.

A gate that keeps work on the host (a repeated or out-of-range subscript, a
growing write, complex operands, `route_fft`, a `linalg` kind without a
builder) is counted as a host fallback, with its reason in the launch log,
whenever a device value has to come back for it. None of the methods
computes on the host while the value is claimed to be on the device. A
device value read back only to steer the host (unique's count, a `while`
condition) is counted in `syncs`/`sync_bytes`, not as a gather. Those
reads and the gathers are the only points where the host waits for the
card (`runmat_tpu_torch/syncs.py` checks that on a card).

`matmul` stamps the session's precision policy into the op's static, as the
JAX engine does (`_mm_policy`, engine.py:199-203, 264): "highest" and
"native" multiply single in true FP32, "high" in TF32, "bf16" and "default"
round the operands to bf16 and accumulate in FP32. The TF32 switch is set
around the one product and restored after it.

`_categorize`, `phys_shape`, `_index_vec`, `index_read_general`,
`index_write` and `structural` follow `runmat_tpu/accel/engine.py` (48-90,
632-659, 987-1149).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import dtypes
from ..errors import MatError
from ..ops import ctrng as philox
from ..ops import table
from ..ops.threefry import rng_draw
from ..runtime.dispatch import _broadcast_check, matlab_broadcast_shape
from ..unported import not_ported
from ..values import MatArray, normalize_shape
from ..vm.indexing import ColonMark
from .dense import DenseOps
from . import fuse
from .lazy import DEFAULT_FUSE_CAP, LazyNode, structure_key, topo_order
from .residency import ResidencyPool

_REDUCE_OPS = {"sum", "mean", "min", "max", "any", "all", "prod",
               "std0", "std1", "var0", "var1", "median", "nnz"}
_SCAN_OPS = {"cumsum", "cumprod", "cummax", "cummin"}
# structural ops over logical shapes (engine.py:1522-1546)
_L_OPS = ("flipL", "rollL", "tileL", "rot90L", "permuteL", "trilL", "triuL",
          "kronL")
_INDEX_OPS = ("iota", "gather1", "gather1d", "gatherN", "scatter1",
              "scatter1d", "scatterN", "fillall", "maskset")

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


def _fflat(x: torch.Tensor, lshape) -> torch.Tensor:
    """The F-order sequence of a tensor stored in the physical shape of
    `lshape` (a view where x is F-contiguous or rank 1)."""
    if x.ndim <= 1:
        return x.reshape(-1)
    return reshape_f(x.reshape(tuple(lshape)), (x.numel(),))


def _c_index(idx: torch.Tensor, shape) -> torch.Tensor:
    """0-based F-order linear indices into an array of `shape` -> the
    row-major linear indices of the same elements."""
    out = torch.zeros_like(idx)
    rest = idx
    stride = 1
    strides = []
    for s in reversed(shape):
        strides.append(stride)
        stride *= s
    for s, st in zip(shape, reversed(strides)):
        out = out + (rest % s) * st
        rest = rest // s
    return out


def _integral(h: np.ndarray) -> bool:
    """Every subscript value is an integer (NaN is not)."""
    return h.dtype.kind in "biu" or bool(np.all(h == np.floor(h)))


def _categorize(ops: list) -> str:
    """Dominant dispatch category for telemetry (≙ ProviderTelemetry
    per-category counters)."""
    cats = set()
    for op in ops:
        if op == "matmul":
            cats.add("matmul")
        elif op.startswith("rng:"):
            cats.add("rng")
        elif op.startswith("r:"):
            cats.add("reduction")
        elif op.startswith("s:"):
            cats.add("scan")
        elif op.startswith(("gather", "scatter", "slice", "maskset",
                            "fillall")):
            cats.add("indexing")
    for c in ("matmul", "rng", "reduction", "scan", "indexing"):
        if c in cats:
            return c
    return "elementwise"


def counter_value(counter: int) -> int:
    """A 64-bit counter block index as the int64 that holds its bits."""
    counter &= (1 << 64) - 1
    return counter - (1 << 64) if counter >= 1 << 63 else counter


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for float32 products on the card inside the block only."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        attr, value = "fp32_precision", "tf32" if on else "ieee"
    else:
        attr, value = "allow_tf32", on
    prev = getattr(m, attr)
    setattr(m, attr, value)
    try:
        yield
    finally:
        setattr(m, attr, prev)


def _matmul(a: torch.Tensor, b: torch.Tensor, policy: str) -> torch.Tensor:
    """A product under a precision policy. Only float32 on a card is
    affected: "high" runs in TF32; "bf16"/"default" round the operands to
    bf16 and accumulate in float32 (the rounded operands are exact in TF32,
    so the card's TF32 units give bf16 products with float32 sums); every
    other policy is true FP32."""
    if a.dtype != torch.float32:
        return torch.matmul(a, b)
    low = policy in ("bf16", "default")
    if low:
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    if not a.is_cuda:
        return torch.matmul(a, b)
    with _tf32(low or policy == "high"):
        return torch.matmul(a, b)


def phys_shape(shape: tuple) -> tuple:
    """Logical MATLAB shape -> physical on-device shape: scalars (), vectors
    rank-1, everything else in its logical shape. The logical shape lives
    on the LazyNode / MatArray."""
    n = 1
    for s in shape:
        n *= s
    if n == 1:
        return ()
    nonsing = [s for s in shape if s != 1]
    if len(nonsing) == 1:
        return (nonsing[0],)
    if n == 0:
        return (0,) if len(nonsing) <= 1 else tuple(shape)
    return tuple(shape)


class TorchEngine:
    def __init__(self, device="cuda", auto_offload: Optional[bool] = None,
                 offload_threshold: Optional[int] = None,
                 matmul_precision: Optional[str] = None):
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
        # the JAX engine's resolution (engine.py:199-203)
        mm = os.environ.get("RUNMAT_TPU_MATMUL_PRECISION") or matmul_precision
        if mm is None and \
                os.environ.get("RUNMAT_TPU_ALLOW_PRECISION_DOWNCAST") == "1":
            mm = "bf16"
        self.matmul_precision = (mm or "highest").lower()
        self.mesh = None
        self.supports_complex = False
        self.fuse_cap = int(os.environ.get("RUNMAT_TPU_FUSE_CAP",
                                           str(DEFAULT_FUSE_CAP)))
        # fusion plans by DAG structure (`materialize`) and folded loops by
        # program structure (accel/loops.py: their captured CUDA graphs);
        # reset(gpuDevice) and `release` clear it
        self._jit_cache: dict = {}
        self.stats = {"dispatches": 0, "compiles": 0, "cache_hits": 0,
                      "uploads": 0, "gathers": 0, "upload_bytes": 0,
                      "gather_bytes": 0, "host_fallbacks": 0,
                      "loop_folds": 0, "loop_bails": 0, "while_folds": 0,
                      "syncs": 0, "sync_bytes": 0, "graph_captures": 0,
                      "graph_replays": 0, "graph_declines": 0,
                      "eager_ops": 0}
        # the ops run through `_exec` outside a generated kernel, by op
        self.eager_by_op: collections.Counter = collections.Counter()
        self.category_stats: dict = {}
        self.launch_log = collections.deque(maxlen=64)
        self.dispatch_seq = 0
        self.gathered_seq = 0
        self.residency = ResidencyPool()
        self.dense = DenseOps(self)

    # ------------------------------------------------------------- dtype policy

    def dtype_for(self, mclass: str, is_complex: bool = False):
        return np.dtype(dtypes.np_dtype(mclass, is_complex))

    # ------------------------------------------------------------ residency ops

    def release(self) -> None:
        """Drop the captured graphs and their private memory pools."""
        self._jit_cache.clear()

    def to_device(self, h: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor in physical shape (always a copy). To
        a card, through pinned memory and an asynchronous copy: a copy from
        pageable memory would wait for the card's queue."""
        ps = phys_shape(h.shape)
        self.stats["uploads"] += 1
        self.stats["upload_bytes"] += h.nbytes
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(h.reshape(ps), order="C"))
        buf = torch.empty(ps, dtype=torch_dtype(h.dtype), pin_memory=True)
        buf.numpy()[...] = h.reshape(ps)
        return buf.to(self.device, non_blocking=True)

    def upload(self, x: MatArray, force_shard: bool = False) -> MatArray:
        if x.is_complex:
            not_ported("complex upload", "A8")
        h = x.host()
        node = LazyNode(self, "leaf", [], (), h.shape, h.dtype,
                             value=self.to_device(h))
        return MatArray.from_device(node, x.mclass)

    def _lift(self, x: MatArray, dt: np.dtype) -> LazyNode:
        """MatArray -> DAG node. Host scalars become scalar parameters."""
        if x.on_device:
            return x.dev
        h = x._host
        if h.dtype.kind == "c":
            not_ported("complex operands", "A8")
        if h.size == 1:
            return self._scalar_node(h.reshape(-1)[0], dt)
        return LazyNode(self, "leaf", [], (), h.shape, h.dtype,
                             value=self.to_device(h))

    def _scalar_node(self, v, dt: np.dtype) -> LazyNode:
        return LazyNode(self, "scalar", [], (), (1, 1), dt, value=v)

    def _op(self, op: str, inputs: list, static: tuple, shape,
            dtype) -> LazyNode:
        node = LazyNode(self, op, inputs, static, shape, dtype)
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
        if op not in table.TORCH_BINARY:
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
        if op not in table.TORCH_UNARY:
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
        """JaxEngine's policy (engine.py:832-845): a resident operand, or
        auto-offload by the largest operand's size. Whether the kind has a
        builder is `linalg`'s question."""
        xs = [x for x in xs if isinstance(x, MatArray)]
        if any(x.is_complex for x in xs):
            return self._declines("linalg", "complex not ported (A8)", *xs)
        if any(x.on_device for x in xs):
            return True
        if not self.auto_offload:
            return False
        if any(x.mclass not in ("double", "single") for x in xs):
            return False
        return max((x.size for x in xs), default=0) >= self.offload_threshold

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
        node = self._op("matmul", [na, nb], (str(dt), self.matmul_precision),
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
        ctr = self._scalar_node(counter_value(start), np.dtype(np.int64))
        node = self._op("rng:" + kind, [ctr],
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

    def scan(self, op: str, x: MatArray, axis: int, reverse: bool,
             omitnan: bool, keep_class: str) -> Optional[MatArray]:
        """cumsum/cumprod/cummax/cummin along logical `axis` (0-based)."""
        if op not in _SCAN_OPS:
            self._declines("s:" + op, "scan not ported", x)
            return None
        nx = x.dev
        dt = self.dtype_for(keep_class)
        node = self._op("s:" + op, [nx],
                        (int(axis), bool(reverse), bool(omitnan), str(dt)),
                        nx.shape, dt)
        out = MatArray.from_device(node, keep_class)
        out.dl = getattr(x, "dl", False)
        return out

    def linalg(self, kind: str, xs: list, opts: tuple = (),
               out_class: Optional[str] = None) -> Optional[list]:
        """Eager device op through `DenseOps`; outputs are leaf MatArrays.
        None when the port has no builder for `kind`: the caller's host
        path (engine.py:847-860)."""
        out = self.dense.call(kind, xs, opts)
        if out is None:
            return None
        if out_class is None:
            out_class = "single" if any(x.mclass == "single" for x in xs) \
                else "double"
        return [self.dense._leaf(arr, out_class) for arr in out]

    # ------------------------------------------------------ indexing fast path

    def index_read(self, base: MatArray, args: list) -> Optional[MatArray]:
        """Colon, contiguous ranges and scalars; linear indexing over
        vectors (F-order) and `A(:)`. Anything else returns None."""
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
                if flat.size == 0 or not _integral(flat):
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
            if flat.size == 0 or not _integral(flat):
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

    # ------------------------------------------ general indexing (lazy)

    def _host_path(self, op: str, reason: str, *xs) -> None:
        """A None that sends a builtin or subscript to its host path,
        counted when a device value comes back for it."""
        self._declines(op, reason, *xs)
        return None

    @staticmethod
    def _subscript_reason(a) -> str:
        if not isinstance(a, MatArray):
            return f"{type(a).__name__} subscript"
        if a.on_device:
            return "subscript on the device"
        if a.mclass == "logical":
            return "logical subscript"
        if a.is_complex or a.size == 0:
            return "complex or empty subscript"
        return "subscript out of range or repeated"

    def _index_vec(self, a, extent: int, unique_required: bool = False
                   ) -> Optional[np.ndarray]:
        """Host numeric subscript -> validated 0-based index vector.
        unique_required: writes with duplicate subscripts are MATLAB
        last-wins, which `index_put_` on a card does not guarantee -> host
        path. Out of range or not an integer -> host path, which raises the
        MATLAB error (the JAX package truncates 1.5 to 1 here)."""
        if not isinstance(a, MatArray) or a.on_device or \
                a.mclass == "logical" or a.is_complex:
            return None
        h = a._host
        if h is None or h.size == 0 or not _integral(h):
            return None
        flat = h.reshape(-1, order="F").astype(np.int64)
        if np.any(flat < 1) or np.any(flat > extent):
            return None
        if unique_required and flat.size > 1 and \
                np.unique(flat).size != flat.size:
            return None
        return flat - 1

    def _idx_leaf(self, flat: np.ndarray) -> LazyNode:
        """A 0-based index vector as an int64 node. An arithmetic
        progression (a range subscript such as 1:64:N) is made on the device
        from its start, step and length, so nothing is copied; any other
        vector is uploaded."""
        n = int(flat.size)
        step = int(flat[1] - flat[0]) if n > 1 else 1
        if n == 1 or bool(np.all(np.diff(flat) == step)):
            return LazyNode(self, "iota", [], (int(flat[0]), step, n), (n,),
                            np.dtype(np.int64))
        iv = np.ascontiguousarray(flat, dtype=np.int64)
        return LazyNode(self, "leaf", [], (), (n,), iv.dtype,
                        value=self.to_device(iv))

    def index_read_general(self, base: MatArray, args: list
                           ) -> Optional[MatArray]:
        """Arbitrary numeric-subscript gather, lazy on the device: one
        subscript is an F-order linear gather (`gather1`), one per dimension
        an `index_select` chain (`gatherN`)."""
        nb = base.dev
        shape = nb.shape
        if len(args) == 1:
            n = int(np.prod(shape))
            a = args[0]
            iv = self._index_vec(a, n)
            if iv is None:
                return self._host_path("index_read", self._subscript_reason(a),
                                       base)
            ih = a._host
            base_is_vec = len(shape) == 2 and (shape[0] == 1 or shape[1] == 1)
            idx_is_vec = ih.ndim == 2 and (ih.shape[0] == 1 or ih.shape[1] == 1)
            if base_is_vec and idx_is_vec:
                out_shape = (1, iv.size) if shape[0] == 1 else (iv.size, 1)
            else:
                out_shape = normalize_shape(ih.shape)
            node = self._op("gather1", [nb, self._idx_leaf(iv)], (),
                            out_shape, nb.dtype)
            return MatArray.from_device(node, base.mclass)
        if len(args) != len(shape):
            return self._host_path("index_read", f"{len(args)} subscripts of "
                                   f"a {len(shape)}-D array", base)
        inputs = [nb]
        spec = []
        out_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                spec.append("colon")
                out_shape.append(shape[k])
                continue
            iv = self._index_vec(a, shape[k])
            if iv is None:
                return self._host_path("index_read", self._subscript_reason(a),
                                       base)
            spec.append(("s", len(inputs)))
            inputs.append(self._idx_leaf(iv))
            out_shape.append(iv.size)
        node = self._op("gatherN", inputs, (tuple(spec),),
                        normalize_shape(out_shape), nb.dtype)
        return MatArray.from_device(node, base.mclass)

    def index_write(self, base: MatArray, args: list, rhs: MatArray
                    ) -> Optional[MatArray]:
        """A lazy device write: colon fill, logical-mask write of a scalar,
        linear and N-subscript scatters. Growth, class changes, deletion,
        repeated subscripts with an array right-hand side and complex values
        stay on the host path."""
        def host(reason):
            return self._host_path("index_write", reason, base, rhs)

        if not isinstance(base, MatArray) or not base.on_device:
            return host("the base is on the host")
        nb = base.dev
        shape = nb.shape
        if base.mclass not in ("double", "single", "logical"):
            return host(f"{base.mclass} base")
        if rhs.is_complex or base.is_complex:
            return host("complex not ported (A8)")
        if rhs.mclass not in ("double", "single", "logical"):
            return host(f"{rhs.mclass} right-hand side")
        if rhs.mclass != base.mclass and base.mclass == "logical":
            return host("numeric into logical changes the class")
        if rhs.size == 1 and not rhs.on_device:
            rn = self._scalar_node(rhs._host.reshape(-1)[0], nb.dtype)
        else:
            rn = self._lift(rhs, nb.dtype)

        if len(args) == 1:
            a = args[0]
            n = int(np.prod(shape))
            if isinstance(a, ColonMark):
                if rhs.size not in (1, n):
                    return host("A(:) = B with numel(B) ~= numel(A)")
                node = self._op("fillall", [nb, rn], (), shape, nb.dtype)
                return MatArray.from_device(node, base.mclass)
            if isinstance(a, MatArray) and a.mclass == "logical":
                if rhs.size != 1 or a.size != n:
                    return host("mask write of an array or a mask of "
                                "another size")
                if a.on_device:
                    mnode = a.dev
                else:
                    mask = np.ascontiguousarray(a._host.reshape(-1, order="F"))
                    mnode = LazyNode(self, "leaf", [], (), (n,),
                                     np.dtype(np.bool_),
                                     value=self.to_device(mask))
                node = self._op("maskset", [nb, mnode, rn], (), shape,
                                nb.dtype)
                return MatArray.from_device(node, base.mclass)
            iv = self._index_vec(a, n, unique_required=rhs.size != 1)
            if iv is None or rhs.size not in (1, iv.size):
                return host(self._subscript_reason(a) if iv is None
                            else "numel(B) ~= number of subscripts")
            node = self._op("scatter1", [nb, self._idx_leaf(iv), rn],
                            (rhs.size == 1,), shape, nb.dtype)
            return MatArray.from_device(node, base.mclass)

        if len(args) != len(shape):
            return host(f"{len(args)} subscripts of a {len(shape)}-D array")
        inputs = [nb]
        spec = []
        sel_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                spec.append("colon")
                sel_shape.append(shape[k])
                continue
            iv = self._index_vec(a, shape[k], unique_required=True)
            if iv is None:
                return host(self._subscript_reason(a))
            spec.append(("s", len(inputs)))
            inputs.append(self._idx_leaf(iv))
            sel_shape.append(iv.size)
        if rhs.size not in (1, int(np.prod(sel_shape))):
            return host("right-hand side of another size")
        inputs.append(rn)
        node = self._op("scatterN", inputs,
                        (tuple(spec), tuple(sel_shape), rhs.size == 1),
                        shape, nb.dtype)
        return MatArray.from_device(node, base.mclass)

    # -------------------------------------------- structural ops (lazy)

    def structural(self, op: str, xs: list, static: tuple,
                   out_shape) -> Optional[MatArray]:
        """flip/roll/tile/rot90/permute/tril/triu/kron over logical shapes,
        as DAG nodes. None when no operand is on the device (numpy does
        it then)."""
        if not any(x.on_device for x in xs):
            return None
        if any(x.is_complex for x in xs):
            return self._host_path(op, "complex not ported (A8)", *xs)
        nodes = []
        dt = None
        for x in xs:
            n = x.dev if x.on_device else self._lift(x, x.host().dtype)
            nodes.append(n)
            dt = np.result_type(dt, n.dtype) if dt is not None else n.dtype
        node = self._op(op, nodes, static, normalize_shape(out_shape),
                        np.dtype(dt))
        out_class = xs[0].mclass
        if len(xs) == 2 and xs[0].mclass != xs[1].mclass:
            out_class = "double"
        return MatArray.from_device(node, out_class)

    # ------------------------------------ sort, unique, set ops (eager)

    def read_scalar(self, t: torch.Tensor):
        """A device scalar read back to steer the host (unique's count, a
        `while` condition): counted in `syncs` and `sync_bytes`."""
        self.count_sync(int(t.element_size()))
        return t.item()

    def count_sync(self, nbytes: int) -> None:
        self.stats["syncs"] += 1
        self.stats["sync_bytes"] += nbytes

    def sort(self, x: MatArray, axis: int, descend: bool, want_idx: bool
             ) -> Optional[list]:
        """Device sort (values [+ 1-based double indices]); NaN last
        ascending, first descending, stable both ways (engine.py:729)."""
        if x.is_complex or x.mclass not in ("double", "single"):
            return self._host_path("sort", f"sort of a {x.mclass} array", x)
        out = self.dense.call("sort", [x], (int(axis), bool(descend),
                                            bool(want_idx)))
        if out is None:
            return None
        res = [self.dense._leaf(out[0], x.mclass)]
        if want_idx:
            res.append(self.dense._leaf(out[1], "double"))
        return res

    def unique(self, x: MatArray, stable: bool, want_idx: bool
               ) -> Optional[list]:
        """Device unique: [U, ia, ic] (ia, ic 1-based double columns); the
        unique count is the one value read back (engine.py:754)."""
        if x.is_complex or x.mclass not in ("double", "single"):
            return self._host_path("unique", f"unique of a {x.mclass} array",
                                   x)
        out = self.dense.call("unique", [x], (bool(stable),))
        if out is None:
            return None
        u, ia, ic = out
        row = len(x.shape) == 2 and x.shape[0] == 1 and x.shape[1] > 1
        n = int(u.shape[0])
        res = [self.dense._leaf(u, x.mclass, (1, n) if row else (n, 1))]
        if want_idx:
            res.append(self.dense._leaf(ia, "double", (n, 1)))
            res.append(self.dense._leaf(ic, "double", (int(ic.shape[0]), 1)))
        return res

    def setop(self, op: str, a: MatArray, b: MatArray, stable: bool = False,
              want_idx: bool = False) -> Optional[list]:
        """Device union/intersect/setdiff/setxor (engine.py:774)."""
        for x in (a, b):
            if x.is_complex or x.mclass not in ("double", "single"):
                return self._host_path(op, f"{op} of a {x.mclass} array",
                                       a, b)
        out = self.dense.call("setop", [a, b], (op, bool(stable)))
        if out is None:
            return None
        mclass = a.mclass if a.mclass == b.mclass else "double"
        ha = a.shape
        row = not (len(ha) == 2 and ha[1] == 1 and ha[0] > 1)
        n = int(out[0].shape[0])
        res = [self.dense._leaf(out[0], mclass, (1, n) if row else (n, 1))]
        if want_idx and len(out) > 1:
            res.append(self.dense._leaf(out[1], "double", (n, 1)))
        return res

    # ------------------------------------------------- outside this slice

    def fft(self, x, n, dim, inverse):
        not_ported("fft", "A7")

    # ------------------------------------------------------------ materialize

    def materialize(self, node: LazyNode) -> torch.Tensor:
        """Run the DAG reachable from `node` through its fusion plan.
        Workspace-pinned nodes of the same DAG get their values in the same
        pass, as extra outputs of the groups that compute them."""
        if node.value is not None:
            return node.value
        order = topo_order(node)
        extra = [n for n in order
                 if n.pinned and n.value is None and n is not node]
        program = self._build_program(order)
        index = {id(n): i for i, n in enumerate(order)}
        out_idx = [index[id(node)]] + [index[id(n)] for n in extra]
        key = (structure_key(node), tuple(sorted(out_idx)))
        plan = self._jit_cache.get(key)
        if plan is None:
            plan = fuse.plan(program, out_idx)
            self._jit_cache[key] = plan
            self.stats["compiles"] += 1
        else:
            self.stats["cache_hits"] += 1
        values = self._program_values(order)
        t0 = time.perf_counter()
        results = self.run_program(program, values, out_idx, plan)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats["dispatches"] += 1
        self.dispatch_seq += 1
        ops = [n.op for n in order
               if n.value is None and n.op not in ("scalar", "leaf")]
        self.record_launch(_categorize(ops), ops, ms,
                           sum(int(r.nbytes) for r in results))
        self.launch_log[-1].update(
            kernels=plan.kernels,
            eager=[f"{op}: {why}" for _, op, why in plan.eager][:16])
        for n, val in zip([node] + extra, results):
            n.value = val
            n.inputs = []
            n.n_ops = 0
            n.dispatch_id = self.dispatch_seq
        return results[0]

    def _program_values(self, order: list) -> list:
        """The payloads of a program's leaves and scalars: each scalar
        parameter becomes one 0-d tensor on this device, however many ops
        read it; a draw's counter stays a host int, its kernel's launch
        argument."""
        on_card = set()
        for n in order:
            if n.value is None and not n.op.startswith("rng:"):
                on_card.update(id(i) for i in n.inputs)
        return [(self._scalar(n.value, n.dtype) if id(n) in on_card
                 else int(n.value)) if n.op == "scalar" else n.value
                for n in order]

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

    def run_program(self, program: list, values: list, out_idx: list,
                    plan: fuse.Plan) -> list:
        """Execute program entries by `plan` (`fuse.plan(program,
        out_idx)`): each group through `fuse.run_group` (a generated kernel
        on a card), each other entry through `_exec`. `values[i]` is the
        payload of a leaf or scalar entry (unused for ops). Each
        intermediate is dropped after its last consumer, so a long chain
        holds only what is live."""
        env: list = [None] * len(program)
        for i, entry in enumerate(program):
            if entry[0] in ("__leaf__", "scalar"):
                env[i] = values[i]
        for step, (kind, unit) in enumerate(plan.steps):
            if kind == "group":
                outs = fuse.run_group(self, unit, program,
                                      [env[j] for j in unit.inputs])
                for j, t in zip(unit.outputs, outs):
                    env[j] = t
            else:
                op, static, dt, ins, in_shapes, out_shape = program[unit]
                env[unit] = self._exec(op, static, dt, [env[j] for j in ins],
                                       in_shapes, out_shape)
                self.stats["eager_ops"] += 1
                self.eager_by_op[op] += 1
            for j in plan.frees[step]:
                env[j] = None
        return [env[j] for j in out_idx]

    # --------------------------------------------------------------- executor

    _OPS = ("cast", "reshapeF", "transpose", "slice", "slice1", "c:full",
            "c:linspace", "matmul") + _L_OPS + _INDEX_OPS

    def supports_op(self, op: str) -> bool:
        if op.startswith("b:"):
            return op[2:] in table.TORCH_BINARY
        if op.startswith("u:"):
            return op[2:] in table.TORCH_UNARY
        if op.startswith("r:"):
            return op[2:] in _REDUCE_OPS
        if op.startswith("rng:"):
            return op[4:] in ("rand", "randn")
        if op.startswith("s:"):
            return op[2:] in _SCAN_OPS
        return op in self._OPS

    def _scalar(self, value, dt: np.dtype) -> torch.Tensor:
        """A host scalar as a 0-d tensor of `dt` on this device: cast with
        numpy first (so f32 rounding is numpy's), then filled on the device
        with the value as the fill kernel's argument; nothing is copied and
        nothing waits."""
        v = np.asarray(value).astype(dt).item()
        return torch.full((), v, dtype=torch_dtype(dt), device=self.device)

    @staticmethod
    def _tensor(a: torch.Tensor, dt: np.dtype) -> torch.Tensor:
        """Operand in `dt`."""
        tdt = torch_dtype(dt)
        return a if a.dtype == tdt else a.to(tdt)

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
            r = table.TORCH_BINARY[name](a, b)
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
            r = table.TORCH_UNARY[name](a)
            return r if r.dtype == tdt else r.to(tdt)
        if op.startswith("r:"):
            return self._exec_reduce(op[2:], static, dt, args[0],
                                     in_shapes[0], out_shape)
        if op.startswith("s:"):
            return self._exec_scan(op[2:], static, dt, args[0],
                                   in_shapes[0], out_shape)
        if op == "cast":
            return self._tensor(args[0], np.dtype(static[0]))
        if op == "matmul":
            la, lb = in_shapes
            a = self._tensor(args[0], dt).reshape(la)
            b = self._tensor(args[1], dt).reshape(lb)
            pol = static[1] if len(static) > 1 else self.matmul_precision
            return self._to_phys(_matmul(a, b, pol), out_shape)
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
        if op in _L_OPS:
            return self._exec_structural(op, static, tdt, args, in_shapes,
                                         out_shape)
        if op in _INDEX_OPS:
            return self._exec_index(op, static, args, in_shapes, out_shape)
        raise MatError("MATLAB:internal", f"Unknown device op '{op}'.")

    def _exec_structural(self, op: str, static: tuple, tdt: torch.dtype,
                         args: list, in_shapes: tuple, out_shape: tuple):
        """The L-ops (engine.py:1522-1546) on the logical-shape view."""
        a = args[0].reshape(in_shapes[0])
        if op == "flipL":
            r = torch.flip(a, (static[0],))
        elif op == "rollL":
            r = torch.roll(a, static[0], static[1])
        elif op == "tileL":
            r = a.reshape(static[1]).repeat(*static[0])
        elif op == "rot90L":
            r = torch.rot90(a, static[0], (0, 1))
        elif op == "permuteL":
            r = a.reshape(static[1]).permute(*static[0])
        elif op == "trilL":
            r = torch.tril(a, static[0])
        elif op == "triuL":
            r = torch.triu(a, static[0])
        else:
            r = torch.kron(a.to(tdt), args[1].reshape(in_shapes[1]).to(tdt))
        return self._to_phys(r, out_shape)

    def _exec_index(self, op: str, static: tuple, args: list,
                    in_shapes: tuple, out_shape: tuple):
        """Indexed reads and writes (engine.py:1583-1703). Linear ops take
        0-based F-order indices; a write returns a new tensor."""
        if op == "iota":
            start, step, n = static
            return torch.arange(n, dtype=torch.int64,
                                device=self.device) * step + start
        x = args[0]
        la = tuple(in_shapes[0])
        if op in ("gather1", "gather1d", "scatter1", "scatter1d"):
            if op.endswith("1d"):
                # the loop variable, 1-based, as a one-element index (a 0-d
                # index tensor is read back to the host by torch)
                idx = args[1].reshape(1).to(torch.int64) - 1
            else:
                idx = args[1]
            if op.startswith("gather"):
                if x.ndim > 1 and x.is_contiguous():
                    taken = x.reshape(-1)[_c_index(idx, la)]
                else:
                    taken = _fflat(x, la)[idx]
                return reshape_f(taken, phys_shape(tuple(out_shape)))
            r = args[2]
            if op == "scatter1d" or static[0]:
                val = r.reshape(()).to(x.dtype)
            else:
                val = _fflat(r, in_shapes[2]).to(x.dtype)
            if x.ndim <= 1:
                out = x.reshape(-1).clone()
                out[idx] = val
                return out.reshape(x.shape)
            out = x.clone(memory_format=torch.contiguous_format)
            out.view(-1)[_c_index(idx, la)] = val
            return out
        if op == "gatherN":
            x = x.reshape(la)
            for k, s in enumerate(static[0]):
                if s != "colon":
                    x = torch.index_select(x, k, self._subscript(args, s))
            return self._to_phys(x, out_shape)
        if op == "fillall":
            r = args[1]
            if r.ndim == 0:
                return r.to(x.dtype).expand(x.shape).contiguous()
            return reshape_f(_fflat(r, in_shapes[1]).to(x.dtype),
                             tuple(x.shape))
        if op == "maskset":
            m, r = args[1], args[2]
            val = r.reshape(()).to(x.dtype)
            if x.ndim > 1 and tuple(in_shapes[1]) == la:
                m = m.reshape(la)
            else:   # F-order sequence of the mask, laid out as the base
                m = reshape_f(_fflat(m, in_shapes[1]), tuple(x.shape))
            return torch.where(m, val, x)
        # scatterN: one index tensor per dimension, broadcast as jnp.ix_
        spec, sel_shape, scalar_rhs = static
        r = args[-1]
        if scalar_rhs:
            val = r.reshape(()).to(x.dtype)
        else:
            val = reshape_f(_fflat(r, in_shapes[-1]).to(x.dtype),
                            tuple(sel_shape))
        out = x.reshape(la).clone(memory_format=torch.contiguous_format)
        picked = [k for k, s in enumerate(spec) if s != "colon"]
        if len(picked) == 1:
            # a scalar rhs is expanded too: index_fill_ with a tensor value
            # reads it back to the host
            k = picked[0]
            out.index_copy_(k, self._subscript(args, spec[k]),
                            val.expand(tuple(sel_shape)))
        else:
            idxs = []
            for k, s in enumerate(spec):
                i = torch.arange(la[k], device=self.device) if s == "colon" \
                    else self._subscript(args, s)
                view = [1] * len(la)
                view[k] = -1
                idxs.append(i.reshape(view))
            out[tuple(idxs)] = val
        return self._to_phys(out, out_shape)

    @staticmethod
    def _subscript(args: list, s) -> torch.Tensor:
        """The index tensor of one subscript slot: ("s", i) a 0-based index
        vector, ("d", i) the 1-based loop variable."""
        kind, slot = s
        if kind == "s":
            return args[slot]
        return args[slot].reshape(1).to(torch.int64) - 1

    def _linspace(self, start, stop, n: int, dt: np.dtype) -> torch.Tensor:
        """jnp.linspace's formula: start*(1-s) + stop*s with s = i/(n-1),
        and the exact endpoint appended. i/(n-1) is a true division on
        every device (torch multiplies by a reciprocal on a card when the
        divisor is a Python number), as the generated kernel divides."""
        tdt = torch_dtype(dt)
        s0 = self._tensor(start, dt).reshape(())
        s1 = self._tensor(stop, dt).reshape(())
        if n <= 1:
            return s0.reshape(1)[:n]
        div = n - 1
        step = torch.arange(div, dtype=tdt, device=self.device) / \
            torch.full((), div, dtype=tdt, device=self.device)
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
        if name == "median":
            return self._median(x, axes, omitnan, tdt)
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

    @staticmethod
    def _median(x: torch.Tensor, axes: tuple, omitnan: bool,
                tdt: torch.dtype) -> torch.Tensor:
        """jnp.median/nanmedian: the mean (a + b) * 0.5 of the two middle
        values of each slice, in integer positions (torch.median would take
        the lower one). NaN poisons a slice unless omitted; an all-NaN slice
        is NaN."""
        xf = x.to(tdt) if tdt.is_floating_point else x.to(torch.float64)
        rest = [i for i in range(xf.ndim) if i not in axes]
        kept = tuple(1 if i in axes else s for i, s in enumerate(xf.shape))
        merged = xf.permute(*rest, *axes).reshape(
            *(xf.shape[i] for i in rest), -1)
        nan = torch.isnan(merged)
        # one NaN, so that the card's radix sort puts each of them last
        srt = torch.sort(torch.where(nan, torch.full_like(merged, float(
            "nan")), merged), dim=-1).values
        if omitnan:
            cnt = (~nan).sum(-1, keepdim=True)
            lo = torch.gather(srt, -1, ((cnt - 1) // 2).clamp(min=0))
            hi = torch.gather(srt, -1, cnt // 2)
            r = (lo + hi) * 0.5
        else:
            n = merged.shape[-1]
            r = (srt[..., (n - 1) // 2:(n - 1) // 2 + 1]
                 + srt[..., n // 2:n // 2 + 1]) * 0.5
            r = torch.where(nan.any(-1, keepdim=True),
                            torch.full_like(r, float("nan")), r)
        return r.reshape(kept).to(tdt)

    def _exec_scan(self, name: str, static: tuple, dt: np.dtype, x,
                   lshape: tuple, out_shape: tuple) -> torch.Tensor:
        """Scans with MATLAB NaN semantics (engine.py:1791-1831):
        cumsum/cumprod honour omitnan (NaN -> identity); cummax/cummin
        always skip NaN until the first non-NaN (np.fmax.accumulate)."""
        axis, reverse, omitnan, _ = static
        tdt = torch_dtype(dt)
        # logical axis -> physical axis (vectors are stored rank-1)
        if lshape and tuple(x.shape) != tuple(lshape):
            if x.ndim <= 1:
                nonsing = next((i for i, s in enumerate(lshape) if s != 1), 0)
                if axis != nonsing:
                    return self._to_phys(x.to(tdt), out_shape)  # no-op scan
                axis = 0
            else:
                x = x.reshape(lshape)
        elif axis >= x.ndim:
            return self._to_phys(x.to(tdt), out_shape)
        if x.ndim == 0:
            x = x.reshape(1)
        if reverse:
            x = x.flip(axis)
        isf = x.is_floating_point()
        if name in ("cumsum", "cumprod"):
            xx = x.to(tdt) if tdt.is_floating_point else x
            if omitnan and isf:
                ident = 0.0 if name == "cumsum" else 1.0
                xx = torch.where(torch.isnan(xx), torch.full_like(xx, ident),
                                 xx)
            fn = torch.cumsum if name == "cumsum" else torch.cumprod
            r = fn(xx, dim=axis)
        elif isf:
            nan = torch.isnan(x)
            sent = float("-inf") if name == "cummax" else float("inf")
            fn = torch.cummax if name == "cummax" else torch.cummin
            r = fn(torch.where(nan, torch.full_like(x, sent), x),
                   dim=axis).values
            allnan = torch.cumprod(nan.to(x.dtype), dim=axis)
            r = torch.where(allnan > 0, torch.full_like(r, float("nan")), r)
        else:
            fn = torch.cummax if name == "cummax" else torch.cummin
            r = fn(x, dim=axis).values
        if reverse:
            r = r.flip(axis)
        return self._to_phys(r.to(tdt), out_shape)

    def _exec_rng(self, kind: str, static: tuple, dt: np.dtype, args: list):
        """A draw from its counter: a host int (materialize) or a 0-d int64
        tensor on this device (a folded loop's), passed on as it is."""
        key, n, shape, mclass = static
        (ctr,) = args
        prec = torch.float32 if mclass == "single" else torch.float64
        vals = rng_draw(kind, key, ctr, n, prec, self.device)
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
        """Every cached plan and folded loop, in JaxEngine's format
        (`fuse.snapshot`)."""
        return [snap for snap in (fuse.snapshot(k, v)
                                  for k, v in self._jit_cache.items())
                if snap is not None]

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
