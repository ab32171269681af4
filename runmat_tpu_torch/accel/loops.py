"""The `for` and `while` folds of the port, on `TorchEngine`.

The interpreter (`vm/interp.py`) calls `try_device_loop` and
`try_device_while` at each loop entry. A loop whose body is pure device math
is traced once by `_Trace` (it only builds DAG nodes) into programs in the
engine's format (`_program`). As the JAX package runs a fold as one compiled
`lax.fori_loop` (`make_loop_fn`, `_build_and_run`), the port runs it as one
captured CUDA graph:

  * Device loop state (`_Step`). The step index `t` is a 0-d int64 on the
    device; the loop variable is `it[t]` of the iterable, uploaded once per
    fold when the body reads it; draw k of an iteration takes the counter
    `c0 + offset_k + t*BPI` (BPI: blocks one iteration draws), computed on
    the device in int64, so it stays exact past 2^32 (the JAX package bails
    at T*BPI >= 2^31; the port does not need to); the Threefry kernel reads
    it from device memory. The program's scalars are filled on the device
    once per fold, and each `c0 + offset_k` and `t` are written with
    `fill_`, so nothing is copied from the host and nothing in an iteration
    reads the device back.
  * `for` on a card: iteration 0 runs eagerly through `run_program` with
    those sources, with torch's sync debug mode set to raise, which warms
    the allocator, cuBLAS and the kernels' occupancy queries and finds any
    op that would wait for the card. Such an op declines the capture before
    it starts (`stats["graph_declines"]`, the reason in the launch log) and
    the fold runs as a host loop of the same step. Otherwise one iteration
    is captured as a `torch.cuda.CUDAGraph` (`_Graph`), `t.add_(1)` its last
    node, and replayed T-1 times. The graph is cached in the engine's
    `_jit_cache` by program structure, shapes, dtypes and the RNG key (T,
    `c0` and the scalars' values are not in the key): a later fold of the
    same loop loads its sources into the graph's buffers and replays it T
    times. An error during a capture or a replay raises (`GraphFault`); it
    is not turned into a bail.
  * Carries at fixed addresses: each read-carried output is copied into its
    carry buffer at the end of the graph. Two graphs alternating input and
    output buffers would save the copy only if the program could choose
    where its last op writes; torch's allocator chooses, so they would still
    end in a copy. The copy moves the carry twice a step: 8 MB in
    monte_carlo.m (S, 4 MB), 512 MB in index_sets.m's loop (B, 256 MB, 16
    steps), beside the 256 MB copy its column write already makes. An
    output written before it is read (monte_carlo's Z) is not copied: the
    graph's own output holds its last value. The final carry is cloned once
    out of the cache's buffers into the workspace.
  * `while`: a condition program and a body program, as the JAX package's
    `lax.while_loop` (`make_while_fn`, `_build_and_run_while`): the
    condition runs eagerly on the device and its one value is read back
    each iteration (`read_scalar`, one byte), then the body, through the
    same capture as the `for` body from its second iteration (or at once
    when cached). Its eligibility is the JAX package's: no RNG in the loop,
    and every variable it writes is defined before it and read before it is
    written, so a loop that runs zero times leaves the workspace as the
    interpreter would. The launch log gets a "device_while" entry with the
    iteration count; `stats["while_folds"]` counts the folds.
  * On the CPU (the tests) the same device-state step runs eagerly, T
    times, with CPU tensors as its sources and no graph.
  * The body runs through its fusion plan (`accel/fuse.py`, made once a
    `_Step`): on a card its elementwise chain is one generated Triton kernel
    inside the graph. Iteration 0 compiles every kernel the body launches,
    so nothing compiles inside the capture (`ops/fused.py` raises if a
    launch would), and the kernels read the fold's scalars through pointers,
    as the draw reads its counter.
  * Each fold's key counts in `stats["compiles"]` the first time and in
    `stats["cache_hits"]` after, as the JAX package counts its loop
    executables; it stays in `_jit_cache` with its graph, or None where no
    graph was captured (on the CPU, or after a decline).

Accounting: `stats["graph_captures"]`, `["graph_replays"]` and
`["graph_declines"]`; one "device_loop" launch-log entry per fold with its
`iterations`, its `graph` ("captured", "cached", "declined" or "eager") and
its `replays`; the Threefry kernel's `launches` count the draws each replay
runs (`threefry.replayed`). The cache and its graphs' private memory pools
are freed by `TorchEngine.release` (on uninstall and `reset(gpuDevice)`).

`_Bail`, `_Marker`, `_bc`, `_note_bail`, `_scan_window` and `_Trace` are
copied from `runmat_tpu/accel/loops.py` (31-57, 214-686), and the `while`
gate from its `try_device_while` (850-946); `_Trace._load` copies a
host-resident carried variable to the device with the engine's `to_device`
in place of `jax.device_put`.

A fold that fails is not silent: `stats["loop_bails"]` counts it and the
launch log keeps the exception text. The interpreter then runs the loop.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Any, Optional

import numpy as np
import torch

from ..errors import MatError
from ..ops import fused, threefry
from ..values import MatArray
from . import active_engine, fuse
from .engine import counter_value, phys_shape
from .lazy import LazyNode, topo_order

# builtins that are safe to call during the trace: elementwise/broadcast math,
# reductions, and creation — everything they produce for device args stays in
# the lazy DAG
_SAFE_BUILTINS = frozenset("""
sin cos tan asin acos atan sinh cosh tanh asinh acosh atanh exp log log2
log10 log1p expm1 sqrt abs sign floor ceil round fix real imag conj angle
atan2 hypot power mod rem min max sum mean prod single double times plus
minus rdivide ldivide uminus uplus zeros ones cumsum cumprod
""".split())

_RNG_BUILTINS = frozenset(("rand", "randn"))


class _Bail(Exception):
    pass


class GraphFault(RuntimeError):
    """A capture or a replay of a folded loop's CUDA graph failed."""


class _Marker:
    """Payload for scalar LazyNodes whose value is loop-iteration-dependent."""

    __slots__ = ("tag", "arg")

    def __init__(self, tag: str, arg: int = 0):
        self.tag = tag      # "rng" (a draw's int64 counter) | "loopvar"
        self.arg = arg      # rng: block offset within one iteration


def _engine_locked(fn):
    """`fn` under the active engine's lock (TorchEngine's methods take it
    each): a fold traces, captures and replays as one engine call."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        eng = active_engine()
        if eng is None:
            return fn(*args, **kwargs)
        with eng.lock:
            return fn(*args, **kwargs)
    return run


@_engine_locked
def try_device_loop(interp, frame, code, for_next_pc: int, iterable):
    """Run the whole `for` loop at `for_next_pc` on the device. Returns the
    pc to resume at, or None for the interpreter to run the loop."""
    from ..runtime import registry

    eng = active_engine()
    if eng is None:
        return None
    # eligibility: the same checks as the JAX package's try_device_loop
    if not isinstance(iterable, MatArray) or iterable.on_device:
        return None
    if iterable.mclass not in ("double", "single") or iterable.is_complex:
        return None
    h = iterable.host()
    if h.ndim != 2 or h.shape[0] != 1 or h.shape[1] < 8:
        return None
    T = int(h.shape[1])
    B = _bc()
    instrs = code.instrs
    if code.loop_hints.get(for_next_pc) == "never":
        return None
    fact = code.loop_facts.get(for_next_pc)
    if fact is not None and fact.get("never"):
        code.loop_hints[for_next_pc] = "never"
        return None
    fn_op, loopvar, done, _, _ = instrs[for_next_pc]
    if fn_op != B.FOR_NEXT or done is None:
        return None
    if instrs[done - 1][0] != B.JMP or \
            instrs[done - 2][0] != B.CHECK_INTERRUPT:
        return None
    lo_pc, hi_pc = for_next_pc + 1, done - 2
    written: set = set()
    if _scan_window(B, instrs, range(lo_pc, hi_pc), written) is None or \
            not written:
        code.loop_hints[for_next_pc] = "never"
        return None

    state = interp.session.rng
    old_cap = eng.fuse_cap
    eng.fuse_cap = 1 << 60
    try:
        tr = _Trace(interp, frame, eng, registry, state, loopvar, written,
                    iterable)
        tr.run(instrs, code.consts, lo_pc, hi_pc)
        result = _build_and_run(eng, tr, T, state, h)
    except GraphFault:
        raise
    except Exception as e:
        # boundary: the interpreter runs the loop instead; the fold's
        # failure is counted and its reason kept
        _record_bail(eng, code, for_next_pc, e)
        return None
    finally:
        eng.fuse_cap = old_cap

    code.loop_hints[for_next_pc] = 0
    for name, val in result.items():
        frame.vars[name] = val
    frame.vars[loopvar] = MatArray(h[:, -1:].copy(), iterable.mclass)
    state.advance(T * tr.rng_blocks)
    eng.stats["loop_folds"] += 1
    return done + 1


def _bc():
    from ..vm import bytecode as B
    return B


def _note_bail(code, pc: int, limit: int = 8) -> None:
    cur = code.loop_hints.get(pc, 0)
    if cur == "never":
        return
    cur += 1
    code.loop_hints[pc] = "never" if cur >= limit else cur


def _scan_window(B, instrs, rng, written: set, allow_store: bool = True):
    """Static eligibility scan over a bytecode window. Returns True when every
    opcode is traceable (collecting written names), None to bail."""
    for i in rng:
        op, a, b, c, d = instrs[i]
        if op == B.STORE:
            if not allow_store or b:    # display output -> host side effect
                return None
            written.add(a)
        elif op == B.STORE_INDEX:
            if not allow_store or d or c != "paren":
                return None
            written.add(a)
        elif op == B.BUILD_MAT:
            if a != ():
                return None          # only the empty [] literal is traceable
        elif op in (B.CONST, B.LOAD, B.BINOP, B.UNOP, B.MTIMES, B.TRANSPOSE,
                    B.RESOLVE_CALL, B.POP, B.DUP, B.CHECK_INTERRUPT,
                    B.COLON_VAL, B.RANGE, B.PUSH_IXCTX, B.PUSH_IXCTX_VAR,
                    B.POP_IXCTX, B.END_VAL, B.INDEX):
            if op == B.RESOLVE_CALL and (d == 2 or c > 1):
                return None
            if op == B.INDEX and b != "paren":
                return None
        else:
            return None
    return True


# --------------------------------------------------------------------------- #
# trace: mini-interpreter over the restricted body window
# --------------------------------------------------------------------------- #


class _Trace:
    def __init__(self, interp, frame, eng, registry, state, loopvar, written,
                 iterable):
        self.interp = interp
        self.frame = frame
        self.eng = eng
        self.registry = registry
        self.state = state
        self.loopvar = loopvar
        self.written = written
        self.iterable = iterable
        self.shadow: dict[str, Any] = {}
        self.carry_in: dict[str, LazyNode] = {}   # read-before-write tracers
        self.carry_init: dict[str, Any] = {}      # their initial device values
        self.rng_blocks = 0                       # Philox blocks per iteration
        self.loopvar_node: Optional[LazyNode] = None
        self.marker_nodes: list[LazyNode] = []
        self.ixctx: list = []                     # END_VAL context bases

    # -- value access -------------------------------------------------------- #

    def _resolves_to_builtin(self, name: str) -> bool:
        """True only when `name` genuinely resolves to a registry builtin in
        the tracing scope — nested functions, file-local siblings, classes,
        local/session/imported functions all shadow intrinsics (mirrors
        Interp.call_named resolution order; ≙ vm/object/resolve.rs)."""
        f = self.frame
        while f is not None:
            if f.code is not None and name in getattr(f.code, "nested", {}):
                return False
            f = f.parent
        if self.frame.code is not None:
            sibs = getattr(self.frame.code, "siblings", None)
            if sibs and name in sibs:
                return False
        if self.interp.session.classes.get(name) is not None:
            return False
        r = self.interp.resolve_function(name)
        return r is not None and r[0] == "builtin"

    def _load(self, name: str):
        if name in self.shadow:
            return self.shadow[name]
        if name == self.loopvar:
            if self.loopvar_node is None:
                dt = np.dtype(np.float64 if self.iterable.mclass == "double"
                              else np.float32)
                node = LazyNode(self.eng, "scalar", [], (), (1, 1), dt,
                                value=_Marker("loopvar"))
                self.marker_nodes.append(node)
                self.loopvar_node = node
            return MatArray.from_device(self.loopvar_node, self.iterable.mclass)
        from ..vm.interp import NOVALUE
        v = self.interp._load_name(self.frame, name)
        if v is NOVALUE:
            return NOVALUE
        if name in self.written:
            # loop-carried: replace with a tracer leaf bound to the carry slot
            if not isinstance(v, MatArray) or v.mclass not in \
                    ("double", "single", "logical"):
                raise _Bail()
            if v.on_device:
                init, dt = self.eng.materialize(v.dev), v.dev.dtype
            else:
                init, dt = self.eng.to_device(v.host()), v.host().dtype
            node = LazyNode(self.eng, "leaf", [], (), v.shape, dt,
                            value=init)
            tracer = MatArray.from_device(node, v.mclass)
            self.carry_in[name] = node
            self.carry_init[name] = init
            self.shadow[name] = tracer
            return tracer
        if isinstance(v, MatArray) and v.on_device and v.dev.value is None:
            # Loop-invariant with a pending lazy DAG: force it ONCE here,
            # outside the loop. Otherwise the producer chain (e.g. a 400 MB
            # rand draw) is traced into the loop body and re-executes every
            # iteration — numerically identical (counters are baked) but
            # catastrophic for bandwidth. The node becomes a value-bearing
            # leaf, so the program builder passes it as a loop-invariant arg.
            self.eng.materialize(v.dev)
        return v   # loop-invariant: used as-is (scalars lift on first op)

    # -- rng ----------------------------------------------------------------- #

    def _rng(self, kind: str, args: list) -> MatArray:
        from ..values import text_of
        dims = []
        mclass = "double"
        for a in args:
            if isinstance(a, MatArray) and a.mclass == "char":
                mclass = text_of(a)
                if mclass not in ("double", "single"):
                    raise _Bail()
                continue
            if not isinstance(a, MatArray) or a.on_device or a.size != 1:
                raise _Bail()
            dims.append(int(a.host().reshape(-1)[0]))
        if not dims:
            dims = [1]
        if len(dims) == 1:
            dims = [dims[0], dims[0]]
        from ..values import normalize_shape
        shape = normalize_shape(tuple(dims))
        n = 1
        for s in shape:
            n *= s
        from ..ops import ctrng
        off = self.rng_blocks
        self.rng_blocks += ctrng.blocks_for(kind, n, mclass)
        ctr = LazyNode(self.eng, "scalar", [], (), (1, 1), np.dtype(np.int64),
                       value=_Marker("rng", off))
        self.marker_nodes.append(ctr)
        dt = self.eng.dtype_for(mclass)
        node = self.eng._op("rng:" + kind, [ctr],
                            (self.state.key, n, shape, mclass), shape, dt)
        return MatArray.from_device(node, mclass)

    # -- the mini-interpreter -------------------------------------------------#

    def run(self, instrs, consts, lo_pc: int, hi_pc: int) -> None:
        from ..runtime import dispatch as D
        from ..vm.interp import NOVALUE, _collect_args, _unwrap1
        B = _bc()
        stack: list = []
        pc = lo_pc
        while pc < hi_pc:
            op, a, b, c, d = instrs[pc]
            pc += 1
            if op == B.CONST:
                stack.append(consts[a])
            elif op == B.LOAD:
                v = self._load(a)
                if v is NOVALUE:
                    raise _Bail()
                stack.append(v)
            elif op == B.STORE:
                v = _unwrap1(stack.pop(), a)
                self.shadow[a] = v
            elif op == B.BINOP:
                rhs = _unwrap1(stack.pop())
                lhs = _unwrap1(stack.pop())
                stack.append(self._op2(D.binary, a, lhs, rhs))
            elif op == B.UNOP:
                v = _unwrap1(stack.pop())
                stack.append(self._op1(D.unary, a, v))
            elif op == B.MTIMES:
                rhs = _unwrap1(stack.pop())
                lhs = _unwrap1(stack.pop())
                stack.append(self._op2(D.mtimes, None, lhs, rhs))
            elif op == B.TRANSPOSE:
                v = _unwrap1(stack.pop())
                r = D.ctranspose(v) if a else D.transpose(v)
                self._check_taint([v], r)
                stack.append(r)
            elif op == B.DUP:
                stack.append(stack[-1])
            elif op == B.POP:
                stack.pop()
            elif op == B.CHECK_INTERRUPT:
                pass
            elif op == B.BUILD_MAT:
                if a != ():
                    raise _Bail()
                stack.append(MatArray.empty())
            elif op == B.COLON_VAL:
                from ..vm.indexing import COLON
                stack.append(COLON)
            elif op == B.RANGE:
                stop = _unwrap1(stack.pop())
                step = _unwrap1(stack.pop()) if a else None
                start = _unwrap1(stack.pop())
                for v in (start, step, stop):
                    if isinstance(v, MatArray) and v.on_device:
                        raise _Bail()   # data-dependent extent
                from ..vm.interp import _make_range
                stack.append(_make_range(start, step, stop))
            elif op == B.PUSH_IXCTX:
                self.ixctx.append(stack[-1] if stack else None)
            elif op == B.PUSH_IXCTX_VAR:
                v = self._load(a)
                self.ixctx.append(None if v is NOVALUE else v)
            elif op == B.POP_IXCTX:
                self.ixctx.pop()
            elif op == B.END_VAL:
                base = self.ixctx[-1] if self.ixctx else None
                from ..vm.interp import _end_value
                stack.append(_end_value(base, a, b))
            elif op == B.INDEX:
                args = _collect_args(stack, a)
                base = _unwrap1(stack.pop())
                if self.ixctx and self.ixctx[-1] is None:
                    self.ixctx[-1] = base
                stack.append(self._index_read(base, args))
            elif op == B.STORE_INDEX:
                args = _collect_args(stack, b)
                rhs = _unwrap1(stack.pop())
                self._store_index(a, args, rhs)
            elif op == B.RESOLVE_CALL:
                name, nargs, nargout = a, b, c
                args = _collect_args(stack, nargs)
                v = self._load(name) if d != 1 else NOVALUE
                if v is not NOVALUE:
                    if nargs == 0:
                        stack.append(v)
                        continue
                    if isinstance(v, MatArray):
                        stack.append(self._index_read(v, args))
                        continue
                    raise _Bail()   # paren-indexing a non-array traced value
                if not self._resolves_to_builtin(name):
                    raise _Bail()   # user/nested/local function shadows it
                if name in _RNG_BUILTINS:
                    stack.append(self._rng(name, args))
                    continue
                if name not in _SAFE_BUILTINS:
                    raise _Bail()
                bi = self.registry.lookup(name)
                if bi is None:
                    raise _Bail()
                res = self.interp.call_builtin(bi, args, max(nargout, 1),
                                               self.frame)
                r = res[0] if res else NOVALUE
                if r is NOVALUE:
                    raise _Bail()
                self._check_taint(args, r)
                stack.append(r)
            else:
                raise _Bail()
        return stack

    # condition windows want the residual stack (the cond value)
    run_window = run

    # -- indexed reads / writes ----------------------------------------------#

    def _is_dyn(self, a) -> bool:
        """A subscript that is the raw loop variable (traced scalar)."""
        return isinstance(a, MatArray) and a.on_device and \
            a.dev is self.loopvar_node

    def _check_loopvar_bounds(self, extent: int) -> None:
        """The loop variable used as a subscript: every iterate must be an
        in-range integer, known from the host iterable at gate time."""
        if self.iterable is None:
            raise _Bail()
        h = self.iterable.host().reshape(-1)
        if not np.all(h == np.floor(h)) or h.size == 0 or \
                h.min() < 1 or h.max() > extent:
            raise _Bail()

    def _classify_args(self, base: MatArray, args: list):
        """-> (spec_args, dynamic?) where each entry is COLON | host MatArray
        | ('dyn',). Bails on anything else (device masks handled separately
        by engine.index_write)."""
        from ..vm.indexing import ColonMark
        dyn = False
        for a in args:
            if isinstance(a, ColonMark):
                continue
            if self._is_dyn(a):
                dyn = True
                continue
            if isinstance(a, MatArray) and not a.on_device and \
                    a.mclass != "logical":
                continue
            return None, False
        return args, dyn

    def _index_read(self, base, args: list):
        if not isinstance(base, MatArray) or not args:
            raise _Bail()
        eng = self.eng
        spec_args, dyn = self._classify_args(base, args)
        if spec_args is None:
            raise _Bail()
        if not dyn:
            if not base.on_device:
                # loop-invariant host read: plain interpreter indexing
                from ..vm import indexing as IXM
                return IXM.read_paren(base, args)
            r = eng.index_read(base, args)
            if r is None:
                r = eng.index_read_general(base, args)
            if r is None:
                raise _Bail()
            return r
        # dynamic subscript: lower to a traced gather
        if not base.on_device:
            if base.mclass not in ("double", "single", "logical"):
                raise _Bail()
            node = eng._lift(base, base.host().dtype)
            base = MatArray.from_device(node, base.mclass)
        nb = base.dev
        shape = nb.shape
        from ..vm.indexing import ColonMark
        if len(args) == 1:
            n = 1
            for s in shape:
                n *= s
            self._check_loopvar_bounds(n)
            node = eng._op("gather1d", [nb, args[0].dev], (), (1, 1),
                           nb.dtype)
            return MatArray.from_device(node, base.mclass)
        if len(args) != len(shape):
            raise _Bail()
        inputs = [nb]
        spec = []
        out_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                spec.append("colon")
                out_shape.append(shape[k])
            elif self._is_dyn(a):
                self._check_loopvar_bounds(shape[k])
                spec.append(("d", len(inputs)))
                inputs.append(a.dev)
                out_shape.append(1)
            else:
                iv = eng._index_vec(a, shape[k])
                if iv is None:
                    raise _Bail()
                spec.append(("s", len(inputs)))
                inputs.append(eng._idx_leaf(iv))
                out_shape.append(iv.size)
        from ..values import normalize_shape
        node = eng._op("gatherN", inputs, (tuple(spec),),
                       normalize_shape(out_shape), nb.dtype)
        return MatArray.from_device(node, base.mclass)

    def _store_index(self, name: str, args: list, rhs) -> None:
        if not isinstance(rhs, MatArray) or not args:
            raise _Bail()
        base = self._load(name)
        from ..vm.interp import NOVALUE
        if base is NOVALUE or not isinstance(base, MatArray):
            raise _Bail()
        eng = self.eng
        if not base.on_device:
            raise _Bail()   # written vars are lifted by _load; anything else
        spec_args, dyn = self._classify_args(base, args)
        if spec_args is None:
            # device logical mask with scalar rhs is handled by index_write
            res = eng.index_write(base, args, rhs)
            if res is None:
                raise _Bail()
            self.shadow[name] = res
            return
        if not dyn:
            res = eng.index_write(base, args, rhs)
            if res is None:
                raise _Bail()
            self.shadow[name] = res
            return
        if rhs.mclass not in ("double", "single", "logical") or \
                rhs.is_complex != base.is_complex:
            raise _Bail()
        nb = base.dev
        shape = nb.shape
        from ..vm.indexing import ColonMark
        rn = eng._lift(rhs, nb.dtype) if rhs.size != 1 or rhs.on_device \
            else eng._scalar_node(rhs._host.reshape(-1)[0], nb.dtype)
        if len(args) == 1:
            n = 1
            for s in shape:
                n *= s
            if rhs.size != 1:
                raise _Bail()
            self._check_loopvar_bounds(n)
            node = eng._op("scatter1d", [nb, args[0].dev, rn], (), shape,
                           nb.dtype)
            self.shadow[name] = MatArray.from_device(node, base.mclass)
            return
        if len(args) != len(shape):
            raise _Bail()
        inputs = [nb]
        spec = []
        sel_shape = []
        for k, a in enumerate(args):
            if isinstance(a, ColonMark):
                spec.append("colon")
                sel_shape.append(shape[k])
            elif self._is_dyn(a):
                self._check_loopvar_bounds(shape[k])
                spec.append(("d", len(inputs)))
                inputs.append(a.dev)
                sel_shape.append(1)
            else:
                iv = eng._index_vec(a, shape[k], unique_required=True)
                if iv is None:
                    raise _Bail()
                spec.append(("s", len(inputs)))
                inputs.append(eng._idx_leaf(iv))
                sel_shape.append(iv.size)
        nelem = 1
        for s in sel_shape:
            nelem *= s
        if rhs.size not in (1, nelem):
            raise _Bail()
        inputs.append(rn)
        node = eng._op("scatterN", inputs,
                       (tuple(spec), tuple(sel_shape), rhs.size == 1),
                       shape, nb.dtype)
        self.shadow[name] = MatArray.from_device(node, base.mclass)

    def _op2(self, fn, opname, lhs, rhs):
        r = fn(opname, lhs, rhs) if opname is not None else fn(lhs, rhs)
        self._check_taint([lhs, rhs], r)
        return r

    def _op1(self, fn, opname, v):
        r = fn(opname, v)
        self._check_taint([v], r)
        return r

    def _check_taint(self, args, result) -> None:
        """Any op consuming a device value must produce a device value; a host
        escape would bake iteration-0 data into every iteration."""
        if any(isinstance(x, MatArray) and x.on_device for x in args):
            if not (isinstance(result, MatArray) and result.on_device):
                raise _Bail()


def _record_bail(eng, code, pc: int, e: Exception) -> None:
    """A fold that failed: counted, with its reason in the launch log."""
    _note_bail(code, pc)
    eng.stats["loop_bails"] += 1
    eng.launch_log.append({"cat": "loop_bail", "ops": [], "n_ops": 0,
                           "reason": f"{type(e).__name__}: {e}"[:160]})


def _program(eng, roots: list, carried_leaf: dict, markers: bool):
    """The DAG under `roots` as program entries in the engine's format, and
    for each entry where its value comes from in each iteration: ("op",
    None), ("carry", slot), ("fixed", tensor) for a loop-invariant leaf,
    ("const", (value, dtype)) for a host scalar, or a marker ("loopvar", 0),
    ("rng", offset) when `markers` allows them."""
    order: list = []
    seen: set = set()
    for r in roots:
        for n in topo_order(r):
            if id(n) not in seen:
                seen.add(id(n))
                order.append(n)
    index = {id(n): i for i, n in enumerate(order)}
    program = []
    sources = []
    for n in order:
        if n.op == "scalar":
            program.append(("scalar", (), n.dtype, (), (), n.shape))
            if isinstance(n.value, _Marker):
                if not markers:
                    raise _Bail()    # loopvar/rng markers: not in a while
                sources.append((n.value.tag, n.value.arg))
            else:
                sources.append(("const", (
                    np.asarray(n.value).astype(n.dtype).item(), n.dtype)))
        elif n.value is not None:
            program.append(("__leaf__", (), n.dtype, (), (), n.shape))
            if id(n) in carried_leaf:
                sources.append(("carry", carried_leaf[id(n)]))
            else:
                sources.append(("fixed", n.value))
        else:
            if not eng.supports_op(n.op):
                raise MatError("MATLAB:internal",
                               f"no device op {n.op} for a loop body")
            program.append((n.op, n.static, n.dtype,
                            tuple(index[id(i)] for i in n.inputs),
                            tuple(i.shape for i in n.inputs), n.shape))
            sources.append(("op", None))
    return program, sources, [index[id(r)] for r in roots]


def _carry(tr: _Trace, names: list, finals: dict) -> tuple:
    """The carry slots of the written variables and their initial values.
    A read-carried variable keeps its shape and type across iterations;
    a write-before-read one (no initial value) is never read."""
    carried_leaf = {id(node): names.index(name)
                    for name, node in tr.carry_in.items() if name in names}
    carry = []
    for name in names:
        init = tr.carry_init.get(name)
        root = finals[name].dev
        if init is not None and (tuple(init.shape) != phys_shape(root.shape)
                                 or tr.carry_in[name].dtype != root.dtype):
            raise _Bail()
        carry.append(init)
    return carried_leaf, carry


def _finals(tr: _Trace) -> tuple:
    names = sorted(tr.written)
    finals = {}
    for name in names:
        v = tr.shadow.get(name)
        if not (isinstance(v, MatArray) and v.on_device):
            raise _Bail()
        finals[name] = v
    return names, finals


def _bind(eng, names: list, finals: dict, carry: list) -> dict:
    """The final carry as leaf MatArrays of the workspace."""
    result = {}
    for k, name in enumerate(names):
        root = finals[name].dev
        node = LazyNode(eng, "leaf", [], (), tuple(root.shape), root.dtype,
                        value=carry[k])
        node.dispatch_id = eng.dispatch_seq
        result[name] = MatArray.from_device(node, finals[name].mclass)
    return result


def _key(kind: str, program: list, sources: list, roots: list,
         *extra) -> tuple:
    """A fold's graph-cache key: its program and where each entry's value
    comes from, with the shapes and dtypes of its invariant leaves; not the
    scalars' values, T or the counter (the JAX package's `key_parts`)."""
    parts = []
    for entry, (kind_i, p) in zip(program, sources):
        if kind_i == "fixed":
            p = (tuple(p.shape), str(p.dtype))
        elif kind_i == "const":
            p = str(p[1])
        parts.append((entry, kind_i, p))
    return (kind, tuple(parts), tuple(roots)) + extra


@contextlib.contextmanager
def _syncs_raise():
    """Any call that waits for the card raises inside the block."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _waits(e: RuntimeError) -> bool:
    return "synchronizing CUDA operation" in str(e)


class _Step:
    """One iteration of a folded loop with its sources in device memory: the
    step index `t`; for each draw its counter base `c0 + offset`, to which
    an iteration adds `t*BPI` (one kernel); the iterable `it` (or None);
    the program's scalars, filled on the device once; its invariant leaves.
    `run` enqueues one iteration and nothing in it waits for the card, so
    it can be captured."""

    def __init__(self, eng, program: list, sources: list, roots: list,
                 bpi: int = 0, c0: int = 0, it=None):
        self.eng, self.program, self.roots, self.bpi = eng, program, roots, bpi
        self.kinds = [kind for kind, _ in sources]
        self.t = torch.zeros((), dtype=torch.int64, device=eng.device)
        self.it = it
        self.slots = [self._slot(kind, p, c0) for kind, p in sources]
        self.plan = fuse.plan(program, roots, in_loop=True)

    def _slot(self, kind: str, p, c0: int):
        if kind == "const":
            return self.eng._scalar(*p)
        if kind == "rng":
            return torch.full((), counter_value(c0 + p), dtype=torch.int64,
                              device=self.eng.device)
        return p

    def values(self, carry: list) -> list:
        out = []
        for kind, s in zip(self.kinds, self.slots):
            if kind == "carry":
                out.append(carry[s])
            elif kind == "loopvar":
                out.append(self.it.index_select(0, self.t.reshape(1))
                           .reshape(()))
            elif kind == "rng":
                out.append(torch.add(s, self.t, alpha=self.bpi))
            else:
                out.append(s)       # op: None; const and fixed: tensors
        return out

    def run(self, carry: list, advance: bool = True) -> list:
        outs = self.eng.run_program(self.program, self.values(carry),
                                    self.roots, self.plan)
        if advance:
            self.t.add_(1)
        return outs

    def load(self, sources: list, c0: int, it) -> None:
        """This fold's scalars, leaves, counter and iterable into the
        buffers a captured graph reads; t back to 0."""
        self.t.zero_()
        if it is not None:
            self.it[:it.numel()].copy_(it)
        for slot, (kind, p) in zip(self.slots, sources):
            if kind == "const":
                slot.fill_(p[0])
            elif kind == "rng":
                slot.fill_(counter_value(c0 + p))
            elif kind == "fixed" and not _same_storage(slot, p):
                slot.copy_(p)


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class _Graph:
    """One `_Step` captured as a CUDA graph over carry buffers at fixed
    addresses. The step's invariant leaves are cloned first, so a later
    fold's `load` never writes into a workspace value. `copy_slots` are the
    read-carried slots, copied into their buffers at the end of the graph;
    any other output stays where the graph wrote it."""

    def __init__(self, eng, step: _Step, carry: list, copy_slots: set):
        self.eng, self.step = eng, step
        self.copy_slots = copy_slots
        step.slots = [s.clone() if kind == "fixed" else s
                      for kind, s in zip(step.kinds, step.slots)]
        self.bufs = [c.clone() if k in copy_slots else None
                     for k, c in enumerate(carry)]
        before = collections.Counter(threefry.captured)
        kernels = collections.Counter(fused.captured)
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(eng.device)
        side = torch.cuda.Stream(device=eng.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                outs = step.run(self.bufs, advance=False)
                # an output that is (a view of) a carry buffer is cloned
                # before any buffer is written
                owned = [b for b in self.bufs if b is not None]
                outs = [o.clone() if any(_same_storage(o, b) for b in owned)
                        else o for o in outs]
                for k in sorted(copy_slots):
                    self.bufs[k].copy_(outs[k])
                step.t.add_(1)
            except BaseException as e:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass            # the capture's first error is raised
                raise GraphFault(f"capture of a folded loop failed: "
                                 f"{type(e).__name__}: {e}") from e
            self.graph.capture_end()
        current.wait_stream(side)
        self.outs = outs
        self.draws = collections.Counter(threefry.captured) - before
        self.kernels = collections.Counter(fused.captured) - kernels
        eng.stats["graph_captures"] += 1

    def fits(self, it) -> bool:
        return it is None or self.step.it.numel() >= it.numel()

    def load(self, sources: list, c0: int, it, carry: list) -> None:
        self.step.load(sources, c0, it)
        for k in self.copy_slots:
            self.bufs[k].copy_(carry[k])

    def replay(self, times: int) -> None:
        try:
            for _ in range(times):
                self.graph.replay()
        except RuntimeError as e:
            raise GraphFault(f"replay of a folded loop failed: {e}") from e
        self.eng.stats["graph_replays"] += times
        threefry.replayed(self.draws, times)
        fused.replayed(self.kernels, times)

    def carry(self) -> list:
        """The carry after the last replay."""
        return [b if k in self.copy_slots else self.outs[k]
                for k, b in enumerate(self.bufs)]

    def results(self) -> list:
        """The carry, out of the cache's buffers."""
        return [c.clone() for c in self.carry()]


def _decline(eng, e: RuntimeError) -> str:
    eng.stats["graph_declines"] += 1
    return f"declined: {e}"[:160]


def _count(eng, key: tuple) -> None:
    """A fold's program compiled the first time, reused after."""
    if key in eng._jit_cache:
        eng.stats["cache_hits"] += 1
    else:
        eng.stats["compiles"] += 1
        eng._jit_cache[key] = None


def _run_for(eng, key: tuple, make_step, sources: list, carry: list,
             T: int, c0: int, it, copy_slots: set) -> tuple:
    """T iterations; returns (final carry, how, graph replays)."""
    _count(eng, key)
    if eng.device.type != "cuda":
        step = make_step()
        for _ in range(T):
            carry = step.run(carry)
        return carry, "eager", 0
    graph = eng._jit_cache.get(key)
    if graph is not None and graph.fits(it):
        graph.load(sources, c0, it, carry)
        graph.replay(T)
        return graph.results(), "cached", T
    step = make_step()
    try:
        with _syncs_raise():
            first = step.run(carry)
    except RuntimeError as e:
        if not _waits(e):
            raise
        how = _decline(eng, e)
        step.t.zero_()
        for _ in range(T):
            carry = step.run(carry)
        return carry, how, 0
    graph = _Graph(eng, step, first, copy_slots)
    eng._jit_cache[key] = graph
    graph.replay(T - 1)
    return graph.results(), "captured", T - 1


def _build_and_run(eng, tr: _Trace, T: int, state,
                   iter_host: np.ndarray) -> dict:
    names, finals = _finals(tr)
    carried_leaf, carry = _carry(tr, names, finals)
    program, sources, roots = _program(
        eng, [finals[name].dev for name in names], carried_leaf, True)
    bpi = tr.rng_blocks
    it = None
    if any(kind == "loopvar" for kind, _ in sources):
        it = eng.to_device(iter_host.reshape(-1).astype(
            np.float64 if tr.iterable.mclass == "double" else np.float32))
    key = _key("device_loop", program, sources, roots, bpi, it is not None)
    t0 = time.perf_counter()
    carry, how, replays = _run_for(
        eng, key,
        lambda: _Step(eng, program, sources, roots, bpi, state.counter, it),
        sources, carry, T, state.counter, it, set(carried_leaf.values()))
    eng.stats["dispatches"] += 1
    eng.dispatch_seq += 1
    eng.record_launch("device_loop",
                      [p[0] for p, s in zip(program, sources) if s[0] == "op"],
                      (time.perf_counter() - t0) * 1e3,
                      sum(int(c.nbytes) for c in carry))
    eng.launch_log[-1].update(iterations=T, graph=how, replays=replays)
    return _bind(eng, names, finals, carry)


# --------------------------------------------------------------------------- #
# the while fold
# --------------------------------------------------------------------------- #


@_engine_locked
def try_device_while(interp, frame, code, marker_pc: int, jf_pc: int,
                     end_pc: int):
    """Run the whole `while` loop at `marker_pc` on the device. Returns the
    pc to resume at, or None for the interpreter to run the loop."""
    from ..runtime import registry
    from ..vm.interp import NOVALUE

    eng = active_engine()
    if eng is None or jf_pc is None or end_pc is None:
        return None
    B = _bc()
    instrs = code.instrs
    if code.loop_hints.get(marker_pc) == "never":
        return None
    if instrs[end_pc - 1][0] != B.JMP or \
            instrs[end_pc - 2][0] != B.CHECK_INTERRUPT:
        return None
    cond_lo, cond_hi = marker_pc + 1, jf_pc
    body_lo, body_hi = jf_pc + 1, end_pc - 2
    written: set = set()
    if _scan_window(B, instrs, range(cond_lo, cond_hi), written,
                    allow_store=False) is None or \
            _scan_window(B, instrs, range(body_lo, body_hi), written) is None:
        code.loop_hints[marker_pc] = "never"
        return None
    for i in [*range(cond_lo, cond_hi), *range(body_lo, body_hi)]:
        op, a = instrs[i][:2]
        if op == B.RESOLVE_CALL and a in _RNG_BUILTINS:
            code.loop_hints[marker_pc] = "never"
            return None          # no data-dependent RNG counters
    if not written:
        return None
    # zero-trip safety: every written variable exists with a carried type
    for name in written:
        v = interp._load_name(frame, name)
        if v is NOVALUE or not isinstance(v, MatArray) or \
                v.mclass not in ("double", "single", "logical"):
            return None

    old_cap = eng.fuse_cap
    eng.fuse_cap = 1 << 60
    try:
        tr = _Trace(interp, frame, eng, registry, interp.session.rng, None,
                    written, None)
        cond_stack = tr.run_window(instrs, code.consts, cond_lo, cond_hi)
        if len(cond_stack) != 1:
            raise _Bail()
        cond_v = cond_stack[0]
        if not (isinstance(cond_v, MatArray) and cond_v.on_device
                and cond_v.size == 1):
            raise _Bail()        # host-computed condition: nothing to gain
        tr.run(instrs, code.consts, body_lo, body_hi)
        if tr.rng_blocks:
            raise _Bail()
        result = _build_and_run_while(eng, tr, cond_v)
    except GraphFault:
        raise
    except Exception as e:
        # boundary: the interpreter runs the loop instead, on record
        _record_bail(eng, code, marker_pc, e)
        return None
    finally:
        eng.fuse_cap = old_cap
    for name, val in result.items():
        interp._store_name(frame, name, val)
    eng.stats["while_folds"] += 1
    return end_pc


def _build_and_run_while(eng, tr: _Trace, cond_v: MatArray) -> dict:
    names, finals = _finals(tr)
    if any(name not in tr.carry_init for name in names):
        raise _Bail()            # zero-trip safety (checked above too)
    carried_leaf, carry = _carry(tr, names, finals)
    cond_prog, cond_src, (cond_root,) = _program(eng, [cond_v.dev],
                                                 carried_leaf, False)
    body_prog, body_src, roots = _program(
        eng, [finals[name].dev for name in names], carried_leaf, False)
    cond = _Step(eng, cond_prog, cond_src, [cond_root])
    on_card = eng.device.type == "cuda"
    key = _key("device_while", body_prog, body_src, roots)
    _count(eng, key)
    graph = eng._jit_cache.get(key) if on_card else None
    how = "eager"
    if graph is not None:
        graph.load(body_src, 0, None, carry)
        carry = graph.carry()
        how = "cached"
    else:
        body = _Step(eng, body_prog, body_src, roots)

    t0 = time.perf_counter()
    trips = replays = 0
    while True:
        (c,) = cond.run(carry, advance=False)
        if not eng.read_scalar(c.reshape(()).to(torch.bool)):
            break
        if graph is None and on_card and trips == 1 and how == "eager":
            graph = _Graph(eng, body, carry, set(range(len(carry))))
            eng._jit_cache[key] = graph
            how = "captured"
        if graph is not None:
            graph.replay(1)
            replays += 1
            carry = graph.carry()
        elif on_card and trips == 0:
            try:
                with _syncs_raise():
                    carry = body.run(carry, advance=False)
            except RuntimeError as e:
                if not _waits(e):
                    raise
                how = _decline(eng, e)
                carry = body.run(carry, advance=False)
        else:
            carry = body.run(carry, advance=False)
        trips += 1
    if graph is not None:
        carry = graph.results()
    eng.stats["dispatches"] += 1
    eng.dispatch_seq += 1
    eng.record_launch("device_while",
                      [p[0] for p, s in zip(body_prog, body_src)
                       if s[0] == "op"],
                      (time.perf_counter() - t0) * 1e3,
                      sum(int(c.nbytes) for c in carry))
    eng.launch_log[-1].update(iterations=trips, graph=how, replays=replays)
    return _bind(eng, names, finals, carry)
