"""The `for`-loop fold for the PyTorch engine, and the seam that installs it.

`runmat_tpu`'s interpreter imports `try_device_loop` and `try_device_while`
from `runmat_tpu.accel.loops` at each loop entry (`vm/interp.py`).
`install_seam` rebinds those two module attributes to the functions here and
`remove_seam` puts the originals back. Under any engine other than a
`TorchEngine` the functions here delegate to the originals, so the JAX path
is untouched.

A `for` loop whose body is pure device math is traced once by the JAX
package's `_Trace` (it only builds DAG nodes; its one jax call, in `_load`,
is overridden) into a loop program, which then runs eagerly T times through
`TorchEngine.run_program`. Iteration t draws from counter block
`start + t*BPI + offset` (BPI: blocks one iteration draws), computed on the
host with the 64-bit carry into the high word, and the session state
advances by `T*BPI` afterwards: the same values the interpreter would draw.

A fold that fails is not silent: `stats["loop_bails"]` counts it and the
launch log keeps the exception text. The interpreter then runs the loop.
"""

from __future__ import annotations

import time

import numpy as np

from runmat_tpu.accel import active_engine
from runmat_tpu.accel import loops as jloops
from runmat_tpu.accel.engine import phys_shape
from runmat_tpu.accel.lazy import topo_order
from runmat_tpu.accel.loops import (_Bail, _Marker, _Trace, _bc, _note_bail,
                                    _scan_window)
from runmat_tpu.values import MatArray

from .engine import TorchEngine
from .lazy import TorchLazyNode

_ORIGINAL = {"try_device_loop": jloops.try_device_loop,
             "try_device_while": jloops.try_device_while}


def install_seam() -> None:
    jloops.try_device_loop = try_device_loop
    jloops.try_device_while = try_device_while


def remove_seam() -> None:
    for name, fn in _ORIGINAL.items():
        setattr(jloops, name, fn)


def try_device_while(interp, frame, code, marker_pc, jf_pc, end_pc):
    eng = active_engine()
    if not isinstance(eng, TorchEngine):
        return _ORIGINAL["try_device_while"](interp, frame, code, marker_pc,
                                             jf_pc, end_pc)
    eng.stats["while_not_ported"] += 1
    return None


def try_device_loop(interp, frame, code, for_next_pc: int, iterable):
    """Run the whole `for` loop at `for_next_pc` on the device. Returns the
    pc to resume at, or None for the interpreter to run the loop."""
    eng = active_engine()
    if not isinstance(eng, TorchEngine):
        return _ORIGINAL["try_device_loop"](interp, frame, code, for_next_pc,
                                            iterable)
    from runmat_tpu.runtime import registry

    # eligibility: the same checks as runmat_tpu.accel.loops.try_device_loop
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
        tr = _TorchTrace(interp, frame, eng, registry, state, loopvar,
                         written, iterable)
        tr.run(instrs, code.consts, lo_pc, hi_pc)
        result = _build_and_run(eng, tr, T, state, h)
    except Exception as e:
        # boundary: the interpreter runs the loop instead; the fold's
        # failure is counted and its reason kept
        _note_bail(code, for_next_pc)
        eng.stats["loop_bails"] += 1
        eng.launch_log.append({"cat": "loop_bail", "ops": [], "n_ops": 0,
                               "reason": f"{type(e).__name__}: {e}"[:160]})
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


class _TorchTrace(_Trace):
    def _load(self, name: str):
        """As `_Trace._load`, with a host-resident carried variable copied
        to the device by the engine."""
        if name in self.shadow or name == self.loopvar or \
                name not in self.written:
            return super()._load(name)
        from runmat_tpu.vm.interp import NOVALUE
        v = self.interp._load_name(self.frame, name)
        if v is NOVALUE:
            return NOVALUE
        if not isinstance(v, MatArray) or v.mclass not in \
                ("double", "single", "logical"):
            raise _Bail()
        if v.on_device:
            init, dt = self.eng.materialize(v.dev), v.dev.dtype
        else:
            init, dt = self.eng.to_device(v.host()), v.host().dtype
        node = TorchLazyNode(self.eng, "leaf", [], (), v.shape, dt,
                             value=init)
        tracer = MatArray.from_device(node, v.mclass)
        self.carry_in[name] = node
        self.carry_init[name] = init
        self.shadow[name] = tracer
        return tracer


def _build_and_run(eng: TorchEngine, tr: _TorchTrace, T: int, state,
                   iter_host: np.ndarray) -> dict:
    names = sorted(tr.written)
    finals = {}
    for name in names:
        v = tr.shadow.get(name)
        if not (isinstance(v, MatArray) and v.on_device):
            raise _Bail()
        finals[name] = v

    order: list = []
    seen: set = set()
    for name in names:
        for n in topo_order(finals[name].dev):
            if id(n) not in seen:
                seen.add(id(n))
                order.append(n)
    index = {id(n): i for i, n in enumerate(order)}
    carry_slot = {name: k for k, name in enumerate(names)}
    carried_leaf = {id(node): carry_slot[name]
                    for name, node in tr.carry_in.items()
                    if name in carry_slot}

    # one program in the engine's format; `sources[i]` says where entry i's
    # value comes from in each iteration
    program = []
    sources = []
    for n in order:
        if n.op == "scalar":
            program.append(("scalar", (), n.dtype, (), (), n.shape))
            if isinstance(n.value, _Marker):
                sources.append((n.value.tag, n.value.arg))
            else:
                sources.append(("fixed", eng._tensor(
                    np.asarray(n.value, dtype=n.dtype), n.dtype)))
        elif n.value is not None:
            program.append(("__leaf__", (), n.dtype, (), (), n.shape))
            if id(n) in carried_leaf:
                sources.append(("carry", carried_leaf[id(n)]))
            else:
                sources.append(("fixed", n.value))
        else:
            if not eng.supports_op(n.op):
                raise NotImplementedError(
                    f"runmat_tpu_torch: op {n.op} in a loop body not ported "
                    f"yet (ROADMAP A6)")
            program.append((n.op, n.static, n.dtype,
                            tuple(index[id(i)] for i in n.inputs),
                            tuple(i.shape for i in n.inputs), n.shape))
            sources.append(("op", None))
    roots = [index[id(finals[name].dev)] for name in names]

    # read-carried variables start from their live values and must keep
    # their shape and type; write-before-read ones are never read
    carry = []
    for name in names:
        init = tr.carry_init.get(name)
        root = finals[name].dev
        if init is not None and (tuple(init.shape) != phys_shape(root.shape)
                                 or tr.carry_in[name].dtype != root.dtype):
            raise _Bail()
        carry.append(init)

    it = iter_host.reshape(-1).astype(
        np.float64 if tr.iterable.mclass == "double" else np.float32)
    c0 = state.counter
    bpi = tr.rng_blocks
    mask = 0xFFFFFFFF
    t0 = time.perf_counter()
    for t in range(T):
        base = c0 + t * bpi
        values = []
        for kind, payload in sources:
            if kind == "carry":
                values.append(carry[payload])
            elif kind == "rng_lo":
                values.append(np.uint32((base + payload) & mask))
            elif kind == "rng_hi":
                values.append(np.uint32(((base + payload) >> 32) & mask))
            elif kind == "loopvar":
                values.append(it[t])
            else:
                values.append(payload)
        carry = eng.run_program(program, values, roots)
    eng.stats["dispatches"] += 1
    eng.dispatch_seq += 1
    eng.record_launch("device_loop",
                      [p[0] for p, s in zip(program, sources) if s[0] == "op"],
                      (time.perf_counter() - t0) * 1e3,
                      sum(int(c.nbytes) for c in carry))

    result = {}
    for k, name in enumerate(names):
        root = finals[name].dev
        node = TorchLazyNode(eng, "leaf", [], (), tuple(root.shape),
                             root.dtype, value=carry[k])
        node.dispatch_id = eng.dispatch_seq
        result[name] = MatArray.from_device(node, finals[name].mclass)
    return result
