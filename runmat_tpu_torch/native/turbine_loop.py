"""Copy of runmat_tpu/native/turbine_loop.py in the PyTorch port.

Turbine gate: translate scalar-numeric for-loops to the native stack VM.

Reference parity: runmat-turbine's execute_or_compile path — hot bytecode is
compiled to native code, with fallback to the interpreter on any unsupported
construct (runmat-core/src/session/run.rs:812-832, turbine/src/compiler.rs).
The translation runs on loop ENTRY (the loop trip count is the hotness
signal, like the reference's threshold-10 profiler) and bails to the Python
interpreter unless every instruction in the window is scalar-double math.

Round 4 widens the tier toward the reference's general bytecode compiler
(turbine/src/compiler.rs:249): 2-D indexed loads/stores A(i,j), nested
`for`/`while` loops translated into native counting loops (trip count
mirrors the interpreter's colon semantics exactly, including the endpoint
clamp), and single-output scalar user functions inlined at translation time
with isolated scoped slots (bounded depth/total, cache revalidated against
the callee's identity).

The port counts what the tier does: `taken` counts the loops it ran to
their end ("for", "while"), `bails` each fall-back to the interpreter by
its reason (the same decisions as the JAX package's tier, which keeps no
count): the library not built, a gate of the entry, the construct a
translation stopped at, or the native VM's status. `reset_counts()` zeroes
both.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np

from ..values import MatArray

# Turbine ISA (mirror of native/turbine.cpp)
(T_CONST, T_LOAD, T_STORE, T_ADD, T_SUB, T_MUL, T_DIV, T_POW, T_NEG,
 T_LT, T_LE, T_GT, T_GE, T_EQ, T_NE, T_AND, T_OR, T_NOT,
 T_JMP, T_JMP_IF_FALSE, T_JMP_IF_TRUE, T_CALL1, T_CALL2, T_DUP, T_POP,
 T_HALT, T_LOADIDX, T_STOREIDX, T_LOADIDX2, T_STOREIDX2,
 T_ENTER, T_CALL, T_RETN) = range(33)

_BIN = {"add": T_ADD, "sub": T_SUB, "mul": T_MUL, "div": T_DIV,
        "pow": T_POW, "lt": T_LT, "le": T_LE, "gt": T_GT, "ge": T_GE,
        "eq": T_EQ, "ne": T_NE, "and": T_AND, "or": T_OR}
_UN = {"neg": T_NEG, "logical_not": T_NOT, "uplus": None}

_FN1 = {n: i for i, n in enumerate(
    "sin cos tan asin acos atan sinh cosh tanh exp log log2 log10 sqrt abs "
    "floor ceil round sign fix expm1 log1p".split())}
_FN2 = {n: i for i, n in enumerate(
    "atan2 hypot mod rem max min power".split())}
_FN0 = {"pi": float(np.pi), "eps": float(np.finfo(np.float64).eps),
        "Inf": float("inf"), "inf": float("inf"),
        "NaN": float("nan"), "nan": float("nan")}

_SCOPE = "\x00"            # prefix marking callee-scope slot keys
_MAX_SUBROUTINES = 64      # distinct user callees per loop site
# headroom beyond frame 0 for callee frames (recursion depth x frame size
# bounded at runtime by the VM's slots_cap -> status 5 -> interpreter)
_FRAME_HEADROOM = 16384
# VM steps (instructions) a loop may take before the VM returns status 2
# and the interpreter runs the loop
STEP_BUDGET = 200_000_000


taken: collections.Counter = collections.Counter()   # "for", "while"
bails: collections.Counter = collections.Counter()   # reason -> count


def reset_counts() -> None:
    taken.clear()
    bails.clear()


def _bail(reason: str):
    bails[reason] += 1
    return None


# the native VM's statuses other than 0 (turbine.cpp beside this file)
_STATUS = {1: "stack error", 2: "step budget exceeded", 3: "bad opcode",
           4: "bad subscript", 5: "frame overflow"}


class _Bail(Exception):
    def __init__(self, reason: str = "unsupported construct"):
        super().__init__(reason)
        self.reason = reason


def _cache(code) -> dict:
    """Per-unit translation cache: loop sites re-entered with the same
    structure skip re-translation (≙ the reference Turbine's compiled-code
    cache keyed by bytecode hash, turbine/src/cache.rs). Slot/array STATE
    is rebuilt fresh each entry and revalidated against the recorded
    recipe; any class/shape drift drops the entry."""
    c = getattr(code, "_turbine_cache", None)
    if c is None:
        c = {}
        code._turbine_cache = c
    return c


def _user_code(interp, frame, name):
    """Resolve `name` in the frame's context for inlining purposes.
    Returns ("user", Code) for a plain user function, ("builtin", None)
    when the name resolves to a builtin (intrinsic table may apply), or
    None for anything the native tier must not second-guess (nested or
    sibling functions, classes, unresolved names)."""
    f = frame
    while f is not None:
        if f.code is not None and name in getattr(f.code, "nested", ()):
            return None                 # shares the parent workspace
        f = f.parent
    if frame.code is not None and \
            name in (getattr(frame.code, "siblings", None) or ()):
        return None
    if interp.session.classes.get(name) is not None:
        return None
    r = interp.resolve_function(name)
    if r is None:
        try:
            r = interp.session.resolve_path_function(name)
        except Exception:
            return None
    if r is None:
        return None
    kind, obj = r
    if kind == "user":
        return ("user", obj)
    if kind == "builtin":
        return ("builtin", None)
    return None


def _rebuild(interp, frame, ent):
    """Fresh slot init values + array copies for a cached program; None if
    the workspace no longer matches the recorded assumptions."""
    from ..vm.interp import NOVALUE
    # inlined callees must still resolve to the same Code objects
    for name, cid in ent.get("inlined", ()):
        cur = _user_code(interp, frame, name)
        if not (cur and cur[0] == "user" and id(cur[1]) == cid):
            return None
    init: list = []
    for spec in ent["slot_spec"]:
        kind = spec[0]
        if kind == "internal":
            init.append(0.0)
            continue
        name = spec[1]
        v = interp._load_name(frame, name)
        if kind == "var":
            if v is NOVALUE or not (isinstance(v, MatArray) and v.size == 1
                                    and not v.on_device and not v.is_complex
                                    and v.mclass == spec[2]):
                return None
            init.append(float(v.host().reshape(-1)[0]))
        else:   # "undef": init is unobservable (reads only follow stores)
            if v is NOVALUE:
                init.append(0.0)
            elif isinstance(v, MatArray) and v.size == 1 and \
                    not v.on_device and not v.is_complex and \
                    v.mclass == "double":
                init.append(float(v.host().reshape(-1)[0]))
            else:
                return None
    arr_names: list = []
    arr_bufs: list = []
    for name in ent["arr_spec"]:
        v = interp._load_name(frame, name)
        if v is NOVALUE or not isinstance(v, MatArray) or v.on_device or \
                v.is_complex or v.mclass != "double" or v.size <= 1:
            return None
        h = v.host()
        arr_bufs.append(np.ravel(h, order="F").astype(np.float64).copy())
        arr_names.append((name, tuple(h.shape)))
    return init, arr_names, arr_bufs


def _dispatch_cached(lib, interp, frame, code, ck, translate, resume_pc):
    cache = _cache(code)
    ent = cache.get(ck)
    if ent is not None:
        state = _rebuild(interp, frame, ent)
        if state is not None:
            init, arr_names, arr_bufs = state
            return _run_native(lib, frame, ent["prog"], ent["consts"],
                               ent["slot_map"], init, arr_names, arr_bufs,
                               resume_pc, ck[0])
        cache.pop(ck, None)
    try:
        (prog, consts, slot_map, init, arr_names, arr_bufs,
         slot_spec, arr_spec, inlined) = translate()
    except _Bail as e:
        return _bail(e.reason)
    if len(cache) > 64:
        cache.clear()
    cache[ck] = {"prog": prog, "consts": consts, "slot_map": slot_map,
                 "slot_spec": slot_spec, "arr_spec": arr_spec,
                 "inlined": inlined}
    # status != 0 -> None: budget/VM/subscript error falls back untouched —
    # arr_bufs are private copies and only dirty slots/arrays bind back, so
    # a store in a never-taken branch cannot conjure a variable and a
    # partial native run leaves the workspace exactly as before (the
    # "never required for correctness" invariant)
    return _run_native(lib, frame, prog, consts, slot_map, init,
                       arr_names, arr_bufs, resume_pc, ck[0])


def try_native_loop(interp, frame, code, for_next_pc: int, iterable):
    """Execute the whole scalar loop natively. Returns resume pc or None."""
    from . import turbine
    lib = turbine()
    if lib is None:
        return _bail("not built")
    if not isinstance(iterable, MatArray) or iterable.on_device or \
            iterable.is_complex or iterable.mclass != "double":
        return _bail("iterable not a host double row")
    h = iterable.host()
    if h.ndim != 2 or h.shape[0] != 1 or h.shape[1] < 64:
        return _bail("fewer than 64 iterations")

    from ..vm import bytecode as B
    instrs = code.instrs
    fn_op, loopvar, done, _, _ = instrs[for_next_pc]
    if fn_op != B.FOR_NEXT or done is None:
        return _bail("loop shape")
    if instrs[done - 1][0] != B.JMP or instrs[done - 2][0] != B.CHECK_INTERRUPT:
        return _bail("loop shape")
    lo, hi = for_next_pc + 1, done - 2

    # cache key includes the range parameters (baked into the program);
    # non-uniform iterables never hit the cache (or the translator)
    it = h.reshape(-1)
    if it.size >= 2:
        # uniformity via min/max spread (orders of magnitude cheaper than
        # np.allclose on multi-million-element ranges; NaN steps make the
        # comparison false and fall back)
        steps = np.diff(it)
        mn, mx = steps.min(), steps.max()
        if not (mx - mn <= 1e-12 * max(abs(mn), abs(mx)) + 1e-300):
            return _bail("non-uniform iterable")
        step = float(steps[0])
    else:
        step = 1.0
    rng = (float(it[0]), step, int(it.size))
    ck = ("for", for_next_pc) + rng
    return _dispatch_cached(
        lib, interp, frame, code, ck,
        lambda: _translate(interp, frame, code, instrs, lo, hi, loopvar,
                           rng, done),
        done + 1)


def try_native_while(interp, frame, code, marker_pc: int, jf_pc: int,
                     end_pc: int):
    """Execute a whole scalar `while` loop natively (the tier-2 analog of
    the device while-gate; ≙ the reference Turbine compiling hot while
    bodies). Window = condition + body; the loop-back jump is re-emitted as
    the epilogue and the exit branch resolves to HALT. Returns the resume
    pc or None (fallback, original state untouched)."""
    from . import turbine
    lib = turbine()
    if lib is None:
        return _bail("not built")
    from ..vm import bytecode as B
    instrs = code.instrs
    if jf_pc is None or end_pc is None or end_pc > len(instrs):
        return _bail("loop shape")
    lo, hi = marker_pc + 1, end_pc - 1
    if hi <= lo or instrs[hi][0] != B.JMP or instrs[hi][1] != lo:
        return _bail("loop shape")
    return _dispatch_cached(
        lib, interp, frame, code, ("while", marker_pc),
        lambda: _translate(interp, frame, code, instrs, lo, hi, None, None,
                           end_pc),
        end_pc)   # resume AT end_pc (the exit-branch target), like the
                  # device while-gate


def _run_native(lib, frame, prog, consts, slot_map, init, arr_names,
                arr_bufs, resume_pc, kind):
    ops = np.array([p[0] for p in prog], dtype=np.int32)
    args = np.array([float(p[1]) for p in prog], dtype=np.float64)
    cons = np.asarray(consts, dtype=np.float64)
    # frame 0 = the loop window's slots; callee frames stack above it
    cap = len(init) + _FRAME_HEADROOM
    slots = np.zeros(cap, dtype=np.float64)
    slots[:len(init)] = np.asarray(init, dtype=np.float64)
    dirty = np.zeros(cap, dtype=np.uint8)
    if cons.size == 0:
        cons = np.zeros(1)
    n_arr = len(arr_bufs)
    arr_ptrs = (ctypes.POINTER(ctypes.c_double) * max(n_arr, 1))()
    arr_lens = np.zeros(max(n_arr, 1), dtype=np.int64)
    arr_rows = np.ones(max(n_arr, 1), dtype=np.int64)
    for k, buf in enumerate(arr_bufs):
        arr_ptrs[k] = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        arr_lens[k] = buf.size
        shp = arr_names[k][1]
        arr_rows[k] = shp[0] if shp else 1
    arr_dirty = np.zeros(max(n_arr, 1), dtype=np.uint8)
    status = lib.turbine_run(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        args.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        np.int32(len(prog)),
        cons.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        slots.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dirty.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr_ptrs,
        arr_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        arr_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        arr_dirty.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(n_arr),
        np.int64(STEP_BUDGET),
        np.int64(cap))
    if status != 0:
        return _bail(f"status {status}: {_STATUS.get(status, 'error')}")
    taken[kind] += 1
    for name, k in slot_map.items():
        if dirty[k]:
            frame.vars[name] = MatArray.scalar(float(slots[k]))
    for k, (name, shape) in enumerate(arr_names):
        if arr_dirty[k]:
            frame.vars[name] = MatArray(
                arr_bufs[k].reshape(shape, order="F"), "double")
    return resume_pc


def _translate(interp, frame, code, instrs, lo, hi, loopvar, range_params,
               done):
    """Bytecode window -> turbine program implementing the WHOLE loop.
    `loopvar`/`range_params` None = while mode: no counter prologue/
    epilogue, the window is condition+body, and the loop-back edge is
    re-emitted. range_params = (start, step, count), validated uniform by
    the caller (also the cache key, so key and baked constants agree).

    Class-safety bails (the tier is never required for correctness): the
    native VM computes in f64 only, so any `single` operand, any store of a
    logical-valued expression, or any pre-existing logical variable that is
    a store target makes the translation bail to the interpreter — otherwise
    class()/rounding would diverge from MATLAB whenever this tier engaged."""
    from ..vm import bytecode as B
    from ..vm.interp import NOVALUE

    slot_of: dict[str, int] = {}
    init: list[float] = []
    consts: list[float] = []
    logical_vars: set[str] = set()
    slot_spec: list = []               # per-slot rebuild recipe (see _rebuild)
    undefined_vars: set[str] = set()   # no pre-loop value; defined by STORE
    stored_so_far: set[str] = set()    # saw an unconditional in-window STORE
    inlined: list = []                 # (name, id(Code)) for cache revalidation
    scope_seq = [0]
    subs: dict = {}                    # id(Code) -> {entry, callee, nargs}
    sub_queue: list = []               # pending callee compilations
    call_patches: list = []            # (prog idx, id(Code))
    prog: list = []

    def const_idx(v: float) -> int:
        consts.append(float(v))
        return len(consts) - 1

    def internal_slot(val: float = 0.0) -> int:
        k = len(init)
        init.append(val)
        slot_spec.append(("internal",))
        return k

    def slot(key: str, stored_names: set) -> int:
        """Slot for a scoped key. Caller-scope keys ("" prefix) bind to the
        workspace; inlined-scope keys are pure internals."""
        if key in slot_of:
            return slot_of[key]
        if key.startswith(_SCOPE):
            slot_of[key] = internal_slot(0.0)
            undefined_vars.add(key)
            return slot_of[key]
        v = interp._load_name(frame, key)
        if v is NOVALUE:
            # only valid for write-before-read targets; a genuine read of an
            # undefined variable must error through the interpreter path
            if key not in stored_names:
                raise _Bail()
            undefined_vars.add(key)
            val = 0.0
            slot_spec.append(("undef", key))
        else:
            if not (isinstance(v, MatArray) and v.size == 1
                    and not v.on_device and not v.is_complex
                    and v.mclass in ("double", "logical")):
                # single/int: f64 compute would diverge
                raise _Bail('not a host double or logical scalar')
            if v.mclass == "logical":
                if key in stored_names:
                    raise _Bail('writeback would coerce to double')
                logical_vars.add(key)
            val = float(v.host().reshape(-1)[0])
            slot_spec.append(("var", key, v.mclass))
        slot_of[key] = len(init)
        init.append(val)
        return slot_of[key]

    # array registry: host double arrays accessed by 1-based linear or (i,j)
    # index. Every registered array gets a PRIVATE F-order copy — reads and
    # writes share one buffer per name so in-loop updates are visible, and a
    # failed native run discards the copies (COW).
    arr_of: dict[str, int] = {}
    arr_bufs: list = []
    arr_names: list = []

    def arr(name: str) -> int:
        if name in arr_of:
            return arr_of[name]
        v = interp._load_name(frame, name)
        if v is NOVALUE or not isinstance(v, MatArray) or v.on_device or \
                v.is_complex or v.mclass != "double" or v.size <= 1:
            raise _Bail()
        h = v.host()
        arr_of[name] = len(arr_bufs)
        arr_bufs.append(np.ravel(h, order="F").astype(np.float64).copy())
        arr_names.append((name, tuple(h.shape)))
        return arr_of[name]

    # abstract class-tag stack mirroring the value stack: "n" numeric,
    # "b" logical, "u" unknown (control-flow merge). Storing anything but a
    # definitely-numeric value bails — the native VM carries doubles only.
    tags: list = []
    _CMP = {"lt", "le", "gt", "ge", "eq", "ne", "and", "or"}

    def _pop_tag():
        return tags.pop() if tags else "u"

    def emit_window(w_instrs, w_consts, wlo, whi, scope, depth,
                    pre_stored=()):
        """Translate bytecode [wlo, whi) of one scope into `prog`.
        Returns (break_patches, ret_patches): prog indexes of jumps whose
        bytecode target is `done` (outer-loop break; caller scope only) or
        a RET (inlined-callee return)."""
        # ---- prescan: stores, jump structure, conditional regions -------
        stored_names: set[str] = {scope + n for n in pre_stored}
        jump_targets: set[int] = set()
        spans: list[tuple[int, int]] = []   # normalized (lo, hi) regions
        for i in range(wlo, whi):
            op, a, b, c, d = w_instrs[i]
            if op == B.STORE:
                stored_names.add(scope + a)
            elif op == B.FOR_NEXT:
                stored_names.add(scope + a)
                if b is not None:
                    spans.append((i, b))     # loop body: may run 0 times
            elif op in (B.JMP, B.JMP_IF_FALSE, B.JMP_IF_TRUE):
                if isinstance(a, int):
                    if a < i:
                        # backward edge: only the structured loop-back of a
                        # nested for (target = FOR_NEXT) or while (target
                        # follows a WHILE_INFO marker)
                        if not (a < len(w_instrs) and
                                (w_instrs[a][0] == B.FOR_NEXT or
                                 (a >= 1 and
                                  w_instrs[a - 1][0] == B.WHILE_INFO))):
                            raise _Bail()
                        spans.append((a, i))
                    else:
                        jump_targets.add(a)
                        spans.append((i, a))

        def _in_branch(i: int) -> bool:
            return any(s < i < t for s, t in spans)

        jump_map: dict[int, int] = {}     # bytecode pc -> turbine index
        patches: list = []                # (turbine idx, bytecode target)
        ret_patches: list = []
        break_patches: list = []
        # nested-for loop vars that were undefined before the loop: visible
        # inside the body only; removed again at the loop's done pc
        temp_defined: dict[int, list] = {}

        for n in pre_stored:
            stored_so_far.add(scope + n)

        def wslot(name: str) -> int:
            return slot(scope + name, stored_names)

        base_depth = len(tags)   # outer expression context (mid-expr inline)
        pc = wlo
        while pc < whi:
            jump_map[pc] = len(prog)
            for n in temp_defined.pop(pc, ()):
                stored_so_far.discard(n)
            if pc in jump_targets and len(tags) > base_depth:
                # merge point: paths may disagree about this window's tags
                tags[base_depth:] = ["u"] * (len(tags) - base_depth)
            op, a, b, c, d = w_instrs[pc]
            pc += 1
            if op == B.CONST:
                v = w_consts[a]
                if not (isinstance(v, MatArray) and v.size == 1
                        and not v.is_complex
                        and v.mclass in ("double", "int32")):
                    raise _Bail()
                prog.append((T_CONST,
                             const_idx(float(v.host().reshape(-1)[0]))))
                tags.append("n")
            elif op == B.LOAD:
                key = scope + a
                if scope:
                    if key in slot_of or key in stored_names:
                        if key not in stored_so_far:
                            raise _Bail('read-before-write in callee')
                        prog.append((T_LOAD, wslot(a)))
                        tags.append("n")
                        continue
                elif key in slot_of or key in stored_names or \
                        interp._load_name(frame, a) is not NOVALUE:
                    k = wslot(a)            # registers undefined_vars first
                    if key in undefined_vars and key not in stored_so_far:
                        raise _Bail('dynamic read-before-write')
                    prog.append((T_LOAD, k))
                    tags.append("b" if key in logical_vars else "n")
                    continue
                if a in _FN0:
                    r = _user_code(interp, frame, a)
                    if not (r and r[0] == "builtin"):
                        raise _Bail('shadowed: resolution must win')
                    prog.append((T_CONST, const_idx(_FN0[a])))
                    tags.append("n")
                else:
                    raise _Bail()
            elif op == B.STORE:
                if b:
                    raise _Bail('display side effect')
                if _pop_tag() != "n":
                    raise _Bail('logical-valued store: class diverge')
                key = scope + a
                k = slot(key, stored_names)
                if key in undefined_vars and key not in stored_so_far:
                    if _in_branch(pc - 1):
                        raise _Bail('conditional first definition')
                    stored_so_far.add(key)
                prog.append((T_STORE, k))
            elif op == B.BINOP:
                t = _BIN.get(a)
                if t is None:
                    raise _Bail()
                prog.append((t, 0))
                _pop_tag(); _pop_tag()
                tags.append("b" if a in _CMP else "n")
            elif op == B.UNOP:
                t = _UN.get(a, -1)
                if t == -1:
                    raise _Bail()
                if t is not None:
                    prog.append((t, 0))
                _pop_tag()
                tags.append("b" if a == "logical_not" else "n")
            elif op in (B.MTIMES, B.MPOW, B.MRDIV):
                # scalar operands: matrix ops coincide with their elementwise
                # forms (a/b for MRDIV; tags guarantee scalar doubles)
                t = {B.MTIMES: T_MUL, B.MPOW: T_POW, B.MRDIV: T_DIV}[op]
                prog.append((t, 0))
                _pop_tag(); _pop_tag()
                tags.append("n")
            elif op == B.MLDIV:
                raise _Bail('operand order swap not in the ISA (rare)')
            elif op == B.JMP:
                idx = len(prog)
                prog.append((T_JMP, 0))
                patches.append((idx, a))
            elif op == B.JMP_IF_FALSE:
                idx = len(prog)
                prog.append((T_JMP_IF_FALSE, 0))
                patches.append((idx, a))
                _pop_tag()
            elif op == B.JMP_IF_TRUE:
                idx = len(prog)
                prog.append((T_JMP_IF_TRUE, 0))
                patches.append((idx, a))
                _pop_tag()
            elif op == B.BOOL_SCALAR:
                pass                     # scalars are already 0/1 doubles
            elif op == B.DUP:
                prog.append((T_DUP, 0))
                tags.append(tags[-1] if tags else "u")
            elif op == B.POP:
                prog.append((T_POP, 0))
                _pop_tag()
            elif op in (B.CHECK_INTERRUPT, B.WHILE_INFO):
                pass
            elif op == B.FOR_POP:
                pass                     # native loops never push iterators
            elif op == B.RET:
                if not scope:
                    raise _Bail('return exits the enclosing function')
                idx = len(prog)
                prog.append((T_JMP, 0))
                ret_patches.append(idx)
            elif op == B.RANGE:
                # only as the iterable of an immediately following nested
                # for: translated into a native counting loop mirroring
                # _make_range's trip count + endpoint clamp exactly
                if pc >= whi or w_instrs[pc][0] != B.FOR_INIT or \
                        pc + 1 >= whi or w_instrs[pc + 1][0] != B.FOR_NEXT:
                    raise _Bail()
                has_step = a
                st_stop = internal_slot()
                st_step = internal_slot()
                st_start = internal_slot()
                if _pop_tag() != "n":
                    raise _Bail()
                prog.append((T_STORE, st_stop))
                if has_step:
                    if _pop_tag() != "n":
                        raise _Bail()
                    prog.append((T_STORE, st_step))
                else:
                    prog.append((T_CONST, const_idx(1.0)))
                    prog.append((T_STORE, st_step))
                if _pop_tag() != "n":
                    raise _Bail()
                prog.append((T_STORE, st_start))
                n_slot = internal_slot()
                c_slot = internal_slot()
                jump_map[pc] = len(prog)
                pc += 1                  # consume FOR_INIT
                fn_pc = pc
                _, var, done_i, _, _ = w_instrs[pc]
                pc += 1
                if done_i is None or done_i >= whi or \
                        w_instrs[done_i][0] != B.FOR_POP:
                    raise _Bail()
                lv_slot = wslot(var)
                vkey = scope + var
                if vkey in undefined_vars and vkey not in stored_so_far:
                    # loop var is bound inside the body only (0-trip loops
                    # leave it unset); reads after done_i must re-bail
                    stored_so_far.add(vkey)
                    temp_defined.setdefault(done_i, []).append(vkey)
                # n = 0 if step==0 or wrong direction, else
                #     floor((stop-start)/step + 1e-10) + 1   (≙ _make_range)
                def _ld(s):
                    prog.append((T_LOAD, s))
                _ld(st_step)
                prog.append((T_CONST, const_idx(0.0)))
                prog.append((T_EQ, 0))
                j_empty1 = len(prog)
                prog.append((T_JMP_IF_TRUE, 0))
                _ld(st_stop)
                _ld(st_start)
                prog.append((T_SUB, 0))
                _ld(st_step)
                prog.append((T_DIV, 0))
                prog.append((T_DUP, 0))
                prog.append((T_CONST, const_idx(0.0)))
                prog.append((T_LT, 0))
                j_empty2 = len(prog)
                prog.append((T_JMP_IF_TRUE, 0))  # span<0: wrong direction
                prog.append((T_CONST, const_idx(1e-10)))
                prog.append((T_ADD, 0))
                prog.append((T_CALL1, _FN1["floor"]))
                prog.append((T_CONST, const_idx(1.0)))
                prog.append((T_ADD, 0))
                prog.append((T_STORE, n_slot))
                j_go = len(prog)
                prog.append((T_JMP, 0))
                # empty: n = 0 (the span path leaves one value to discard)
                for eidx, extra_pop in ((j_empty1, False), (j_empty2, True)):
                    here = len(prog)
                    prog[eidx] = (prog[eidx][0], here)
                    if extra_pop:
                        prog.append((T_POP, 0))
                    prog.append((T_CONST, const_idx(0.0)))
                    prog.append((T_STORE, n_slot))
                    if not extra_pop:
                        jj = len(prog)
                        prog.append((T_JMP, 0))
                prog[jj] = (T_JMP, len(prog))
                prog[j_go] = (T_JMP, len(prog))
                prog.append((T_CONST, const_idx(0.0)))
                prog.append((T_STORE, c_slot))
                # head (the FOR_NEXT target): c += 1; exit when c > n
                head = len(prog)
                jump_map[fn_pc] = head
                _ld(c_slot)
                prog.append((T_CONST, const_idx(1.0)))
                prog.append((T_ADD, 0))
                prog.append((T_DUP, 0))
                prog.append((T_STORE, c_slot))
                _ld(n_slot)
                prog.append((T_GT, 0))
                idx = len(prog)
                prog.append((T_JMP_IF_TRUE, 0))
                patches.append((idx, done_i))
                # lv = start + (c-1)*step, endpoint clamped like _make_range
                _ld(st_start)
                _ld(c_slot)
                prog.append((T_CONST, const_idx(1.0)))
                prog.append((T_SUB, 0))
                _ld(st_step)
                prog.append((T_MUL, 0))
                prog.append((T_ADD, 0))
                prog.append((T_STORE, lv_slot))
                _ld(c_slot)
                _ld(n_slot)
                prog.append((T_EQ, 0))
                _ld(n_slot)
                prog.append((T_CONST, const_idx(1.0)))
                prog.append((T_GT, 0))
                prog.append((T_AND, 0))
                _ld(lv_slot)
                _ld(st_stop)
                prog.append((T_SUB, 0))
                prog.append((T_CALL1, _FN1["abs"]))
                _ld(st_step)
                prog.append((T_CALL1, _FN1["abs"]))
                prog.append((T_CONST, const_idx(1e-10)))
                prog.append((T_MUL, 0))
                prog.append((T_LT, 0))
                prog.append((T_AND, 0))
                idx = len(prog)
                prog.append((T_JMP_IF_FALSE, 0))
                _ld(st_stop)
                prog.append((T_STORE, lv_slot))
                prog[idx] = (T_JMP_IF_FALSE, len(prog))
                # body continues through the main walk; loop-back JMP to
                # fn_pc resolves via jump_map, breaks to done_i likewise
            elif op == B.STORE_INDEX:
                # y(k) = v / y(i,j) = v: write into an EXISTING host double
                # array (growth/OOB must go through the interpreter; the VM
                # returns status 4 on any bad subscript -> clean fallback)
                name, nargs, kind, display = a, b, c, d
                if nargs not in (1, 2) or kind != "paren" or display or \
                        scope:
                    raise _Bail()
                for _ in range(nargs):
                    if _pop_tag() != "n":     # index tags
                        raise _Bail()
                if _pop_tag() != "n":     # value must be numeric
                    raise _Bail()
                prog.append((T_STOREIDX if nargs == 1 else T_STOREIDX2,
                             arr(name)))
            elif op == B.RESOLVE_CALL:
                name, nargs, nargout_, mode = a, b, c, d
                if mode != 0 or nargout_ > 1:
                    raise _Bail()
                key = scope + name
                if scope:
                    is_var = key in slot_of or key in stored_names
                    existing = NOVALUE
                else:
                    existing = interp._load_name(frame, name)
                    is_var = key in slot_of or existing is not NOVALUE
                if is_var:
                    if nargs == 0:
                        if key in undefined_vars and \
                                key not in stored_so_far:
                            raise _Bail('dynamic read-before-write')
                        if scope and key not in stored_so_far:
                            raise _Bail()
                        prog.append((T_LOAD, wslot(name)))
                        tags.append("b" if key in logical_vars else "n")
                        continue
                    if not scope and nargs in (1, 2) and \
                            key not in slot_of and \
                            isinstance(existing, MatArray) and \
                            existing.size > 1:
                        # x(k) / x(i,j): 1-based read from a host double array
                        for _ in range(nargs):
                            if _pop_tag() != "n":
                                raise _Bail()
                        prog.append((T_LOADIDX if nargs == 1 else T_LOADIDX2,
                                     arr(name)))
                        tags.append("n")
                        continue
                    raise _Bail('indexing a scalar / higher subscript')
                r = _user_code(interp, frame, name)
                if r is None:
                    raise _Bail()
                if r[0] == "user":
                    _call_sub(r[1], name, nargs)
                    continue
                # builtin: the intrinsic tables apply
                if nargs == 1 and name in _FN1:
                    prog.append((T_CALL1, _FN1[name]))
                    _pop_tag()
                    tags.append("n")
                elif nargs == 2 and name in _FN2:
                    prog.append((T_CALL2, _FN2[name]))
                    _pop_tag(); _pop_tag()
                    tags.append("n")
                elif nargs == 0 and name in _FN0:
                    prog.append((T_CONST, const_idx(_FN0[name])))
                    tags.append("n")
                else:
                    raise _Bail(f"no intrinsic {name}/{nargs}")
            else:
                raise _Bail(f"opcode {op}")
        jump_map[whi] = len(prog)
        for n in temp_defined.pop(whi, ()):
            stored_so_far.discard(n)

        for idx, target in patches:
            if target in jump_map:
                t = jump_map[target]
            elif not scope and target == done:
                break_patches.append(idx)   # 'break': caller resolves
                continue
            else:
                raise _Bail('jump out of the window')
            prog[idx] = (prog[idx][0], t)
        return break_patches, ret_patches

    def _call_sub(callee, name, nargs):
        """Emit a native CALL to a single-output scalar user function
        compiled ONCE as a subroutine with frame-relative slots — true
        calls instead of bounded inlining, so deep helper chains and
        recursion stay native (VERDICT r4 #7; ≙ the reference Turbine
        compiling general call bytecode, runmat-turbine/src/value_abi.rs).
        Frame overflow at runtime returns status 5 -> interpreter."""
        if callee.is_script or callee.has_varargin or callee.has_varargout \
                or getattr(callee, "arg_specs", None) or callee.nested or \
                len(callee.outs) != 1 or callee.outs[0] == "~" or \
                len(callee.params) != nargs or "~" in callee.params:
            raise _Bail()
        cid = id(callee)
        rec = subs.get(cid)
        if rec is None:
            if len(subs) >= _MAX_SUBROUTINES:
                raise _Bail()
            rec = {"callee": callee, "nargs": nargs, "entry": None}
            subs[cid] = rec
            sub_queue.append(rec)
        for _ in range(nargs):
            if _pop_tag() != "n":
                raise _Bail()
        idxp = len(prog)
        prog.append((T_CALL, 0))
        call_patches.append((idxp, cid))
        tags.append("n")
        inlined.append((name, cid))

    def _compile_sub(rec):
        """Compile one callee body as a subroutine region: ENTER fs,
        prologue binding args (top-of-stack = last arg) into frame-local
        slots, the translated body, epilogue LOAD(out) + RETN. All slots
        created during this region are renumbered frame-relative."""
        callee = rec["callee"]
        scope_seq[0] += 1
        sc = f"{_SCOPE}{scope_seq[0]}:"
        base_i = len(init)
        entry = len(prog)
        prog.append((T_ENTER, 0))
        save_tags = tags[:]
        tags[:] = ["n"] * rec["nargs"]
        for pname in reversed(callee.params):
            if _pop_tag() != "n":
                raise _Bail()
            k = slot(sc + pname, {sc + pname})
            prog.append((T_STORE, k))
            undefined_vars.discard(sc + pname)
        _, ret_patches = emit_window(callee.instrs, callee.consts, 0,
                                     len(callee.instrs), sc, 1,
                                     pre_stored=tuple(callee.params))
        epi = len(prog)
        for idx in ret_patches:
            prog[idx] = (T_JMP, epi)
        okey = sc + callee.outs[0]
        if okey not in slot_of or okey not in stored_so_far:
            raise _Bail('output not unconditionally assigned')
        prog.append((T_LOAD, slot_of[okey]))
        prog.append((T_RETN, 0))
        # frame-relative renumbering: every slot this region created
        for j in range(entry, len(prog)):
            opj, aj = prog[j]
            if opj in (T_LOAD, T_STORE) and aj >= base_i:
                prog[j] = (opj, aj - base_i)
        prog[entry] = (T_ENTER, len(init) - base_i)
        rec["entry"] = entry
        tags[:] = save_tags

    # instruction 0 declares frame 0's width (patched once all slots are
    # known); callee frames stack above it at runtime
    prog.append((T_ENTER, 0))

    if loopvar is not None:
        # the loop variable is always written by the prologue before any
        # read; register its slot directly (pre-loop value irrelevant)
        slot_of[loopvar] = len(init)
        init.append(0.0)
        slot_spec.append(("internal",))
        lv_slot = slot_of[loopvar]

        start, step, count = range_params

        # prologue: lv = start; counter in a dedicated slot
        cnt_slot = len(init)
        init.append(0.0)
        slot_spec.append(("internal",))
        prog.append((T_CONST, const_idx(start)))
        prog.append((T_STORE, lv_slot))

    body_base = len(prog)
    break_patches, _ = emit_window(instrs, code.consts, lo, hi, "", 0)

    if loopvar is not None:
        # epilogue: counter++, lv += step, loop while counter < count
        prog.append((T_LOAD, cnt_slot))
        prog.append((T_CONST, const_idx(1.0)))
        prog.append((T_ADD, 0))
        prog.append((T_DUP, 0))
        prog.append((T_STORE, cnt_slot))
        prog.append((T_CONST, const_idx(float(count))))
        prog.append((T_GE, 0))
        idx = len(prog)
        prog.append((T_JMP_IF_TRUE, 0))   # done
        # lv = start + counter*step (no drift accumulation)
        prog.append((T_LOAD, cnt_slot))
        prog.append((T_CONST, const_idx(step)))
        prog.append((T_MUL, 0))
        prog.append((T_CONST, const_idx(start)))
        prog.append((T_ADD, 0))
        prog.append((T_STORE, lv_slot))
        prog.append((T_JMP, body_base))
        done_idx = len(prog)
        prog[idx] = (T_JMP_IF_TRUE, done_idx)
        prog.append((T_HALT, 0))
    else:
        # while mode: loop back to the condition; exit branch -> HALT
        prog.append((T_JMP, body_base))
        done_idx = len(prog)
        prog.append((T_HALT, 0))
    for bidx in break_patches:
        prog[bidx] = (prog[bidx][0], done_idx)
    # compile queued callee subroutines (a callee may queue more), patch
    # every CALL site, then stamp frame 0's width
    n_frame0 = None
    while sub_queue:
        if n_frame0 is None:
            n_frame0 = len(init)       # frame 0 = slots of the main window
        _compile_sub(sub_queue.pop(0))
    for idxp, cid in call_patches:
        entry = subs[cid]["entry"]
        if entry is None:
            raise _Bail()
        prog[idxp] = (T_CALL, entry)
    prog[0] = (T_ENTER, n_frame0 if n_frame0 is not None else len(init))
    slot_map = {n: k for n, k in slot_of.items()
                if not n.startswith(_SCOPE)}
    return (prog, consts, slot_map, init, arr_names, arr_bufs,
            slot_spec, [n for n, _ in arr_names], inlined)
