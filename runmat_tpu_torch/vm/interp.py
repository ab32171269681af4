"""Copy of runmat_tpu/vm/interp.py in the PyTorch port.

Bytecode interpreter.

Reference parity: runmat-vm/src/interpreter/{runner,dispatch}.rs — the async VM
hot loop with the fusion gate. Here the "fusion gate" is implicit: values flow
through the accel engine as lazy DAG nodes (runmat_tpu.accel.lazy), so any chain
of device ops fuses when materialized; the interpreter itself only orchestrates
control flow, calls, and host-side semantics.

Copy-on-write: LOAD marks MatArrays shared; STORE_INDEX writes in place only on
unshared targets (≙ reference GC value semantics).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..errors import InterruptError, MatError, undefined
from ..values import (CellArray, FunctionHandle, MatArray, OutputList,
                      StringArray, StructArray)
from ..runtime import registry
from ..runtime.concat import build_cell, build_matrix
from ..runtime import dispatch as D
from . import bytecode as B
from . import indexing as IX


class _NoValue:
    __slots__ = ()

    def __repr__(self):  # pragma: no cover
        return "<novalue>"


NOVALUE = _NoValue()


class Frame:
    __slots__ = ("vars", "globals", "persist", "iters", "ixctx", "nargin",
                 "nargout", "code", "varargout_names", "parent", "arg_names")

    def __init__(self, code: B.Code, nargin: int = 0, nargout: int = 0,
                 parent: "Frame" = None):
        self.vars: dict[str, Any] = {}
        self.globals: set[str] = set()
        self.persist: dict[str, tuple] = {}
        self.iters: list = []
        self.ixctx: list = []
        self.nargin = nargin
        self.nargout = nargout
        self.code = code
        self.parent = parent   # enclosing frame for NESTED functions
        self.arg_names: tuple = ()   # caller arg identifiers (inputname)


class Ctx:
    """Context handed to builtins that need interpreter access."""

    __slots__ = ("interp", "frame", "nargout")

    def __init__(self, interp: "Interp", frame: Frame, nargout: int = 1):
        self.interp = interp
        self.frame = frame
        self.nargout = nargout

    @property
    def session(self):
        return self.interp.session

    @property
    def arg_names(self):
        """Source identifier names of the current call's arguments (None
        per non-identifier arg) — MATLAB inputname()."""
        return getattr(self.interp, "_current_call_names", None) or ()


def _map_host_exception(name: str, e: Exception) -> MatError:
    """Host exception -> MATLAB error (≙ the reference dispatcher mapping
    builtin failures into MException, runmat-runtime/src/dispatcher.rs).
    Common failure families get their conventional MATLAB identifiers so
    try/catch code keyed on them behaves; the rest surface as
    RunMat:builtin:internalError with the host detail preserved."""
    text = str(e)
    kind = type(e).__name__
    if isinstance(e, ValueError) and (
            "broadcast" in text or "same shape" in text
            or "shape mismatch" in text or "dimensions" in text
            or "must match" in text):
        return MatError("MATLAB:sizeDimensionsMustMatch",
                        f"{name}: Arrays have incompatible sizes for "
                        f"this operation.")
    if isinstance(e, IndexError):
        return MatError("MATLAB:badsubscript",
                        f"{name}: Index exceeds array bounds.")
    if isinstance(e, FileNotFoundError):
        return MatError("MATLAB:FileIO:FileNotFound",
                        f"{name}: No such file or directory: "
                        f"{getattr(e, 'filename', '') or text}")
    if isinstance(e, (NotADirectoryError, IsADirectoryError,
                      PermissionError)):
        return MatError("MATLAB:FileIO:InvalidPath", f"{name}: {text}")
    if isinstance(e, (UnicodeDecodeError,)):
        return MatError("MATLAB:FileIO:InvalidFormat",
                        f"{name}: File is not valid text "
                        f"({text.split(':')[0]}).")
    if isinstance(e, OverflowError):
        return MatError("MATLAB:overflow", f"{name}: Value out of range.")
    if isinstance(e, ZeroDivisionError):
        return MatError("MATLAB:divideByZero", f"{name}: Division by zero.")
    if isinstance(e, (TypeError, AttributeError)):
        # keep the host detail: an internal builtin bug must stay
        # diagnosable from the error text
        return MatError("MATLAB:invalidType",
                        f"{name}: Invalid argument type for this function "
                        f"({kind}: {e}).")
    return MatError("RunMat:builtin:internalError",
                    f"{name}: invalid input ({kind}: {e})")


def make_mexception(err: MatError) -> StructArray:
    s = StructArray.scalar({
        "identifier": MatArray.char_from_str(err.identifier),
        "message": MatArray.char_from_str(err.message),
        "stack": StructArray({}, (0, 0)),
    })
    return s


class Interp:
    def __init__(self, session):
        self.session = session
        self._dloop_failed: set = set()   # (code id, pc) of failed device-loop gates
        self.active_frames: list = []     # live frame stack (spill candidates)
        registry.ensure_loaded()

    # ------------------------------------------------------------------ calls

    def resolve_function(self, name: str) -> Optional[tuple[str, Any]]:
        """Resolution order: local functions -> session functions -> builtins."""
        prog = self.session.program
        if prog is not None and name in prog.functions:
            return ("user", prog.functions[name])
        f = self.session.functions.get(name)
        if f is not None:
            return ("user", f)
        # imported package members (import pkg.fn / pkg.*) shadow builtins
        # and path functions, per MATLAB import precedence
        if getattr(self.session, "imports", None):
            from ..packages import resolve_import
            hit = resolve_import(self.session, name)
            if hit is not None:
                if hit[0] == "class":
                    return ("class", hit[1])
                return ("user", hit[1])
        b = registry.lookup(name)
        if b is not None:
            if b.extension and getattr(self.session, "compat",
                                       "extended") == "strict":
                return None   # strict MATLAB mode: extensions don't exist
                # (≙ ParserOptions CompatMode + HIR extension gates)
            return ("builtin", b)
        return None

    def call_named(self, name: str, args: list, nargout: int, frame: Frame) -> list:
        # nested functions of the current (or enclosing) function bind tightest
        f = frame
        while f is not None:
            if f.code is not None and name in f.code.nested:
                return self.call_user(f.code.nested[name], args, nargout,
                                      parent=f)
            f = f.parent
        # file-private local functions of package members (code.siblings;
        # separate scopes, unlike workspace-sharing nested functions)
        if frame.code is not None:
            sibs = getattr(frame.code, "siblings", None)
            if sibs and name in sibs:
                return self.call_user(sibs[name], args, nargout)
        # method dispatch on the dominant (object) argument takes precedence
        # over path functions (MATLAB resolution order; ≙ vm/object/resolve.rs)
        from .. import oop
        for a in args:
            if isinstance(a, (oop.MatObject, oop.HandleObject)):
                m = a.cls.find_method(self.session, name)
                if m is not None:
                    return self.call_user(m, args, nargout)
                break
        cls = self.session.classes.get(name)
        if cls is not None:
            return [oop.construct(self, frame, cls, args)]
        r = self.resolve_function(name)
        if r is None:
            r = self.session.resolve_path_function(name)
        if r is None:
            raise undefined(name)
        kind, f = r
        if kind == "class":
            return [oop.construct(self, frame, f, args)]
        if kind == "user":
            return self.call_user(f, args, nargout)
        return self.call_builtin(f, args, nargout, frame)

    def call_builtin(self, b: registry.Builtin, args: list, nargout: int,
                     frame: Frame) -> list:
        if len(args) < b.min_in:
            raise MatError("MATLAB:narginchk:notEnoughInputs",
                           f"Not enough input arguments for '{b.name}'.")
        if b.max_in is not None and len(args) > b.max_in:
            raise MatError("MATLAB:TooManyInputs",
                           f"Too many input arguments for '{b.name}'.")
        from ..runtime import timelike
        if timelike.applies(b.name, args):
            # datetime/duration args ride the numeric library via the
            # microseconds encode/decode shim (runtime/timelike.py)
            return timelike.shim(
                b, args, nargout,
                lambda enc: self.call_builtin(b, enc, nargout, frame))
        kw = {}
        if b.pass_nargout:
            kw["nargout"] = nargout
        if b.pass_ctx:
            kw["ctx"] = Ctx(self, frame, nargout)
        prof = getattr(self.session, "_profile", None)
        try:
            if prof is not None:
                import time as _time
                t0 = _time.perf_counter()
                try:
                    res = b.fn(*args, **kw)
                finally:
                    rec = prof.setdefault(b.name, [0, 0.0])
                    rec[0] += 1
                    rec[1] += _time.perf_counter() - t0
            else:
                res = b.fn(*args, **kw)
        except (MatError, KeyboardInterrupt, SystemExit, MemoryError):
            raise
        except RecursionError:
            raise
        except Exception as e:
            # A builtin must never leak a host-language exception: surface it
            # as a MATLAB error (≙ the reference dispatcher mapping builtin
            # failures into MException, runmat-runtime/src/dispatcher.rs).
            raise _map_host_exception(b.name, e)
        if res is None:
            return []
        if isinstance(res, list):
            return res
        if isinstance(res, OutputList):
            return res.items
        return [res]

    def call_user(self, code: B.Code, args: list, nargout: int,
                  parent: Frame = None) -> list:
        prof = getattr(self.session, "_profile", None)
        if prof is not None and not code.is_script:
            import time as _time
            t0 = _time.perf_counter()
            try:
                return self._call_user_impl(code, args, nargout, parent)
            finally:
                rec = prof.setdefault(code.name, [0, 0.0])
                rec[0] += 1
                rec[1] += _time.perf_counter() - t0
        return self._call_user_impl(code, args, nargout, parent)

    def _call_user_impl(self, code: B.Code, args: list, nargout: int,
                        parent: Frame = None) -> list:
        nparams = len(code.params) - (1 if code.has_varargin else 0)
        nv_param = None
        if code.arg_specs and any(sp[1] is not None for sp in code.arg_specs):
            # trailing name-value options bind into the last (struct) param
            nv_param = code.params[-1] if code.params else None
        if len(args) > nparams and not code.has_varargin and nv_param is None:
            raise MatError("MATLAB:TooManyInputs",
                           f"Too many input arguments for '{code.name}'.")
        if nv_param is not None:
            nparams -= 1   # the struct param is filled from name-value pairs
        frame = Frame(code, nargin=len(args), nargout=nargout, parent=parent)
        # caller-side identifier names of the actual args (inputname())
        frame.arg_names = getattr(self, "_current_call_names", None) or ()
        for i, p in enumerate(code.params[:nparams]):
            if i < len(args) and p != "~":
                v = args[i]
                if isinstance(v, MatArray) or type(v).__name__ == "MatObject":
                    v.shared = True
                frame.vars[p] = v
        if code.has_varargin:
            extra = args[nparams:]
            data = np.empty((1, len(extra)), dtype=object)
            for i, v in enumerate(extra):
                if isinstance(v, MatArray):
                    v.shared = True
                data[0, i] = v
            frame.vars["varargin"] = CellArray(data)
        if code.arg_specs:
            self._apply_arg_specs(code, frame, args[nparams:]
                                  if nv_param is not None else [])
        self.run(code, frame)
        # collect outputs
        nouts = len(code.outs) - (1 if code.has_varargout else 0)
        want = max(nargout, 1 if code.outs else 0)
        results = []
        for i, o in enumerate(code.outs[:nouts]):
            if i >= want:
                break
            if o == "~":
                results.append(MatArray.empty())
                continue
            if o not in frame.vars:
                if i < nargout:
                    raise MatError("MATLAB:UndefinedFunction",
                                   f"Output argument \"{o}\" (and possibly others) not "
                                   f"assigned a value in function \"{code.name}\".")
                break
            results.append(frame.vars[o])
        if code.has_varargout and len(results) < want and "varargout" in frame.vars:
            vo = frame.vars["varargout"]
            if not isinstance(vo, CellArray):
                raise MatError("MATLAB:varargout", "varargout must be a cell array.")
            flat = vo.data.reshape(-1, order="F")
            for i in range(flat.size):
                if len(results) >= want:
                    break
                results.append(flat[i])
        return results

    def call_value(self, fv, args: list, nargout: int, frame: Frame) -> list:
        # Handle/feval-style indirect calls carry no caller identifier
        # names (MATLAB inputname() is empty through them); clear so the
        # callee never reads a previous RESOLVE_CALL's stale names.
        self._current_call_names = None
        if isinstance(fv, FunctionHandle):
            if fv.kind == "named":
                return self.call_named(fv.name, args, nargout, frame)
            # anonymous: params + captures
            code = fv.body
            f2 = Frame(code, nargin=len(args), nargout=nargout)
            f2.vars.update(fv.captures)
            for i, p in enumerate(fv.params):
                if i < len(args) and p != "~":
                    v = args[i]
                    if isinstance(v, MatArray):
                        v.shared = True
                    f2.vars[p] = v
            stack = self.run(code, f2, keep_stack=True)
            val = stack[-1] if stack else NOVALUE
            if isinstance(val, OutputList):
                return list(val.items[:max(1, nargout)])
            if isinstance(val, list):   # multi-output tail call results
                return val[:max(1, nargout)]
            return [] if val is NOVALUE else [val]
        if hasattr(fv, "_mat_paren_call_"):
            # callable built-in objects (BoundMethod, MemoizedFunction, ...)
            return fv._mat_paren_call_(self, frame, list(args),
                                       max(nargout, 1))
        if isinstance(fv, (MatArray, StringArray)) :
            from ..values import text_of
            return self.call_named(text_of(fv), args, nargout, frame)
        raise MatError("MATLAB:UndefinedFunction", "Value is not callable.")

    # ------------------------------------------------------------------ eval

    def eval_source(self, src: str, frame: Frame) -> None:
        """eval() support: parse+compile+run in the given frame."""
        from ..frontend.parser import parse
        from .compiler import Compiler
        prog = parse(src, "<eval>")
        compiled = Compiler.compile_program(prog, "<eval>")
        self.run(compiled.main, frame)

    # -------------------------------------------------------------- main loop

    def run(self, code: B.Code, frame: Frame, keep_stack: bool = False):
        # Register the frame so HBM-pressure spillers can see function-local
        # workspaces, not just the base workspace (ADVICE r2: a long-running
        # function allocating past budget must participate in spilling).
        self.active_frames.append(frame)
        try:
            return self._run_impl(code, frame, keep_stack)
        finally:
            self.active_frames.pop()

    def _run_impl(self, code: B.Code, frame: Frame, keep_stack: bool = False):
        instrs = code.instrs
        consts = code.consts
        n = len(instrs)
        stack: list = []
        trystack: list = []   # (catch_pc, catch_var, stack_depth)
        pc = 0
        session = self.session
        while pc < n:
            op, a, b, c, d = instrs[pc]
            pc += 1
            try:
                if op == B.CONST:
                    stack.append(consts[a])
                elif op == B.LOAD:
                    v = self._load_name(frame, a)
                    if v is NOVALUE:
                        res = self._call_or_undef(a, frame)
                        stack.append(res)
                    else:
                        if isinstance(v, MatArray) or type(v).__name__ == "MatObject":
                            v.shared = True
                        stack.append(v)
                elif op == B.STORE:
                    v = stack.pop()
                    v = _unwrap1(v, a)
                    if isinstance(v, MatArray) and v._dev is not None and \
                            getattr(v._dev, "value", 1) is None:
                        # workspace-bound lazy value: fused kernels emit it as
                        # an extra output (≙ fused_elementwise_multi)
                        v._dev.pinned = True
                    self._store_name(frame, a, v)
                    if b:
                        self._display(a, v)
                elif op == B.BINOP:
                    rhs = _unwrap1(stack.pop())
                    lhs = _unwrap1(stack.pop())
                    stack.append(D.binary(a, lhs, rhs))
                elif op == B.UNOP:
                    stack.append(D.unary(a, _unwrap1(stack.pop())))
                elif op == B.MTIMES:
                    rhs = _unwrap1(stack.pop())
                    stack.append(D.mtimes(_unwrap1(stack.pop()), rhs))
                elif op == B.MLDIV:
                    rhs = _unwrap1(stack.pop())
                    stack.append(D.mldivide(_unwrap1(stack.pop()), rhs))
                elif op == B.MRDIV:
                    rhs = _unwrap1(stack.pop())
                    stack.append(D.mrdivide(_unwrap1(stack.pop()), rhs))
                elif op == B.MPOW:
                    rhs = _unwrap1(stack.pop())
                    stack.append(D.mpower(_unwrap1(stack.pop()), rhs))
                elif op == B.TRANSPOSE:
                    v = _unwrap1(stack.pop())
                    stack.append(D.ctranspose(v) if a else D.transpose(v))
                elif op == B.RANGE:
                    stop = _unwrap1(stack.pop())
                    step = _unwrap1(stack.pop()) if a else None
                    start = _unwrap1(stack.pop())
                    stack.append(_make_range(start, step, stop))
                elif op == B.COLON_VAL:
                    stack.append(IX.COLON)
                elif op == B.RESOLVE_CALL:
                    # arg identifier names are valid only for THIS resolved
                    # call (builtins read them mid-call, user functions
                    # capture them at frame entry); clear on exit so later
                    # handle/feval/method calls never see stale names.
                    self._current_call_names = \
                        code.call_arg_names.get(pc - 1)
                    try:
                        self._resolve_call(stack, frame, a, b, c, d)
                    finally:
                        self._current_call_names = None
                elif op == B.LOADC:
                    v = self._load_name(frame, a)
                    if v is NOVALUE:
                        cls = session.classes.get(a)
                        if cls is not None:
                            from ..oop import ClassRef
                            stack.append(ClassRef(cls))
                        else:
                            from ..packages import find_package
                            pkg = find_package(session, a)
                            if pkg is not None:
                                stack.append(pkg)
                            else:
                                from ..oop import (BUILTIN_EMPTY_CLASSES,
                                                   BuiltinClassRef)
                                nxt = instrs[pc][0] if pc < n else None
                                if a in BUILTIN_EMPTY_CLASSES and \
                                        (b == "recv" or nxt == B.FIELD):
                                    # string.empty / double.empty(0, 3):
                                    # the bare class name is a static-
                                    # access receiver, not a ctor call
                                    stack.append(BuiltinClassRef(a))
                                else:
                                    stack.append(
                                        self._call_or_undef(a, frame))
                    else:
                        if isinstance(v, MatArray):
                            v.shared = True
                        from ..oop import MatObject
                        if isinstance(v, MatObject):
                            v.shared = True
                        stack.append(v)
                elif op == B.CALL_METHOD:
                    args = _collect_args(stack, b)
                    base = _unwrap1(stack.pop())
                    res = self._call_method(frame, base, a, args, max(c, 1))
                    _push_results(stack, res, c)
                elif op == B.DYNCALL:
                    args = _collect_args(stack, a)
                    fv = stack.pop()
                    nout = max(frame.nargout, 1) if b == -1 else b
                    res = self.call_value(fv, args, nout, frame)
                    _push_results(stack, res, nout)
                elif op == B.INDEX:
                    args = _collect_args(stack, a)
                    base = _unwrap1(stack.pop())
                    if frame.ixctx and frame.ixctx[-1] is None:
                        frame.ixctx[-1] = base  # PUSH_IXCTX placeholder
                    if b == "brace":
                        stack.append(IX.read_brace(base, args))
                    elif isinstance(base, FunctionHandle):
                        res = self.call_value(base, args, 1, frame)
                        stack.append(res[0] if res else NOVALUE)
                    elif hasattr(base, "_mat_paren_call_"):
                        # callable built-in objects (MemoizedFunction, ...)
                        res = base._mat_paren_call_(self, frame, args, 1)
                        stack.append(res[0] if res else NOVALUE)
                    else:
                        stack.append(IX.read_paren(base, args))
                elif op == B.FIELD:
                    if a is None:
                        fname_v = stack.pop()
                        from ..values import text_of
                        fname = text_of(fname_v)
                    else:
                        fname = a
                    base = _unwrap1(stack.pop())
                    stack.append(self._field_read(base, fname))
                elif op == B.PUSH_IXCTX:
                    frame.ixctx.append(stack[-1] if stack else None)
                elif op == B.PUSH_IXCTX_VAR:
                    v = self._load_name(frame, a)
                    frame.ixctx.append(None if v is NOVALUE else v)
                elif op == B.POP_IXCTX:
                    frame.ixctx.pop()
                elif op == B.END_VAL:
                    base = frame.ixctx[-1] if frame.ixctx else None
                    stack.append(_end_value(base, a, b))
                elif op == B.BUILD_MAT:
                    stack.append(self._build(stack, a, build_matrix))
                elif op == B.BUILD_CELL:
                    stack.append(self._build(stack, a, build_cell))
                elif op == B.JMP:
                    pc = a
                elif op == B.JMP_IF_FALSE:
                    if not _truthy(stack.pop()):
                        pc = a
                elif op == B.JMP_IF_TRUE:
                    if _truthy(stack.pop()):
                        pc = a
                elif op == B.BOOL_SCALAR:
                    v = _unwrap1(stack.pop())
                    stack.append(MatArray.logical_scalar(_truthy_scalar(v)))
                elif op == B.DUP:
                    stack.append(stack[-1])
                elif op == B.POP:
                    stack.pop()
                elif op == B.STORE_INDEX:
                    self._store_index(stack, frame, a, b, c, d)
                elif op == B.STORE_PATH:
                    self._store_path(stack, frame, a, b, c, d)
                elif op == B.SPLIT:
                    self._split(stack, a)
                elif op == B.FOR_INIT:
                    itv = _unwrap1(stack.pop())
                    npc = None
                    if isinstance(itv, MatArray) and not itv.on_device and \
                            itv.size >= 8:
                        from ..accel.loops import try_device_loop
                        npc = try_device_loop(self, frame, code, pc, itv)
                        # the native tier-2 loop executor is not carried
                    if npc is not None:
                        pc = npc
                    else:
                        frame.iters.append(_make_iter(itv))
                elif op == B.FOR_NEXT:
                    it = frame.iters[-1]
                    v = it.next()
                    if v is None:
                        pc = b
                    else:
                        frame.vars[a] = v
                elif op == B.WHILE_INFO:
                    # device-while gate; bail -> the plain interpreter path
                    # (never required for correctness). The native tier-2
                    # while executor is not carried.
                    key = (id(code), pc - 1)
                    if key not in self._dloop_failed:
                        from ..accel.loops import try_device_while
                        npc = try_device_while(self, frame, code, pc - 1, a, b)
                        if npc is not None:
                            pc = npc
                        else:
                            self._dloop_failed.add(key)
                elif op == B.FOR_POP:
                    frame.iters.pop()
                elif op == B.MAKE_ANON:
                    adef: B.AnonDef = consts[a]
                    captures = {}
                    for nm in adef.free_names:
                        v = self._load_name(frame, nm)
                        if v is not NOVALUE:
                            if isinstance(v, MatArray):
                                v.shared = True
                            captures[nm] = v
                    stack.append(FunctionHandle("anon", params=adef.params,
                                                body=adef.code, captures=captures,
                                                src=adef.src))
                elif op == B.MAKE_HANDLE:
                    stack.append(FunctionHandle("named", name=a))
                elif op == B.GLOBAL_DECL:
                    for nm in a:
                        frame.globals.add(nm)
                        if nm not in session.global_vars:
                            session.global_vars[nm] = MatArray.empty()
                elif op == B.PERSIST_DECL:
                    for nm in a:
                        key = (id(code), nm)
                        frame.persist[nm] = key
                        if key not in session.persistents:
                            session.persistents[key] = MatArray.empty()
                elif op == B.TRY_PUSH:
                    trystack.append((a, b, len(stack)))
                elif op == B.TRY_POP:
                    trystack.pop()
                elif op == B.RET:
                    break
                elif op == B.ANS_STMT:
                    v = stack.pop()
                    if v is NOVALUE:
                        if b is not None:
                            pass  # variable display already handled via RESOLVE_CALL value
                    else:
                        v = _unwrap1(v)
                        if b is not None and b in frame.vars:
                            if a:
                                self._display(b, v)
                        else:
                            frame.vars["ans"] = v
                            if a:
                                self._display("ans", v)
                elif op == B.DISPLAY_VAR:
                    v = self._load_name(frame, a)
                    if v is not NOVALUE:
                        self._display(a, v)
                elif op == B.SWITCH_MATCH:
                    case_v = _unwrap1(stack.pop())
                    sw_v = _unwrap1(stack.pop())
                    stack.append(MatArray.logical_scalar(_switch_match(sw_v, case_v)))
                elif op == B.CHECK_INTERRUPT:
                    if session.interrupt_requested:
                        session.interrupt_requested = False
                        raise InterruptError()
                else:  # pragma: no cover
                    raise MatError("MATLAB:internal", f"Bad opcode {op}.")
            except MatError as err:
                if trystack:
                    catch_pc, catch_var, depth = trystack.pop()
                    del stack[depth:]
                    if catch_var:
                        frame.vars[catch_var] = make_mexception(err)
                    session.last_error = err
                    pc = catch_pc
                    continue
                if not err.stack or err.stack[-1][0] != code.name:
                    err.stack.append((code.name, code.lines[pc - 1] if pc - 1 < len(code.lines) else 0))
                raise
        return stack if keep_stack else None

    # ---------------------------------------------------------------- helpers

    def _load_name(self, frame: Frame, name: str):
        v = frame.vars.get(name, NOVALUE)
        if v is not NOVALUE:
            return v
        if name in frame.globals:
            return self.session.global_vars.get(name, MatArray.empty())
        key = frame.persist.get(name)
        if key is not None:
            return self.session.persistents[key]
        # nested function: shared workspace with the enclosing function
        p = frame.parent
        while p is not None:
            if name in p.vars:
                return p.vars[name]
            p = p.parent
        return NOVALUE

    def _store_name(self, frame: Frame, name: str, v) -> None:
        if name in frame.globals:
            self.session.global_vars[name] = v
            return
        key = frame.persist.get(name)
        if key is not None:
            self.session.persistents[key] = v
            return
        if name not in frame.vars:
            p = frame.parent
            while p is not None:
                if name in p.vars:
                    p.vars[name] = v
                    return
                p = p.parent
        frame.vars[name] = v

    def _call_or_undef(self, name: str, frame: Frame):
        r = self.resolve_function(name)
        if r is None:
            raise undefined(name)
        kind, f = r
        if kind == "class":
            from .. import oop
            return oop.construct(self, frame, f, [])
        res = (self.call_user(f, [], 1) if kind == "user"
               else self.call_builtin(f, [], 1, frame))
        return res[0] if res else NOVALUE

    def _resolve_call(self, stack: list, frame: Frame, name: str, nargs: int,
                      nargout: int, mode: int) -> None:
        if nargout == -1:   # anon tail call: inherit the caller's nargout
            nargout = max(frame.nargout, 1)
        args = _collect_args(stack, nargs)
        if mode != 1:  # not force-call
            v = self._load_name(frame, name)
            if v is not NOVALUE:
                if mode == 2:  # brace
                    stack.append(IX.read_brace(v, args))
                    return
                if isinstance(v, FunctionHandle):
                    res = self.call_value(v, args, max(nargout, 1), frame)
                    _push_results(stack, res, nargout)
                    return
                if hasattr(v, "_mat_paren_call_") and (nargs > 0 or
                                                       mode == 3):
                    # mode 3 = explicit `f()` parens: invoke zero-arg
                    res = v._mat_paren_call_(self, frame, args, max(nargout, 1))
                    _push_results(stack, res, nargout)
                    return
                if nargs == 0:
                    if isinstance(v, MatArray):
                        v.shared = True
                    if nargout > 1:
                        raise MatError("MATLAB:maxlhs", "Too many output arguments.")
                    stack.append(v)
                    return
                stack.append(IX.read_paren(v, args))
                return
        if mode == 2:
            raise undefined(name)
        res = self.call_named(name, args, nargout, frame)
        _push_results(stack, res, nargout)

    def _apply_arg_specs(self, code: B.Code, frame: Frame, nv_args: list):
        """Apply an arguments-validation block at function entry
        (≙ runmat-hir argument-validation: defaults, class coercion, size
        checks with scalar expansion, validator functions)."""
        from ..values import StructArray, text_of
        from .. import dtypes

        def eval_default(dcode):
            f = Frame(dcode)
            f.vars = frame.vars       # defaults may reference earlier args
            stack = self.run(dcode, f, keep_stack=True)
            return stack[-1] if stack else MatArray.empty()

        def coerce(v, cls, where):
            if cls is None or not isinstance(v, MatArray):
                return v
            if v.mclass == cls:
                return v
            numeric = ("double", "single", "int8", "int16", "int32", "int64",
                       "uint8", "uint16", "uint32", "uint64", "logical")
            if cls in numeric and v.mclass in numeric + ("char",):
                h = v.host()
                return MatArray(dtypes.cast_to_class(
                    h.astype(np.float64) if h.dtype.kind in "bu" or
                    v.mclass == "char" else h, cls), cls)
            if cls in ("char", "string") and v.mclass in ("char",):
                return v
            raise MatError("MATLAB:validation:UnableToConvert",
                           f"Argument '{where}' must be of class {cls}; "
                           f"got {v.mclass}.")

        def check_size(v, dims, where):
            if dims is None or not isinstance(v, MatArray):
                return v
            shape = v.shape
            concrete = all(d is not None for d in dims)
            want = tuple(dims)
            if len(shape) == len(want) and all(
                    w is None or s == w for s, w in zip(shape, want)):
                return v
            if concrete and v.size == 1:
                # MATLAB scalar expansion against a concrete size spec
                h = np.full(want, v.host().reshape(-1)[0])
                return MatArray(h, v.mclass)
            spec = ",".join(":" if d is None else str(d) for d in dims)
            raise MatError("MATLAB:validation:IncompatibleSize",
                           f"Argument '{where}' must be of size ({spec}).")

        def validate(v, validators, where):
            from ..runtime import registry
            for vname, vargs in validators:
                b = registry.lookup(vname)
                if b is None:
                    raise MatError("MATLAB:validation:UnknownValidator",
                                   f"Unknown validator '{vname}'.")
                call_args = [v]
                raws = list(vargs or [])
                # `{mustBeLessThan(a, 5)}` names the argument itself first
                if raws and raws[0] == where.split(".")[0]:
                    raws = raws[1:]
                for raw in raws:
                    try:
                        call_args.append(MatArray.scalar(float(raw)))
                    except ValueError:
                        call_args.append(MatArray.char_from_str(
                            raw.strip("'\"")))
                self.call_builtin(b, call_args, 0, frame)

        nv_pairs: dict = {}
        i = 0
        while i + 1 < len(nv_args) + 1 and i < len(nv_args):
            key_v = nv_args[i]
            from ..values import is_text
            if not is_text(key_v) or i + 1 >= len(nv_args):
                raise MatError("MATLAB:validation:BadNameValue",
                               "Expected name-value pairs.")
            nv_pairs[text_of(key_v)] = nv_args[i + 1]
            i += 2

        nv_structs: dict[str, dict] = {}
        declared_nv: dict[str, set] = {}
        for name, field, dims, cls, validators, dcode in code.arg_specs:
            if field is not None:
                declared_nv.setdefault(name, set()).add(field)
                bucket = nv_structs.setdefault(name, {})
                if field in nv_pairs:
                    v = nv_pairs.pop(field)
                elif dcode is not None:
                    v = eval_default(dcode)
                else:
                    continue
                v = coerce(v, cls, f"{name}.{field}")
                v = check_size(v, dims, f"{name}.{field}")
                validate(v, validators, f"{name}.{field}")
                bucket[field] = v
                continue
            v = frame.vars.get(name)
            if v is None:
                if dcode is not None:
                    v = eval_default(dcode)
                else:
                    raise MatError("MATLAB:validation:NotEnoughInputs",
                                   f"Argument '{name}' is required.")
            v = coerce(v, cls, name)
            v = check_size(v, dims, name)
            validate(v, validators, name)
            frame.vars[name] = v
        if nv_pairs:
            bad = next(iter(nv_pairs))
            raise MatError("MATLAB:validation:UnknownNameValue",
                           f"'{bad}' is not a recognized name-value argument.")
        for sname, fields in nv_structs.items():
            frame.vars[sname] = StructArray.scalar(fields)

    def _call_method(self, frame: Frame, base, fname: str, args: list,
                     nargout: int) -> list:
        """obj.m(args) / ClassRef.static(args); falls back to field-read +
        paren indexing for structs and plain values."""
        self._current_call_names = None   # no inputname through methods
        # built-in object method protocol (≙ reference dotted method builtins
        # like inputParser.parse / timer.start registered per class)
        if hasattr(base, "_mat_call_method_"):
            r = base._mat_call_method_(self, frame, fname, args, nargout)
            if r is not NotImplemented:
                return r
        from .. import oop
        if isinstance(base, (oop.MatObject, oop.HandleObject)):
            m = base.cls.find_method(self.session, fname)
            if m is not None:
                return oop.call_method(self, frame, m, base, args, nargout)
            m = base.cls.find_static(self.session, fname)
            if m is not None:
                return self.call_user(m, args, nargout)
            v = oop.prop_read(base, fname)
            return [IX.read_paren(v, args) if args else v]
        if isinstance(base, oop.ClassRef):
            m = base.cls.find_static(self.session, fname)
            if m is None:
                raise MatError("MATLAB:class:noStatic",
                               f"Unrecognized static method '{fname}' for "
                               f"class '{base.cls.name}'.")
            return self.call_user(m, args, nargout)
        if isinstance(base, oop.BuiltinClassRef):
            if fname == "empty":
                dims = [int(a.host().reshape(-1)[0]) for a in args]
                return [base.empty(dims)]
            raise MatError("MATLAB:class:noStatic",
                           f"Unrecognized static method '{fname}' for "
                           f"class '{base.name}'.")
        v = self._field_read(base, fname)
        if isinstance(v, FunctionHandle):
            return self.call_value(v, args, nargout, frame)
        if not args:
            return [v]
        return [IX.read_paren(_unwrap1(v), args)]

    def _field_read(self, base, fname: str):
        if hasattr(base, "_mat_get_field_"):
            r = base._mat_get_field_(fname)
            if r is not NotImplemented:
                return r
        if hasattr(base, "_mat_call_method_"):
            # MATLAB: obj.m == obj.m() — dot access invokes zero-arg methods
            r = base._mat_call_method_(self, None, fname, [], 1)
            if r is not NotImplemented:
                return r[0] if r else NOVALUE
        from ..tables import MatTable
        if isinstance(base, MatTable):
            if fname == "Properties":
                from ..values import CellArray
                data = np.empty((1, len(base.varnames)), dtype=object)
                for i, nm in enumerate(base.varnames):
                    data[0, i] = MatArray.char_from_str(nm)
                return StructArray.scalar({
                    "VariableNames": CellArray(data),
                })
            return base.col(fname)
        from .. import oop
        if isinstance(base, (oop.MatObject, oop.HandleObject)):
            if fname in base.props:
                return oop.prop_read(base, fname)
            m = base.cls.find_method(self.session, fname)
            if m is not None:
                # MATLAB: obj.m == obj.m() — dot access invokes the method
                res = oop.call_method(self, None, m, base, [], 1)
                return res[0] if res else NOVALUE
            return oop.prop_read(base, fname)   # raises the right error
        if isinstance(base, oop.ClassRef):
            m = base.cls.find_static(self.session, fname)
            if m is not None:
                res = self.call_user(m, [], 1)
                return res[0] if res else NOVALUE
            raise MatError("MATLAB:class:noStatic",
                           f"Unrecognized static method '{fname}' for class "
                           f"'{base.cls.name}'.")
        if isinstance(base, oop.BuiltinClassRef):
            if fname == "empty":
                return base.empty()
            raise MatError("MATLAB:class:noStatic",
                           f"Unrecognized static method '{fname}' for class "
                           f"'{base.name}'.")
        if isinstance(base, StructArray):
            if fname not in base.fields:
                raise MatError("MATLAB:nonExistentField",
                               f"Unrecognized field name \"{fname}\".")
            if base.is_scalar:
                return base.fields[fname].reshape(-1)[0]
            flat = base.fields[fname].reshape(-1, order="F")
            return OutputList([flat[i] for i in range(flat.size)])
        raise MatError("MATLAB:structRefFromNonStruct",
                       f"Field reference for non-structure value (class {type(base).__name__}).")

    def _build(self, stack: list, counts: tuple, builder):
        total = sum(counts)
        elems = stack[-total:] if total else []
        if total:
            del stack[-total:]
        rows = []
        i = 0
        for cnt in counts:
            row = []
            for e in elems[i:i + cnt]:
                if isinstance(e, OutputList):
                    row.extend(e.items)
                elif e is NOVALUE:
                    raise MatError("MATLAB:emptyOutput", "Expression produced no value.")
                else:
                    row.append(e)
            rows.append(row)
            i += cnt
        rows = [r for r in rows if r]  # fully-expanded-empty rows vanish
        return builder(rows)

    def _store_index(self, stack: list, frame: Frame, name: str, nargs: int,
                     kind: str, display: bool) -> None:
        args = _collect_args(stack, nargs)
        rhs = _unwrap1(stack.pop())
        base = self._load_name(frame, name)
        if base is NOVALUE:
            base = CellArray.empty() if kind == "brace" else MatArray.empty()
        if kind == "brace":
            newv = IX.write_brace(base, args, rhs)
        else:
            in_place = isinstance(base, MatArray) and not base.shared
            newv = IX.write_paren(base, args, rhs, in_place=in_place)
        self._store_name(frame, name, newv)
        if display:
            self._display(name, newv)

    def _store_path(self, stack: list, frame: Frame, name: str, desc: tuple,
                    total_args: int, display: bool) -> None:
        from ..values import text_of
        args_flat = stack[-total_args:] if total_args else []
        if total_args:
            del stack[-total_args:]
        rhs = _unwrap1(stack.pop())
        # split args per step
        step_args = []
        i = 0
        for step in desc:
            if step[0] in ("paren", "brace"):
                raw = args_flat[i:i + step[1]]
                flat = []
                for x in raw:
                    if isinstance(x, OutputList):
                        flat.extend(x.items)
                    else:
                        flat.append(x)
                step_args.append(flat)
                i += step[1]
            elif step[0] == "dynfield":
                step_args.append(text_of(_unwrap1(args_flat[i])))
                i += 1
            else:
                step_args.append(step[1])
        base = self._load_name(frame, name)
        if base is NOVALUE:
            base = None
        newv = self._path_write(base, list(zip(desc, step_args)), rhs)
        self._store_name(frame, name, newv)
        if display:
            self._display(name, newv)

    def _path_write(self, cur, steps: list, rhs):
        """Recursive read-modify-write along an lvalue path."""
        if not steps:
            return rhs
        (kind, _), sarg = steps[0]
        rest = steps[1:]
        if kind == "field" or kind == "dynfield":
            fname = sarg
            if hasattr(cur, "_mat_set_field_") and not rest:
                r = cur._mat_set_field_(fname, rhs)
                if r is not NotImplemented:
                    return cur
            from ..tables import MatTable
            if isinstance(cur, MatTable):
                if fname == "Properties" and rest and rest[0][0][0] in (
                        "field", "dynfield"):
                    # T.Properties.VariableNames/RowNames = ... (≙ the
                    # reference's table.subsasgn metadata surface)
                    return _table_set_property(cur, rest[0][1], rhs)
                if rest:
                    old = cur.col(fname)
                    return cur.set_col(fname, self._path_write(old, rest, rhs))
                return cur.set_col(fname, rhs)
            from .. import oop
            if isinstance(cur, (oop.MatObject, oop.HandleObject)):
                if rest:
                    old = oop.prop_read(cur, fname)
                    newf = self._path_write(old, rest, rhs)
                    return oop.prop_write(cur, fname, newf)
                return oop.prop_write(cur, fname, rhs)
            if cur is None or (isinstance(cur, MatArray) and cur.size == 0):
                cur = StructArray.scalar()
            if not isinstance(cur, StructArray):
                raise MatError("MATLAB:structAssToNonStruct",
                               "Field assignment to a non-structure value.")
            if cur.size != 1:
                raise MatError("MATLAB:multipleStructAssign",
                               "Scalar struct required for this assignment.")
            cur = cur.copy()
            old = cur.fields.get(fname)
            old_v = old.reshape(-1)[0] if old is not None and old.size else None
            newf = self._path_write(old_v, rest, rhs)
            cur.set_scalar_field(fname, newf)
            return cur
        if kind == "paren":
            if rest:
                # read-modify-write of the indexed element
                if cur is None:
                    cur = StructArray({}, (0, 0)) if rest and rest[0][0][0] in ("field", "dynfield") \
                        else MatArray.empty()
                try:
                    old_item = IX.read_paren(cur, sarg)
                except MatError:
                    old_item = None
                new_item = self._path_write(old_item, rest, rhs)
                return IX.write_paren(cur, sarg, new_item)
            base = cur if cur is not None else MatArray.empty()
            return IX.write_paren(base, sarg, rhs)
        # brace
        if rest:
            if cur is None:
                cur = CellArray.empty()
            try:
                old_ol = IX.read_brace(cur, sarg)
                old_item = old_ol.items[0] if old_ol.items else None
            except MatError:
                old_item = None
            new_item = self._path_write(old_item, rest, rhs)
            return IX.write_brace(cur, sarg, new_item)
        base = cur if cur is not None else CellArray.empty()
        return IX.write_brace(base, sarg, rhs)

    def _split(self, stack: list, n: int) -> None:
        v = stack.pop()
        if isinstance(v, OutputList):
            vals = v.items
        elif isinstance(v, list):
            vals = v
        else:
            vals = [v]
        if len(vals) < n:
            raise MatError("MATLAB:needMoreRhsOutputs",
                           "Not enough output arguments / elements to satisfy "
                           "the assignment targets.")
        for i in range(n):
            stack.append(vals[i])

    def _display(self, name: str, v) -> None:
        self.session.display_value(name, v)


# --------------------------------------------------------------------------- #
# module helpers
# --------------------------------------------------------------------------- #

def _unwrap1(v, what: str = ""):
    if isinstance(v, OutputList):
        if len(v.items) == 1:
            return v.items[0]
        if not v.items:
            raise MatError("MATLAB:emptyOutput",
                           "Indexing produced no value where one was required.")
        raise MatError("MATLAB:multipleOutputs",
                       "Expected one output; a comma-list produced "
                       f"{len(v.items)} values.")
    if v is NOVALUE:
        raise MatError("MATLAB:emptyOutput",
                       "Expression produced no value where one was required.")
    return v


def _collect_args(stack: list, nargs: int) -> list:
    if nargs == 0:
        return []
    raw = stack[-nargs:]
    del stack[-nargs:]
    args = []
    for x in raw:
        if isinstance(x, OutputList):
            args.extend(x.items)
        elif x is NOVALUE:
            raise MatError("MATLAB:emptyOutput", "Argument produced no value.")
        else:
            args.append(x)
    return args


def _push_results(stack: list, res: list, nargout: int) -> None:
    if nargout > 1:
        if len(res) < nargout:
            raise MatError("MATLAB:maxlhs", "Too many output arguments.")
        stack.append(res[:nargout])
    else:
        stack.append(res[0] if res else NOVALUE)


def _switch_match(sw, case) -> bool:
    """MATLAB switch semantics: scalar/string equality; a cell case matches if
    any element matches."""
    from ..runtime.builtins.control import _isequal_impl
    if isinstance(case, CellArray):
        return any(_switch_match(sw, e) for e in case.data.reshape(-1))
    if isinstance(sw, MatArray) and sw.mclass == "char":
        from ..values import is_text
        if is_text(case) or isinstance(case, StringArray):
            from ..values import text_of
            return text_of(sw) == text_of(case)
        return False
    if isinstance(case, MatArray) and case.mclass == "char" and isinstance(sw, StringArray):
        return sw.is_scalar and sw.item() == case.to_str()
    return _isequal_impl(sw, case, False)


def _truthy(v) -> bool:
    v = _unwrap1(v)
    if isinstance(v, MatArray):
        return v.is_true()
    if isinstance(v, (CellArray, StructArray, StringArray)):
        raise MatError("MATLAB:invalidConversion",
                       f"Conversion to logical from {type(v).__name__} is not possible.")
    return bool(v)


def _truthy_scalar(v) -> bool:
    if isinstance(v, MatArray):
        if v.size != 1:
            raise MatError("MATLAB:invalidLogicalOperand",
                           "Operands to || and && must be convertible to logical scalar values.")
        return v.is_true()
    raise MatError("MATLAB:invalidLogicalOperand",
                   "Operands to || and && must be convertible to logical scalar values.")


def _make_range(start, step, stop) -> MatArray:
    if type(start).__name__ == "MatDatetime" or \
            type(stop).__name__ == "MatDatetime":
        return _make_datetime_range(start, step, stop)
    s = start.scalar_double() if isinstance(start, MatArray) else float(start)
    e = stop.scalar_double() if isinstance(stop, MatArray) else float(stop)
    d = 1.0 if step is None else (step.scalar_double() if isinstance(step, MatArray) else float(step))
    out_class = "double"
    for v in (start, step, stop):
        if isinstance(v, MatArray) and v.mclass == "single":
            out_class = "single"
    # doc colon: an integer-class endpoint makes the whole range that class
    from .. import dtypes as _dt
    for v in (start, step, stop):
        if isinstance(v, MatArray) and _dt.is_integer_class(v.mclass):
            out_class = v.mclass
            break
    if d == 0 or (d > 0 and s > e) or (d < 0 and s < e):
        return MatArray(np.zeros((1, 0), dtype=np.float64), "double")
    n = int(np.floor((e - s) / d + 1e-10)) + 1
    vals = s + d * np.arange(n, dtype=np.float64)
    # clamp the endpoint against accumulation error
    if n > 1 and abs(vals[-1] - e) < abs(d) * 1e-10:
        vals[-1] = e
    arr = vals.reshape(1, -1)
    if out_class == "single":
        arr = arr.astype(np.float32)
    elif out_class != "double":
        from .. import dtypes as _dt
        arr = _dt.cast_to_class(arr, out_class)
    return MatArray(arr, out_class)


def _table_set_property(tbl, prop: str, rhs):
    from ..values import CellArray, text_of as _tof
    from ..tables import MatTable
    def _names(v):
        if isinstance(v, CellArray):
            return [_tof(x) for x in v.data.reshape(-1, order="F")]
        from ..values import StringArray
        if isinstance(v, StringArray):
            return [str(x) for x in v.data.reshape(-1, order="F")]
        raise MatError("MATLAB:table:InvalidPropertyValue",
                       f"Invalid value for table property '{prop}'.")
    if prop == "VariableNames":
        names = _names(rhs)
        if len(names) != len(tbl.varnames):
            raise MatError("MATLAB:table:IncorrectNumberOfVarNames",
                           "The VariableNames property must contain one "
                           "name for each variable in the table.")
        return MatTable(names, list(tbl.cols), tbl.rownames)
    if prop == "RowNames":
        return MatTable(list(tbl.varnames), list(tbl.cols), _names(rhs))
    raise MatError("MATLAB:table:UnknownProperty",
                   f"Unrecognized table property '{prop}'.")


def _make_datetime_range(start, step, stop):
    """t1:t2 / t1:dur:t2 / t1:caldur:t2 — MATLAB datetime colon; the
    default step is one calendar day."""
    from ..runtime.builtins.datetime_builtins import MatDatetime, MatDuration
    if not (isinstance(start, MatDatetime) and isinstance(stop, MatDatetime)
            and start.data.size == 1 and stop.data.size == 1):
        raise MatError("MATLAB:datetime:colon",
                       "Colon endpoints must be scalar datetime values.")
    s = start.data.reshape(-1)[0].astype("datetime64[us]")
    e = stop.data.reshape(-1)[0].astype("datetime64[us]")
    if isinstance(step, MatDuration):
        d = step.data.reshape(-1)[0].astype("timedelta64[us]")
    elif step is None:
        d = np.timedelta64(86_400_000_000, "us")        # one day
    elif isinstance(step, MatArray) and not step.is_complex:
        # numeric step counts days (serial-datenum convention)
        d = np.timedelta64(
            int(round(step.scalar_double() * 86_400_000_000)), "us")
    else:
        from ..runtime.builtins.datetime2 import is_caldur
        if is_caldur(step):
            # calendar-duration stepping: repeated caldur_add
            from ..runtime.builtins.datetime2 import caldur_add
            out, cur, k = [], MatDatetime(start.data.copy()), 0
            while cur.data.reshape(-1)[0].astype("datetime64[us]") <= e:
                out.append(cur.data.reshape(-1)[0])
                k += 1
                cur = caldur_add(MatDatetime(start.data.copy()),
                                 _scale_caldur(step, k), 1.0)
                if k > 1_000_000:
                    raise MatError("MATLAB:pmaxsize",
                                   "Requested range is too large.")
            return MatDatetime(np.array(out,
                                        dtype="datetime64[us]").reshape(1, -1))
        raise MatError("MATLAB:datetime:colon",
                       "Colon step must be a duration, calendarDuration, "
                       "or numeric day count.")
    dz = d.astype(np.int64)
    sz, ez = s.astype(np.int64), e.astype(np.int64)
    if dz == 0 or (dz > 0 and sz > ez) or (dz < 0 and sz < ez):
        return MatDatetime(np.empty((1, 0), dtype="datetime64[us]"))
    n = (ez - sz) // dz + 1
    vals = sz + dz * np.arange(n, dtype=np.int64)
    return MatDatetime(vals.astype("datetime64[us]").reshape(1, -1))


def _scale_caldur(cd, k: int):
    from ..values import MatArray as _MA, StructArray as _SA
    months = cd.get_scalar_field("months").host() * k
    days = cd.get_scalar_field("days").host() * k
    return _SA.scalar({
        "_calendarDuration": _MA.logical_scalar(True),
        "months": _MA(months, "double"),
        "days": _MA(days, "double"),
    })


def _end_value(base, dim: int, nargs: int) -> MatArray:
    if base is None:
        raise MatError("MATLAB:badsubscript", "'end' could not be resolved.")
    shape = base.shape if hasattr(base, "shape") else (1, 1)
    shape = tuple(shape)
    if nargs == 1:
        n = 1
        for d in shape:
            n *= d
        return MatArray.scalar(float(n))
    from .indexing import _folded_shape
    fs = _folded_shape(shape, nargs)
    return MatArray.scalar(float(fs[dim]) if dim < len(fs) else 1.0)


class _RangeIter:
    __slots__ = ("vals", "i", "n")

    def __init__(self, vals: np.ndarray):
        self.vals = vals
        self.i = 0
        self.n = vals.shape[1] if vals.ndim == 2 else len(vals)

    def next(self):
        if self.i >= self.n:
            return None
        v = self.vals[:, self.i:self.i + 1]
        self.i += 1
        if v.size == 1:
            return MatArray(v.reshape(1, 1), "double" if v.dtype == np.float64 else
                            ("single" if v.dtype == np.float32 else "double"))
        return MatArray(v.copy(), "double")


class _ColsIter:
    """for x = M iterates columns (ND arrays fold trailing dims)."""

    __slots__ = ("m", "i", "n", "wrap")

    def __init__(self, m, wrap):
        self.m = m
        self.i = 0
        self.n = m.shape[1] if m.ndim >= 2 else 0
        self.wrap = wrap

    def next(self):
        if self.i >= self.n:
            return None
        col = self.m[:, self.i]
        self.i += 1
        return self.wrap(col.reshape(-1, 1).copy())


def _make_iter(v):
    if isinstance(v, MatArray):
        h = v.host()
        if h.ndim > 2:
            h = h.reshape(h.shape[0], -1, order="F")
        cls = v.mclass
        return _ColsIter(h, lambda d: MatArray(d, cls))
    if isinstance(v, CellArray):
        return _ColsIter(v.data, lambda d: CellArray(d))
    if isinstance(v, StringArray):
        return _ColsIter(v.data, lambda d: StringArray(d))
    if isinstance(v, StructArray):
        raise MatError("MATLAB:forLoop", "FOR loop over struct arrays is not supported.")
    raise MatError("MATLAB:forLoop", "Invalid FOR loop range.")
