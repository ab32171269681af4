"""Copy of runmat_tpu/vm/bytecode.py in the PyTorch port.

Bytecode ISA and compiled units.

Reference parity: runmat-vm/src/bytecode/{instr,program,compile}.rs — the
~120-variant Instr ISA compiled from HIR+MIR. This ISA is deliberately smaller:
MATLAB's call-or-index ambiguity is resolved at *runtime* against the frame
(instruction RESOLVE_CALL), matching MATLAB's own dynamic-workspace semantics
(and the reference's eval/assignin gates, runmat-hir/src/lib.rs:36-41), instead
of a static variable-slot layout.

Instructions are tuples (OP, a, b, c); the interpreter dispatches on OP ints.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# ---- opcodes ---------------------------------------------------------------- #
(
    CONST,          # (CONST, const_idx)           push constant value (copied if mutable)
    LOAD,           # (LOAD, name)                 var load / 0-arg call / error
    STORE,          # (STORE, name, display)       pop -> var
    RESOLVE_CALL,   # (RESOLVE_CALL, name, nargs, nargout) var-index or call; flattens OutputLists
    DYNCALL,        # (DYNCALL, nargs, nargout)    callee under args on stack
    BINOP,          # (BINOP, opname)              pop b,a -> push
    UNOP,           # (UNOP, opname)
    MTIMES, MLDIV, MRDIV, MPOW,  # matrix binary ops
    TRANSPOSE,      # (TRANSPOSE, conj: bool)
    RANGE,          # (RANGE, has_step)            pop stop[,step],start -> vector
    COLON_VAL,      # push bare-colon marker
    INDEX,          # (INDEX, nargs, kind)         pop args..., base -> read (kind 'paren'|'brace')
    FIELD,          # (FIELD, name|None)           pop [dyn-name,] base -> field value
    PUSH_IXCTX,     # (PUSH_IXCTX,)                peek base -> index ctx stack
    PUSH_IXCTX_VAR, # (PUSH_IXCTX_VAR, name)       var -> index ctx stack (for lvalue writes)
    POP_IXCTX,      #
    END_VAL,        # (END_VAL, dim, nargs)        push size of ctx array along dim
    BUILD_MAT,      # (BUILD_MAT, row_counts)      pop elements row-major -> matrix
    BUILD_CELL,     # (BUILD_CELL, row_counts)
    JMP,            # (JMP, target)
    JMP_IF_FALSE,   # (JMP_IF_FALSE, target)       pop, MATLAB truthiness
    JMP_IF_TRUE,    # (JMP_IF_TRUE, target)
    DUP, POP,       #
    STORE_INDEX,    # (STORE_INDEX, name, nargs, kind, display) stack: rhs, args... ; write var
    STORE_PATH,     # (STORE_PATH, name, path_desc, total_args, display) chained lvalue write
    SPLIT,          # (SPLIT, n)                   pop call-result list -> push n values (v1 deepest)
    FOR_INIT,       # (FOR_INIT,)                  pop iterable -> push iterator
    FOR_NEXT,       # (FOR_NEXT, var, end_target)  advance top iterator; bind var or jump
    FOR_POP,        # discard iterator
    MAKE_ANON,      # (MAKE_ANON, const_idx(AnonDef))
    MAKE_HANDLE,    # (MAKE_HANDLE, name)
    GLOBAL_DECL,    # (GLOBAL_DECL, names)
    PERSIST_DECL,   # (PERSIST_DECL, names, fn_key)
    TRY_PUSH,       # (TRY_PUSH, catch_target, catch_var)
    TRY_POP,        #
    RET,            # end of unit
    ANS_STMT,       # (ANS_STMT, display)          pop expression-statement result (maybe None)
    DISPLAY_VAR,    # (DISPLAY_VAR, name)          echo variable
    SWITCH_MATCH,   # (SWITCH_MATCH,)              pop case_val, switch_val -> push bool (isequal / member)
    CHECK_INTERRUPT,
    BOOL_SCALAR,    # pop value -> logical scalar (&&/|| operand check)
    CALL_METHOD,    # (CALL_METHOD, fname, nargs, nargout) pop args..., base ->
                    # method dispatch on objects/ClassRef; falls back to
                    # field-read + paren-index for structs/handles
    LOADC,          # (LOADC, name) var load, else ClassRef, else 0-arg call
    WHILE_INFO,     # (WHILE_INFO, jf_pc, end_pc) no-op marker at a while-loop
                    # top; the interpreter may attempt a device while here
) = range(48)

OPNAMES = {v: k for k, v in list(globals().items()) if isinstance(v, int)}


@dataclass
class AnonDef:
    params: list
    free_names: list          # captured at MAKE_ANON time
    code: "Code"
    src: str = ""             # unparsed source (func2str)


@dataclass
class Code:
    """A compiled unit: function body, script, or anonymous-function body."""
    instrs: list = field(default_factory=list)
    consts: list = field(default_factory=list)
    name: str = "<script>"
    params: list = field(default_factory=list)
    outs: list = field(default_factory=list)
    has_varargin: bool = False
    has_varargout: bool = False
    lines: list = field(default_factory=list)   # per-instr source line (for stacks)
    is_script: bool = True
    nested: dict = field(default_factory=dict)   # name -> Code (nested functions)
    arg_specs: list = field(default_factory=list)
    # per-loop-site device-gate state (≙ static pre-qualification from the
    # MIR fact pass, runmat-mir/src/analysis/facts.rs): for_next_pc ->
    # "never" (statically ineligible / gave up) or dynamic bail count
    loop_hints: dict = field(default_factory=dict)
    # compile-time fact stamps per loop window: for_next_pc ->
    # {"never": reason | None, "classes": {name: cls}} — from the fact
    # lattice (facts.loop_class_facts); "never" skips the gate's trial
    # trace entirely
    loop_facts: dict = field(default_factory=dict)
    # pc -> tuple of source identifier names per call argument (None for
    # non-identifier args): powers MATLAB inputname() and table()'s
    # variable-name capture
    call_arg_names: dict = field(default_factory=dict)
    # source-unit identity: the execution-unit name/path this Code was
    # compiled from and the names of every function defined in the same
    # unit — powers mfilename() / localfunctions() (≙ the reference's
    # source_context + SourceFunctionInfo catalog,
    # runmat-runtime/src/builtins/introspection/{mfilename,localfunctions}.rs)
    source_path: str = ""
    unit_functions: list = field(default_factory=list)
    # arguments-block entries: (name, field|None, dims|None, cls|None,
    #                           validators, default_code|None)

    def emit(self, op: int, a=None, b=None, c=None, d=None, line: int = 0) -> int:
        self.instrs.append((op, a, b, c, d))
        self.lines.append(line)
        return len(self.instrs) - 1

    def patch(self, idx: int, **kw) -> None:
        op, a, b, c, d = self.instrs[idx]
        a = kw.get("a", a)
        b = kw.get("b", b)
        self.instrs[idx] = (op, a, b, c, d)

    def const(self, v) -> int:
        self.consts.append(v)
        return len(self.consts) - 1

    def here(self) -> int:
        return len(self.instrs)


@dataclass
class CompiledProgram:
    main: Code
    functions: dict            # name -> Code (local functions)
    classes: dict = field(default_factory=dict)
