"""Copy of runmat_tpu/vm/compiler.py in the PyTorch port.

AST -> bytecode compiler.

Reference parity: runmat-vm/src/bytecode/compile.rs:18 + compiler/core.rs (MIR
statements -> Instr). Differences: name resolution is deferred to runtime
(RESOLVE_CALL) to match MATLAB dynamic-workspace semantics; fusion-graph
construction (≙ vm/src/accel/graph.rs) happens lazily in the accel engine
instead of at compile time — the engine traces op DAGs from the live values.
"""

from __future__ import annotations

import numpy as np

from ..errors import MatError
from ..frontend import ast as A
from ..values import MatArray
from . import bytecode as B

_BINOP_MAP = {
    "+": "add", "-": "sub", ".*": "mul", "./": "div", ".\\": "ldiv",
    ".^": "pow", "==": "eq", "~=": "ne", "<": "lt", "<=": "le", ">": "gt",
    ">=": "ge", "&": "and", "|": "or",
}
_MATRIX_OPS = {"*": B.MTIMES, "\\": B.MLDIV, "/": B.MRDIV, "^": B.MPOW}
_UNOP_MAP = {"-": "neg", "+": "uplus", "~": "logical_not"}


def _contains_end(node) -> bool:
    if isinstance(node, A.EndRef):
        return True
    if isinstance(node, A.Index):
        # 'end' inside a nested index resolves against that nested base
        return False
    if isinstance(node, A.BinOp):
        return _contains_end(node.left) or _contains_end(node.right)
    if isinstance(node, A.UnOp) or isinstance(node, A.PostOp):
        return _contains_end(node.operand)
    if isinstance(node, A.Range):
        return _contains_end(node.start) or (node.step is not None and _contains_end(node.step)) \
            or _contains_end(node.stop)
    if isinstance(node, A.FieldAccess):
        return _contains_end(node.base)
    return False


def _contains_end_shallow(node) -> bool:
    return _contains_end(node)


def _free_idents(node, acc: set) -> None:
    """All identifier names appearing in an expression (for anon captures)."""
    if isinstance(node, A.Ident):
        acc.add(node.name)
    elif isinstance(node, A.BinOp):
        _free_idents(node.left, acc)
        _free_idents(node.right, acc)
    elif isinstance(node, (A.UnOp, A.PostOp)):
        _free_idents(node.operand, acc)
    elif isinstance(node, A.Range):
        _free_idents(node.start, acc)
        if node.step is not None:
            _free_idents(node.step, acc)
        _free_idents(node.stop, acc)
    elif isinstance(node, A.Index):
        _free_idents(node.base, acc)
        for a in node.args:
            _free_idents(a, acc)
    elif isinstance(node, A.FieldAccess):
        _free_idents(node.base, acc)
        if node.dynamic is not None:
            _free_idents(node.dynamic, acc)
    elif isinstance(node, (A.MatrixLit, A.CellLit)):
        for r in node.rows:
            for e in r:
                _free_idents(e, acc)
    elif isinstance(node, A.AnonFunc):
        inner: set = set()
        _free_idents(node.body, inner)
        acc |= (inner - set(node.params))


class Compiler:
    def __init__(self, name: str = "<script>", is_script: bool = True):
        self.code = B.Code(name=name, is_script=is_script)
        self.loop_stack: list[tuple[str, list, list]] = []  # (kind, break_patches, continue_targets)
        self.end_ctx_depth = 0
        self._tmp = 0
        self._loop_facts: dict = {}   # id(For stmt) -> fact record

    # ------------------------------------------------------------------ public

    @staticmethod
    def compile_program(prog: A.Program, name: str = "<script>") -> B.CompiledProgram:
        c = Compiler(name, is_script=True)
        c._stamp_loop_facts(prog.body)
        for st in prog.body:
            c.stmt(st)
        c.code.emit(B.RET)
        functions = {fname: Compiler.compile_function(fd) for fname, fd in prog.functions.items()}
        unit_fns = list(functions.keys())
        for code in (c.code, *functions.values()):
            code.source_path = name
            code.unit_functions = unit_fns
        return B.CompiledProgram(c.code, functions, dict(prog.classes))

    def _stamp_loop_facts(self, stmts: list) -> None:
        """Run the compile-time fact lattice so `_for` can stamp each loop
        window with class facts (device-gate pre-qualification,
        ≙ runmat-mir/src/analysis/facts.rs)."""
        try:
            from ..facts import loop_class_facts
            self._loop_facts = loop_class_facts(stmts)
        except Exception:
            self._loop_facts = {}

    @staticmethod
    def compile_function(fd: A.FunctionDef) -> B.Code:
        c = Compiler(fd.name, is_script=False)
        code = c.code
        code.params = [p for p in fd.params]
        code.outs = [o for o in fd.outs]
        code.has_varargin = bool(code.params) and code.params[-1] == "varargin"
        code.has_varargout = bool(code.outs) and code.outs[-1] == "varargout"
        c._stamp_loop_facts(fd.body)
        for st in fd.body:
            c.stmt(st)
        code.emit(B.RET, line=fd.line)
        for nf in fd.nested:
            code.nested[nf.name] = Compiler.compile_function(nf)
        for sp in getattr(fd, "arg_specs", []) or []:
            code.arg_specs.append((
                sp.name, sp.field_name, sp.dims, sp.cls, sp.validators,
                Compiler.compile_expr(sp.default) if sp.default is not None
                else None))
        return code

    @staticmethod
    def compile_expr(e) -> B.Code:
        """Compile a bare expression (e.g. a classdef property default) into a
        Code unit that leaves its value on the stack."""
        c = Compiler("@expr", is_script=False)
        c.expr(e)
        return c.code

    def compile_anon(self, e: A.AnonFunc) -> B.AnonDef:
        c = Compiler("@anon", is_script=False)
        c.code.params = list(e.params)
        c.expr(e.body)
        # multi-output tail call: @(x) deal(x, 2*x) must propagate the
        # caller's nargout — mark the tail call with the -1 sentinel, which
        # the interpreter resolves to the frame's nargout at run time
        if c.code.instrs:
            op, a, b2, c2, d2 = c.code.instrs[-1]
            if op == B.RESOLVE_CALL and c2 == 1:
                c.code.instrs[-1] = (op, a, b2, -1, d2)
            elif op == B.DYNCALL and b2 == 1:
                c.code.instrs[-1] = (op, a, -1, c2, d2)
        c.code.emit(B.RET)
        free: set = set()
        _free_idents(e.body, free)
        free -= set(e.params)
        return B.AnonDef(list(e.params), sorted(free), c.code, A.unparse(e))

    # -------------------------------------------------------------- statements

    def stmt(self, s) -> None:
        line = getattr(s, "line", 0)
        if isinstance(s, A.ExprStmt):
            self._expr_stmt(s, line)
        elif isinstance(s, A.Assign):
            self._assign(s.lhs, s.rhs, s.display, line)
        elif isinstance(s, A.MultiAssign):
            self._multi_assign(s, line)
        elif isinstance(s, A.If):
            self._if(s, line)
        elif isinstance(s, A.While):
            self._while(s, line)
        elif isinstance(s, A.For):
            self._for(s, line)
        elif isinstance(s, A.Switch):
            self._switch(s, line)
        elif isinstance(s, A.TryCatch):
            self._try(s, line)
        elif isinstance(s, A.Break):
            if not self.loop_stack:
                raise MatError("MATLAB:BREAK", "BREAK statement outside of a loop.")
            idx = self.code.emit(B.JMP, None, line=line)
            self.loop_stack[-1][1].append(idx)
        elif isinstance(s, A.Continue):
            if not self.loop_stack:
                raise MatError("MATLAB:CONTINUE", "CONTINUE statement outside of a loop.")
            idx = self.code.emit(B.JMP, None, line=line)
            self.loop_stack[-1][2].append(idx)
        elif isinstance(s, A.Return):
            self.code.emit(B.RET, line=line)
        elif isinstance(s, A.Import):
            # lower to the functional form: import('pkg.fn', ...)
            for p in s.paths:
                self.code.emit(B.CONST, self.code.const(_char_const(p)),
                               line=line)
            self.code.emit(B.RESOLVE_CALL, "import", len(s.paths), 0, 0,
                           line=line)
            self.code.emit(B.ANS_STMT, False, line=line)
        elif isinstance(s, A.Global):
            self.code.emit(B.GLOBAL_DECL, tuple(s.names), line=line)
        elif isinstance(s, A.Persistent):
            self.code.emit(B.PERSIST_DECL, tuple(s.names), self.code.name, line=line)
        elif isinstance(s, A.Command):
            for a in s.args:
                self.code.emit(B.CONST, self.code.const(_char_const(a)), line=line)
            self.code.emit(B.RESOLVE_CALL, s.name, len(s.args), 0, 1, line=line)  # force-call
            self.code.emit(B.ANS_STMT, False, None, line=line)
        elif isinstance(s, A.FunctionDef):
            raise MatError("MATLAB:parser:nestedFunction", "Unexpected function definition.")
        else:
            raise MatError("MATLAB:internal", f"Unknown statement {type(s).__name__}.")

    def _expr_stmt(self, s: A.ExprStmt, line: int) -> None:
        e = s.expr
        if isinstance(e, A.Ident):
            # var -> display under its own name; else 0-arg call -> ans
            self.code.emit(B.RESOLVE_CALL, e.name, 0, 0, 0, line=line)
            self.code.emit(B.ANS_STMT, s.display, e.name, line=line)
            return
        if isinstance(e, A.Index) and isinstance(e.base, A.Ident) and e.kind == "paren":
            self._compile_callable_use(e, nargout=0, line=line)
            self.code.emit(B.ANS_STMT, s.display, None, line=line)
            return
        self.expr(e)
        self.code.emit(B.ANS_STMT, s.display, None, line=line)

    def _assign(self, lhs, rhs, display: bool, line: int) -> None:
        if isinstance(lhs, A.Ident):
            self.expr(rhs)
            self.code.emit(B.STORE, lhs.name, display, line=line)
            return
        root, path = self._lvalue_path(lhs)
        self.expr(rhs)
        if len(path) == 1 and path[0][0] in ("paren", "brace"):
            kind, args = path[0][0], path[0][2]
            has_end = any(_contains_end(a) for a in args if not isinstance(a, A.Colon))
            if has_end:
                self.code.emit(B.PUSH_IXCTX_VAR, root, line=line)
            for k, a in enumerate(args):
                self._index_arg(a, k, len(args))
            self.code.emit(B.STORE_INDEX, root, len(args), kind, display, line=line)
            if has_end:
                self.code.emit(B.POP_IXCTX, line=line)
            return
        # general chained path: s.a(2).b = rhs
        total_args = 0
        desc = []
        for step in path:
            if step[0] in ("paren", "brace"):
                args = step[2]
                for k, a in enumerate(args):
                    self._index_arg(a, k, len(args))  # note: 'end' unsupported in deep paths for now
                desc.append((step[0], len(args)))
                total_args += len(args)
            elif step[0] == "field":
                desc.append(("field", step[1]))
            else:  # dynamic field
                self.expr(step[2])
                desc.append(("dynfield", None))
                total_args += 1
        self.code.emit(B.STORE_PATH, root, tuple(desc), total_args, display, line=line)

    def _lvalue_path(self, lhs):
        """Decompose an lvalue into (root_var, [steps]) left-to-right."""
        steps = []
        node = lhs
        while True:
            if isinstance(node, A.Ident):
                root = node.name
                break
            if isinstance(node, A.Index):
                steps.append((node.kind, None, node.args))
                node = node.base
            elif isinstance(node, A.FieldAccess):
                if node.dynamic is not None:
                    steps.append(("dynfield", None, node.dynamic))
                else:
                    steps.append(("field", node.name, None))
                node = node.base
            else:
                raise MatError("MATLAB:parser:lvalue", "Invalid assignment target.")
        steps.reverse()
        return root, steps

    def _multi_assign(self, s: A.MultiAssign, line: int) -> None:
        n = len(s.lhs)
        rhs = s.rhs
        if isinstance(rhs, A.Index) and isinstance(rhs.base, A.Ident) and rhs.kind == "paren":
            self._compile_callable_use(rhs, nargout=n, line=line)
        elif isinstance(rhs, A.Index) and rhs.kind == "brace":
            # [a,b] = c{:}
            self.expr(rhs)
        elif isinstance(rhs, A.Ident):
            self.code.emit(B.RESOLVE_CALL, rhs.name, 0, n, 0, line=line)
        else:
            self.expr(rhs)
        self.code.emit(B.SPLIT, n, line=line)
        # values pushed v1..vn (vn on top): store in reverse
        for target in reversed(s.lhs):
            if target is None:
                self.code.emit(B.POP, line=line)
            elif isinstance(target, A.Ident):
                self.code.emit(B.STORE, target.name, s.display, line=line)
            else:
                self._assign_from_stack(target, s.display, line)

    def _assign_from_stack(self, lhs, display: bool, line: int) -> None:
        """Store stack top into a non-trivial lvalue (rhs already on stack)."""
        root, path = self._lvalue_path(lhs)
        if len(path) == 1 and path[0][0] in ("paren", "brace"):
            kind, args = path[0][0], path[0][2]
            has_end = any(_contains_end(a) for a in args if not isinstance(a, A.Colon))
            if has_end:
                self.code.emit(B.PUSH_IXCTX_VAR, root, line=line)
            for k, a in enumerate(args):
                self._index_arg(a, k, len(args))
            self.code.emit(B.STORE_INDEX, root, len(args), kind, display, line=line)
            if has_end:
                self.code.emit(B.POP_IXCTX, line=line)
            return
        total_args = 0
        desc = []
        for step in path:
            if step[0] in ("paren", "brace"):
                args = step[2]
                for k, a in enumerate(args):
                    self._index_arg(a, k, len(args))
                desc.append((step[0], len(args)))
                total_args += len(args)
            elif step[0] == "field":
                desc.append(("field", step[1]))
            else:
                self.expr(step[2])
                desc.append(("dynfield", None))
                total_args += 1
        self.code.emit(B.STORE_PATH, root, tuple(desc), total_args, display, line=line)

    def _if(self, s: A.If, line: int) -> None:
        end_jumps = []
        for cond, body in s.branches:
            self.expr(cond)
            jf = self.code.emit(B.JMP_IF_FALSE, None, line=line)
            for st in body:
                self.stmt(st)
            end_jumps.append(self.code.emit(B.JMP, None, line=line))
            self.code.patch(jf, a=self.code.here())
        if s.else_body:
            for st in s.else_body:
                self.stmt(st)
        end = self.code.here()
        for j in end_jumps:
            self.code.patch(j, a=end)

    def _while(self, s: A.While, line: int) -> None:
        marker = self.code.emit(B.WHILE_INFO, None, None, line=line)
        top = self.code.here()
        self.expr(s.cond)
        jf = self.code.emit(B.JMP_IF_FALSE, None, line=line)
        self.loop_stack.append(("while", [], []))
        for st in s.body:
            self.stmt(st)
        _, breaks, conts = self.loop_stack.pop()
        for c in conts:
            self.code.patch(c, a=self.code.here())
        self.code.emit(B.CHECK_INTERRUPT, line=line)
        self.code.emit(B.JMP, top, line=line)
        end = self.code.here()
        self.code.patch(jf, a=end)
        self.code.patch(marker, a=jf, b=end)
        for bidx in breaks:
            self.code.patch(bidx, a=end)

    def _for(self, s: A.For, line: int) -> None:
        self.expr(s.expr)
        self.code.emit(B.FOR_INIT, line=line)
        next_pc = self.code.here()
        fact = self._loop_facts.get(id(s))
        if fact is not None:
            self.code.loop_facts[next_pc] = fact
        fn = self.code.emit(B.FOR_NEXT, s.var, None, line=line)
        self.loop_stack.append(("for", [], []))
        for st in s.body:
            self.stmt(st)
        _, breaks, conts = self.loop_stack.pop()
        for c in conts:
            self.code.patch(c, a=self.code.here())
        self.code.emit(B.CHECK_INTERRUPT, line=line)
        self.code.emit(B.JMP, next_pc, line=line)
        done = self.code.here()
        self.code.patch(fn, b=done)
        for bidx in breaks:
            self.code.patch(bidx, a=done)
        self.code.emit(B.FOR_POP, line=line)

    def _switch(self, s: A.Switch, line: int) -> None:
        tmp = f"@switch_{self._tmp}"
        self._tmp += 1
        self.expr(s.expr)
        self.code.emit(B.STORE, tmp, False, line=line)
        end_jumps = []
        for cexpr, body in s.cases:
            self.code.emit(B.LOAD, tmp, line=line)
            self.expr(cexpr)
            self.code.emit(B.SWITCH_MATCH, line=line)
            jf = self.code.emit(B.JMP_IF_FALSE, None, line=line)
            for st in body:
                self.stmt(st)
            end_jumps.append(self.code.emit(B.JMP, None, line=line))
            self.code.patch(jf, a=self.code.here())
        if s.otherwise:
            for st in s.otherwise:
                self.stmt(st)
        end = self.code.here()
        for j in end_jumps:
            self.code.patch(j, a=end)

    def _try(self, s: A.TryCatch, line: int) -> None:
        tp = self.code.emit(B.TRY_PUSH, None, s.catch_var, line=line)
        for st in s.body:
            self.stmt(st)
        self.code.emit(B.TRY_POP, line=line)
        jend = self.code.emit(B.JMP, None, line=line)
        self.code.patch(tp, a=self.code.here())
        for st in s.catch_body:
            self.stmt(st)
        self.code.patch(jend, a=self.code.here())

    # ------------------------------------------------------------- expressions

    def expr(self, e) -> None:
        c = self.code
        if isinstance(e, A.Num):
            c.emit(B.CONST, c.const(_num_const(e)))
        elif isinstance(e, A.Str):
            c.emit(B.CONST, c.const(_char_const(e.value)))
        elif isinstance(e, A.DQStr):
            from ..values import StringArray
            c.emit(B.CONST, c.const(StringArray.scalar(e.value)))
        elif isinstance(e, A.Ident):
            c.emit(B.LOAD, e.name, line=e.line)
        elif isinstance(e, A.Colon):
            c.emit(B.COLON_VAL)
        elif isinstance(e, A.EndRef):
            raise MatError("MATLAB:parser:endOutsideIndex", "'end' used outside of indexing.")
        elif isinstance(e, A.BinOp):
            self._binop(e)
        elif isinstance(e, A.UnOp):
            self.expr(e.operand)
            c.emit(B.UNOP, _UNOP_MAP[e.op])
        elif isinstance(e, A.PostOp):
            self.expr(e.operand)
            c.emit(B.TRANSPOSE, e.op == "'")
        elif isinstance(e, A.Range):
            self.expr(e.start)
            if e.step is not None:
                self.expr(e.step)
            self.expr(e.stop)
            c.emit(B.RANGE, e.step is not None)
        elif isinstance(e, A.Index):
            self._compile_callable_use(e, nargout=1, line=0)
        elif isinstance(e, A.FieldAccess):
            if isinstance(e.base, A.Ident):
                c.emit(B.LOADC, e.base.name)
            else:
                self.expr(e.base)
            if e.dynamic is not None:
                self.expr(e.dynamic)
                c.emit(B.FIELD, None)
            else:
                c.emit(B.FIELD, e.name)
        elif isinstance(e, A.MatrixLit):
            counts = []
            for row in e.rows:
                for el in row:
                    self.expr(el)
                counts.append(len(row))
            c.emit(B.BUILD_MAT, tuple(counts))
        elif isinstance(e, A.CellLit):
            counts = []
            for row in e.rows:
                for el in row:
                    self.expr(el)
                counts.append(len(row))
            c.emit(B.BUILD_CELL, tuple(counts))
        elif isinstance(e, A.AnonFunc):
            adef = self.compile_anon(e)
            c.emit(B.MAKE_ANON, c.const(adef))
        elif isinstance(e, A.FuncHandle):
            c.emit(B.MAKE_HANDLE, e.name)
        else:
            raise MatError("MATLAB:internal", f"Unknown expression {type(e).__name__}.")

    def _binop(self, e: A.BinOp) -> None:
        c = self.code
        if e.op in ("&&", "||"):
            # short-circuit: operands must be logical scalars
            self.expr(e.left)
            if e.op == "&&":
                j = c.emit(B.JMP_IF_FALSE, None)
                self.expr(e.right)
                c.emit(B.BOOL_SCALAR)
                jend = c.emit(B.JMP, None)
                c.patch(j, a=c.here())
                c.emit(B.CONST, c.const(MatArray.logical_scalar(False)))
                c.patch(jend, a=c.here())
            else:
                j = c.emit(B.JMP_IF_TRUE, None)
                self.expr(e.right)
                c.emit(B.BOOL_SCALAR)
                jend = c.emit(B.JMP, None)
                c.patch(j, a=c.here())
                c.emit(B.CONST, c.const(MatArray.logical_scalar(True)))
                c.patch(jend, a=c.here())
            return
        self.expr(e.left)
        self.expr(e.right)
        if e.op in _MATRIX_OPS:
            c.emit(_MATRIX_OPS[e.op])
        else:
            c.emit(B.BINOP, _BINOP_MAP[e.op])

    def _compile_callable_use(self, e: A.Index, nargout: int, line: int) -> None:
        """x(args): runtime decides variable-indexing vs function call."""
        c = self.code
        if e.kind == "paren" and isinstance(e.base, A.FieldAccess) and \
                e.base.dynamic is None and \
                not any(_contains_end(a) for a in e.args if not isinstance(a, A.Colon)):
            # obj.m(args) / Class.static(args): method dispatch at runtime,
            # falling back to field-read + paren-index for structs
            base = e.base.base
            if isinstance(base, A.Ident):
                # b="recv": receiver position — a bare builtin class name
                # here is a static-access receiver (string.empty(0, 3)),
                # not a zero-arg ctor call
                c.emit(B.LOADC, base.name, "recv", line=line)
            else:
                self.expr(base)
            for a in e.args:
                self._index_arg(a, 0, len(e.args))
            c.emit(B.CALL_METHOD, e.base.name, len(e.args), nargout, line=line)
            return
        if isinstance(e.base, A.Ident):
            has_end = any(_contains_end(a) for a in e.args if not isinstance(a, A.Colon))
            if has_end:
                c.emit(B.PUSH_IXCTX_VAR, e.base.name, line=line)
            for k, a in enumerate(e.args):
                self._index_arg(a, k, len(e.args))
            # mode 3: explicit empty parens `f()` — distinguishable from a
            # bare identifier so callable values (handles, bound methods)
            # invoke with zero args instead of evaluating to themselves
            mode = 2 if e.kind == "brace" else \
                (3 if not e.args and e.kind == "paren" else 0)
            pc = c.emit(B.RESOLVE_CALL, e.base.name, len(e.args),
                        nargout, mode, line=line)
            argn = tuple(a.name if isinstance(a, A.Ident) else None
                         for a in e.args)
            if any(argn):
                c.call_arg_names[pc] = argn   # inputname()/table() capture
            if has_end:
                c.emit(B.POP_IXCTX, line=line)
            return
        # chained: base expression then INDEX
        self.expr(e.base)
        has_end = any(_contains_end(a) for a in e.args if not isinstance(a, A.Colon))
        if has_end:
            c.emit(B.PUSH_IXCTX, line=line)
        for k, a in enumerate(e.args):
            self._index_arg(a, k, len(e.args))
        c.emit(B.INDEX, len(e.args), e.kind, line=line)
        if has_end:
            c.emit(B.POP_IXCTX, line=line)

    def _index_arg(self, a, dim: int, nargs: int) -> None:
        if isinstance(a, A.Colon):
            self.code.emit(B.COLON_VAL)
            return
        self._compile_with_end(a, dim, nargs)

    def _compile_with_end(self, a, dim: int, nargs: int) -> None:
        """Compile an index argument where EndRef resolves against the current
        index context (dim, nargs baked statically)."""
        if isinstance(a, A.EndRef):
            self.code.emit(B.END_VAL, dim, nargs)
            return
        if isinstance(a, A.BinOp) and a.op not in ("&&", "||"):
            self._compile_with_end(a.left, dim, nargs)
            self._compile_with_end(a.right, dim, nargs)
            if a.op in _MATRIX_OPS:
                self.code.emit(_MATRIX_OPS[a.op])
            else:
                self.code.emit(B.BINOP, _BINOP_MAP[a.op])
            return
        if isinstance(a, A.UnOp):
            self._compile_with_end(a.operand, dim, nargs)
            self.code.emit(B.UNOP, _UNOP_MAP[a.op])
            return
        if isinstance(a, A.Range):
            self._compile_with_end(a.start, dim, nargs)
            if a.step is not None:
                self._compile_with_end(a.step, dim, nargs)
            self._compile_with_end(a.stop, dim, nargs)
            self.code.emit(B.RANGE, a.step is not None)
            return
        self.expr(a)


def _num_const(e: A.Num) -> MatArray:
    if e.is_imag:
        m = MatArray(np.full((1, 1), complex(0, e.value), dtype=np.complex128), "double")
    else:
        m = MatArray(np.full((1, 1), e.value, dtype=np.float64), "double")
    m.shared = True
    return m


def _char_const(s: str) -> MatArray:
    m = MatArray.char_from_str(s)
    m.shared = True
    return m
