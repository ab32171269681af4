"""Copy of runmat_tpu/frontend/parser.py in the PyTorch port.

Recursive-descent MATLAB parser.

Reference parity: runmat-parser (crates/runmat-parser/src/parser.rs, ast.rs).
Precedence follows MATLAB operator precedence (|| < && < | < & < comparison <
range ':' < additive < multiplicative < unary < power/postfix), with the
matrix-literal whitespace column-split rule and transpose handled via lexer
context. Implemented from the MATLAB grammar, not translated.
"""

from __future__ import annotations

from typing import Optional

from ..errors import MatError
from . import ast as A
from .lexer import Token, tokenize

_COMPARE_OPS = ("==", "~=", "<", "<=", ">", ">=")
_ADD_OPS = ("+", "-")
_MUL_OPS = ("*", "/", "\\", ".*", "./", ".\\")
_POW_OPS = ("^", ".^")

# Tokens that can begin an expression (used for matrix element splitting).
def _starts_expr(t: Token) -> bool:
    if t.kind in ("NUM", "IMAG", "IDENT", "STR", "DQSTR"):
        return True
    if t.kind == "KW" and t.text == "end":
        return True
    return t.kind == "OP" and t.text in ("(", "[", "{", "-", "+", "~", "@", ":", "'")


class Parser:
    def __init__(self, tokens: list[Token], src_name: str = "<input>"):
        self.toks = tokens
        self.pos = 0
        self.src_name = src_name
        # context stacks
        self.matrix_depth = 0      # inside [ ] or { } at current nesting frame
        self.paren_depth = 0
        self.index_depth = 0       # inside indexing args ( 'end' allowed )
        self._ctx: list[str] = []  # 'matrix' | 'paren'

    # ------------------------------------------------------------------ utils

    def peek(self, k: int = 0) -> Token:
        j = self.pos + k
        return self.toks[j] if j < len(self.toks) else self.toks[-1]

    def next(self) -> Token:
        t = self.peek()
        if t.kind != "EOF":
            self.pos += 1
        return t

    def expect_op(self, op: str) -> Token:
        t = self.peek()
        if not t.is_op(op):
            raise self._err(t, f"Expected '{op}'")
        return self.next()

    def _err(self, t: Token, msg: str) -> MatError:
        return MatError("MATLAB:parser:parseError",
                        f"Parse error: {msg}, got {t.kind} '{t.text}' ({self.src_name}:{t.line}:{t.col}).")

    def _skip_newlines(self) -> None:
        while self.peek().kind == "NEWLINE" or self.peek().is_op(";", ","):
            self.next()

    def _in_matrix(self) -> bool:
        return bool(self._ctx) and self._ctx[-1] == "matrix"

    # ------------------------------------------------------------- entry point

    def parse_program(self) -> A.Program:
        body: list = []
        functions: dict = {}
        classes: dict = {}
        self._skip_newlines()
        is_function_file = self.peek().is_kw("function")
        while self.peek().kind != "EOF":
            if self.peek().is_kw("classdef"):
                # MATLAB requires classdef in its own file; as an extension
                # (REPL/script convenience) trailing statements and further
                # definitions after the classdef are kept and executed
                cd = self.parse_classdef()
                classes[cd.name] = cd
            elif self.peek().is_kw("function"):
                fd = self.parse_function_def()
                functions[fd.name] = fd
            else:
                st = self.parse_statement()
                if st is not None:
                    body.append(st)
            self._skip_newlines()
        return A.Program(body, functions, classes, is_function_file)

    # -------------------------------------------------------------- statements

    def parse_block(self, terminators: tuple[str, ...]) -> list:
        """Parse statements until a terminator keyword (not consumed)."""
        body: list = []
        self._skip_newlines()
        while True:
            t = self.peek()
            if t.kind == "EOF":
                break
            if t.kind == "KW" and t.text in terminators:
                break
            st = self.parse_statement()
            if st is not None:
                body.append(st)
            self._skip_newlines()
        return body

    def parse_statement(self) -> Optional[A.Node]:
        t = self.peek()
        line = t.line
        if t.kind == "NEWLINE" or t.is_op(";", ","):
            self.next()
            return None
        if t.kind == "KW":
            kw = t.text
            if kw == "if":
                return self.parse_if()
            if kw == "while":
                return self.parse_while()
            if kw in ("for", "parfor"):
                return self.parse_for()
            if kw == "switch":
                return self.parse_switch()
            if kw == "try":
                return self.parse_try()
            if kw == "break":
                self.next()
                return A.Break(line)
            if kw == "continue":
                self.next()
                return A.Continue(line)
            if kw == "return":
                self.next()
                return A.Return(line)
            if kw in ("global", "persistent"):
                self.next()
                names = []
                while self.peek().kind == "IDENT":
                    names.append(self.next().text)
                return A.Global(names, line) if kw == "global" else A.Persistent(names, line)
            if kw == "function":
                raise self._err(t, "function definitions must appear at top level or be nested in a function")
            raise self._err(t, f"unexpected keyword '{kw}'")

        if t.kind == "IDENT" and t.text == "import" and \
                self.peek(1).kind == "IDENT" and self.peek(1).ws_before:
            # import pkg.fn pkg2.*  (statement form; functional import('...')
            # parses as a normal call)
            self.next()
            paths = []
            while self.peek().kind == "IDENT":
                parts = [self.next().text]
                while True:
                    if self.peek().is_op("."):
                        self.next()
                        parts.append(self.next().text)
                    elif self.peek().is_op(".*"):
                        self.next()
                        parts.append("*")
                        break
                    else:
                        break
                paths.append(".".join(parts))
            self._consume_terminator()
            return A.Import(paths, line)

        if t.kind == "IDENT" and self._looks_like_command():
            return self.parse_command()

        # expression, assignment, or multi-assignment ([a,b] = f(...))
        expr = self.parse_expr()
        if self.peek().is_op("="):
            self.next()
            rhs = self.parse_expr()
            display = self._consume_terminator()
            if isinstance(expr, A.MatrixLit):
                lhs_list = self._matrix_to_multi_lhs(expr, t)
                return A.MultiAssign(lhs_list, rhs, display, line)
            lhs = self._as_lvalue(expr, t)
            return A.Assign(lhs, rhs, display, line)
        display = self._consume_terminator()
        return A.ExprStmt(expr, display, line)

    def _consume_terminator(self) -> bool:
        """Consume one statement terminator; returns display flag (True unless ';')."""
        t = self.peek()
        if t.is_op(";"):
            self.next()
            return False
        if t.is_op(","):
            self.next()
            return True
        if t.kind in ("NEWLINE", "EOF"):
            return True
        if t.kind == "KW" and t.text in ("end", "else", "elseif", "case", "otherwise", "catch"):
            return True
        raise self._err(t, "expected end of statement")

    def _as_lvalue(self, expr: A.Node, t: Token) -> A.Node:
        if isinstance(expr, (A.Ident, A.Index, A.FieldAccess)):
            return expr
        if isinstance(expr, A.MatrixLit):
            # single-element [a] = rhs is also legal multi form; normalize later
            return expr
        raise self._err(t, "invalid assignment target")

    def _matrix_to_multi_lhs(self, m: A.MatrixLit, t: Token) -> list:
        if len(m.rows) != 1:
            raise self._err(t, "invalid multi-assignment target")
        out = []
        for el in m.rows[0]:
            if isinstance(el, A.Ident) and el.name == "~":
                out.append(None)
            elif isinstance(el, (A.Ident, A.Index, A.FieldAccess)):
                out.append(el)
            elif isinstance(el, A.UnOp) and el.op == "~" and isinstance(el.operand, A.Ident):
                out.append(None)
            else:
                raise self._err(t, "invalid multi-assignment target element")
        return out

    def _is_multi_assign_target(self, m: A.MatrixLit) -> bool:
        return len(m.rows) == 1

    # command-syntax detection: IDENT followed by a space-separated word that
    # cannot continue an expression (e.g. `hold on`, `format long`, `clear all`).
    def _looks_like_command(self) -> bool:
        t0, t1 = self.peek(0), self.peek(1)
        if t1.kind == "IDENT" and t1.ws_before:
            t2 = self.peek(2)
            # `x y` then (newline | ; | , | another word) — not `a b(...)`? MATLAB
            # still treats `disp hello` as command. Exclude `t1 =` (assignment reads).
            if t2.is_op("=") or t2.is_op("(") and not t2.ws_before:
                return False
            if t2.kind in ("NEWLINE", "EOF") or t2.is_op(";", ",") or t2.kind in ("IDENT", "NUM", "STR"):
                # exclude binary continuation like `a b` can't happen in exprs anyway
                return True
            if t2.is_op("*") and not t2.ws_before:
                # wildcard command arg: `clearvars a*`, `clear tmp*`
                t3 = self.peek(3)
                return t3.kind in ("NEWLINE", "EOF") or t3.is_op(";", ",") or \
                    (t3.kind == "IDENT" and t3.ws_before)
            return False
        if t1.kind == "OP" and t1.text == "-" and t1.ws_before:
            # `ls -la` style: IDENT - IDENT with no space after '-'
            t2 = self.peek(2)
            if t2.kind == "IDENT" and not t2.ws_before:
                t3 = self.peek(3)
                return t3.kind in ("NEWLINE", "EOF") or t3.is_op(";", ",") or (t3.kind == "IDENT" and t3.ws_before)
        return False

    def parse_command(self) -> A.Command:
        name_tok = self.next()
        args: list[str] = []
        cur = ""
        while True:
            t = self.peek()
            if t.kind in ("NEWLINE", "EOF") or t.is_op(";", ","):
                break
            if t.ws_before and cur:
                args.append(cur)
                cur = ""
            if t.kind == "STR":
                cur += t.text
            else:
                cur += t.text
            self.next()
        if cur:
            args.append(cur)
        self._consume_terminator()
        return A.Command(name_tok.text, args, name_tok.line)

    # control flow ------------------------------------------------------------

    def parse_if(self) -> A.If:
        line = self.next().line  # 'if'
        branches = []
        cond = self.parse_expr()
        body = self.parse_block(("elseif", "else", "end"))
        branches.append((cond, body))
        else_body = None
        while True:
            t = self.peek()
            if t.is_kw("elseif"):
                self.next()
                c = self.parse_expr()
                b = self.parse_block(("elseif", "else", "end"))
                branches.append((c, b))
            elif t.is_kw("else"):
                self.next()
                else_body = self.parse_block(("end",))
            elif t.is_kw("end"):
                self.next()
                break
            else:
                raise self._err(t, "expected 'end' to close 'if'")
        return A.If(branches, else_body, line)

    def parse_while(self) -> A.While:
        line = self.next().line
        cond = self.parse_expr()
        body = self.parse_block(("end",))
        self.next()  # end
        return A.While(cond, body, line)

    def parse_for(self) -> A.For:
        kw = self.next()
        line = kw.line
        is_parfor = kw.text == "parfor"
        parens = False
        if self.peek().is_op("("):
            self.next()
            parens = True
        var_tok = self.peek()
        if var_tok.kind != "IDENT":
            raise self._err(var_tok, "expected loop variable")
        self.next()
        self.expect_op("=")
        expr = self.parse_expr()
        if parens:
            self.expect_op(")")
        body = self.parse_block(("end",))
        self.next()
        return A.For(var_tok.text, expr, body, line, is_parfor)

    def parse_switch(self) -> A.Switch:
        line = self.next().line
        expr = self.parse_expr()
        self._skip_newlines()
        cases = []
        otherwise = None
        while True:
            t = self.peek()
            if t.is_kw("case"):
                self.next()
                cexpr = self.parse_expr()
                body = self.parse_block(("case", "otherwise", "end"))
                cases.append((cexpr, body))
            elif t.is_kw("otherwise"):
                self.next()
                otherwise = self.parse_block(("end",))
            elif t.is_kw("end"):
                self.next()
                break
            else:
                raise self._err(t, "expected 'case', 'otherwise' or 'end'")
        return A.Switch(expr, cases, otherwise, line)

    def parse_try(self) -> A.TryCatch:
        line = self.next().line
        body = self.parse_block(("catch", "end"))
        catch_var = None
        catch_body: list = []
        if self.peek().is_kw("catch"):
            catch_tok = self.next()
            t = self.peek()
            # `catch err` only when the identifier sits on the same line and is
            # immediately followed by a statement terminator.
            if t.kind == "IDENT" and t.line == catch_tok.line and \
                    (self.peek(1).kind in ("NEWLINE", "EOF") or self.peek(1).is_op(";", ",")):
                catch_var = t.text
                self.next()
            catch_body = self.parse_block(("end",))
        t = self.peek()
        if not t.is_kw("end"):
            raise self._err(t, "expected 'end' to close 'try'")
        self.next()
        return A.TryCatch(body, catch_var, catch_body, line)

    # function definitions ------------------------------------------------------

    def parse_function_def(self) -> A.FunctionDef:
        line = self.next().line  # 'function'
        outs: list[str] = []
        # forms: function name(...)  |  function out = name(...)  |  function [o1,o2] = name(...)
        if self.peek().is_op("["):
            self.next()
            while not self.peek().is_op("]"):
                t = self.peek()
                if t.kind == "IDENT":
                    outs.append(t.text)
                    self.next()
                elif t.is_op(","):
                    self.next()
                elif t.is_op("~"):
                    outs.append("~")
                    self.next()
                else:
                    raise self._err(t, "expected output name")
            self.next()
            self.expect_op("=")
            name = self.next().text
        else:
            first = self.peek()
            if first.kind != "IDENT":
                raise self._err(first, "expected function name")
            self.next()
            if self.peek().is_op("="):
                self.next()
                outs = [first.text]
                name_tok = self.peek()
                if name_tok.kind != "IDENT":
                    raise self._err(name_tok, "expected function name")
                name = self.next().text
            else:
                name = first.text
        params: list[str] = []
        if self.peek().is_op("("):
            self.next()
            while not self.peek().is_op(")"):
                t = self.peek()
                if t.kind == "IDENT":
                    params.append(t.text)
                    self.next()
                elif t.is_op("~"):
                    params.append("~")
                    self.next()
                elif t.is_op(","):
                    self.next()
                else:
                    raise self._err(t, "expected parameter name")
            self.next()
        # body runs until matching 'end' or next top-level 'function' / EOF
        body: list = []
        nested: list = []
        arg_specs: list = []
        self._skip_newlines()
        # 'arguments' is a contextual keyword: only a block when it opens the
        # body and is followed by a statement separator or block options
        while self.peek().kind == "IDENT" and self.peek().text == "arguments" \
                and (self.peek(1).kind == "NEWLINE" or self.peek(1).is_op(";")
                     or self.peek(1).is_op("(")):
            arg_specs.extend(self._parse_arguments_block())
            self._skip_newlines()
        first_nested_pos = None
        saw_end = False
        while True:
            t = self.peek()
            if t.kind == "EOF":
                break
            if t.is_kw("end"):
                self.next()
                saw_end = True
                break
            if t.is_kw("function"):
                # tentatively parse as a NESTED function; if this def turns
                # out to be end-less (no matching 'end' for the parent), the
                # position is restored and the def re-parses as a sibling
                if first_nested_pos is None:
                    first_nested_pos = self.pos
                nested.append(self.parse_function_def())
                self._skip_newlines()
                continue
            st = self.parse_statement()
            if st is not None:
                body.append(st)
            self._skip_newlines()
        if nested and not saw_end:
            # end-less file: the tentatively-nested defs are actually siblings
            self.pos = first_nested_pos
            nested = []
        return A.FunctionDef(name, params, outs, body, line, nested,
                             arg_specs=arg_specs)

    def _parse_arguments_block(self) -> list:
        """Parse an arguments-validation block into ArgSpec entries
        (≙ runmat-hir argument-validation blocks).

        entry := name['.'field] ['(' dims ')'] [class] ['{' validators '}']
                 ['=' default-expr]"""
        self.next()  # 'arguments'
        # optional block options: (Output) / (Repeating) — recorded, specs
        # from Output blocks are validation-only on outputs (skipped)
        block_opt = None
        if self.peek().is_op("("):
            self.next()
            while not self.peek().is_op(")") and self.peek().kind != "EOF":
                block_opt = self.next().text
            self.next()
        specs: list = []
        if self.peek().is_op(";") or self.peek().is_op(","):
            self.next()   # one-line form: arguments; spec; ...; end
        self._skip_newlines()
        while not self.peek().is_kw("end") and self.peek().kind != "EOF":
            t = self.peek()
            if t.kind != "IDENT":
                raise self._err(t, "expected argument name")
            name = self.next().text
            field = None
            if self.peek().is_op("."):
                self.next()
                field = self.next().text
            dims = None
            if self.peek().is_op("("):   # whitespace before '(' is allowed here
                self.next()
                dims = []
                while not self.peek().is_op(")"):
                    tt = self.peek()
                    if tt.is_op(":"):
                        dims.append(None)
                        self.next()
                    elif tt.kind == "NUM":
                        dims.append(int(float(self.next().text)))
                    elif tt.is_op(","):
                        self.next()
                    else:
                        raise self._err(tt, "expected dimension")
                self.next()
            cls = None
            if self.peek().kind == "IDENT":
                cls = self.next().text
            validators: list = []
            if self.peek().is_op("{"):
                self.next()
                while not self.peek().is_op("}"):
                    tt = self.peek()
                    if tt.kind == "IDENT":
                        vname = self.next().text
                        vargs = None
                        if self.peek().is_op("(") and not self.peek().ws_before:
                            vargs = []
                            self.next()
                            depth = 1
                            while depth and self.peek().kind != "EOF":
                                tok = self.next()
                                if tok.is_op("("):
                                    depth += 1
                                elif tok.is_op(")"):
                                    depth -= 1
                                    if depth == 0:
                                        break
                                if depth and not tok.is_op(","):
                                    vargs.append(tok.text)
                        validators.append((vname, vargs))
                    elif tt.is_op(","):
                        self.next()
                    else:
                        raise self._err(tt, "expected validator name")
                self.next()
            default = None
            if self.peek().is_op("="):
                self.next()
                default = self.parse_expr()
            self._consume_terminator()
            self._skip_newlines()
            if block_opt != "Output":
                specs.append(A.ArgSpec(name, field, dims, cls, validators,
                                       default))
        if self.peek().is_kw("end"):
            self.next()
        return specs

    def parse_classdef(self) -> A.ClassDef:
        line = self.next().line  # 'classdef'
        # optional attributes: classdef (Attr) Name
        if self.peek().is_op("("):
            d = 1
            self.next()
            while d and self.peek().kind != "EOF":
                t = self.next()
                if t.is_op("("):
                    d += 1
                elif t.is_op(")"):
                    d -= 1
        name_tok = self.peek()
        if name_tok.kind != "IDENT":
            raise self._err(name_tok, "expected class name")
        name = self.next().text
        supers: list[str] = []
        if self.peek().is_op("<"):
            self.next()
            while True:
                t = self.peek()
                if t.kind == "IDENT":
                    sup = self.next().text
                    while self.peek().is_op("."):
                        self.next()
                        sup += "." + self.next().text
                    supers.append(sup)
                if self.peek().is_op("&"):
                    self.next()
                    continue
                break
        properties: list = []
        methods: list = []
        static_methods: list = []
        events: list = []
        self._skip_newlines()
        while not self.peek().is_kw("end") and self.peek().kind != "EOF":
            t = self.peek()
            if _is_ctxkw(t, "properties"):
                self.next()
                attrs = self._parse_block_attrs()
                self._skip_newlines()
                while not self.peek().is_kw("end") and self.peek().kind != "EOF":
                    pt = self.peek()
                    if pt.kind != "IDENT":
                        raise self._err(pt, "expected property name")
                    pname = self.next().text
                    # optional size/class/validators — skip to '=' or end of line
                    default = None
                    while self.peek().kind not in ("NEWLINE", "EOF") and not self.peek().is_op(";", "=") \
                            and not self.peek().is_kw("end"):
                        self.next()
                    if self.peek().is_op("="):
                        self.next()
                        default = self.parse_expr()
                    properties.append((pname, default, attrs))
                    self._skip_newlines()
                self.next()  # end
            elif _is_ctxkw(t, "methods"):
                self.next()
                attrs = self._parse_block_attrs()
                is_static = any(a.lower() == "static" for a in attrs)
                self._skip_newlines()
                while not self.peek().is_kw("end") and self.peek().kind != "EOF":
                    if self.peek().is_kw("function"):
                        fd = self.parse_function_def()
                        (static_methods if is_static else methods).append(fd)
                    else:
                        self.next()
                    self._skip_newlines()
                self.next()  # end
            elif _is_ctxkw(t, "events"):
                self.next()
                self._parse_block_attrs()
                self._skip_newlines()
                while not self.peek().is_kw("end") and self.peek().kind != "EOF":
                    if self.peek().kind == "IDENT":
                        events.append(self.next().text)
                    else:
                        self.next()
                    self._skip_newlines()
                self.next()  # end
            elif _is_ctxkw(t, "enumeration"):
                # skip block
                self.next()
                depth = 1
                while depth and self.peek().kind != "EOF":
                    tt = self.next()
                    if tt.is_kw("end"):
                        depth -= 1
            else:
                self.next()
            self._skip_newlines()
        if self.peek().is_kw("end"):
            self.next()
        return A.ClassDef(name, supers, properties, methods, static_methods,
                          line, events)

    def _parse_block_attrs(self) -> list[str]:
        attrs: list[str] = []
        if self.peek().is_op("("):
            self.next()
            while not self.peek().is_op(")") and self.peek().kind != "EOF":
                t = self.next()
                if t.kind == "IDENT":
                    attrs.append(t.text)
            self.next()
        return attrs

    # ------------------------------------------------------------- expressions

    def parse_expr(self) -> A.Node:
        return self.parse_or_else()

    def parse_or_else(self) -> A.Node:
        left = self.parse_and_also()
        while self.peek().is_op("||"):
            self.next()
            right = self.parse_and_also()
            left = A.BinOp("||", left, right)
        return left

    def parse_and_also(self) -> A.Node:
        left = self.parse_elem_or()
        while self.peek().is_op("&&"):
            self.next()
            right = self.parse_elem_or()
            left = A.BinOp("&&", left, right)
        return left

    def parse_elem_or(self) -> A.Node:
        left = self.parse_elem_and()
        while self.peek().is_op("|"):
            self.next()
            right = self.parse_elem_and()
            left = A.BinOp("|", left, right)
        return left

    def parse_elem_and(self) -> A.Node:
        left = self.parse_compare()
        while self.peek().is_op("&"):
            self.next()
            right = self.parse_compare()
            left = A.BinOp("&", left, right)
        return left

    def parse_compare(self) -> A.Node:
        left = self.parse_range()
        while self.peek().is_op(*_COMPARE_OPS):
            op = self.next().text
            right = self.parse_range()
            left = A.BinOp(op, left, right)
        return left

    def parse_range(self) -> A.Node:
        left = self.parse_additive()
        if self.peek().is_op(":") and not self._colon_is_index_sep():
            self.next()
            mid = self.parse_additive()
            if self.peek().is_op(":") and not self._colon_is_index_sep():
                self.next()
                stop = self.parse_additive()
                return A.Range(left, mid, stop)
            return A.Range(left, None, mid)
        return left

    def _colon_is_index_sep(self) -> bool:
        # never true: bare-colon indices are handled before expression parsing
        return False

    def parse_additive(self) -> A.Node:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if not (t.kind == "OP" and t.text in _ADD_OPS):
                break
            if self._in_matrix() and t.ws_before and not self.peek(1).ws_before \
                    and _starts_expr(self.peek(1)):
                break  # `[1 -2]` — new matrix element
            self.next()
            right = self.parse_multiplicative()
            left = A.BinOp(t.text, left, right)
        return left

    def parse_multiplicative(self) -> A.Node:
        left = self.parse_unary()
        while self.peek().is_op(*_MUL_OPS):
            op = self.next().text
            right = self.parse_unary()
            left = A.BinOp(op, left, right)
        return left

    def parse_unary(self) -> A.Node:
        t = self.peek()
        if t.is_op("-", "+", "~"):
            self.next()
            operand = self.parse_unary()
            if t.text == "+":
                return operand if not isinstance(operand, A.Num) else operand
            return A.UnOp(t.text, operand)
        return self.parse_power()

    def parse_power(self) -> A.Node:
        base = self.parse_postfix()
        t = self.peek()
        if t.is_op(*_POW_OPS):
            op = self.next().text
            # exponent may have unary sign: 2^-1
            exp = self.parse_power_exponent()
            return A.BinOp(op, base, exp)
        return base

    def parse_power_exponent(self) -> A.Node:
        t = self.peek()
        if t.is_op("-", "+", "~"):
            self.next()
            operand = self.parse_power_exponent()
            return operand if t.text == "+" else A.UnOp(t.text, operand)
        node = self.parse_postfix()
        nt = self.peek()
        if nt.is_op(*_POW_OPS):
            op = self.next().text
            return A.BinOp(op, node, self.parse_power_exponent())
        return node

    def parse_postfix(self) -> A.Node:
        node = self.parse_primary()
        while True:
            t = self.peek()
            if t.is_op("'"):
                self.next()
                node = A.PostOp("'", node)
            elif t.is_op(".'"):
                self.next()
                node = A.PostOp(".'", node)
            elif t.is_op("("):
                if self._in_matrix() and t.ws_before:
                    break  # `[a (1)]` — new element
                self.next()
                args = self.parse_index_args(")")
                node = A.Index(node, args, "paren")
            elif t.is_op("{"):
                if self._in_matrix() and t.ws_before:
                    break
                self.next()
                args = self.parse_index_args("}")
                node = A.Index(node, args, "brace")
            elif t.is_op("."):
                nt = self.peek(1)
                if nt.kind == "IDENT" or (nt.kind == "KW"):
                    self.next()
                    name = self.next().text
                    node = A.FieldAccess(node, name)
                elif nt.is_op("("):
                    self.next()
                    self.next()
                    dyn = self.parse_expr()
                    self.expect_op(")")
                    node = A.FieldAccess(node, None, dyn)
                else:
                    raise self._err(nt, "expected field name after '.'")
            else:
                break
        return node

    def parse_index_args(self, closer: str) -> list:
        """Arguments of indexing/call: expressions, bare ':' and 'end' allowed."""
        self._ctx.append("paren")
        self.index_depth += 1
        args: list = []
        try:
            while True:
                t = self.peek()
                if t.is_op(closer):
                    self.next()
                    break
                if t.is_op(","):
                    self.next()
                    continue
                if t.is_op(":"):
                    nt = self.peek(1)
                    if nt.is_op(",", closer):
                        self.next()
                        args.append(A.Colon())
                        continue
                args.append(self.parse_expr())
        finally:
            self.index_depth -= 1
            self._ctx.pop()
        return args

    def parse_primary(self) -> A.Node:
        t = self.peek()
        if t.kind == "NUM":
            self.next()
            return A.Num(self._num_value(t.text), False, "." not in t.text and "e" not in t.text.lower())
        if t.kind == "IMAG":
            self.next()
            return A.Num(self._num_value(t.text[:-1]), True)
        if t.kind == "STR":
            self.next()
            return A.Str(t.text)
        if t.kind == "DQSTR":
            self.next()
            return A.DQStr(t.text)
        if t.kind == "IDENT":
            self.next()
            return A.Ident(t.text, t.line)
        if t.kind == "KW" and t.text == "end":
            if self.index_depth > 0:
                self.next()
                return A.EndRef()
            raise self._err(t, "'end' used outside of indexing")
        if t.is_op("("):
            self.next()
            self._ctx.append("paren")
            try:
                inner = self.parse_expr()
            finally:
                self._ctx.pop()
            self.expect_op(")")
            return inner
        if t.is_op("["):
            return self.parse_matrix_lit("]", A.MatrixLit)
        if t.is_op("{"):
            return self.parse_matrix_lit("}", A.CellLit)
        if t.is_op("@"):
            self.next()
            nt = self.peek()
            if nt.is_op("("):
                self.next()
                params: list[str] = []
                while not self.peek().is_op(")"):
                    pt = self.peek()
                    if pt.kind == "IDENT":
                        params.append(pt.text)
                        self.next()
                    elif pt.is_op(",", "~"):
                        if pt.is_op("~"):
                            params.append("~")
                        self.next()
                    else:
                        raise self._err(pt, "expected parameter name")
                self.next()
                body = self.parse_expr()
                return A.AnonFunc(params, body)
            if nt.kind == "IDENT":
                name = self.next().text
                while self.peek().is_op(".") and self.peek(1).kind == "IDENT":
                    self.next()
                    name += "." + self.next().text
                return A.FuncHandle(name)
            raise self._err(nt, "expected function name or parameter list after '@'")
        if t.is_op(":"):
            # bare colon as an expression (rare: only valid as index; callers
            # handle it; here it means "magic colon" value)
            self.next()
            return A.Colon()
        raise self._err(t, "unexpected token")

    @staticmethod
    def _num_value(text: str) -> float:
        tl = text.lower()
        if tl.startswith("0x"):
            return float(int(tl, 16))
        if tl.startswith("0b"):
            return float(int(tl, 2))
        return float(text)

    # matrix / cell literals -----------------------------------------------------

    def parse_matrix_lit(self, closer: str, ctor) -> A.Node:
        self.next()  # [ or {
        self._ctx.append("matrix")
        rows: list[list[A.Node]] = []
        cur: list[A.Node] = []
        try:
            while True:
                t = self.peek()
                if t.is_op(closer):
                    self.next()
                    break
                if t.kind == "EOF":
                    raise self._err(t, f"expected '{closer}'")
                if t.is_op(",",):
                    self.next()
                    continue
                if t.is_op(";") or t.kind == "NEWLINE":
                    self.next()
                    if cur:
                        rows.append(cur)
                        cur = []
                    continue
                if t.is_op("~") and (self.peek(1).is_op(",", ";", closer) or
                                     self.peek(1).kind == "NEWLINE"):
                    # output placeholder in [~, x] = f(...) targets
                    self.next()
                    cur.append(A.Ident("~", t.line))
                    continue
                el = self.parse_expr()
                cur.append(el)
        finally:
            self._ctx.pop()
        if cur:
            rows.append(cur)
        return ctor(rows)


def _is_ctxkw(t, name: str) -> bool:
    """Contextual keyword: properties/methods/events/... are keywords only
    inside classdef blocks; plain identifiers elsewhere (MATLAB semantics)."""
    return t.kind in ("KW", "IDENT") and t.text == name


def parse(src: str, src_name: str = "<input>") -> A.Program:
    return Parser(tokenize(src), src_name).parse_program()


def parse_expression(src: str) -> A.Node:
    p = Parser(tokenize(src))
    e = p.parse_expr()
    return e
