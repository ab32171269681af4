"""Copy of runmat_tpu/frontend/ast.py in the PyTorch port.

MATLAB AST node definitions.

Reference parity: runmat-parser/src/ast.rs:6-177 (Expr/Stmt). Lean dataclass
nodes; spans carry only the line (enough for MException stacks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class Node:
    __slots__ = ()


# --------------------------------------------------------------------------- #
# expressions
# --------------------------------------------------------------------------- #

@dataclass
class Num(Node):
    value: float
    is_imag: bool = False
    is_int_literal: bool = False


@dataclass
class Str(Node):          # 'char literal'
    value: str


@dataclass
class DQStr(Node):        # "string literal"
    value: str


@dataclass
class Ident(Node):
    name: str
    line: int = 0


@dataclass
class Colon(Node):        # bare ':' used as an index
    pass


@dataclass
class EndRef(Node):       # 'end' inside an index expression
    pass


@dataclass
class Range(Node):
    start: Node
    step: Optional[Node]
    stop: Node


@dataclass
class BinOp(Node):
    op: str
    left: Node
    right: Node


@dataclass
class UnOp(Node):
    op: str               # '-', '+', '~'
    operand: Node


@dataclass
class PostOp(Node):
    op: str               # "'" (ctranspose) or ".'" (transpose)
    operand: Node


@dataclass
class Index(Node):
    """base(args) or base{args}. Paren form is call-or-index, resolved at
    lowering time against the symbol table (reference: runmat-hir resolution)."""
    base: Node
    args: list
    kind: str             # 'paren' | 'brace'


@dataclass
class FieldAccess(Node):
    base: Node
    name: Optional[str]   # static field
    dynamic: Optional[Node] = None  # s.(expr)


@dataclass
class MatrixLit(Node):
    rows: list            # list[list[Node]]


@dataclass
class CellLit(Node):
    rows: list


@dataclass
class AnonFunc(Node):
    params: list
    body: Node


@dataclass
class FuncHandle(Node):
    name: str


# --------------------------------------------------------------------------- #
# statements
# --------------------------------------------------------------------------- #

@dataclass
class ExprStmt(Node):
    expr: Node
    display: bool
    line: int = 0


@dataclass
class Assign(Node):
    lhs: Node             # Ident | Index | FieldAccess chain
    rhs: Node
    display: bool
    line: int = 0


@dataclass
class MultiAssign(Node):
    lhs: list             # elements: Ident | Index | FieldAccess | None (~ placeholder)
    rhs: Node
    display: bool
    line: int = 0


@dataclass
class If(Node):
    branches: list        # list[(cond, body)]
    else_body: Optional[list]
    line: int = 0


@dataclass
class While(Node):
    cond: Node
    body: list
    line: int = 0


@dataclass
class For(Node):
    var: str
    expr: Node
    body: list
    line: int = 0
    is_parfor: bool = False


@dataclass
class Switch(Node):
    expr: Node
    cases: list           # list[(case_expr, body)]
    otherwise: Optional[list]
    line: int = 0


@dataclass
class TryCatch(Node):
    body: list
    catch_var: Optional[str]
    catch_body: list
    line: int = 0


@dataclass
class Break(Node):
    line: int = 0


@dataclass
class Continue(Node):
    line: int = 0


@dataclass
class Return(Node):
    line: int = 0


@dataclass
class Import(Node):
    """import pkg.fn / import pkg.* (one or more space-separated paths)."""
    paths: list           # dotted strings; trailing segment may be '*'
    line: int = 0


@dataclass
class Global(Node):
    names: list
    line: int = 0


@dataclass
class Persistent(Node):
    names: list
    line: int = 0


@dataclass
class Command(Node):
    name: str
    args: list            # list[str]
    line: int = 0


@dataclass
class ArgSpec(Node):
    """One entry of an arguments-validation block (≙ runmat-hir
    argument-validation model)."""
    name: str
    field_name: Optional[str]   # name.field -> name-value option bound into a struct
    dims: Optional[list]        # per-dim sizes; None element = ':' (any)
    cls: Optional[str]          # class coercion target ('double', 'char', ...)
    validators: list            # [(builtin_name, raw_args|None), ...]
    default: Optional[Node]     # default expression (evaluated in fn scope)


@dataclass
class FunctionDef(Node):
    name: str
    params: list          # may end with 'varargin'
    outs: list            # may end with 'varargout'
    body: list
    line: int = 0
    nested: list = field(default_factory=list)   # nested FunctionDefs
    arg_specs: list = field(default_factory=list)  # ArgSpec entries


@dataclass
class ClassDef(Node):
    name: str
    supers: list
    properties: list      # list[(name, default_expr|None, attrs)]
    methods: list         # list[FunctionDef]
    static_methods: list
    line: int = 0
    events: list = None   # event names declared in events blocks


@dataclass
class Program(Node):
    """A parsed source unit: script statements + local function defs."""
    body: list
    functions: dict       # name -> FunctionDef
    classes: dict         # name -> ClassDef
    is_function_file: bool = False


# --------------------------------------------------------------------------- #
# expression unparser (func2str of anonymous handles; ≙ the reference keeps
# the original source text on Closure values)
# --------------------------------------------------------------------------- #

def unparse(e) -> str:
    if isinstance(e, Num):
        v = e.value
        if isinstance(v, complex):
            return f"{v.imag:g}i" if v.real == 0 else f"({v.real:g}+{v.imag:g}i)"
        return f"{v:g}" if v == v and abs(v) != float("inf") else str(v)
    if isinstance(e, Str):
        return "'" + e.value.replace("'", "''") + "'"
    if isinstance(e, DQStr):
        return '"' + e.value.replace('"', '""') + '"'
    if isinstance(e, Ident):
        return e.name
    if isinstance(e, Colon):
        return ":"
    if isinstance(e, EndRef):
        return "end"
    if isinstance(e, Range):
        if e.step is not None:
            return f"{unparse(e.start)}:{unparse(e.step)}:{unparse(e.stop)}"
        return f"{unparse(e.start)}:{unparse(e.stop)}"
    if isinstance(e, BinOp):
        def p(sub):
            # conservative re-parenthesization keeps the round trip exact
            return f"({unparse(sub)})" if isinstance(sub, (BinOp, Range)) \
                else unparse(sub)
        return f"{p(e.left)} {e.op} {p(e.right)}"
    if isinstance(e, UnOp):
        o = e.operand
        inner = f"({unparse(o)})" if isinstance(o, (BinOp, Range)) else unparse(o)
        return f"{e.op}{inner}"
    if isinstance(e, PostOp):
        return f"{unparse(e.operand)}{e.op}"
    if isinstance(e, Index):
        o, c = ("{", "}") if e.kind == "brace" else ("(", ")")
        return f"{unparse(e.base)}{o}{', '.join(unparse(a) for a in e.args)}{c}"
    if isinstance(e, FieldAccess):
        if e.dynamic is not None:
            return f"{unparse(e.base)}.({unparse(e.dynamic)})"
        return f"{unparse(e.base)}.{e.name}"
    if isinstance(e, MatrixLit):
        rows = ["  ".join(unparse(x) for x in r) for r in e.rows]
        return "[" + "; ".join(rows) + "]"
    if isinstance(e, CellLit):
        rows = ["  ".join(unparse(x) for x in r) for r in e.rows]
        return "{" + "; ".join(rows) + "}"
    if isinstance(e, AnonFunc):
        return f"@({', '.join(e.params)}) {unparse(e.body)}"
    if isinstance(e, FuncHandle):
        return f"@{e.name}"
    return "<expr>"
