"""Copy of runmat_tpu/frontend/hir.py in the PyTorch port.

HIR: name/callable resolution, binding tables, and entrypoint policy.

Reference parity: runmat-hir (crates/runmat-hir/src/lib.rs:16-44) — the
reference lowers the AST into an HIR assembly carrying binding/callable
resolution, the classdef model, the entrypoint policy (script vs function
file), and the dynamic-workspace gates (eval/assignin/evalin force dynamic
resolution, lib.rs:36-41). This module is that layer for the TPU build: a
pure resolution pass over the parsed program whose tables power the
static-analysis lints and host tooling, while the VM keeps MATLAB's
runtime call-or-index semantics (the RESOLVE_CALL design note in
vm/bytecode.py).

Shape/class facts live in facts.py; CFG dataflow in vm/mir.py — together
the three cover the reference's HIR+MIR analysis surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ast as A

# names MATLAB resolves without a definition
BUILTIN_CONSTANTS = frozenset(
    "ans pi inf Inf nan NaN eps true false i j varargin varargout "
    "nargin nargout end".split())

# calling these makes the unit's workspace dynamic: identifiers may be
# created/retargeted at runtime, so static resolution is advisory only
# (≙ EVAL/ASSIGNIN gates, runmat-hir/src/lib.rs:36-41)
DYNAMIC_GATES = frozenset("eval evalin assignin feval clear load".split())


@dataclass
class Binding:
    name: str
    kind: str          # param | output | local | global | persistent |
    #                    loopvar | capture | catch
    line: int = 0


@dataclass
class HirUnit:
    name: str
    kind: str                      # script | function | anon
    params: list = field(default_factory=list)
    outs: list = field(default_factory=list)
    bindings: dict = field(default_factory=dict)    # name -> Binding
    reads: list = field(default_factory=list)       # (name, line, is_call)
    calls: dict = field(default_factory=dict)       # name -> resolution
    dynamic_gates: list = field(default_factory=list)   # (gate, line)
    nested: list = field(default_factory=list)
    assigned: set = field(default_factory=set)          # actually stored

    @property
    def is_dynamic(self) -> bool:
        return bool(self.dynamic_gates)


@dataclass
class HirAssembly:
    entry: str                     # "script" | "function-file"
    units: list = field(default_factory=list)
    functions: dict = field(default_factory=dict)   # name -> HirUnit
    classes: dict = field(default_factory=dict)     # name -> class def

    def unit(self, name: str):
        for u in self.units:
            if u.name == name:
                return u
        return None


# --------------------------------------------------------------------------- #
# lowering
# --------------------------------------------------------------------------- #

def lower(prog, registry=None) -> HirAssembly:
    """AST -> HIR assembly. `registry` (the builtin registry module) makes
    callable resolution precise; without it builtins resolve as unknown."""
    asm = HirAssembly(
        entry="function-file" if getattr(prog, "is_function_file", False)
        else "script")
    asm.classes = dict(getattr(prog, "classes", {}) or {})
    local_fns = set(getattr(prog, "functions", {}) or {})

    def resolve(name: str, unit: HirUnit, nested_names: set) -> str:
        """MATLAB resolution order for a called identifier."""
        if name in unit.bindings:
            return "variable"
        if name in nested_names:
            return "nested"
        if name in local_fns:
            return "local-function"
        if name in asm.classes:
            return "class"
        if registry is not None and registry.lookup(name) is not None:
            return "builtin"
        if name in BUILTIN_CONSTANTS:
            return "constant"
        return "unknown"

    def lower_unit(name, body, params, outs, kind, captures=()) -> HirUnit:
        u = HirUnit(name=name, kind=kind, params=list(params),
                    outs=list(outs))
        for p in params:
            if p != "~":
                u.bindings[p] = Binding(p, "param")
        for o in outs:
            u.bindings.setdefault(o, Binding(o, "output"))
        for c in captures:
            u.bindings.setdefault(c, Binding(c, "capture"))
        _collect(body, u)
        return u

    def _collect(stmts, u: HirUnit):
        for s in stmts:
            _stmt(s, u)

    def _bind(name, kind, line, u):
        if not name or name == "~":
            return
        u.assigned.add(name)
        if name not in u.bindings:
            u.bindings[name] = Binding(name, kind, line)

    def _lhs(target, line, u):
        if target is None:
            return
        if isinstance(target, A.Ident):
            _bind(target.name, "local", line, u)
            return
        base = target
        while isinstance(base, (A.Index, A.FieldAccess)):
            if isinstance(base, A.Index):
                for a2 in base.args:
                    _expr(a2, line, u)
            base = base.base
        if isinstance(base, A.Ident):
            _bind(base.name, "local", line, u)

    def _stmt(s, u: HirUnit):
        line = getattr(s, "line", 0) or 0
        if isinstance(s, A.Assign):
            _expr(s.rhs, line, u)
            _lhs(s.lhs, line, u)
        elif isinstance(s, A.MultiAssign):
            _expr(s.rhs, line, u)
            for tgt in s.lhs:
                _lhs(tgt, line, u)
        elif isinstance(s, A.ExprStmt):
            _expr(s.expr if hasattr(s, "expr") else s.value, line, u)
        elif isinstance(s, A.If):
            for cond, blk in s.branches:
                if cond is not None:
                    _expr(cond, line, u)
                _collect(blk, u)
            if s.else_body:
                _collect(s.else_body, u)
        elif isinstance(s, A.While):
            _expr(s.cond, line, u)
            _collect(s.body, u)
        elif isinstance(s, A.For):
            _expr(s.expr, line, u)
            _bind(s.var, "loopvar", line, u)
            _collect(s.body, u)
        elif isinstance(s, A.Switch):
            _expr(s.expr, line, u)
            for case_val, blk in s.cases:
                if case_val is not None:
                    _expr(case_val, line, u)
                _collect(blk, u)
            if s.otherwise:
                _collect(s.otherwise, u)
        elif isinstance(s, A.TryCatch):
            _collect(s.body, u)
            if s.catch_var:
                _bind(s.catch_var, "catch", line, u)
            _collect(s.catch_body, u)
        elif isinstance(s, A.Global):
            for n in s.names:
                u.bindings[n] = Binding(n, "global", line)
        elif isinstance(s, A.Persistent):
            for n in s.names:
                u.bindings[n] = Binding(n, "persistent", line)
        # Return/Break/Continue: nothing to resolve

    def _expr(e, line, u: HirUnit):
        if e is None or isinstance(e, (str, int, float, bool)):
            return
        t = type(e).__name__
        if isinstance(e, A.Ident):
            u.reads.append((e.name, line, False))
            return
        if isinstance(e, A.Index):
            if isinstance(e.base, A.Ident):
                u.reads.append((e.base.name, line, True))
                if e.base.name in DYNAMIC_GATES:
                    u.dynamic_gates.append((e.base.name, line))
            else:
                _expr(e.base, line, u)
            for a2 in e.args:
                _expr(a2, line, u)
            return
        if isinstance(e, A.FuncHandle):
            u.reads.append((e.name, line, True))
            return
        if isinstance(e, A.AnonFunc):
            inner = lower_unit(f"@anon:{line}", [], e.params, [], "anon")
            _expr(e.body, line, inner)
            u.nested.append(inner)
            params = set(e.params)
            for n, ln, call in inner.reads:
                if n not in params:
                    u.reads.append((n, ln, call))
            return
        if isinstance(e, (A.MatrixLit, A.CellLit)):
            for row in e.rows:
                for item in row:
                    _expr(item, line, u)
            return
        for attr in ("left", "right", "operand", "base", "start", "step",
                     "stop", "cond", "value", "body", "dynamic"):
            sub = getattr(e, attr, None)
            if sub is not None and not isinstance(sub, (str, int, float,
                                                        bool, list)):
                _expr(sub, line, u)
        for attr in ("args", "items"):
            sub = getattr(e, attr, None)
            if isinstance(sub, list):
                for x in sub:
                    _expr(x, line, u)

    # main/script unit
    main = lower_unit("<main>", prog.body, [], [], "script")
    asm.units.append(main)
    for fname, fd in (getattr(prog, "functions", {}) or {}).items():
        nested_names = {nf.name for nf in getattr(fd, "nested", []) or []}
        fu = lower_unit(fname, fd.body, fd.params, fd.outs, "function")
        for nf in getattr(fd, "nested", []) or []:
            fu.nested.append(lower_unit(nf.name, nf.body, nf.params,
                                        nf.outs, "function",
                                        captures=fd.params))
        asm.functions[fname] = fu
        asm.units.append(fu)

    # resolve every call site per unit
    for u in asm.units:
        nested_names = {n.name for n in u.nested}
        for name, line, is_call in u.reads:
            if name not in u.calls:
                u.calls[name] = resolve(name, u, nested_names)
    return asm


# --------------------------------------------------------------------------- #
# lints over the assembly
# --------------------------------------------------------------------------- #

def analyze(asm: HirAssembly, registry=None) -> list:
    """Resolution lints: [(line, ident, severity, message)].

    - hir/ShadowedBuiltin: a local assignment shadows a builtin that the
      same program also calls — a classic MATLAB footgun (`sum = 3`)
    - hir/DynamicWorkspace: unit uses eval/assignin/evalin/...; static
      resolution is advisory there (≙ the reference HIR gates)
    - hir/OutputNeverAssigned: a declared function output no statement
      assigns — guaranteed runtime error when the caller requests it
    """
    out: list = []
    called_anywhere = {name for u in asm.units
                       for name, _, is_call in u.reads if is_call}
    for u in asm.units:
        if u.is_dynamic:
            gate, line = u.dynamic_gates[0]
            out.append((line, "hir/DynamicWorkspace", "info",
                        f"'{gate}' makes this workspace dynamic; static "
                        f"name resolution is advisory here"))
        for b in u.bindings.values():
            if b.kind == "local" and registry is not None and \
                    registry.lookup(b.name) is not None and \
                    b.name in called_anywhere:
                out.append((b.line, "hir/ShadowedBuiltin", "info",
                            f"assignment to '{b.name}' shadows the builtin "
                            f"of the same name for the rest of this scope"))
        if u.kind == "function" and not u.is_dynamic:
            for o in u.outs:
                if o == "varargout":
                    continue
                if o not in u.assigned and o not in u.params:
                    out.append((0, "hir/OutputNeverAssigned", "warning",
                                f"output '{o}' of function '{u.name}' is "
                                f"never assigned"))
    return out
