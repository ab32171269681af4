"""Copy of runmat_tpu/analysis.py in the PyTorch port.

Static analysis: AST lints powering `check` and the LSP.

Reference parity: runmat-static-analysis (`analyze_source`,
crates/runmat-static-analysis/src/frontend.rs:137-192 + lints/shape.rs) —
diagnostics beyond parse errors: unknown identifiers (neither variable nor
function), unused variables, unreachable code after return/break/continue,
literal-matrix row-width mismatches. Each finding carries (line, severity,
identifier, message).
"""

from __future__ import annotations

from dataclasses import dataclass

from .frontend import ast as A

_CONSTANTS = {"ans", "pi", "inf", "Inf", "nan", "NaN", "eps", "true", "false",
              "i", "j", "varargin", "varargout", "nargin", "nargout", "end"}


@dataclass
class Finding:
    line: int
    severity: str            # "error" | "warning" | "info"
    identifier: str
    message: str


def _expr_idents(e, out: list, lits: list):
    """Collect (name, is_called) identifier reads + matrix literals."""
    if e is None or isinstance(e, (str, int, float, bool)):
        return
    if isinstance(e, A.Ident):
        out.append((e.name, False))
        return
    if isinstance(e, A.Index):
        if isinstance(e.base, A.Ident):
            out.append((e.base.name, True))
        else:
            _expr_idents(e.base, out, lits)
        for a in e.args:
            _expr_idents(a, out, lits)
        return
    if isinstance(e, A.FuncHandle):
        out.append((e.name, True))
        return
    if isinstance(e, A.AnonFunc):
        inner: list = []
        _expr_idents(e.body, inner, lits)
        params = set(e.params)
        out.extend((n, c) for n, c in inner if n not in params)
        return
    if isinstance(e, (A.MatrixLit, A.CellLit)):
        if isinstance(e, A.MatrixLit):
            lits.append(e)
        for row in e.rows:
            for item in row:
                _expr_idents(item, out, lits)
        return
    for attr in ("left", "right", "operand", "base", "start", "step", "stop",
                 "dynamic", "rhs", "cond", "body"):
        v = getattr(e, attr, None)
        if isinstance(v, A.Node):
            _expr_idents(v, out, lits)
    for attr in ("args",):
        v = getattr(e, attr, None)
        if isinstance(v, list):
            for item in v:
                _expr_idents(item, out, lits)


def _lhs_names(lhs) -> list[tuple[str, bool]]:
    """(name, is_plain_binding) for an lvalue expression."""
    if isinstance(lhs, A.Ident):
        return [(lhs.name, True)]
    base = lhs
    while isinstance(base, (A.Index, A.FieldAccess)):
        base = base.base
    if isinstance(base, A.Ident):
        return [(base.name, False)]   # indexed write: also a read of the base
    return []


def analyze_source(source: str, name: str = "<input>") -> list[Finding]:
    from .errors import MatError
    from .frontend.parser import parse
    from .runtime import registry

    findings: list[Finding] = []
    try:
        prog = parse(source, name)
    except MatError as e:
        findings.append(Finding(getattr(e, "line", 0) or 0, "error",
                                e.identifier, e.message))
        return findings

    registry.ensure_loaded()
    func_names = set(prog.functions) | set(prog.classes)

    def is_callable(n: str) -> bool:
        return registry.lookup(n) is not None or n in func_names or \
            n in _CONSTANTS

    units = [("<script>", prog.body, [], [], prog.is_function_file)]
    for fname, fd in prog.functions.items():
        units.append((fname, fd.body, list(fd.params), list(fd.outs), True))

    for unit_name, body, params, outs, _is_fn in units:
        assigned: dict[str, int] = {p: -1 for p in params}
        for o in outs:
            assigned.setdefault(o, -1)
        used: set[str] = set()

        def note_reads(e, line):
            reads: list = []
            lits: list = []
            _expr_idents(e, reads, lits)
            for n, called in reads:
                used.add(n)
                if n not in assigned and not is_callable(n):
                    findings.append(Finding(
                        line, "warning",
                        "RunMat:check:UnknownIdentifier",
                        f"'{n}' is used but is neither a variable assigned "
                        f"earlier nor a known function."))
                    assigned.setdefault(n, -1)   # report once
            for lit in lits:
                rows = lit.rows
                if rows and all(all(isinstance(x, (A.Num, A.Str))
                                    for x in r) for r in rows):
                    # char literals concatenate by length; only check all-Num
                    if all(all(isinstance(x, A.Num) for x in r) for r in rows):
                        widths = {len(r) for r in rows}
                        if len(widths) > 1:
                            findings.append(Finding(
                                line, "error", "RunMat:check:ShapeMismatch",
                                "Matrix literal rows have different lengths."))

        def scan(stmts):
            terminated_at = None
            for s in stmts:
                line = getattr(s, "line", 0) or 0
                if terminated_at is not None:
                    findings.append(Finding(
                        line, "warning", "RunMat:check:Unreachable",
                        "Code after return/break/continue is unreachable."))
                    terminated_at = None
                if isinstance(s, A.ExprStmt):
                    note_reads(s.expr, line)
                elif isinstance(s, A.Assign):
                    note_reads(s.rhs, line)
                    if not isinstance(s.lhs, A.Ident):
                        note_reads(s.lhs, line)
                    for n, plain in _lhs_names(s.lhs):
                        if not plain and n not in assigned and \
                                not is_callable(n):
                            pass   # indexed write to new name auto-creates
                        assigned.setdefault(n, line)
                        if not plain:
                            used.add(n)
                elif isinstance(s, A.MultiAssign):
                    note_reads(s.rhs, line)
                    for t in s.lhs:
                        if t is None:
                            continue
                        for n, plain in _lhs_names(t):
                            assigned.setdefault(n, line)
                            if not plain:
                                used.add(n)
                elif isinstance(s, A.For):
                    note_reads(s.expr, line)
                    assigned.setdefault(s.var, line)
                    used.add(s.var)
                    scan(s.body)
                elif isinstance(s, A.While):
                    note_reads(s.cond, line)
                    scan(s.body)
                elif isinstance(s, A.If):
                    for cond, blk in s.branches:
                        note_reads(cond, line)
                        scan(blk)
                    if s.else_body:
                        scan(s.else_body)
                elif isinstance(s, A.Switch):
                    note_reads(s.expr, line)
                    for _case, blk in s.cases:
                        scan(blk)
                    if s.otherwise:
                        scan(s.otherwise)
                elif isinstance(s, A.TryCatch):
                    scan(s.body)
                    if s.catch_var:
                        assigned.setdefault(s.catch_var, line)
                        used.add(s.catch_var)
                    scan(s.catch_body)
                elif isinstance(s, (A.Global, A.Persistent)):
                    for n in s.names:
                        assigned.setdefault(n, -1)
                        used.add(n)
                elif isinstance(s, (A.Return, A.Break, A.Continue)):
                    terminated_at = line

        scan(body)

        # unused-variable lint applies to function bodies only: a script's
        # final workspace is its output (matching MATLAB's Code Analyzer)
        if unit_name != "<script>":
            for n, line in assigned.items():
                if n not in used and n not in outs and n not in params and \
                        line > 0:
                    findings.append(Finding(
                        line, "info", "RunMat:check:UnusedVariable",
                        f"Variable '{n}' is assigned but never used "
                        f"(function '{unit_name}')."))

    # shape/class fact propagation (≙ HIR/MIR fact lattice,
    # runmat-hir/src/lib.rs:16-44): catches mismatches built from variables
    from .facts import analyze_facts
    seen = {(f.line, f.identifier) for f in findings}
    for line, ident, msg in analyze_facts(prog):
        if (line, ident) in seen:
            continue
        seen.add((line, ident))
        findings.append(Finding(line, "warning" if ident.endswith(
            ("DimMismatch", "InnerDim")) else "error", ident, msg))

    # HIR resolution lints (builtin shadowing, dynamic-workspace gates,
    # never-assigned outputs — ≙ runmat-hir resolution + entrypoint policy)
    from .frontend import hir
    try:
        asm = hir.lower(prog, registry=registry)
        for line, ident, sev, msg in hir.analyze(asm, registry=registry):
            if (line, ident) in seen:
                continue
            seen.add((line, ident))
            findings.append(Finding(line, sev, ident, msg))
    except Exception:
        pass   # resolution lints are advisory; never block check

    # MIR dataflow lints (CFG unreachable blocks, maybe-undefined-on-a-path,
    # dead stores in functions, spawn-capture mutation — ≙ runmat-mir
    # analysis/{dataflow,spawn_safety}.rs)
    try:
        from .vm.compiler import Compiler
        from .vm import mir
        compiled = Compiler.compile_program(prog, name)
        for line, ident, msg in mir.analyze_program(compiled):
            if (line, ident) in seen:
                continue
            seen.add((line, ident))
            sev = "info" if ident in ("mir/DeadStore",
                                      "mir/SpawnCaptureMutated") else "warning"
            findings.append(Finding(line, sev, ident, msg))
    except MatError:
        pass   # compile errors surface when the script actually runs

    findings.sort(key=lambda f: (f.line, f.identifier, f.message))
    return findings
