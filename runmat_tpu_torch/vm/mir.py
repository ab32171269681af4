"""Copy of runmat_tpu/vm/mir.py in the PyTorch port.

MIR: control-flow graph + dataflow analyses over compiled bytecode.

Reference parity: runmat-mir (crates/runmat-mir/src/{lib.rs,lowering/,
analysis/{dataflow,store,facts,spawn_safety}.rs}) — the reference lowers HIR
into a basic-block CFG and runs dataflow (reaching definitions, liveness),
a per-block fact store, and spawn-safety analysis; results feed the bytecode
compiler, the lints, and the fusion planner. Here the CFG is derived from the
compiled bytecode itself — the ISA is this repo's single IR below the AST, so
building blocks over it yields the same analyses with one fewer lowering,
and every analysis stays valid by construction as the compiler evolves.

Public surface:
  build_mir(code)            -> MirUnit (blocks, preds/succs, def/use tables)
  reaching_definitions(unit) -> per-block IN sets of (name, def_pc)
  liveness(unit)             -> per-block live-in/live-out name sets
  analyze_code(code)         -> lint findings (unreachable blocks, dead
                                stores, maybe-undefined uses in functions,
                                spawn-capture mutation)
  format_mir(unit)           -> printable CFG dump (cli `check --mir`)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import bytecode as B


# --------------------------------------------------------------------------- #
# def/use extraction per instruction
# --------------------------------------------------------------------------- #

def defs_uses(instr, consts) -> tuple[list, list]:
    """Variable names defined / used by one instruction.

    STORE_INDEX/STORE_PATH both read and write their base (MATLAB
    read-modify-write slice assignment). MAKE_ANON uses its free names — the
    closure captures their current values at that pc (≙ the reference's
    capture analysis in runmat-hir lowering).
    """
    op, a, b, c, d = instr
    if op == B.STORE:
        return [a], []
    if op in (B.STORE_INDEX, B.STORE_PATH):
        return [a], [a]
    if op == B.FOR_NEXT:
        return [a], []
    if op in (B.LOAD, B.LOADC, B.PUSH_IXCTX_VAR, B.DISPLAY_VAR):
        return [], [a]
    if op == B.RESOLVE_CALL:
        return [], [a]        # var-index or call on `a`
    if op == B.GLOBAL_DECL or op == B.PERSIST_DECL:
        return list(a), []
    if op == B.TRY_PUSH and b:
        return [b], []        # catch var binds on entry to the handler
    if op == B.MAKE_ANON:
        anon = consts[a]
        return [], list(getattr(anon, "free_names", ()) or ())
    return [], []


# --------------------------------------------------------------------------- #
# CFG construction
# --------------------------------------------------------------------------- #

@dataclass
class Block:
    index: int
    start: int                # first pc (inclusive)
    end: int                  # last pc (exclusive)
    succs: list = field(default_factory=list)
    preds: list = field(default_factory=list)


@dataclass
class MirUnit:
    code: B.Code
    blocks: list               # [Block]
    block_of: list             # pc -> block index
    # per-block summaries for dataflow
    gen_defs: list             # [set[(name, pc)]]  last def per name in block
    kill_names: list           # [set[name]] names defined in block
    use_before_def: list       # [set[name]] upward-exposed uses
    defs_by_name: dict         # name -> set[pc]

    @property
    def entry(self) -> int:
        return 0


def _succ_pcs(code: B.Code, pc: int):
    op, a, b, c, d = code.instrs[pc]
    n = len(code.instrs)
    if op == B.JMP:
        return [a]
    if op in (B.JMP_IF_FALSE, B.JMP_IF_TRUE):
        return [t for t in (pc + 1, a) if t < n]
    if op == B.FOR_NEXT:
        return [t for t in (pc + 1, b) if t < n]
    if op == B.TRY_PUSH:
        # exceptional edge into the handler + normal fallthrough
        return [t for t in (pc + 1, a) if t < n]
    if op == B.RET:
        return []
    return [pc + 1] if pc + 1 < n else []


def build_mir(code: B.Code) -> MirUnit:
    instrs = code.instrs
    n = len(instrs)
    leaders = {0} if n else set()
    for pc in range(n):
        op = instrs[pc][0]
        succs = _succ_pcs(code, pc)
        if op in (B.JMP, B.JMP_IF_FALSE, B.JMP_IF_TRUE, B.FOR_NEXT,
                  B.TRY_PUSH, B.RET):
            for t in succs:
                leaders.add(t)
            if pc + 1 < n:
                leaders.add(pc + 1)
    order = sorted(leaders)
    blocks = []
    block_of = [0] * n
    for bi, start in enumerate(order):
        end = order[bi + 1] if bi + 1 < len(order) else n
        blocks.append(Block(bi, start, end))
        for pc in range(start, end):
            block_of[pc] = bi
    for blk in blocks:
        if blk.end > blk.start:
            for t in _succ_pcs(code, blk.end - 1):
                ti = block_of[t]
                if ti not in blk.succs:
                    blk.succs.append(ti)
    for blk in blocks:
        for s in blk.succs:
            blocks[s].preds.append(blk.index)

    gen_defs, kill_names, ubd = [], [], []
    defs_by_name: dict = {}
    for blk in blocks:
        last_def: dict = {}
        upward: set = set()
        for pc in range(blk.start, blk.end):
            d, u = defs_uses(instrs[pc], code.consts)
            for name in u:
                if name not in last_def:
                    upward.add(name)
            for name in d:
                last_def[name] = pc
                defs_by_name.setdefault(name, set()).add(pc)
        gen_defs.append({(name, pc) for name, pc in last_def.items()})
        kill_names.append(set(last_def))
        ubd.append(upward)
    return MirUnit(code, blocks, block_of, gen_defs, kill_names, ubd,
                   defs_by_name)


# --------------------------------------------------------------------------- #
# dataflow: reaching definitions + liveness (worklist over the CFG)
# --------------------------------------------------------------------------- #

def reaching_definitions(unit: MirUnit, entry_defs=()) -> list:
    """IN set per block of (name, def_pc); def_pc=-1 marks an entry binding
    (function parameter). (≙ runmat-mir/src/analysis/dataflow.rs)"""
    nb = len(unit.blocks)
    ins = [set() for _ in range(nb)]
    outs = [set() for _ in range(nb)]
    entry = {(name, -1) for name in entry_defs}
    work = list(range(nb))
    while work:
        bi = work.pop()
        blk = unit.blocks[bi]
        in_set = set(entry) if bi == unit.entry else set()
        for p in blk.preds:
            in_set |= outs[p]
        out_set = {(nm, pc) for (nm, pc) in in_set
                   if nm not in unit.kill_names[bi]} | unit.gen_defs[bi]
        changed = out_set != outs[bi]
        ins[bi], outs[bi] = in_set, out_set
        if changed:
            for s in blk.succs:
                if s not in work:
                    work.append(s)
    return ins


def definite_assignment(unit: MirUnit, entry_defs=()) -> list:
    """MUST-analysis IN set per block: names assigned on EVERY path from
    entry (meet = intersection; complements the MAY reaching-defs above).
    Drives the maybe-used-before-defined lint."""
    nb = len(unit.blocks)
    all_names = set(unit.defs_by_name) | set(entry_defs)
    ins = [set(all_names) for _ in range(nb)]     # top = everything
    outs = [set(all_names) for _ in range(nb)]
    ins[unit.entry] = set(entry_defs)
    work = list(range(nb))
    while work:
        bi = work.pop()
        blk = unit.blocks[bi]
        if bi == unit.entry:
            in_set = set(entry_defs)
        else:
            in_set = set(all_names)
            for p in blk.preds:
                in_set &= outs[p]
            if not blk.preds:
                in_set = set(entry_defs)
        out_set = in_set | unit.kill_names[bi]
        changed = out_set != outs[bi] or in_set != ins[bi]
        ins[bi], outs[bi] = in_set, out_set
        if changed:
            for s in blk.succs:
                if s not in work:
                    work.append(s)
    return ins


def liveness(unit: MirUnit, exit_live=()) -> tuple[list, list]:
    """Backward liveness; `exit_live` seeds names live at RET (function
    outputs, globals). Returns (live_in, live_out) per block."""
    nb = len(unit.blocks)
    live_in = [set() for _ in range(nb)]
    live_out = [set() for _ in range(nb)]
    exit_set = set(exit_live)
    work = list(range(nb))
    while work:
        bi = work.pop()
        blk = unit.blocks[bi]
        out = set() if blk.succs else set(exit_set)
        for s in blk.succs:
            out |= live_in[s]
        inn = unit.use_before_def[bi] | (out - unit.kill_names[bi])
        changed = inn != live_in[bi]
        live_in[bi], live_out[bi] = inn, out
        if changed:
            for p in blk.preds:
                if p not in work:
                    work.append(p)
    return live_in, live_out


def unreachable_blocks(unit: MirUnit) -> list:
    """Block indices not reachable from entry (CFG-accurate — catches code
    after `error(...)`-style terminators only when the compiler emits real
    jumps; complements the AST-level return/break lint)."""
    seen = set()
    stack = [unit.entry] if unit.blocks else []
    while stack:
        bi = stack.pop()
        if bi in seen:
            continue
        seen.add(bi)
        stack.extend(unit.blocks[bi].succs)
    return [b.index for b in unit.blocks if b.index not in seen]


# --------------------------------------------------------------------------- #
# lints over the dataflow results
# --------------------------------------------------------------------------- #

_SIDE_EFFECT_DISPLAY = 4   # STORE display operand position (op, name, display)


def analyze_code(code: B.Code, extra_entry_defs=()) -> list:
    """Dataflow lints for one compiled unit. Returns [(line, ident, msg)].

    - mir/UnreachableBlock: CFG-unreachable code
    - mir/MaybeUndefined: a use in a FUNCTION body that some path reaches
      with no prior definition (scripts are skipped: the workspace may
      predefine anything — ≙ the reference entrypoint policy)
    - mir/DeadStore: a store in a function whose value no path can read
    - mir/SpawnCaptureMutated: a variable captured by an anonymous function
      passed to spawn/parfeval is reassigned afterwards — the task sees the
      captured copy (COW), which commonly surprises (≙ runmat-mir/src/
      analysis/spawn_safety.rs)
    """
    from ..runtime import registry

    findings: list = []
    unit = build_mir(code)
    instrs = code.instrs
    lines = code.lines

    for bi in unreachable_blocks(unit):
        blk = unit.blocks[bi]
        for pc in range(blk.start, blk.end):
            if instrs[pc][0] not in (B.RET, B.JMP, B.CHECK_INTERRUPT,
                                     B.FOR_POP, B.TRY_POP, B.POP):
                findings.append((lines[pc] if pc < len(lines) else 0,
                                 "mir/UnreachableBlock",
                                 "this code is unreachable"))
                break

    is_fn = not code.is_script
    if is_fn:
        entry = set(code.params) | set(extra_entry_defs) | {"varargin"}
        must = definite_assignment(unit, entry_defs=entry)
        reported: set = set()
        for blk in unit.blocks:
            defined = set(must[blk.index])
            for pc in range(blk.start, blk.end):
                d, u = defs_uses(instrs[pc], code.consts)
                if instrs[pc][0] in (B.STORE_INDEX, B.STORE_PATH):
                    # indexed assignment auto-grows from undefined (legal
                    # MATLAB first assignment) — a def, not a risky use
                    u = []
                for name in u:
                    if name in defined or name in reported:
                        continue
                    if name not in unit.defs_by_name:
                        continue   # never assigned: a call (AST lint covers)
                    if registry.lookup(name) is not None or \
                            name in ("nargin", "nargout", "ans", "end"):
                        continue
                    # assigned somewhere, but not on every path to this use
                    reported.add(name)
                    findings.append((lines[pc] if pc < len(lines) else 0,
                                     "mir/MaybeUndefined",
                                     f"'{name}' may be used before it is "
                                     f"defined on some execution path"))
                defined.update(d)

        exit_live = set(code.outs) | {"varargout"}
        # globals/persistents outlive the call
        for pc in range(len(instrs)):
            op, a, *_ = instrs[pc]
            if op in (B.GLOBAL_DECL, B.PERSIST_DECL):
                exit_live |= set(a)
        _, live_out = liveness(unit, exit_live=exit_live)
        for blk in unit.blocks:
            live = set(live_out[blk.index])
            for pc in range(blk.end - 1, blk.start - 1, -1):
                op, a, b_, c_, d_ = instrs[pc]
                d, u = defs_uses(instrs[pc], code.consts)
                if op == B.STORE and a not in live and not b_ and \
                        a not in exit_live:
                    findings.append((lines[pc] if pc < len(lines) else 0,
                                     "mir/DeadStore",
                                     f"value assigned to '{a}' is never read"))
                live -= set(d)
                live |= set(u)

    # spawn-capture mutation: a MAKE_ANON feeding spawn/parfeval whose free
    # names are redefined at any pc CFG-reachable after the capture
    spawn_pcs = [pc for pc, ins_ in enumerate(instrs)
                 if ins_[0] == B.RESOLVE_CALL and ins_[1] in ("spawn",
                                                              "parfeval")]
    if spawn_pcs:
        reach_after: dict = {}

        def pcs_after(pc0: int) -> set:
            if pc0 in reach_after:
                return reach_after[pc0]
            seen: set = set()
            stack = list(_succ_pcs(code, pc0))
            while stack:
                p = stack.pop()
                if p in seen:
                    continue
                seen.add(p)
                stack.extend(_succ_pcs(code, p))
            reach_after[pc0] = seen
            return seen

        for pc, ins_ in enumerate(instrs):
            if ins_[0] != B.MAKE_ANON:
                continue
            if not any(sp > pc for sp in spawn_pcs):
                continue
            anon = code.consts[ins_[1]]
            for name in getattr(anon, "free_names", ()) or ():
                later = {dp for dp in unit.defs_by_name.get(name, ())
                         if dp in pcs_after(pc)}
                if later:
                    findings.append((lines[pc] if pc < len(lines) else 0,
                                     "mir/SpawnCaptureMutated",
                                     f"'{name}' is captured by a task but "
                                     f"reassigned afterwards; the task sees "
                                     f"the value captured here (copy-on-"
                                     f"write)"))
                    break
    return findings


def analyze_program(prog: B.CompiledProgram) -> list:
    out = list(analyze_code(prog.main))
    for fn in prog.functions.values():
        out.extend(analyze_code(fn))
        for nested in fn.nested.values():
            out.extend(analyze_code(nested, extra_entry_defs=fn.params))
    return out


# --------------------------------------------------------------------------- #
# debug dump
# --------------------------------------------------------------------------- #

def format_mir(code: B.Code) -> str:
    unit = build_mir(code)
    live_in, live_out = liveness(
        unit, exit_live=set(code.outs) if not code.is_script else ())
    parts = [f"mir {code.name}: {len(unit.blocks)} blocks, "
             f"{len(code.instrs)} instrs"]
    for blk in unit.blocks:
        parts.append(f"bb{blk.index} [{blk.start}..{blk.end}) "
                     f"preds={blk.preds} succs={blk.succs} "
                     f"live_in={sorted(live_in[blk.index])} "
                     f"live_out={sorted(live_out[blk.index])}")
        for pc in range(blk.start, blk.end):
            op, a, b, c, d = code.instrs[pc]
            opname = B.OPNAMES.get(op, str(op))
            ops = " ".join(str(x) for x in (a, b, c) if x is not None)
            parts.append(f"  {pc:4d}  {opname} {ops}".rstrip())
    return "\n".join(parts)
