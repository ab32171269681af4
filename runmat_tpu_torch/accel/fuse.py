"""The fusion plan: a program of `TorchEngine` cut into groups that run as
generated Triton kernels (`ops/fused.py`) and ops that run eagerly.

The JAX package traces a whole program into one `jax.jit` executable and
leaves fusion to XLA (runmat_tpu/accel/engine.py:1153-1221). The port
decides it here, once a program structure: `plan(program, out_idx)` takes
the entries of `TorchEngine._build_program` (op, static, dtype, input
indices, input shapes, logical output shape) and returns a `Plan` that the
engine keeps in `_jit_cache` under the JAX package's key (the DAG's
`structure_key` and the output positions), so a reused plan is a cache hit
as a reused executable is there.

A group is a connected set of entries in the code generator's table with one
iteration shape (a logical MATLAB shape); every input broadcasts to it by
implicit expansion:
  * `b:`/`u:` ops computing in float32 or float64 (comparisons and
    logicals give logical values), `cast` between the float classes and
    logical, `c:full` and `c:linspace`;
  * at most one `r:sum` or `r:mean` with the default NaN mode over 'all'
    or a trailing block of the iteration shape's non-singleton dims, after
    which the group takes only ops over the reduced shape (its epilogue).
Entries join in program order: an entry joins the group of the first of its
inputs whose group takes it, unless that would make a cycle (an input from
outside the group that depends on the group); else it starts a group. Two
groups of one shape without a reduction that meet at an entry merge, under
the same rule (so `sin(x) .* exp(-x)` of a leaf x is one kernel). An
entry that is read outside its group or is a program output is a group
output, so workspace values come out of the same pass, as the JAX package's
extra outputs do.

Every other entry runs through `TorchEngine._exec` as before and is counted
(`stats["eager_ops"]`, `eager_by_op`), with its reason in `Plan.eager`:
RNG draws, indexing, structural ops, scans, sorts and matmul are eager by
design; complex values (Triton has no complex type: "complex operand",
checked first), integer classes (saturating arithmetic), NaN modes other
than the default, reductions over other axes and empty arrays stay eager
in this slice.

`run_group_plain` is the plain version of a group: its entries through the
same `_exec` (`ops/table.py` TORCH_BINARY/TORCH_UNARY, `_reduce_impl`).
`run_group` runs a group: on CPU tensors the plain version, on CUDA
tensors the generated kernel, which raises on any failure. At its first
launch a group fixes how its kernel walks the iteration shape and which
input it reads densely (`_walk`); a later launch whose input no longer
lies so reads it through its strides.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import torch

from ..ops import fused

class Group:
    """Entries of one generated kernel, `members` in program order: the
    prologue, then the reduction `reduce` (a program index) if any, then
    its epilogue over the reduced shape `rshape`."""

    def __init__(self, gid: int, shape: tuple):
        self.gid = gid
        self.shape = tuple(shape)
        self.members: list = []
        self.reduce: Optional[int] = None     # program index
        self.rshape: Optional[tuple] = None
        self.inputs: list = []
        self.outputs: list = []
        self.spec: Optional[fused.Spec] = None
        # the spec as first launched, with the walking order and dense
        # input it chose (`_walk`); kept so that every later launch (a graph
        # capture too) compiles nothing new
        self.launch: Optional[fused.Spec] = None
        self.in_loop = False

    @property
    def label(self) -> str:
        return self.spec.label


class Plan:
    """`steps`: ("eager", i) or ("group", Group), in an order that runs
    every input first; `frees[s]`: the entries whose last reader is step
    s; `eager`: (program index, op, reason) of every eager entry."""

    def __init__(self, steps, frees, groups, eager):
        self.steps, self.frees = steps, frees
        self.groups, self.eager = groups, eager

    @property
    def kernels(self) -> list:
        return [g.label for g in self.groups]


def _dtype(program, j) -> str:
    return str(program[j][2])


def decline(program: list, i: int) -> Optional[str]:
    """None if entry i is in the code generator's table, else why not."""
    op, static, dt, ins, in_shapes, out_shape = program[i]
    head = op.split(":")[0] + ":" if ":" in op else op
    if head not in ("b:", "u:", "r:", "c:") and op != "cast":
        return "not elementwise"
    if any(fused.numel(s) == 0 for s in (out_shape,) + tuple(in_shapes)):
        return "empty array"
    dts = [str(dt)] + [_dtype(program, j) for j in ins]
    if op.startswith("b:") or op == "cast":
        dts.append(str(static[0]))
    if any(d.startswith("complex") for d in dts):
        # Triton has no complex type: complex groups stay eager
        return "complex operand"
    if op.startswith("b:"):
        if op[2:] not in fused.BINARY:
            return "op not in the code generator's table"
    elif op.startswith("u:"):
        if op[2:] not in fused.UNARY:
            return "op not in the code generator's table"
    elif op.startswith("r:"):
        if op[2:] not in fused.REDUCTIONS:
            return "reduction not in the code generator's table"
        if static[1] != "":
            return f"NaN mode {static[1]!r}"
        if fused.trailing_block(in_shapes[0], static[0]) is None:
            return "reduction over non-trailing axes"
        if str(dt) not in fused.FLOATS:
            return f"{dt} reduction"
    elif op == "cast":
        pass
    elif op == "c:linspace":
        if static[0] < 2 or str(dt) not in fused.FLOATS:
            return "linspace of fewer than 2 points"
    elif op != "c:full":
        return "op not in the code generator's table"
    odd = [d for d in dts if d not in fused.DTYPES]
    if odd:
        return f"{odd[0]} operand (integer classes saturate)"
    return None


def _takes(g: Group, program: list, i: int, group_of: list) -> bool:
    """Whether group g can take entry i (shapes only)."""
    op, _, _, ins, in_shapes, out_shape = program[i]
    if op.startswith("r:"):
        return g.reduce is None and tuple(in_shapes[0]) == g.shape
    if g.reduce is None:
        return tuple(out_shape) == g.shape
    # the epilogue reads no value of the prologue
    return tuple(out_shape) == g.rshape and all(
        group_of[j] is not g or j >= g.reduce for j in ins)


def plan(program: list, out_idx, in_loop: bool = False) -> Plan:
    """The groups and eager entries of `program` (the rules in the module
    doc), in an order to run them; `out_idx` the entries returned;
    `in_loop` for a folded loop's body (see `_walk`)."""
    n = len(program)
    group_of: list = [None] * n
    deps: list = [frozenset()] * n      # group ids each entry depends on
    alias: dict = {}                    # a merged group's id -> its host's
    groups: list = []
    next_gid = 0
    eager = []

    def find(gid: int) -> int:
        while gid in alias:
            gid = alias[gid]
        return gid

    def free_of(gids: set, members) -> bool:
        """No input from outside `members` depends on the groups `gids`:
        joining them makes no cycle."""
        inside = set(members)
        return all(k in inside or not any(find(x) in gids for x in deps[k])
                   for m in inside for k in program[m][3])

    for i, (op, static, dt, ins, in_shapes, out_shape) in enumerate(program):
        if op in ("__leaf__", "scalar"):
            continue
        d = set()
        for j in ins:
            d |= deps[j]
            if group_of[j] is not None:
                d.add(group_of[j].gid)
        deps[i] = frozenset(d)
        reason = decline(program, i)
        if reason is not None:
            eager.append((i, op, reason))
            continue
        cands = []
        for j in ins:
            h = group_of[j]
            if h is not None and h not in cands and \
                    _takes(h, program, i, group_of):
                cands.append(h)
        g = next((h for h in cands if free_of({h.gid}, h.members + [i])),
                 None)
        if g is None:
            shape = in_shapes[0] if op.startswith("r:") else out_shape
            g = Group(next_gid, shape)
            g.in_loop = in_loop
            next_gid += 1
            groups.append(g)
        elif g.reduce is None:
            # two chains of the same shape that meet here become one
            for h in cands:
                if h is not g and h.reduce is None and h.shape == g.shape \
                        and free_of({g.gid, h.gid},
                                    g.members + h.members + [i]):
                    alias[h.gid] = g.gid
                    for m in h.members:
                        group_of[m] = g
                    g.members = sorted(g.members + h.members)
                    groups.remove(h)
        g.members.append(i)
        group_of[i] = g
        if op.startswith("r:"):
            g.reduce = i
            g.rshape = tuple(out_shape)
    for k, g in enumerate(groups):
        g.gid = k
    outs = set(out_idx)
    readers: dict = {}
    for i, entry in enumerate(program):
        for j in entry[3]:
            readers.setdefault(j, set()).add(i)
    for g in groups:
        mem = set(g.members)
        for i in g.members:
            for j in program[i][3]:
                if j not in mem and j not in g.inputs:
                    g.inputs.append(j)
        g.outputs = [i for i in g.members
                     if i in outs or readers.get(i, set()) - mem]
        g.spec = _spec(program, g)
    steps = _order(program, groups, group_of, eager)
    last: dict = {}
    for s, (kind, unit) in enumerate(steps):
        for j in (unit.inputs if kind == "group" else program[unit][3]):
            last[j] = s
    frees = [[] for _ in steps]
    for j, s in last.items():
        if j not in outs:
            frees[s].append(j)
    return Plan(steps, frees, groups, eager)


def _spec(program: list, g: Group) -> fused.Spec:
    local = {j: ("x", k) for k, j in enumerate(g.inputs)}
    local.update({i: ("v", m) for m, i in enumerate(g.members)})
    body = tuple((program[i][0], program[i][1], str(program[i][2]),
                  tuple(local[j] for j in program[i][3]))
                 for i in g.members)
    return fused.Spec(
        shape=g.shape,
        inputs=tuple((tuple(program[j][5]), _dtype(program, j))
                     for j in g.inputs),
        body=body,
        reduce=None if g.reduce is None else g.members.index(g.reduce),
        outputs=tuple(g.members.index(i) for i in g.outputs),
        rshape=g.rshape)


def _order(program: list, groups: list, group_of: list, eager: list) -> list:
    """Groups and eager entries in an order that runs every input first;
    among those ready, the one whose first entry comes first."""
    units = {("group", g.gid): (g.members[0], g) for g in groups}
    units.update({("eager", i): (i, i) for i, _, _ in eager})

    def unit(j):
        if group_of[j] is not None:
            return ("group", group_of[j].gid)
        return ("eager", j) if ("eager", j) in units else None

    need = {}
    users: dict = {}
    for key, (_, u) in units.items():
        members = u.members if key[0] == "group" else [u]
        pre = {unit(j) for m in members for j in program[m][3]} - {None, key}
        need[key] = len(pre)
        for p in pre:
            users.setdefault(p, []).append(key)
    ready = [(first, key) for key, (first, _) in units.items()
             if need[key] == 0]
    heapq.heapify(ready)
    steps = []
    while ready:
        _, key = heapq.heappop(ready)
        steps.append((key[0], units[key][1]))
        for u in users.get(key, []):
            need[u] -= 1
            if need[u] == 0:
                heapq.heappush(ready, (units[u][0], u))
    return steps


def run_group_plain(eng, g: Group, program: list, args: list) -> list:
    """The group's entries through the eager executor, in order."""
    env = dict(zip(g.inputs, args))
    last = {}
    for i in g.members:
        for j in program[i][3]:
            last[j] = i
    keep = set(g.outputs)
    for i in g.members:
        op, static, dt, ins, in_shapes, out_shape = program[i]
        env[i] = eng._exec(op, static, dt, [env[j] for j in ins], in_shapes,
                           out_shape)
        for j in set(ins):      # an op may read one value twice (d .* d)
            if last[j] == i and j not in keep and j not in g.inputs:
                del env[j]
    return [env[i] for i in g.outputs]


def _operand(t: torch.Tensor, lshape: tuple):
    """An input in its physical shape and its element strides along the
    non-singleton dims of its logical shape."""
    from .engine import phys_shape
    ph = phys_shape(tuple(lshape))
    if tuple(t.shape) != ph:
        t = t.reshape(ph)
    ns = fused.nonsingleton(lshape)
    if not ns:
        return t, []
    if t.dim() == len(lshape):
        return t, [t.stride(d) for d in ns]
    return t, [t.stride(0)]


def _lies_dense(spec: fused.Spec, st: list, ls) -> bool:
    """Whether an input of logical shape `ls` with strides `st` along its
    non-singleton dims has the full iteration shape and lies densely in
    the order `spec` walks."""
    if tuple(ls) != tuple(spec.shape):
        return False
    stride = dict(zip(fused.nonsingleton(ls), st))
    step = 1
    for d in reversed(spec.order):
        if stride[d] != step:
            return False
        step *= spec.shape[d]
    return True


def _walk(spec: fused.Spec, prepared: list, in_loop: bool) -> fused.Spec:
    """The spec a group keeps for every launch, from its first. It walks
    its first input of the full iteration shape in that input's memory
    order where that input is dense and the order keeps a reduction's dims
    in one block, else row-major; it loads that input at the walk's own
    offset (`dense`) where it is also 16-byte aligned. Not in a folded
    loop's body: a capture there must find compiled the kernel iteration 0
    compiled, whatever the layout of the carry iteration 0 started from."""
    ns = fused.nonsingleton(spec.shape)
    for k, ((t, st), (ls, _)) in enumerate(zip(prepared, spec.inputs)):
        if tuple(ls) != tuple(spec.shape):
            continue
        stride = dict(zip(ns, st))
        order = tuple(sorted(ns, key=lambda d: -stride[d]))
        walked = dataclasses.replace(
            spec, perm=None if list(order) == ns else order)
        if not _lies_dense(walked, st, ls):
            return spec
        if spec.reduce is not None and walked.perm is not None:
            kept, red, col = walked.blocks()
            if list(order) != kept + red and not col:
                return spec
        if in_loop or t.data_ptr() % 16:
            return walked
        return dataclasses.replace(walked, dense=k)
    return spec


def _empty(shape: tuple, order: list, dtype, device) -> torch.Tensor:
    """A tensor of logical `shape`, in its physical shape, whose memory
    runs through the non-singleton dims in `order`."""
    from .engine import phys_shape
    rest = [d for d in range(len(shape)) if d not in order]
    full = list(order) + rest
    t = torch.empty([shape[d] for d in full], dtype=dtype, device=device)
    t = t.permute(*sorted(range(len(full)), key=full.__getitem__))
    return t.reshape(phys_shape(tuple(shape)))


def run_group(eng, g: Group, program: list, args: list) -> list:
    """Run one group: the plain version on CPU tensors, the generated
    kernel on CUDA tensors."""
    from .engine import torch_dtype
    dev = args[0].device
    if dev.type == "cpu":
        return run_group_plain(eng, g, program, args)
    prepared = [_operand(t, ls) for t, (ls, _) in zip(args, g.spec.inputs)]
    if g.launch is None:
        g.launch = _walk(g.spec, prepared, g.in_loop)
    spec = g.launch
    if spec.dense is not None:
        t, st = prepared[spec.dense]
        if t.data_ptr() % 16 or not _lies_dense(spec, st,
                                                spec.inputs[spec.dense][0]):
            spec = dataclasses.replace(spec, dense=None)
    kept = spec.blocks()[0] if spec.reduce is not None else None
    outs = []
    for m in spec.outputs:
        i = g.members[m]
        shape = tuple(program[i][5])
        order = spec.order if spec.reduce is None or m < spec.reduce \
            else [d for d in kept if d < len(shape) and shape[d] != 1]
        outs.append(_empty(shape, order, torch_dtype(program[i][2]), dev))
    fused.launch(spec, [t for t, _ in prepared], [s for _, s in prepared],
                 outs, dev)
    return outs


def snapshot(key, entry) -> Optional[dict]:
    """One `_jit_cache` entry as JaxEngine.fusion_snapshot describes it
    (runmat_tpu/accel/engine.py:1907-1933): a folded loop by its body's
    ops, a materialized DAG by its structure key's entries (leaf and
    scalar markers included, as there) and its output count. A `while`
    fold is "device_while" here; the JAX package's snapshot files it as a
    fused executable with no ops. The port
    adds the generated kernels and the eager ops of a plan."""
    if not isinstance(key, tuple) or not key:
        return None
    if key[0] in ("device_loop", "device_while"):
        ops = [e[0] for e, kind, _ in key[1] if kind == "op"]
        return {"kind": key[0], "ops": ops, "n_ops": len(ops)}
    skey, outs = key[0], key[1]
    # a draw's counter is one int64 scalar here and two uint32 scalars
    # (lo, hi) in the JAX package's DAG: listed as the two
    counters = {j for e in skey if isinstance(e[0], str)
                and e[0].startswith("rng:") for j in e[2]}
    ops = []
    for j, e in enumerate(skey):
        if isinstance(e, tuple) and e and isinstance(e[0], str):
            ops += [e[0]] * (2 if j in counters else 1)
    out = {"kind": "fused_elementwise", "ops": ops[:64], "n_ops": len(ops),
           "n_outputs": max(len(outs), 1)}
    if isinstance(entry, Plan):
        out["kernels"] = entry.kernels
        out["eager"] = [op for _, op, _ in entry.eager]
    return out
