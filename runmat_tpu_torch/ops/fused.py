"""Generated Triton kernels for the lazy DAG's elementwise and reduction
groups: the port's counterpart of the fused executables that the JAX
package's `materialize` gets from `jax.jit` (runmat_tpu/accel/engine.py:
1153-1221), which XLA generated on the TPU. There is no Pallas twin.

`accel/fuse.py` cuts a program into groups and describes each as a `Spec`:
its iteration shape (a logical MATLAB shape), its inputs (logical shape and
dtype), its body (program entries over inputs `("x", k)` and earlier body
values `("v", m)`), the body index of its reduction, if any, and the body
values it writes. `source` turns a Spec into the text of a Python module of
`@triton.jit` kernels; it needs no triton, so the CPU tests run it. `launch`
writes the text under `build/runmat_tpu_torch/fused/`, named by a hash of
it, imports it from there (Triton's `@jit` reads its function's source with
`inspect`, so a string given to `exec` does not compile), and launches.

Two templates, a finishing pass and a one-launch form of the second:

  * map (`map_kernel`): one program a block of BLOCK elements of the
    iteration shape, walked in the order `Spec.perm` names; each input is
    loaded through its own strides (a broadcast dimension gets none, a
    one-element input is one scalar load), so a strided view such as the
    F-order one `rand` returns is read where it lies; each written value is
    stored densely in the walking order. `accel/fuse.py` takes the order
    from the group's first full-size input, so that input is read in its
    own memory order (at the walk's own offset where it is aligned, which
    lets Triton widen its loads) and the outputs get its layout, as
    torch's elementwise kernels give theirs.
  * map-reduce (`part_kernel`, then `fin_kernel`): `sum` or `mean` over
    'all' or over a trailing block of the iteration shape's non-singleton
    dimensions, K segments of R elements. The first kernel runs the same
    prologue over [BK, BR] tiles (segments by reduced elements; [BR, BK]
    where the walking order puts the kept dims inside, a column reduction),
    writes the prologue's values that leave the group, and adds into a tile
    of accumulators; SPLITS programs share each segment, so 16 segments of
    8,294,400 elements (image_normalize.m) fill the card. Each program
    writes one partial a segment; `fin_kernel` sums the partials of a
    segment as one tile in a fixed order (no float atomics: the same result
    on every run), divides for `mean`, and runs the group's epilogue (the
    elementwise ops over the reduced shape, such as `sqrt(... + eps0)`).
  * map-reduce in one launch (`one_kernel`): where `layout` gives SPLITS
    == 1 (one program covers each segment, as for a sum of 1024 values),
    the same loop, then the reduced values, `mean`'s division and the
    epilogue in the same program: one launch and no partials buffer. The
    one partial was the whole sum, so the result is the two kernels' bit
    for bit.

What bounds them on the card: the bytes they move (each input read once,
each output written once, at 3.35 TB/s). The design keeps every
intermediate of a group in registers, so a chain of ops costs one pass over
memory instead of one pass an op.

Numerics follow the eager executor's table (`ops/table.py`
TORCH_UNARY/TORCH_BINARY) with its MATLAB repairs: `pow`'s x^0 = 1 and 1^y
= 1 where pow gives NaN, sign(NaN) = NaN, `min2`/`max2` ignore NaN (as
torch.fmin/fmax), round half away from zero, `mod` and `rem` at 0 and
+-Inf. Transcendentals are libdevice's, never the `.approx`
forms; float32 division is `tl.div_rn` and float64 division IEEE; every
launch passes `enable_fp_fusion=False`, so no multiply and add contract into
an FMA that the eager executor would round twice, and
`enable_reflect_ftz=False`: Triton otherwise builds libdevice to flush
float32 subnormals to zero, which moves ceil(1e-40) from 1 to 0 and
mod(1e-40, -3) from -3 to 1e-40.

A `pow` whose exponent is a one-element input (a scalar of the program,
a 0-d tensor on the card) branches on the exponent's value inside the
kernel: the kernel loads it once, before any loop, in the op's type, and
where it equals 2 computes `a * a`, the correctly rounded square, in place
of libdevice's general `pow` (which held image_normalize's sigma group to
0.28 of its byte bound on an H100). The branch is uniform: every lane of
every program takes the same arm. It needs no NaN repair: a * a is NaN
only where a is, and there a == 1 is false; it gives +Inf at +-Inf and +0
at +-0 as `pow` does. Any other value (image_normalize's gamma of 1.8, a
NaN) takes `_pow`. The value is read on the card, never by the host, so a
plan is not keyed on it and a folded loop's graph replays the right arm
when its exponent changes. An array exponent, a scalar base
(`2 .^ x`) and an exponent computed inside the group keep `_pow`.

A captured CUDA graph replays the arguments it captured, so every operand,
scalars included, is a pointer: a folded loop's scalars are 0-d tensors on
the card. The input pointers and the strides are in `do_not_specialize`:
Triton would otherwise key a compiled kernel on pointer alignment and on
integers divisible by 16, and a view aligned in a loop's eager iteration 0
but not in its capture would compile inside the capture. The exceptions
are the tensors the wrapper allocates (always aligned) and the `dense`
input, which `accel/fuse.py` picks only where it is aligned and never in a
folded loop's body. A launch that would compile while the stream is
capturing raises instead (`MatError`), as does any failure to generate,
compile or launch: nothing falls back to the eager executor.

`launches` counts the generated kernels the card runs, `launches_by` by
kernel: (label, module), the label "fused_map_f32", "fused_reduce_f64",
..., the module that of the group's generated text, so a run can count
each group apart (a map-reduce counts once for its pair of launches or its
one; `by_label` sums a label's). `captured` counts those launched into a graph
being captured (`replayed` adds them once a replay), as `ops/threefry.py`
counts its draws.
"""

from __future__ import annotations

import collections
import hashlib
import importlib.util
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..errors import MatError

_PKG = Path(__file__).resolve().parent.parent
GEN_DIR = _PKG.parent / "build" / "runmat_tpu_torch" / "fused"
# Triton's own cache of compiled kernels, unless the caller names one
TRITON_CACHE = _PKG.parent / "build" / "runmat_tpu_torch" / "triton"

launches = 0
launches_by: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()
compiled: set = set()           # (module, kernel, argument types) compiled
SMS_DEFAULT = 132               # an H100 SXM's multiprocessors

FLOATS = ("float32", "float64")
DTYPES = FLOATS + ("bool",)
_T = {"float32": "tl.float32", "float64": "tl.float64", "bool": "tl.int1"}
BIG = (1 << 31) - (1 << 21)     # index math in int64 from here
# a float64 map of more elements takes 8 warps a block of 1024, unless it
# is one unary op: on an H100 that beat torch.sub on dense_linalg's 4096^2
# map outside the ten-round spread and slowed no main-path group, where 8
# warps slowed resample_pages' lone abs outside its spread
# (fusebench.layout_sweep; PERF.md); float32 maps keep 4
WIDE_MAP = 1 << 20
WIDE_MAP_WARPS = 8

# --------------------------------------------------------------------------- #
# the op table: Triton expressions over operands already in the op's type
# --------------------------------------------------------------------------- #

_LIBDEVICE_UNARY = ("sqrt", "exp", "expm1", "log", "log2", "log10", "log1p",
                    "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                    "cosh", "tanh", "asinh", "acosh", "atanh", "floor",
                    "ceil", "erf")

UNARY = {name: f"libdevice.{name}({{a}})" for name in _LIBDEVICE_UNARY}
UNARY.update({
    "neg": "(-{a})",
    "uplus": "{a}",
    "real": "{a}",
    "conj": "{a}",
    "abs": "tl.abs({a})",
    "sign": "_sign({a})",
    "fix": "libdevice.trunc({a})",
    "round": "libdevice.trunc({a} + tl.where({a} >= 0, 0.5, -0.5))",
    "imag": "(({a} != {a}).to({W}) * 0)",
    "angle": "libdevice.atan2(({a} != {a}).to({W}) * 0, {a})",
    "reciprocal": "{div1}",
    "square": "({a} * {a})",
    "gamma": "_gamma({a})",
    # the four below take their operand as it is, in any class
    "isnan": "({a} != {a})",
    "isinf": "(tl.abs({a}) == _INF)",
    "isfinite": "(tl.abs({a}) < _INF)",
    "logical_not": "({a} == 0)",
})
# a logical operand is never NaN nor infinite
_UNARY_BOOL = {"isinf": "({a} != {a})", "isfinite": "({a} == {a})"}
UNTYPED_UNARY = ("isnan", "isinf", "isfinite", "logical_not")

BINARY = {
    "add": "({a} + {b})",
    "sub": "({a} - {b})",
    "mul": "({a} * {b})",
    "div": "{div}",
    "ldiv": "{rdiv}",
    "pow": "_pow({a}, {b})",
    "atan2": "libdevice.atan2({a}, {b})",
    "hypot": "libdevice.hypot({a}, {b})",
    "mod": "_mod{bits}({a}, {b})",
    "rem": "_rem{bits}({a}, {b})",
    "min2": "_min2({a}, {b})",
    "max2": "_max2({a}, {b})",
    "and": "(({a} != 0) & ({b} != 0))",
    "or": "(({a} != 0) | ({b} != 0))",
    "xor": "(({a} != 0) ^ ({b} != 0))",
    "lt": "({a} < {b})",
    "le": "({a} <= {b})",
    "gt": "({a} > {b})",
    "ge": "({a} >= {b})",
    "eq": "({a} == {b})",
    "ne": "({a} != {b})",
}
_BOOL_BINARY = ("and", "or", "xor", "lt", "le", "gt", "ge", "eq", "ne")
REDUCTIONS = ("sum", "mean")

_PRELUDE = '''"""Generated by runmat_tpu_torch/ops/fused.py: {what}."""
import triton
import triton.language as tl
from triton.language.extra import libdevice

_INF = tl.constexpr(float("inf"))
_NAN = tl.constexpr(float("nan"))
'''

_HELPERS = {
    "_pow": '''
@triton.jit
def _pow(a, b):
    r = libdevice.pow(a, b)
    return tl.where((r != r) & ((b == 0) | (a == 1)), 1.0, r)
''',
    "_sign": '''
@triton.jit
def _sign(a):
    s = (a > 0).to(a.dtype) - (a < 0).to(a.dtype)
    return tl.where(a != a, a, s)
''',
    "_min2": '''
@triton.jit
def _min2(a, b):
    return tl.where(a != a, b, tl.where(b != b, a, tl.minimum(a, b)))
''',
    "_max2": '''
@triton.jit
def _max2(a, b):
    return tl.where(a != a, b, tl.where(b != b, a, tl.maximum(a, b)))
''',
    "_gamma": '''
@triton.jit
def _gamma(a):
    # the divisor in a's type: a * 0 is NaN only where fmod is NaN anyway
    m = libdevice.fmod(a, a * 0 + 2)
    m = tl.where((m != 0) & (m < 0), m + 2.0, m)
    s = tl.where((m >= 1) & (a < 0), -1.0, 1.0)
    return libdevice.exp(libdevice.lgamma(a)) * s
''',
}
for _bits, _div in (("32", "tl.div_rn(a, b)"), ("64", "(a / b)")):
    _HELPERS[f"_mod{_bits}"] = f'''
@triton.jit
def _mod{_bits}(a, b):
    r = a - libdevice.floor({_div}) * b
    r = tl.where(b == 0, a, r)
    inf_b = (tl.abs(b) == _INF) & (tl.abs(a) < _INF)
    same = (a >= 0) == (b > 0)
    return tl.where(inf_b, tl.where((a == 0) | same, a, b), r)
'''
    _HELPERS[f"_rem{_bits}"] = f'''
@triton.jit
def _rem{_bits}(a, b):
    r = a - libdevice.trunc({_div}) * b
    r = tl.where(b == 0, _NAN, r)
    inf_b = (tl.abs(b) == _INF) & (tl.abs(a) < _INF)
    return tl.where(inf_b, a, r)
'''


@dataclass(frozen=True)
class Spec:
    """One group, in the program format's terms (see the module doc).
    `rshape` is the reduction's logical output shape (None for a map);
    `perm` the order in which the kernel walks the non-singleton dims,
    outermost first (None: row-major), which is also the memory order of
    what it writes; `dense` an input that lies densely in that order and
    16-byte aligned, loaded at the walk's own offset (so Triton can widen
    its loads) instead of through its strides."""
    shape: tuple
    inputs: tuple                 # ((logical shape, dtype name), ...)
    body: tuple                   # ((op, static, dtype name, args), ...)
    reduce: Optional[int]
    outputs: tuple                # body indices
    rshape: Optional[tuple] = None
    perm: Optional[tuple] = None
    dense: Optional[int] = None

    @property
    def order(self) -> list:
        return list(self.perm) if self.perm is not None \
            else nonsingleton(self.shape)

    def blocks(self) -> tuple:
        """(kept dims, reduced dims, column) in walking order; column: the
        kept dims are the inner ones (a reduction over leading dims in
        memory order, as mean(imgs, [2 3]) of an F-order draw)."""
        axes = self.body[self.reduce][1][0]
        order = self.order
        kept = [d for d in order if d not in axes]
        red = [d for d in order if d in axes]
        return kept, red, bool(kept and red) and order == red + kept

    @property
    def label(self) -> str:
        """The kernel row's name: template and the dtype it computes in."""
        if self.reduce is not None:
            dt = self.body[self.reduce][2]
            return f"fused_reduce_{'f32' if dt == 'float32' else 'f64'}"
        dts = {self.body[m][2] for m in self.outputs}
        return "fused_map_" + ("f64" if "float64" in dts else
                               "f32" if "float32" in dts else "bool")


def nonsingleton(shape) -> list:
    return [d for d, s in enumerate(shape) if s != 1]


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def trailing_block(shape, axes) -> Optional[tuple]:
    """(K, R) when the reduced non-singleton dimensions of `shape` are a
    trailing block of its non-singleton dimensions (K segments of R
    contiguous row-major elements), else None."""
    ns = nonsingleton(shape)
    red = [d for d in ns if d in axes]
    kept = [d for d in ns if d not in axes]
    if ns != kept + red:
        return None
    return numel([shape[d] for d in kept]), numel([shape[d] for d in red])


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def layout(spec: Spec, sms: int = SMS_DEFAULT) -> dict:
    """Block sizes, grid and, for a map-reduce, the split of each segment."""
    if spec.reduce is None:
        n = numel(spec.shape)
        block = min(1024, max(16, _pow2(n)))
        warps = 4 if block >= 512 else 1
        if n > WIDE_MAP and spec.label == "fused_map_f64" and not (
                len(spec.body) == 1 and spec.body[0][0].startswith("u:")):
            warps = WIDE_MAP_WARPS
        return {"N": n, "BLOCK": block, "grid": (-(-n // block),),
                "num_warps": warps}
    kept, red, col = spec.blocks()
    k = numel([spec.shape[d] for d in kept])
    r = numel([spec.shape[d] for d in red])
    if col:
        bk = max(1, min(_pow2(k), 256))
        br = max(1, min(_pow2(r), 2048 // bk))
    else:
        br = min(2048, max(16, _pow2(r)))
        bk = max(1, min(_pow2(k), 2048 // br))
    kblocks = -(-k // bk)
    chunks = -(-r // br)
    splits = max(1, min(chunks, -(-4 * sms // kblocks)))
    steps = -(-chunks // splits)
    splits = -(-chunks // steps)
    bs = _pow2(splits)
    bkf = max(1, min(_pow2(k), 1024, 4096 // bs))
    return {"K": k, "R": r, "BK": bk, "BR": br, "SPLITS": splits,
            "STEPS": steps, "BS": bs, "BKF": bkf,
            "grid": (kblocks, splits), "fin_grid": (-(-k // bkf),),
            "num_warps": 8 if bk * br >= 2048 else 4,
            "fin_warps": 4 if bs * bkf >= 512 else 1}


# --------------------------------------------------------------------------- #
# code generation
# --------------------------------------------------------------------------- #


def _cast(x: str, frm: str, to: str) -> str:
    if frm == to:
        return x
    if to == "bool":
        return f"({x} != 0)"
    return f"{x}.to({_T[to]})"


def _op_expr(op: str, static: tuple, dt: str, args: list) -> str:
    """One body entry as an expression over `args`: [(name, dtype), ...]."""
    if op.startswith("b:"):
        name = op[2:]
        w = static[0]
        a, b = (_cast(n, d, w) for n, d in args)
        div = "tl.div_rn({x}, {y})" if w == "float32" else "({x} / {y})"
        e = BINARY[name].format(a=a, b=b, bits="32" if w == "float32"
                                else "64", div=div.format(x=a, y=b),
                                rdiv=div.format(x=b, y=a))
        return _cast(e, "bool" if name in _BOOL_BINARY else w, dt)
    if op.startswith("u:"):
        name = op[2:]
        (a, ad), = args
        if name in UNTYPED_UNARY:
            tmpl = _UNARY_BOOL.get(name, UNARY[name]) if ad == "bool" \
                else UNARY[name]
            return _cast(tmpl.format(a=a), "bool", dt)
        a = _cast(a, ad, dt)
        one = f"(({a} != {a}).to({_T[dt]}) * 0 + 1)"
        div1 = f"tl.div_rn({one}, {a})" if dt == "float32" \
            else f"({one} / {a})"
        return UNARY[name].format(a=a, W=_T[dt], div1=div1)
    if op in ("cast", "c:full"):
        (a, ad), = args
        return _cast(a, ad, static[0] if op == "cast" else dt)
    raise MatError("RunMat:fusedKernel", f"no generated form of '{op}'")


def _linspace(static, dt: str, args: list, lin: str) -> str:
    """`_linspace` of the engine: start*(1-s) + stop*s, s = i/(n-1) in the
    node's dtype, and the stop value exactly at i = n-1."""
    (s0, d0), (s1, d1) = args
    s0, s1 = _cast(s0, d0, dt), _cast(s1, d1, dt)
    div = static[0] - 1
    i = f"{lin}.to({_T[dt]})"
    den = f"(({lin} != {lin}).to({_T[dt]}) * 0 + {div})"
    s = f"tl.div_rn({i}, {den})" if dt == "float32" else f"({i} / {den})"
    return (f"tl.where({lin} == {div}, {s1}, {s0} * (1 - {s}) + {s1} * "
            f"{s})")


def _index_lines(shape, dims, src: str, prefix: str) -> list:
    """`{prefix}{d}` for the dims `dims` of `shape` (in order) from `src`,
    a row-major linear index over those dims."""
    lines = []
    t = src
    for j in range(len(dims) - 1, -1, -1):
        d = dims[j]
        if j == 0:
            lines.append(f"{prefix}{d} = {t}")
        else:
            lines.append(f"{prefix}{d} = {t} % {shape[d]}")
            lines.append(f"{prefix}q{d} = {t} // {shape[d]}")
            t = f"{prefix}q{d}"
    return lines


class _Gen:
    """The text of one Spec's module."""

    def __init__(self, spec: Spec, big: bool, sms: int):
        self.spec, self.big = spec, big
        self.lay = layout(spec, sms)
        self.helpers: set = set()
        self.red = spec.reduce
        n = len(spec.body)
        self.pre = list(range(n if self.red is None else self.red))
        self.epi = [] if self.red is None else list(range(self.red + 1, n))
        # body index -> input k of each pow whose exponent is a one-element
        # input: it branches on the exponent's value (see the module doc)
        self.square = {
            m: args[1][1] for m, (op, static, _, args) in enumerate(spec.body)
            if op == "b:pow" and static[0] in FLOATS and args[1][0] == "x"
            and not nonsingleton(spec.inputs[args[1][1]][0])
            and args[1][1] != spec.dense}

    def _uses(self, members) -> list:
        """The inputs `members` read, but not a branching pow's exponent,
        which `exponents` loads."""
        ks = []
        for m in members:
            for j, (kind, k) in enumerate(self.spec.body[m][3]):
                if kind == "x" and k not in ks and \
                        (j == 0 or m not in self.square):
                    ks.append(k)
        return ks

    def exponents(self, members) -> list:
        """Before any loop: each branching pow's exponent in the op's type,
        and whether it is 2."""
        lines = []
        for m in members:
            if m in self.square:
                k = self.square[m]
                e = _cast(f"tl.load(x{k})", self.spec.inputs[k][1],
                          self.spec.body[m][1][0])
                lines += [f"e{m} = {e}", f"sq{m} = e{m} == 2"]
        return lines

    def stride_args(self) -> list:
        return [f"s{k}_{d}" for k, (ls, _) in enumerate(self.spec.inputs)
                for d in nonsingleton(ls)]

    def strided(self, ks) -> bool:
        """Whether an input of `ks` is loaded through its strides."""
        return any(nonsingleton(self.spec.inputs[k][0]) and
                   k != self.spec.dense for k in ks)

    def loads(self, ks, prefix: str, mask: str, val: str) -> list:
        lines = []
        for k in ks:
            ls = self.spec.inputs[k][0]
            terms = [f"{prefix}{d} * s{k}_{d}" for d in nonsingleton(ls)]
            if k == self.spec.dense:
                lines.append(f"{val}{k} = tl.load(x{k} + lin, mask={mask})")
            elif not terms:
                lines.append(f"{val}{k} = tl.load(x{k})")
            else:
                lines.append(f"{val}{k} = tl.load(x{k} + ({' + '.join(terms)}"
                             f"), mask={mask})")
        return lines

    def body(self, members, val: str, lin: str) -> list:
        lines = []
        for m in members:
            op, static, dt, args = self.spec.body[m]
            named = [(f"{val}{k}", self.spec.inputs[k][1]) if kind == "x"
                     else (f"v{k}", self.spec.body[k][2])
                     for kind, k in args]
            if m in self.square:
                w = static[0]
                a = _cast(*named[0], w)
                self.helpers.add("_pow")
                lines += [f"if sq{m}:",
                          f"    v{m} = {_cast(f'({a} * {a})', w, dt)}",
                          "else:",
                          f"    v{m} = {_cast(f'_pow({a}, e{m})', w, dt)}"]
                continue
            e = _linspace(static, dt, named, lin) if op == "c:linspace" \
                else _op_expr(op, static, dt, named)
            self.helpers.update(h for h in _HELPERS if h + "(" in e)
            lines.append(f"v{m} = {e}")
        return lines

    def def_line(self, name: str, args: list, consts: list) -> list:
        """The kernel's head. The written tensors (allocated here, so
        always aligned) and the dense input keep Triton's alignment
        specialisation; nothing else is specialised."""
        dns = ", ".join(f'"{a}"' for a in args if a.startswith(("x", "s"))
                        and a != f"x{self.spec.dense}")
        return [f"@triton.jit(do_not_specialize=[{dns}])",
                f"def {name}({', '.join(args + [c + ': tl.constexpr' for c in consts])}):"]

    def map_kernel(self) -> list:
        spec, lay = self.spec, self.lay
        ins = [f"x{k}" for k in range(len(spec.inputs))]
        outs = [f"y{j}" for j in range(len(spec.outputs))]
        head = self.def_line("map_kernel", ins + outs + self.stride_args(),
                             ["BLOCK"])
        pid = "tl.program_id(0).to(tl.int64)" if self.big \
            else "tl.program_id(0)"
        b = [f"lin = {pid} * BLOCK + tl.arange(0, BLOCK)",
             f"mask = lin < {lay['N']}"]
        ks = self._uses(self.pre)
        b += self.exponents(self.pre)
        if self.strided(ks):
            b += _index_lines(spec.shape, spec.order, "lin", "i")
        b += self.loads(ks, "i", "mask", "a")
        b += self.body(self.pre, "a", "lin")
        for j, m in enumerate(spec.outputs):
            b.append(f"tl.store(y{j} + lin, v{m}, mask=mask)")
        return head + ["    " + x for x in b]

    def accumulate(self, branching) -> list:
        """The map-reduce's tile loop (unindented lines): the prologue over
        [BK, BR] tiles, its written values stored, the reduced value added
        into `acc`; before it, the exponents of the pows in `branching`."""
        spec, lay = self.spec, self.lay
        _, static, acc_dt, ((kind, src),) = spec.body[self.red]
        pre_out = [m for m in spec.outputs if m in self.pre]
        i64 = ".to(tl.int64)" if self.big else ""
        kept, red, col = spec.blocks()
        # a tile of BK kept by BR reduced elements; in a column reduction
        # the kept ones are inner in memory and make the tile's rows
        kax, rax, tile = ("[None, :]", "[:, None]", "[BR, BK]") if col \
            else ("[:, None]", "[None, :]", "[BK, BR]")
        b = [f"kk = (tl.program_id(0) * BK + tl.arange(0, BK){kax}){i64}",
             f"rb = tl.program_id(1){i64} * {lay['STEPS']}",
             f"kmask = kk < {lay['K']}"]
        b += _index_lines(spec.shape, kept, "kk", "i")
        b += self.exponents(branching)
        b.append(f"acc = tl.zeros({tile}, dtype={_T[acc_dt]})")
        b.append(f"for step in range({lay['STEPS']}):")
        loop = [f"rr = (rb + step) * BR + tl.arange(0, BR){rax}{i64}",
                f"mask = kmask & (rr < {lay['R']})"]
        loop += _index_lines(spec.shape, red, "rr", "i")
        loop.append(f"lin = rr * {lay['K']} + kk" if col
                    else f"lin = kk * {lay['R']} + rr")
        loop += self.loads(self._uses(self.pre + [self.red]), "i", "mask",
                           "a")
        loop += self.body(self.pre, "a", "lin")
        for m in pre_out:
            loop.append(f"tl.store(y{spec.outputs.index(m)} + lin, v{m}, "
                        f"mask=mask)")
        v, vd = (f"a{src}", spec.inputs[src][1]) if kind == "x" \
            else (f"v{src}", spec.body[src][2])
        loop.append(f"acc += tl.where(mask, {_cast(v, vd, acc_dt)}, 0.0)")
        return b + ["    " + x for x in loop]

    def part_kernel(self) -> list:
        spec, lay = self.spec, self.lay
        ins = [f"x{k}" for k in range(len(spec.inputs))]
        outs = [f"y{spec.outputs.index(m)}" for m in spec.outputs
                if m in self.pre]
        head = self.def_line("part_kernel",
                             ins + outs + ["part"] + self.stride_args(),
                             ["BK", "BR"])
        b = self.accumulate(self.pre)
        b += ["kk1 = tl.program_id(0) * BK + tl.arange(0, BK)",
              f"tl.store(part + tl.program_id(1) * {lay['K']} + kk1, "
              f"tl.sum(acc, axis={0 if spec.blocks()[2] else 1}), "
              f"mask=kk1 < {lay['K']})"]
        return head + ["    " + x for x in b]

    def one_kernel(self) -> list:
        """A map-reduce whose segments one program each covers (SPLITS ==
        1): `part_kernel`'s loop, then the reduced values, `mean`'s
        division and the epilogue as `fin_kernel` computes them, in one
        launch and with no partials buffer."""
        spec, lay = self.spec, self.lay
        ins = [f"x{k}" for k in range(len(spec.inputs))]
        outs = [f"y{j}" for j in range(len(spec.outputs))]
        head = self.def_line("one_kernel", ins + outs + self.stride_args(),
                             ["BK", "BR"])
        b = self.accumulate(self.pre + self.epi)
        b += ["ko = tl.program_id(0) * BK + tl.arange(0, BK)",
              f"komask = ko < {lay['K']}",
              f"v{self.red} = tl.sum(acc, axis="
              f"{0 if spec.blocks()[2] else 1})"]
        b += self.finish("ko", "komask", "BK", "j", [])
        return head + ["    " + x for x in b]

    def fin_kernel(self) -> list:
        spec, lay = self.spec, self.lay
        ins = [f"x{k}" for k in range(len(spec.inputs))]
        outs = [f"y{spec.outputs.index(m)}" for m in spec.outputs
                if m not in self.pre]
        head = self.def_line("fin_kernel",
                             ["part"] + ins + outs + self.stride_args(),
                             ["BKF", "BS"])
        b = ["kk = tl.program_id(0) * BKF + tl.arange(0, BKF)",
             f"kmask = kk < {lay['K']}",
             "ss = tl.arange(0, BS)[:, None]",
             f"p = tl.load(part + ss * {lay['K']} + kk[None, :], "
             f"mask=(ss < {lay['SPLITS']}) & kmask[None, :], other=0.0)",
             f"v{self.red} = tl.sum(p, axis=0)"]
        b += self.finish("kk", "kmask", "BKF", "i", self.epi)
        return head + ["    " + x for x in b]

    def finish(self, kk: str, kmask: str, width: str, prefix: str,
               branching) -> list:
        """From the reduced values `v{red}` over the kept indices `kk` (a
        block of `width`): `mean`'s division, the exponents of the pows in
        `branching`, the epilogue and the stores of what it writes."""
        spec, lay = self.spec, self.lay
        name, _, acc_dt, _ = spec.body[self.red]
        b = []
        if name == "r:mean":
            r = lay["R"]
            b.append(f"v{self.red} = tl.div_rn(v{self.red}, tl.full("
                     f"[{width}], {r}, tl.float32))" if acc_dt == "float32"
                     else f"v{self.red} = v{self.red} / {r}.0")
        ks = self._uses(self.epi)
        b += self.exponents(branching)
        if any(nonsingleton(spec.inputs[k][0]) for k in ks):
            b += _index_lines(spec.rshape, spec.blocks()[0], kk, prefix)
        b += self.loads(ks, prefix, kmask, "b")
        b += self.body(self.epi, "b", kk)
        for m in spec.outputs:
            if m not in self.pre:
                b.append(f"tl.store(y{spec.outputs.index(m)} + {kk}, v{m}, "
                         f"mask={kmask})")
        return b

    def text(self) -> str:
        spec = self.spec
        ops = " ".join(b[0] for b in spec.body)
        kernels = [self.map_kernel()] if self.red is None else \
            [self.one_kernel()] if self.lay["SPLITS"] == 1 else \
            [self.part_kernel(), self.fin_kernel()]
        parts = [_PRELUDE.format(what=f"{spec.label} over "
                                 f"{'x'.join(map(str, spec.shape))}: {ops}")]
        parts += [_HELPERS[h] for h in sorted(self.helpers)]
        for k in kernels:
            parts.append("\n\n" + "\n".join(k) + "\n")
        return "".join(parts)


def source(spec: Spec, big: bool = False, sms: int = SMS_DEFAULT) -> str:
    """The text of `spec`'s kernel module; deterministic, no triton
    needed."""
    return _Gen(spec, big, sms).text()


# --------------------------------------------------------------------------- #
# compiling and launching
# --------------------------------------------------------------------------- #

_modules: dict = {}
_kernels: dict = {}             # (spec, big, device) -> (module, layout)
_options: dict = {}             # launch options this triton takes


def _triton():
    """triton, imported at first use; a card machine without it raises.
    The launch options: no FMA contraction, and no flush of subnormals in
    libdevice (Triton's `enable_reflect_ftz`, where this triton has it),
    as the eager executor computes."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE))
    try:
        import triton
        from triton.backends.nvidia.compiler import CUDAOptions
    except ImportError as e:
        raise MatError("RunMat:fusedKernel",
                       f"the fused kernels need triton on the card: {e}") \
            from e
    if not _options:
        _options["enable_fp_fusion"] = False
        if "enable_reflect_ftz" in CUDAOptions.__dataclass_fields__:
            _options["enable_reflect_ftz"] = False
    return triton


def module(text: str):
    """The module of a generated text: written once under GEN_DIR, named by
    a hash of the text, imported from there."""
    h = hashlib.sha256(text.encode()).hexdigest()[:20]
    mod = _modules.get(h)
    if mod is not None:
        return mod
    _triton()
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    path = GEN_DIR / f"fused_{h}.py"
    if not path.exists():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)
    name = f"runmat_fused_{h}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    _modules[h] = mod
    return mod


def _run(mod, kernel: str, grid, args: list, consts: dict,
         num_warps: int) -> None:
    """One launch. Raises before it would compile inside a capture."""
    import torch
    sig = (mod.__name__, kernel) + tuple(
        (str(a.dtype), a.data_ptr() % 16 == 0) if isinstance(a, torch.Tensor)
        else ("i64" if abs(a) >= 1 << 31 else "i32") for a in args)
    if sig not in compiled and torch.cuda.is_current_stream_capturing():
        raise MatError("RunMat:fusedKernel",
                       f"{kernel} of {mod.__name__} would compile inside a "
                       f"CUDA graph capture")
    getattr(mod, kernel)[grid](*args, **consts, num_warps=num_warps,
                               **_options)
    compiled.add(sig)


def _prepared(spec: Spec, big: bool, device) -> tuple:
    """The module and layout of a Spec on a device, made once."""
    import torch
    key = (spec, big, device)
    got = _kernels.get(key)
    if got is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = _kernels[key] = (module(source(spec, big, sms)),
                               layout(spec, sms))
    return got


def launch(spec: Spec, inputs: list, strides: list, outputs: list,
           device) -> None:
    """Run `spec` on the card: `inputs` the operand tensors (physical
    shapes), `strides[k]` the element strides of input k along the
    non-singleton dims of its logical shape, `outputs` allocated tensors in
    `spec.outputs` order, dense in the walking order. Any failure raises
    MatError."""
    global launches
    import torch
    try:
        big = numel(spec.shape) >= BIG or any(
            sum((s - 1) * abs(st) for s, st in zip(
                [spec.inputs[k][0][d] for d in nonsingleton(
                    spec.inputs[k][0])], strides[k])) >= BIG
            for k in range(len(inputs)))
        mod, lay = _prepared(spec, big, device)
        flat = [s for st in strides for s in st]
        if spec.reduce is None:
            _run(mod, "map_kernel", lay["grid"], inputs + outputs + flat,
                 {"BLOCK": lay["BLOCK"]}, lay["num_warps"])
        elif lay["SPLITS"] == 1:
            _run(mod, "one_kernel", lay["grid"], inputs + outputs + flat,
                 {"BK": lay["BK"], "BR": lay["BR"]}, lay["num_warps"])
        else:
            acc = torch.float32 if spec.body[spec.reduce][2] == "float32" \
                else torch.float64
            part = torch.empty(lay["SPLITS"] * lay["K"], dtype=acc,
                               device=device)
            pre = [o for o, m in zip(outputs, spec.outputs)
                   if m < spec.reduce]
            post = [o for o, m in zip(outputs, spec.outputs)
                    if m >= spec.reduce]
            _run(mod, "part_kernel", lay["grid"],
                 inputs + pre + [part] + flat,
                 {"BK": lay["BK"], "BR": lay["BR"]}, lay["num_warps"])
            _run(mod, "fin_kernel", lay["fin_grid"],
                 [part] + inputs + post + flat,
                 {"BKF": lay["BKF"], "BS": lay["BS"]}, lay["fin_warps"])
    except MatError:
        raise
    except Exception as e:      # boundary: generate, compile or launch
        raise MatError("RunMat:fusedKernel",
                       f"{spec.label} failed: {type(e).__name__}: "
                       f"{str(e)[-1500:]}") from e
    key = (spec.label, mod.__name__)
    if torch.cuda.is_current_stream_capturing():
        captured[key] += 1
    else:
        launches += 1
        launches_by[key] += 1


def replayed(kernels: collections.Counter, times: int) -> None:
    """A captured graph holding `kernels` ran `times` times."""
    global launches
    for key, k in kernels.items():
        launches += k * times
        launches_by[key] += k * times


def by_label(counts) -> collections.Counter:
    """Counts keyed by (label, module), as `launches_by`, summed by label."""
    out = collections.Counter()
    for (label, _), k in counts.items():
        out[label] += k
    return out
