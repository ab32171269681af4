"""Copy of runmat_tpu/runtime/builtins/symbolic.py in the PyTorch port.

Symbolic math: sym/syms, algebra, calculus, solve, substitution.

Reference parity: runmat-builtins symbolic scalars/arrays
(runmat-builtins/src/symbolic.rs, runtime builtins/math/symbolic). The
expression engine is sympy (bundled in this environment), wrapped in MATLAB
Symbolic-Toolbox semantics — the same layering as arrays-on-numpy.
"""

from __future__ import annotations

import numpy as np


class _LazySympy:
    """Defers the ~0.9 s sympy import until the first symbolic builtin runs
    (it dominates Session() cold-start otherwise; every `sp.` use below is
    inside a function body, so module import stays cheap)."""
    _mod = None

    def __getattr__(self, name):
        if _LazySympy._mod is None:
            import sympy
            _LazySympy._mod = sympy
        return getattr(_LazySympy._mod, name)


sp = _LazySympy()

from ...errors import MatError, bad_arg
from ...values import CellArray, MatArray, is_text, normalize_shape, text_of
from ..registry import builtin


class SymValue:
    __slots__ = ("exprs", "shape", "shared")
    mclass = "sym"

    def __init__(self, exprs, shape=(1, 1)):
        self.exprs = np.asarray(exprs, dtype=object).reshape(shape)
        self.shape = tuple(shape)
        self.shared = False

    @property
    def size(self):
        return self.exprs.size

    @staticmethod
    def scalar(e):
        return SymValue(np.array([[e]], dtype=object))

    def map(self, fn):
        out = np.empty(self.shape, dtype=object)
        flat_in = self.exprs.reshape(-1)
        flat_out = out.reshape(-1)
        for i in range(flat_in.size):
            flat_out[i] = fn(flat_in[i])
        return SymValue(out, self.shape)

    def copy(self):
        return SymValue(self.exprs.copy(), self.shape)


def _to_sym(v):
    if isinstance(v, SymValue):
        return v
    if isinstance(v, MatArray):
        if v.mclass == "char":
            return SymValue.scalar(sp.sympify(v.to_str()))
        h = v.host()
        out = np.empty(h.shape, dtype=object)
        fo = out.reshape(-1)
        for i, x in enumerate(h.reshape(-1)):
            fo[i] = sp.nsimplify(float(x), rational=True) if x == int(x) \
                else sp.Float(float(x))
        return SymValue(out, h.shape)
    raise bad_arg("sym", "Cannot convert value to sym.")


def _zip2(a: SymValue, b: SymValue, fn) -> SymValue:
    if a.size == 1:
        a = SymValue(np.broadcast_to(a.exprs, b.shape).copy(), b.shape)
    if b.size == 1:
        b = SymValue(np.broadcast_to(b.exprs, a.shape).copy(), a.shape)
    if a.shape != b.shape:
        raise MatError("MATLAB:dimagree", "Matrix dimensions must agree.")
    out = np.empty(a.shape, dtype=object)
    fa, fb, fo = (x.reshape(-1) for x in (a.exprs, b.exprs, out))
    for i in range(fa.size):
        fo[i] = fn(fa[i], fb[i])
    return SymValue(out, a.shape)


def sym_binary(op, a, b):
    """Dispatch hook for arithmetic with sym operands; None if not sym."""
    if not (isinstance(a, SymValue) or isinstance(b, SymValue)):
        return None
    sa, sb = _to_sym(a), _to_sym(b)
    fns = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
           "mul": lambda x, y: x * y, "div": lambda x, y: x / y,
           "pow": lambda x, y: x ** y,
           "eq": lambda x, y: sp.Eq(x, y), "ne": lambda x, y: sp.Ne(x, y),
           "lt": lambda x, y: sp.Lt(x, y), "le": lambda x, y: sp.Le(x, y),
           "gt": lambda x, y: sp.Gt(x, y), "ge": lambda x, y: sp.Ge(x, y)}
    fn = fns.get(op)
    if fn is None:
        raise MatError("MATLAB:sym:badOp", f"Operation '{op}' undefined for sym.")
    return _zip2(sa, sb, fn)


def sym_unary(op, a):
    if not isinstance(a, SymValue):
        return None
    fns = {"neg": lambda x: -x, "uplus": lambda x: x}
    named = {"sin": sp.sin, "cos": sp.cos, "tan": sp.tan, "exp": sp.exp,
             "log": sp.log, "sqrt": sp.sqrt, "abs": sp.Abs}
    if op in fns:
        return a.map(fns[op])
    if op in named:
        return a.map(named[op])
    raise MatError("MATLAB:sym:badOp", f"Operation '{op}' undefined for sym.")


@builtin("sym", category="math/symbolic", min_in=1, max_in=1)
def m_sym(x):
    if is_text(x):
        return SymValue.scalar(sp.Symbol(text_of(x)))
    return _to_sym(x)


@builtin("syms", category="math/symbolic", min_in=1, max_in=None, pass_ctx=True)
def m_syms(*names, ctx=None):
    for n in names:
        nm = text_of(n)
        ctx.frame.vars[nm] = SymValue.scalar(sp.Symbol(nm))
    return None


@builtin("diff_sym", category="math/symbolic", min_in=1, max_in=3)
def m_diff_sym(e, var=None, n=None):
    return _diff(e, var, n)


def _diff(e, var=None, n=None):
    se = _to_sym(e)
    order = int(var2num(n)) if n is not None else 1
    v = _to_sym(var).exprs.reshape(-1)[0] if var is not None else None
    def d(x):
        sv = v if v is not None else (sorted(x.free_symbols, key=str)[0]
                                      if x.free_symbols else sp.Symbol("x"))
        return sp.diff(x, sv, order)
    return se.map(d)


def var2num(v):
    return float(v.host().reshape(-1)[0])


@builtin("int_sym", category="math/symbolic", min_in=1, max_in=4)
def m_int_sym(e, var=None, a=None, b=None):
    se = _to_sym(e)
    v = _to_sym(var).exprs.reshape(-1)[0] if var is not None else None
    def ii(x):
        sv = v if v is not None else (sorted(x.free_symbols, key=str)[0]
                                      if x.free_symbols else sp.Symbol("x"))
        if a is not None and b is not None:
            lo = _to_sym(a).exprs.reshape(-1)[0]
            hi = _to_sym(b).exprs.reshape(-1)[0]
            return sp.integrate(x, (sv, lo, hi))
        return sp.integrate(x, sv)
    return se.map(ii)


@builtin("simplify", category="math/symbolic", min_in=1, max_in=1)
def m_simplify(e):
    if not isinstance(e, SymValue):
        return e
    return e.map(sp.simplify)


@builtin("expand", category="math/symbolic", min_in=1, max_in=1)
def m_expand(e):
    return _to_sym(e).map(sp.expand)


@builtin("factor_sym", category="math/symbolic", min_in=1, max_in=1)
def m_factor_sym(e):
    """factor: numeric scalars get MATLAB's prime-factor row vector;
    symbolic inputs get the polynomial factorization."""
    from ...values import MatArray as _MA
    if isinstance(e, _MA) and not e.is_complex and e.size == 1:
        import numpy as _np
        v = float(_np.asarray(e.host()).reshape(-1)[0])
        if v == int(v) and v >= 1:
            n = int(v)
            out = []
            d = 2
            while d * d <= n:
                while n % d == 0:
                    out.append(float(d))
                    n //= d
                d += 1
            if n > 1:
                out.append(float(n))
            if not out:
                out = [1.0]
            return _MA(_np.array([out]), "double")
    return _to_sym(e).map(sp.factor)


@builtin("subs", category="math/symbolic", min_in=3, max_in=3)
def m_subs(e, old, new):
    """subs(e, old, new) — old/new may be arrays for simultaneous
    substitution (subs(e, [a b], [1 2]))."""
    se = _to_sym(e)
    ovs = list(_to_sym(old).exprs.reshape(-1))
    nvs = list(_to_sym(new).exprs.reshape(-1))
    if len(nvs) == 1 and len(ovs) > 1:
        nvs = nvs * len(ovs)
    if len(ovs) != len(nvs):
        raise bad_arg("subs", "OLD and NEW must have the same number of elements.")
    pairs = list(zip(ovs, nvs))
    return se.map(lambda x: x.subs(pairs, simultaneous=True))


@builtin("solve_sym", category="math/symbolic", min_in=1, max_in=2,
         pass_nargout=True)
def m_solve_sym(e, var=None, nargout=1):
    se = _to_sym(e)
    expr = se.exprs.reshape(-1)[0]
    v = _to_sym(var).exprs.reshape(-1)[0] if var is not None else \
        (sorted(expr.free_symbols, key=str)[0] if expr.free_symbols else None)
    sols = sp.solve(expr, v)
    out = np.empty((len(sols), 1), dtype=object)
    for i, s_ in enumerate(sols):
        out[i, 0] = s_
    return SymValue(out, (len(sols), 1))


@builtin("vpa", category="math/symbolic", min_in=1, max_in=2)
def m_vpa(e, digits=None):
    d = int(var2num(digits)) if digits is not None else 32
    return _to_sym(e).map(lambda x: sp.N(x, d))


@builtin("double_sym", category="math/symbolic", min_in=1, max_in=1)
def m_double_sym(e):
    return sym_to_double(e)


def sym_to_double(e):
    if not isinstance(e, SymValue):
        raise bad_arg("double", "Expected sym.")
    out = np.empty(e.shape, dtype=np.complex128)
    fo = out.reshape(-1)
    for i, x in enumerate(e.exprs.reshape(-1)):
        val = complex(sp.N(x))
        fo[i] = val
    if np.all(out.imag == 0):
        return MatArray(out.real.copy(), "double")
    return MatArray(out, "double")


@builtin("pretty", category="math/symbolic", min_in=1, max_in=1, pass_ctx=True)
def m_pretty(e, ctx=None):
    if isinstance(e, SymValue):
        for x in e.exprs.reshape(-1):
            ctx.session.write(sp.pretty(x) + "\n")
    return None


@builtin("issym", category="math/symbolic", min_in=1, max_in=1)
def m_issym(e):
    return MatArray.logical_scalar(isinstance(e, SymValue))


def sym_display(v: SymValue) -> str:
    flat = v.exprs.reshape(-1)
    if flat.size == 1:
        return "    " + str(flat[0])
    return "\n".join("    " + str(x) for x in flat[:12])


from ..registry import register_alias

register_alias("int", "int_sym")
register_alias("solve", "solve_sym")
register_alias("factor", "factor_sym")
