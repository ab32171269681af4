"""Copy of runmat_tpu/runtime/builtins/optim2.py in the PyTorch port.

Optimization batch 2: unconstrained/nonlinear-least-squares/linear/conic
solvers and options.

Reference parity: runmat-runtime/src/builtins/math/optim/{fminunc,fsolve,
linprog,lsqcurvefit,lsqnonlin,optimoptions,coneprog,secondordercone}.rs.
Solver cores use host scipy.optimize (the reference's host-native solver
code); objective callbacks run through the interpreter so MATLAB function
handles work.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError
from ...values import MatArray, StructArray, is_text, text_of
from ..registry import builtin
from .ode_optim import _callf, _col, _sc


def _np_fn(ctx, f, shape_like=None):
    """Wrap a MATLAB handle as numpy vec -> numpy vec."""

    def fn(x: np.ndarray) -> np.ndarray:
        xa = MatArray(np.asarray(x, dtype=np.float64).reshape(-1, 1), "double")
        r = _callf(ctx, f, [xa])
        return r.host().astype(np.float64).reshape(-1)

    return fn


def _opt_get(opts, name, default):
    if isinstance(opts, StructArray) and name in opts.fields:
        v = opts.get_scalar_field(name)
        if isinstance(v, MatArray) and v.size == 1 and v.mclass != "char":
            return float(v.host().reshape(-1)[0])
        return v
    return default


@builtin("optimoptions", category="math/optim", min_in=1)
def m_optimoptions(solver, *args):
    fields = {
        "Solver": MatArray.char_from_str(text_of(solver) if is_text(solver) else "fminunc"),
        "Display": MatArray.char_from_str("off"),
        "MaxIterations": MatArray.scalar(400.0),
        "MaxFunctionEvaluations": MatArray.scalar(100 * 6.0),
        "OptimalityTolerance": MatArray.scalar(1e-6),
        "StepTolerance": MatArray.scalar(1e-10),
        "FunctionTolerance": MatArray.scalar(1e-6),
    }
    i = 0
    args = list(args)
    while i + 1 < len(args):
        fields[text_of(args[i])] = args[i + 1]
        i += 2
    return StructArray.scalar(fields)


@builtin("fminunc", category="math/optim", min_in=2, max_in=3, pass_ctx=True,
         pass_nargout=True)
def m_fminunc(f, x0, opts=None, ctx=None, nargout=1):
    from scipy import optimize as so
    fn = _np_fn(ctx, f)
    x_init = _col(x0)
    maxit = int(_opt_get(opts, "MaxIterations", 400))
    res = so.minimize(lambda x: float(fn(x)[0]), x_init, method="BFGS",
                      options={"maxiter": maxit})
    shape = x0.host().shape
    x = MatArray(np.asarray(res.x).reshape(shape, order="F"), "double")
    outs = [x, MatArray.scalar(float(res.fun)),
            MatArray.scalar(1.0 if res.success else 0.0),
            StructArray.scalar({"iterations": MatArray.scalar(float(res.nit)),
                                "funcCount": MatArray.scalar(float(res.nfev))})]
    return outs[:max(1, nargout)]


@builtin("fsolve", category="math/optim", min_in=2, max_in=3, pass_ctx=True,
         pass_nargout=True)
def m_fsolve(f, x0, opts=None, ctx=None, nargout=1):
    from scipy import optimize as so
    fn = _np_fn(ctx, f)
    x_init = _col(x0)
    sol, info, ier, _msg = so.fsolve(fn, x_init, full_output=True)
    shape = x0.host().shape
    x = MatArray(np.asarray(sol).reshape(shape, order="F"), "double")
    fval = MatArray(np.asarray(info["fvec"]).reshape(-1, 1), "double")
    outs = [x, fval, MatArray.scalar(1.0 if ier == 1 else 0.0)]
    return outs[:max(1, nargout)]


@builtin("linprog", category="math/optim", min_in=3, pass_ctx=True, pass_nargout=True)
def m_linprog(f, A=None, b=None, Aeq=None, beq=None, lb=None, ub=None,
              ctx=None, nargout=1):
    from scipy import optimize as so
    c = _col(f)

    def mat(v):
        return None if v is None or v.size == 0 else v.host().astype(np.float64)

    bounds = None
    if lb is not None or ub is not None:
        lo = _col(lb) if lb is not None and lb.size else np.full(c.size, -np.inf)
        hi = _col(ub) if ub is not None and ub.size else np.full(c.size, np.inf)
        if lo.size == 1:
            lo = np.full(c.size, lo[0])
        if hi.size == 1:
            hi = np.full(c.size, hi[0])
        bounds = list(zip(lo, hi))
    else:
        bounds = [(None, None)] * c.size
    res = so.linprog(c, A_ub=mat(A), b_ub=(_col(b) if b is not None and b.size else None),
                     A_eq=mat(Aeq), b_eq=(_col(beq) if beq is not None and beq.size else None),
                     bounds=bounds, method="highs")
    if not res.success and nargout <= 1:
        raise MatError("optim:linprog:Infeasible", res.message)
    x = MatArray(np.asarray(res.x if res.x is not None else
                            np.full(c.size, np.nan)).reshape(-1, 1), "double")
    outs = [x, MatArray.scalar(float(res.fun) if res.fun is not None else np.nan),
            MatArray.scalar(1.0 if res.success else -2.0)]
    return outs[:max(1, nargout)]


@builtin("lsqnonlin", category="math/optim", min_in=2, max_in=4, pass_ctx=True,
         pass_nargout=True)
def m_lsqnonlin(f, x0, lb=None, ub=None, ctx=None, nargout=1):
    from scipy import optimize as so
    fn = _np_fn(ctx, f)
    x_init = _col(x0)
    kw = {}
    if lb is not None or ub is not None:
        lo = _col(lb) if lb is not None and lb.size else np.full(x_init.size, -np.inf)
        hi = _col(ub) if ub is not None and ub.size else np.full(x_init.size, np.inf)
        kw["bounds"] = (lo, hi)
    res = so.least_squares(fn, x_init, **kw)
    shape = x0.host().shape
    outs = [MatArray(np.asarray(res.x).reshape(shape, order="F"), "double"),
            MatArray.scalar(float(2 * res.cost)),
            MatArray(np.asarray(res.fun).reshape(-1, 1), "double"),
            MatArray.scalar(1.0 if res.success else 0.0)]
    return outs[:max(1, nargout)]


@builtin("lsqcurvefit", category="math/optim", min_in=4, max_in=6, pass_ctx=True,
         pass_nargout=True)
def m_lsqcurvefit(f, x0, xdata, ydata, lb=None, ub=None, ctx=None, nargout=1):
    from scipy import optimize as so
    yd = _col(ydata)
    xd = xdata

    def resid(p):
        pa = MatArray(np.asarray(p, dtype=np.float64).reshape(-1, 1), "double")
        r = _callf(ctx, f, [pa, xd])
        return r.host().astype(np.float64).reshape(-1) - yd

    x_init = _col(x0)
    kw = {}
    if lb is not None or ub is not None:
        lo = _col(lb) if lb is not None and lb.size else np.full(x_init.size, -np.inf)
        hi = _col(ub) if ub is not None and ub.size else np.full(x_init.size, np.inf)
        kw["bounds"] = (lo, hi)
    res = so.least_squares(resid, x_init, **kw)
    shape = x0.host().shape
    outs = [MatArray(np.asarray(res.x).reshape(shape, order="F"), "double"),
            MatArray.scalar(float(2 * res.cost))]
    return outs[:max(1, nargout)]


@builtin("secondordercone", category="math/optim", min_in=4, max_in=4)
def m_secondordercone(A, b, d, gamma):
    """Cone struct for coneprog: ||A x - b|| <= d' x - gamma."""
    return StructArray.scalar({
        "A": A, "b": b, "d": d, "gamma": gamma,
    })


@builtin("coneprog", category="math/optim", min_in=2, pass_ctx=True, pass_nargout=True)
def m_coneprog(f, cones, *rest, ctx=None, nargout=1):
    """SOCP: minimize f'x s.t. ||A_i x - b_i|| <= d_i' x - gamma_i (+ optional
    linear constraints A,b). Solved with SLSQP."""
    from scipy import optimize as so
    c = _col(f)
    cone_list = []
    if isinstance(cones, StructArray):
        flat = [cones] if cones.is_scalar else None
        if flat is None:
            flat = []
            for i in range(cones.size):
                fields = {k: cones.fields[k].reshape(-1)[i] for k in cones.fields}
                flat.append(StructArray.scalar(fields))
        for s in flat:
            cone_list.append((
                s.get_scalar_field("A").host().astype(np.float64),
                _col(s.get_scalar_field("b")),
                _col(s.get_scalar_field("d")),
                _sc(s.get_scalar_field("gamma"))))
    cons = []
    for A, b, d, g in cone_list:
        cons.append({"type": "ineq",
                     "fun": (lambda x, A=A, b=b, d=d, g=g:
                             float(d @ x - g - np.linalg.norm(A @ x - b)))})
    if len(rest) >= 2 and rest[0] is not None and getattr(rest[0], "size", 0):
        Au = rest[0].host().astype(np.float64)
        bu = _col(rest[1])
        cons.append({"type": "ineq", "fun": lambda x: bu - Au @ x})
    res = so.minimize(lambda x: float(c @ x), np.zeros(c.size), method="SLSQP",
                      constraints=cons)
    outs = [MatArray(np.asarray(res.x).reshape(-1, 1), "double"),
            MatArray.scalar(float(res.fun)),
            MatArray.scalar(1.0 if res.success else -2.0)]
    return outs[:max(1, nargout)]
