"""Copy of runmat_tpu/runtime/builtins/control2.py in the PyTorch port.

Control-systems toolbox: tf/ss models, time/frequency responses, analysis.

Reference parity: runmat-runtime/src/builtins/control/ — tf (with the full
operator set the reference registers as tf.plus/tf.mtimes/... dotted
builtins; here via the generic `_mat_binop_` protocol), ss, feedback, step,
impulse, pole, zero, dcgain, damp, isstable, stepinfo, lqr, pzmap, rlocus,
nyquist, db. Response simulation uses host scipy.signal lti cores.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, MatArray, StructArray, fortran_ravel,
                       is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _vec(v) -> np.ndarray:
    return fortran_ravel(_f(v))


def _trim(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64).reshape(-1)
    nz = np.nonzero(p)[0]
    return p[nz[0]:] if nz.size else np.array([0.0])


class TfValue:
    """SISO transfer function num(s)/den(s) (continuous time)."""

    __slots__ = ("num", "den", "shared")
    mclass = "tf"

    def __init__(self, num, den):
        self.num = _trim(num)
        self.den = _trim(den)
        # normalize leading den coefficient
        if self.den[0] != 0 and self.den[0] != 1:
            self.num = self.num / self.den[0]
            self.den = self.den / self.den[0]
        self.shared = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    # -- arithmetic (≙ reference tf.plus/minus/times/mtimes/... builtins) -- #

    @staticmethod
    def _coerce(other):
        if isinstance(other, TfValue):
            return other
        if isinstance(other, MatArray) and other.size == 1:
            return TfValue([float(other.host().reshape(-1)[0].real)], [1.0])
        return None

    def _mat_binop_(self, op, other, swapped):
        o = TfValue._coerce(other)
        if o is None:
            return NotImplemented
        a, b = (o, self) if swapped else (self, o)
        if op in ("add", "plus"):
            num = np.polyadd(np.polymul(a.num, b.den), np.polymul(b.num, a.den))
            return TfValue(num, np.polymul(a.den, b.den))
        if op in ("sub", "minus"):
            num = np.polysub(np.polymul(a.num, b.den), np.polymul(b.num, a.den))
            return TfValue(num, np.polymul(a.den, b.den))
        if op in ("mul", "mtimes", "times"):
            return TfValue(np.polymul(a.num, b.num), np.polymul(a.den, b.den))
        if op in ("div", "rdivide", "mrdivide"):
            return TfValue(np.polymul(a.num, b.den), np.polymul(a.den, b.num))
        if op in ("ldiv", "ldivide", "mldivide"):
            return TfValue(np.polymul(b.num, a.den), np.polymul(b.den, a.num))
        if op in ("pow", "mpower", "power"):
            k = int(other.host().reshape(-1)[0].real) if isinstance(other, MatArray) else 0
            num, den = np.array([1.0]), np.array([1.0])
            for _ in range(abs(k)):
                num, den = np.polymul(num, self.num), np.polymul(den, self.den)
            return TfValue(num, den) if k >= 0 else TfValue(den, num)
        return NotImplemented

    def _mat_unop_(self, op):
        if op in ("neg", "uminus"):
            return TfValue(-self.num, self.den)
        if op in ("pos", "uplus"):
            return self
        return NotImplemented

    def to_scipy(self):
        from scipy import signal as ss
        return ss.TransferFunction(self.num, self.den)

    def poles(self) -> np.ndarray:
        return np.roots(self.den)

    def zeros_(self) -> np.ndarray:
        return np.roots(self.num)


class SsValue:
    """State-space model (A, B, C, D), continuous time."""

    __slots__ = ("A", "B", "C", "D", "shared")
    mclass = "ss"

    def __init__(self, A, B, C, D):
        self.A, self.B, self.C, self.D = A, B, C, D
        self.shared = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def to_tf(self) -> TfValue:
        from scipy import signal as ss
        num, den = ss.ss2tf(self.A, self.B, self.C, self.D)
        return TfValue(num[0], den)

    def poles(self) -> np.ndarray:
        return np.linalg.eigvals(self.A)


def _as_tf(m) -> TfValue:
    if isinstance(m, TfValue):
        return m
    if isinstance(m, SsValue):
        return m.to_tf()
    from ...values import MatArray as _MA
    if isinstance(m, _MA) and m.size == 1:
        # scalar gain (feedback(G, 1), series with constants, ...)
        k = float(np.asarray(m.host()).reshape(-1)[0])
        return TfValue(np.array([k]), np.array([1.0]))
    raise bad_arg("control", "Expected a tf or ss model.")


@builtin("tf", category="control", min_in=1, max_in=2)
def m_tf(num, den=None):
    if is_text(num) and text_of(num) == "s":
        return TfValue([1.0, 0.0], [1.0])
    if isinstance(num, (TfValue, SsValue)) and den is None:
        t = _as_tf(num)
        return TfValue(t.num, t.den)
    if den is None:
        return TfValue(_vec(num), [1.0])
    return TfValue(_vec(num), _vec(den))


class ZpkValue(TfValue):
    """Zero-pole-gain model; shares the tf arithmetic/response machinery
    (polynomial form is derived from z/p/k at construction)."""

    __slots__ = ("z", "p", "k")
    mclass = "zpk"

    def __init__(self, z, p, k):
        self.z = np.asarray(z, dtype=complex).reshape(-1)
        self.p = np.asarray(p, dtype=complex).reshape(-1)
        self.k = float(k)
        super().__init__(np.real_if_close(self.k * np.poly(self.z)),
                         np.real_if_close(np.poly(self.p)))


def _zvec(v) -> np.ndarray:
    if isinstance(v, MatArray):
        h = v.host()
        return np.asarray(h, dtype=complex).reshape(-1)
    return np.asarray(v, dtype=complex).reshape(-1)


@builtin("zpk", category="control", min_in=1, max_in=3)
def m_zpk(z, p=None, k=None):
    if p is None:
        if is_text(z) and text_of(z) == "s":
            return ZpkValue([0.0], [], 1.0)
        t = _as_tf(z)
        return ZpkValue(np.roots(t.num), np.roots(t.den),
                        t.num[0] / t.den[0])
    return ZpkValue(_zvec(z), _zvec(p),
                    scalar_num(k, "k") if k is not None else 1.0)


@builtin("ss", category="control", min_in=1, max_in=4)
def m_ss(a, b=None, c=None, d=None):
    if b is None:
        t = _as_tf(a)
        from scipy import signal as ss
        A, B, C, D = ss.tf2ss(t.num, t.den)
        return SsValue(A, B, C, D)
    return SsValue(_f(a), _f(b), _f(c), _f(d) if d is not None else
                   np.zeros((_f(c).shape[0], _f(b).shape[1])))


@builtin("pole", category="control", min_in=1, max_in=1)
def m_pole(m):
    if isinstance(m, SsValue):
        p = m.poles()
    else:
        p = _as_tf(m).poles()
    return MatArray(np.asarray(p).reshape(-1, 1), "double")


@builtin("zero", category="control", min_in=1, max_in=1)
def m_zero(m):
    z = _as_tf(m).zeros_()
    return MatArray(np.asarray(z).reshape(-1, 1), "double")


@builtin("dcgain", category="control", min_in=1, max_in=1)
def m_dcgain(m):
    t = _as_tf(m)
    d0 = np.polyval(t.den, 0.0)
    n0 = np.polyval(t.num, 0.0)
    return MatArray.scalar(float(n0 / d0) if d0 != 0 else
                           (np.inf if n0 != 0 else np.nan))


@builtin("isstable", category="control", min_in=1, max_in=1)
def m_isstable(m):
    p = (m.poles() if isinstance(m, SsValue) else _as_tf(m).poles())
    return MatArray.logical_scalar(bool((np.real(p) < 0).all()))


@builtin("damp", category="control", min_in=1, max_in=1, pass_nargout=True)
def m_damp(m, nargout=1):
    p = np.asarray(m.poles() if isinstance(m, SsValue) else _as_tf(m).poles())
    wn = np.abs(p)
    with np.errstate(invalid="ignore", divide="ignore"):
        zeta = np.where(wn > 0, -np.real(p) / wn, 1.0)
    order = np.argsort(wn, kind="stable")
    outs = [MatArray(wn[order].reshape(-1, 1), "double"),
            MatArray(zeta[order].reshape(-1, 1), "double"),
            MatArray(p[order].reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("feedback", category="control", min_in=2, max_in=3)
def m_feedback(g, h, sign=None):
    tg, th = _as_tf(g), _as_tf(h)
    s = scalar_num(sign, "sign") if sign is not None else -1.0
    # closed loop: G / (1 - sign*G*H)
    num = np.polymul(tg.num, th.den)
    den = np.polysub(np.polymul(tg.den, th.den),
                     s * np.polymul(tg.num, th.num)) if s < 0 else \
        np.polysub(np.polymul(tg.den, th.den), np.polymul(tg.num, th.num))
    if s < 0:
        den = np.polyadd(np.polymul(tg.den, th.den), np.polymul(tg.num, th.num))
    return TfValue(num, den)


def _time_response(m, kind: str, t=None):
    from scipy import signal as ss
    sys = _as_tf(m).to_scipy()
    tv = _vec(t) if t is not None else None
    if kind == "step":
        tt, y = ss.step(sys, T=tv, N=500 if tv is None else None)
    else:
        tt, y = ss.impulse(sys, T=tv, N=500 if tv is None else None)
    return tt, y


@builtin("step", category="control", min_in=1, max_in=2, pass_nargout=True)
def m_step(m, t=None, nargout=0):
    tt, y = _time_response(m, "step", t)
    if nargout == 0:
        from .plotting import m_plot
        m_plot(MatArray(tt.reshape(1, -1), "double"),
               MatArray(np.real(y).reshape(1, -1), "double"))
        return None
    outs = [MatArray(np.real(y).reshape(-1, 1), "double"),
            MatArray(tt.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("impulse", category="control", min_in=1, max_in=2, pass_nargout=True)
def m_impulse(m, t=None, nargout=0):
    tt, y = _time_response(m, "impulse", t)
    if nargout == 0:
        from .plotting import m_plot
        m_plot(MatArray(tt.reshape(1, -1), "double"),
               MatArray(np.real(y).reshape(1, -1), "double"))
        return None
    outs = [MatArray(np.real(y).reshape(-1, 1), "double"),
            MatArray(tt.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("stepinfo", category="control", min_in=1, max_in=1)
def m_stepinfo(m):
    tt, y = _time_response(m, "step")
    y = np.real(y)
    yf = y[-1]
    rise = np.nan
    lo_idx = np.where(y >= 0.1 * yf)[0]
    hi_idx = np.where(y >= 0.9 * yf)[0]
    if lo_idx.size and hi_idx.size:
        rise = tt[hi_idx[0]] - tt[lo_idx[0]]
    tol = 0.02 * abs(yf)
    settle = np.nan
    outside = np.where(np.abs(y - yf) > tol)[0]
    if outside.size and outside[-1] + 1 < tt.size:
        settle = tt[outside[-1] + 1]
    elif not outside.size:
        settle = tt[0]
    overshoot = max(0.0, (y.max() - yf) / abs(yf) * 100) if yf != 0 else np.inf
    return StructArray.scalar({
        "RiseTime": MatArray.scalar(float(rise)),
        "SettlingTime": MatArray.scalar(float(settle)),
        "Overshoot": MatArray.scalar(float(overshoot)),
        "Peak": MatArray.scalar(float(np.abs(y).max())),
        "PeakTime": MatArray.scalar(float(tt[np.abs(y).argmax()])),
        "SteadyState": MatArray.scalar(float(yf)),
    })


@builtin("lqr", category="control", min_in=3, max_in=4, pass_nargout=True)
def m_lqr(a_or_sys, b_or_q, q_or_r, r=None, nargout=1):
    import scipy.linalg as sla
    if isinstance(a_or_sys, SsValue):
        A, B = a_or_sys.A, a_or_sys.B
        Q, R = _f(b_or_q), _f(q_or_r)
    else:
        A, B, Q, R = _f(a_or_sys), _f(b_or_q), _f(q_or_r), _f(r)
    P = sla.solve_continuous_are(A, B, Q, R)
    K = np.linalg.solve(R, B.T @ P)
    eigs = np.linalg.eigvals(A - B @ K)
    outs = [MatArray(K, "double"), MatArray(P, "double"),
            MatArray(np.asarray(eigs).reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("db", category="control", min_in=1, max_in=2)
def m_db(x, kind=None):
    h = np.abs(_f(x))
    power = kind is not None and is_text(kind) and text_of(kind).lower() == "power"
    with np.errstate(divide="ignore"):
        r = (10.0 if power else 20.0) * np.log10(h)
    return MatArray(r, "double")


@builtin("pzmap", category="control", min_in=1, max_in=1, pass_nargout=True)
def m_pzmap(m, nargout=0):
    t = _as_tf(m)
    p, z = t.poles(), t.zeros_()
    if nargout == 0:
        from .plotting import m_plot
        if p.size:
            m_plot(MatArray(np.real(p).reshape(1, -1), "double"),
                   MatArray(np.imag(p).reshape(1, -1), "double"),
                   MatArray.char_from_str("x"))
        if z.size:
            m_plot(MatArray(np.real(z).reshape(1, -1), "double"),
                   MatArray(np.imag(z).reshape(1, -1), "double"),
                   MatArray.char_from_str("o"))
        return None
    outs = [MatArray(np.asarray(p).reshape(-1, 1), "double"),
            MatArray(np.asarray(z).reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("rlocus", category="control", min_in=1, max_in=2, pass_nargout=True)
def m_rlocus(m, gains=None, nargout=0):
    t = _as_tf(m)
    ks = _vec(gains) if gains is not None else np.logspace(-2, 2, 100)
    locs = []
    for k in ks:
        den = np.polyadd(t.den, k * np.pad(t.num, (t.den.size - t.num.size, 0)))
        locs.append(np.sort_complex(np.roots(den)))
    R = np.array(locs)  # (nk, npoles)
    if nargout == 0:
        from .plotting import m_plot
        for j in range(R.shape[1] if R.ndim > 1 else 0):
            m_plot(MatArray(np.real(R[:, j]).reshape(1, -1), "double"),
                   MatArray(np.imag(R[:, j]).reshape(1, -1), "double"))
        return None
    outs = [MatArray(R.T, "double"), MatArray(ks.reshape(1, -1), "double")]
    return outs[:max(1, nargout)]


@builtin("nyquist", category="control", min_in=1, max_in=2, pass_nargout=True)
def m_nyquist(m, w=None, nargout=0):
    t = _as_tf(m)
    ws = _vec(w) if w is not None else np.logspace(-2, 2, 200)
    H = np.polyval(t.num, 1j * ws) / np.polyval(t.den, 1j * ws)
    if nargout == 0:
        from .plotting import m_plot
        m_plot(MatArray(np.real(H).reshape(1, -1), "double"),
               MatArray(np.imag(H).reshape(1, -1), "double"))
        return None
    outs = [MatArray(np.real(H).reshape(-1, 1), "double"),
            MatArray(np.imag(H).reshape(-1, 1), "double"),
            MatArray(ws.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]
