"""Copy of runmat_tpu/runtime/builtins/signal2.py in the PyTorch port.

Signal batch 2: IIR/FIR filter design, zero-phase filtering, rate
conversion, waveform generators, periodogram.

Reference parity: runmat-runtime/src/builtins/math/signal/{butter,buttord,
cheb2ord,fir1,filtfilt,downsample,upsample,resample,square,sawtooth,rectpuls,
tripuls,gauspuls,pulstran,periodogram}.rs. Filter design uses host scipy
(bilinear-transform design, like the reference's host-side design code);
the filtering itself runs through the framework's `filter` path.
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import MatArray, fortran_ravel, is_text, text_of
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _vec(v) -> np.ndarray:
    return fortran_ravel(_f(v))


def _rowlike(x, r: np.ndarray, proto=None) -> MatArray:
    """Return r with the vector orientation of x."""
    h = x.host()
    if h.ndim == 2 and h.shape[1] == 1:
        return MatArray(r.reshape(-1, 1), "double")
    return MatArray(r.reshape(1, -1), "double")


# ----------------------------------------------------------------- design --- #

@builtin("butter", category="math/signal", min_in=2, max_in=3, pass_nargout=True)
def m_butter(n, wn, ftype=None, nargout=1):
    from scipy import signal as ss
    order = scalar_int(n, "n")
    w = _vec(wn)
    btype = text_of(ftype).lower() if ftype is not None else \
        ("bandpass" if w.size == 2 else "low")
    btype = {"low": "lowpass", "high": "highpass", "bandpass": "bandpass",
             "stop": "bandstop"}.get(btype, btype)
    b, a = ss.butter(order, w if w.size > 1 else float(w[0]), btype=btype)
    return [MatArray(np.atleast_2d(b), "double"),
            MatArray(np.atleast_2d(a), "double")][:max(1, nargout)]


@builtin("buttord", category="math/signal", min_in=4, max_in=4, pass_nargout=True)
def m_buttord(wp, ws, rp, rs, nargout=1):
    from scipy import signal as ss
    hwp, hws = _vec(wp), _vec(ws)
    n, wn = ss.buttord(hwp if hwp.size > 1 else float(hwp[0]),
                       hws if hws.size > 1 else float(hws[0]),
                       scalar_num(rp, "Rp"), scalar_num(rs, "Rs"))
    outs = [MatArray.scalar(float(n)), MatArray(np.atleast_2d(wn), "double")]
    return outs[:max(1, nargout)]


@builtin("cheb2ord", category="math/signal", min_in=4, max_in=4, pass_nargout=True)
def m_cheb2ord(wp, ws, rp, rs, nargout=1):
    from scipy import signal as ss
    hwp, hws = _vec(wp), _vec(ws)
    n, wn = ss.cheb2ord(hwp if hwp.size > 1 else float(hwp[0]),
                        hws if hws.size > 1 else float(hws[0]),
                        scalar_num(rp, "Rp"), scalar_num(rs, "Rs"))
    outs = [MatArray.scalar(float(n)), MatArray(np.atleast_2d(wn), "double")]
    return outs[:max(1, nargout)]


@builtin("fir1", category="math/signal", min_in=2, max_in=3)
def m_fir1(n, wn, ftype=None):
    from scipy import signal as ss
    order = scalar_int(n, "n")
    w = _vec(wn)
    pass_zero = True
    if ftype is not None and is_text(ftype):
        t = text_of(ftype).lower()
        pass_zero = {"low": True, "high": False, "stop": "bandstop",
                     "bandpass": "bandpass", "dc-1": True, "dc-0": False}.get(t, True)
    elif w.size == 2:
        pass_zero = "bandpass"
    b = ss.firwin(order + 1, w if w.size > 1 else float(w[0]), pass_zero=pass_zero)
    return MatArray(b.reshape(1, -1), "double")


# --------------------------------------------------------------- filtering --- #

@builtin("filtfilt", category="math/signal", min_in=3, max_in=3)
def m_filtfilt(b, a, x):
    from scipy import signal as ss
    hb, ha = _vec(b), _vec(a)
    hx = _f(x)
    if hx.ndim == 2 and 1 in hx.shape:
        r = ss.filtfilt(hb, ha, fortran_ravel(hx))
        return _rowlike(x, r)
    r = ss.filtfilt(hb, ha, hx, axis=0)
    return MatArray(r, "double")


@builtin("downsample", category="math/signal", min_in=2, max_in=3)
def m_downsample(x, n, phase=None):
    k = scalar_int(n, "n")
    ph = scalar_int(phase, "phase") if phase is not None else 0
    h = x.host()
    if h.ndim == 2 and 1 in h.shape:
        flat = h.reshape(-1, order="F")[ph::k]
        return MatArray(flat.reshape(1, -1) if h.shape[0] == 1 else flat.reshape(-1, 1),
                        x.mclass)
    return MatArray(h[ph::k, :], x.mclass)


@builtin("upsample", category="math/signal", min_in=2, max_in=3)
def m_upsample(x, n, phase=None):
    k = scalar_int(n, "n")
    ph = scalar_int(phase, "phase") if phase is not None else 0
    h = x.host()
    if h.ndim == 2 and 1 in h.shape:
        flat = h.reshape(-1, order="F")
        out = np.zeros(flat.size * k, dtype=h.dtype)
        out[ph::k] = flat
        return MatArray(out.reshape(1, -1) if h.shape[0] == 1 else out.reshape(-1, 1),
                        x.mclass)
    out = np.zeros((h.shape[0] * k, h.shape[1]), dtype=h.dtype)
    out[ph::k, :] = h
    return MatArray(out, x.mclass)


@builtin("resample", category="math/signal", min_in=3, max_in=3)
def m_resample(x, p, q):
    from scipy import signal as ss
    hp, hq = scalar_int(p, "p"), scalar_int(q, "q")
    h = _f(x)
    if h.ndim == 2 and 1 in h.shape:
        r = ss.resample_poly(fortran_ravel(h), hp, hq)
        return _rowlike(x, r)
    return MatArray(ss.resample_poly(h, hp, hq, axis=0), "double")


# -------------------------------------------------------------- generators --- #

@builtin("square", category="math/signal", min_in=1, max_in=2)
def m_square(t, duty=None):
    ht = _f(t)
    d = scalar_num(duty, "duty") if duty is not None else 50.0
    frac = np.mod(ht, 2 * np.pi) / (2 * np.pi)
    r = np.where(frac < d / 100.0, 1.0, -1.0)
    return MatArray(r, "double")


@builtin("sawtooth", category="math/signal", min_in=1, max_in=2)
def m_sawtooth(t, width=None):
    ht = _f(t)
    w = scalar_num(width, "width") if width is not None else 1.0
    frac = np.mod(ht, 2 * np.pi) / (2 * np.pi)
    with np.errstate(divide="ignore", invalid="ignore"):
        up = np.where(w > 0, 2 * frac / max(w, 1e-300) - 1, -1.0)
        down = np.where(w < 1, 1 - 2 * (frac - w) / max(1 - w, 1e-300), 1.0)
    r = np.where(frac < w, up, down)
    return MatArray(r, "double")


@builtin("rectpuls", category="math/signal", min_in=1, max_in=2)
def m_rectpuls(t, width=None):
    ht = _f(t)
    w = scalar_num(width, "width") if width is not None else 1.0
    r = np.where((ht >= -w / 2) & (ht < w / 2), 1.0, 0.0)
    return MatArray(r, "double")


@builtin("tripuls", category="math/signal", min_in=1, max_in=2)
def m_tripuls(t, width=None):
    ht = _f(t)
    w = scalar_num(width, "width") if width is not None else 1.0
    r = np.maximum(0.0, 1.0 - np.abs(2 * ht / w))
    return MatArray(r, "double")


@builtin("gauspuls", category="math/signal", min_in=1, max_in=3)
def m_gauspuls(t, fc=None, bw=None):
    ht = _f(t)
    f = scalar_num(fc, "fc") if fc is not None else 1000.0
    b = scalar_num(bw, "bw") if bw is not None else 0.5
    # -6 dB fractional-bandwidth Gaussian envelope (MATLAB default bwr=-6)
    ref = 10 ** (-6 / 20)
    a = -(np.pi * f * b) ** 2 / (4.0 * np.log(ref))
    r = np.exp(-a * ht * ht) * np.cos(2 * np.pi * f * ht)
    return MatArray(r, "double")


@builtin("pulstran", category="math/signal", min_in=3, pass_ctx=True)
def m_pulstran(t, d, func, *rest, ctx=None):
    ht = _vec(t)
    hd = _f(d)
    delays = hd[:, 0] if hd.ndim == 2 and hd.shape[1] >= 1 else fortran_ravel(hd)
    gains = hd[:, 1] if hd.ndim == 2 and hd.shape[1] >= 2 else np.ones(delays.size)
    out = np.zeros(ht.size)
    from ...values import FunctionHandle
    name = text_of(func) if is_text(func) else None
    for dly, g in zip(delays, gains):
        shifted = MatArray((ht - dly).reshape(1, -1), "double")
        if name is not None:
            from ..registry import lookup
            bi = lookup(name)
            if bi is None:
                raise bad_arg("pulstran", f"Unknown pulse function '{name}'.")
            args = [shifted] + list(rest)
            r = bi.fn(*args)
        else:
            r = ctx.interp.call_value(func, [shifted] + list(rest), 1, ctx.frame)[0]
        out += g * fortran_ravel(_f(r))
    return _rowlike(t, out)


@builtin("periodogram", category="math/signal", min_in=1, max_in=4, pass_nargout=True)
def m_periodogram(x, win=None, nfft=None, fs=None, nargout=1):
    hx = _vec(x)
    n = hx.size
    w = _vec(win) if win is not None and getattr(win, "size", 0) > 1 else np.ones(n)
    nf = scalar_int(nfft, "nfft") if nfft is not None else max(256, 1 << (n - 1).bit_length())
    hfs = scalar_num(fs, "fs") if fs is not None else 2 * np.pi
    xw = hx * w
    X = np.fft.rfft(xw, nf)
    scale = 1.0 / (hfs * (w * w).sum())
    p = (np.abs(X) ** 2) * scale
    if nf % 2 == 0:
        p[1:-1] *= 2
    else:
        p[1:] *= 2
    freqs = np.fft.rfftfreq(nf, d=1.0 / hfs)
    outs = [MatArray(p.reshape(-1, 1), "double"), MatArray(freqs.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]
