"""A numpy model of the Box-Muller transform in `csrc/threefry.cu`.

The normal kernels turn each pair of uniforms (u1, u2) into
r*cos(theta), r*sin(theta) with r = sqrt(-2 ln u1), theta = fl(2*pi)*u2,
through their own argument reduction and polynomials rather than libm's
logf/sinf/cosf, because theta lies in [0, 2*pi) and u1 in (0, 1]:
  ln u1    u1 = 2^e * m with m in [2/3, 4/3), f = m - 1 (exact), then
           ln u1 = e*ln2 + f + f^2*P(f) (ln2 in two parts);
  sqrt     the hardware reciprocal square root, then one correction step;
  sin/cos  the quadrant q = rint(theta*2/pi) and x = theta - q*pi/2 by a
           three-term FMA chain (exact enough for |theta| < 7), then
           sin x = x + x^3*S(x^2), cos x = 1 + x^2*C(x^2) and a quadrant
           swap.
This file repeats that arithmetic operation by operation with the kernel's
constants (the same hex literals; `tests/test_torch_ctrng.py` holds the two
lists equal), emulating each fused multiply-add exactly, so the float32
model equals the kernel bit for bit and the float64 model agrees to the
rounding of the square root (the kernel's float64 square root is a
Goldschmidt iteration; the model takes numpy's correctly rounded one).
The CPU tests sweep it over every float32 input against float64 and long
double references; `chip_smoke.py` and the card tests hold the kernel to it
through `ops/threefry.py:device_transform`.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
F64 = np.float64

# float32 constants (threefry.cu, namespace c32), lowest coefficient first
TWO_PI_32 = F32(float.fromhex("0x1.921fb6p+2"))
TWO_OVER_PI_32 = F32(float.fromhex("0x1.45f306p-1"))
ROUND_32 = F32(float.fromhex("0x1.8p+23"))   # adding it rounds to an integer
PIO2_32 = tuple(F32(float.fromhex(h)) for h in
                ("0x1.921fb6p+0", "-0x1.777a5cp-25", "-0x1.ee59dap-50"))
LN2_32 = tuple(F32(float.fromhex(h)) for h in
               ("0x1.62e430p-1", "-0x1.05c610p-29"))
SIN_32 = tuple(F32(float.fromhex(h)) for h in
               ("-0x1.555546p-3", "0x1.11073ap-7", "-0x1.994388p-13"))
COS_32 = tuple(F32(float.fromhex(h)) for h in
               ("-0x1.000000p-1", "0x1.55553cp-5", "-0x1.6c07f0p-10",
                "0x1.991642p-16"))
LOG_32 = tuple(F32(float.fromhex(h)) for h in
               ("-0x1.000000p-1", "0x1.555502p-2", "-0x1.fffe84p-3",
                "0x1.99d1f4p-3", "-0x1.55a756p-3", "0x1.1ebe46p-3",
                "-0x1.f25d8cp-4", "0x1.1ed1f8p-3", "-0x1.093298p-3"))

# float64 constants (threefry.cu, namespace c64)
TWO_PI_64 = float.fromhex("0x1.921fb54442d18p+2")
TWO_OVER_PI_64 = float.fromhex("0x1.45f306dc9c883p-1")
ROUND_64 = float.fromhex("0x1.8p+52")
PIO2_64 = tuple(float.fromhex(h) for h in
                ("0x1.921fb54442d18p+0", "0x1.1a62633145c07p-54",
                 "-0x1.f1976b7ed8fbcp-110"))
LN2_64 = tuple(float.fromhex(h) for h in
               ("0x1.62e42fefa39efp-1", "0x1.abc9e3b39803fp-56"))
SIN_64 = tuple(float.fromhex(h) for h in
               ("-0x1.5555555555555p-3", "0x1.1111111110bb0p-7",
                "-0x1.a01a019e8304ap-13", "0x1.71de3795b27b0p-19",
                "-0x1.ae600a221a59dp-26", "0x1.5e0ac913a9183p-33"))
COS_64 = tuple(float.fromhex(h) for h in
               ("-0x1.0000000000000p-1", "0x1.5555555555551p-5",
                "-0x1.6c16c16c15d71p-10", "0x1.a01a019de0492p-16",
                "-0x1.27e4f8e3d8d0fp-22", "0x1.1eea7e857b478p-29",
                "-0x1.8ff975daa03e1p-37"))
LOG_64 = tuple(float.fromhex(h) for h in
               ("-0x1.0000000000000p-1", "0x1.555555555554dp-2",
                "-0x1.ffffffffffff1p-3", "0x1.999999999c22ap-3",
                "-0x1.5555555557c47p-3", "0x1.24924922a71dep-3",
                "-0x1.fffffffc50d9fp-4", "0x1.c71c731b3ded4p-4",
                "-0x1.99999ae027f06p-4", "0x1.745cd6b8d86dbp-4",
                "-0x1.5555175c4b565p-4", "0x1.3b1b06f6708a2p-4",
                "-0x1.249953d14bf27p-4", "0x1.108c229c011f1p-4",
                "-0x1.ff00c755626b4p-5", "0x1.eda55a06ebbdap-5",
                "-0x1.d2671efcfc267p-5", "0x1.5f17ff9debfedp-5",
                "-0x1.4cc2402131182p-5", "0x1.53f18c1b7431dp-4",
                "-0x1.4533abd461ce8p-4"))


# --------------------------------------------------------------------------- #
# exact fused multiply-add
# --------------------------------------------------------------------------- #

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s, err):
    """s + err (|err| below half an ulp of s) rounded to odd: s, or, where s
    is even and err is not 0, its neighbour on err's side."""
    bits = s.view(np.int64)
    step = np.where((err > 0) == (s > 0), 1, -1)
    return np.where((err != 0) & ((bits & 1) == 0), bits + step,
                    bits).view(F64)


def fma32(a, b, c):
    """a*b + c rounded once to float32. The product of two float32 values
    is exact in float64, and the float64 sum rounds to float32 as the exact
    value would unless it lands on a float32 midpoint (low 29 bits
    0x10000000); there the sum is rounded to odd first (53 >= 24 + 2
    bits)."""
    p = np.asarray(np.asarray(a, F64) * np.asarray(b, F64))
    c = np.broadcast_to(np.asarray(c, F64), p.shape)
    s = np.asarray(p + c)
    mid = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if mid.any():
        _, err = _two_sum(p[mid], c[mid])
        s = s.copy()
        s[mid] = _round_to_odd(s[mid], err)
    return s.astype(F32)


def _split(a):
    t = a * 134217729.0            # 2^27 + 1 (Veltkamp)
    hi = t - (t - a)
    return hi, a - hi


def fma64(a, b, c):
    """a*b + c rounded once to float64 (Boldo and Melquiond: the exact
    product, an exact sum with c, the low parts rounded to odd, one final
    rounding)."""
    a, b = np.asarray(a, F64), np.asarray(b, F64)
    c = np.broadcast_to(np.asarray(c, F64), np.broadcast(a, b).shape)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, verr = _two_sum(tl, pl)
    return th + _round_to_odd(v, verr)


def _horner(coef, x, fma):
    p = coef[-1]
    for c in reversed(coef[:-1]):
        p = fma(p, x, c)
    return p


# --------------------------------------------------------------------------- #
# float32
# --------------------------------------------------------------------------- #

def log_f32(u1: np.ndarray) -> np.ndarray:
    """ln u1 for float32 u1 in (0, 1], as the kernel computes it."""
    bits = np.asarray(u1, F32).view(np.int32)
    e = (bits - np.int32(0x3F2AAAAB)) >> 23
    f = (bits - (e << 23)).view(F32) - F32(1)          # exact
    lg = fma32(f * f, _horner(LOG_32, f, fma32), f)
    ef = e.astype(F32)
    return fma32(ef, LN2_32[0], fma32(ef, LN2_32[1], lg))


def sincos_f32(th: np.ndarray):
    """(cos th, sin th) for float32 th in [0, 7), as the kernel computes
    them."""
    th = np.asarray(th, F32)
    qb = fma32(th, TWO_OVER_PI_32, ROUND_32)
    q = qb.view(np.int32) & 3
    qf = -(qb - ROUND_32)
    x = fma32(qf, PIO2_32[0], th)
    x = fma32(qf, PIO2_32[1], x)
    x = fma32(qf, PIO2_32[2], x)
    s = x * x
    sn = fma32(x * s, _horner(SIN_32, s, fma32), x)
    cs = fma32(s, _horner(COS_32, s, fma32), F32(1))
    odd = (q & 1) == 1
    c, sv = np.where(odd, sn, cs), np.where(odd, cs, sn)
    return (np.where(((q + 1) & 2) != 0, -c, c),
            np.where((q & 2) != 0, -sv, sv))


def uniforms_f32(w0: np.ndarray, w1: np.ndarray):
    """(u1, u2) of the f32 stream from one counter block's words."""
    scale = F32(2.0 ** -24)
    u1 = F32(1) - (np.asarray(w0, np.uint32) >> 8).astype(F32) * scale
    return u1, (np.asarray(w1, np.uint32) >> 8).astype(F32) * scale


def box_muller_f32(w0: np.ndarray, w1: np.ndarray):
    """(r*cos theta, r*sin theta) of the counter blocks' words (u32 arrays),
    as `normal_f32` computes them."""
    u1, u2 = uniforms_f32(w0, w1)
    r = np.sqrt(F32(-2) * log_f32(u1))
    c, s = sincos_f32(TWO_PI_32 * u2)
    return r * c, r * s


# --------------------------------------------------------------------------- #
# float64
# --------------------------------------------------------------------------- #

def u53(w0: np.ndarray, w1: np.ndarray) -> np.ndarray:
    v = ((np.asarray(w0, np.uint64) >> 5) << 26) \
        + (np.asarray(w1, np.uint64) >> 6)
    return v.astype(F64) * 2.0 ** -53


def log_f64(u1: np.ndarray) -> np.ndarray:
    """ln u1 for float64 u1 in (0, 1], as the kernel computes it."""
    bits = np.asarray(u1, F64).view(np.int64)
    e = ((bits >> 32) - 0x3FE55555) >> 20
    f = (bits - (e << 52)).view(F64) - 1.0              # exact
    lg = fma64(f * f, _horner(LOG_64, f, fma64), f)
    ef = e.astype(F64)
    return fma64(ef, LN2_64[0], fma64(ef, LN2_64[1], lg))


def sincos_f64(th: np.ndarray):
    """(cos th, sin th) for float64 th in [0, 7), as the kernel computes
    them."""
    th = np.asarray(th, F64)
    qb = fma64(th, TWO_OVER_PI_64, ROUND_64)
    q = qb.view(np.int64) & 3
    qf = -(qb - ROUND_64)
    x = fma64(qf, PIO2_64[0], th)
    x = fma64(qf, PIO2_64[1], x)
    x = fma64(qf, PIO2_64[2], x)
    s = x * x
    sn = fma64(x * s, _horner(SIN_64, s, fma64), x)
    cs = fma64(s, _horner(COS_64, s, fma64), 1.0)
    odd = (q & 1) == 1
    c, sv = np.where(odd, sn, cs), np.where(odd, cs, sn)
    return (np.where(((q + 1) & 2) != 0, -c, c),
            np.where((q & 2) != 0, -sv, sv))


def box_muller_f64(a0, a1, b0, b1):
    """(r*cos theta, r*sin theta) with u1 from the blocks (a0, a1) and u2
    from (b0, b1), as `normal_f64` computes them (the square root
    correctly rounded)."""
    r = np.sqrt(-2.0 * log_f64(1.0 - u53(a0, a1)))
    c, s = sincos_f64(TWO_PI_64 * u53(b0, b1))
    return r * c, r * s
