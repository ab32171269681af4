"""The port's plain PyTorch Threefry against the JAX package's three forms of
the same stream: the Pallas kernel in interpret mode, the jnp device path of
`ops/ctrng.py`, and its numpy host path.

Tolerances: words and uniforms (f32, f64) bit-exact; normals f32
atol=rtol=2e-6 and f64 atol=1e-13, because Box-Muller goes through each
backend's libm (log/cos/sin), which differ by a few ulp. The CUDA kernel's
own transform is pinned through its numpy model (`ops/boxmuller.py`, at the
end of this file).
"""

import os
import re
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runmat_tpu.ops import ctrng as jctrng
from runmat_tpu.ops.pallas.threefry import (normal_pallas, raw_words_pallas,
                                            uniform_pallas)
from runmat_tpu_torch.ops import boxmuller, ctrng, threefry

KEY = (0x9E3779B9, 0x7F4A7C15)
# (lo, hi) starts; the last one carries from lo into hi inside the draw
COUNTERS = [(0, 0), (12345, 0), (0xFFFFFFFD, 3)]
SIZES = [1, 2, 3, 1023]


@pytest.fixture(autouse=True, scope="module")
def _x64():
    # f64 streams need 64-bit jax arrays, as JaxEngine sets them
    jax.config.update("jax_enable_x64", True)


def _c64(ctr):
    return ctr[0] | (ctr[1] << 32)


@pytest.mark.parametrize("ctr", COUNTERS)
@pytest.mark.parametrize("n", SIZES)
def test_words_match_pallas_jnp_and_numpy(n, ctr):
    w0, w1 = ctrng.raw_words(KEY, ctr, n, "cpu")
    w0, w1 = w0.numpy().astype(np.uint32), w1.numpy().astype(np.uint32)
    p0, p1 = raw_words_pallas(n, interpret=True)(KEY[0], KEY[1], *ctr)
    j0, j1 = jctrng.raw_words(jnp, KEY, _c64(ctr), n)
    h0, h1 = jctrng.raw_words(np, KEY, _c64(ctr), n)
    for ref0, ref1 in ((p0, p1), (j0, j1), (h0, h1)):
        assert np.array_equal(w0, np.asarray(ref0))
        assert np.array_equal(w1, np.asarray(ref1))


@pytest.mark.parametrize("ctr", COUNTERS)
@pytest.mark.parametrize("n", SIZES + [4097])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_bit_exact(dtype, n, ctr):
    got = ctrng.uniform(KEY, ctr, n, getattr(torch, dtype), "cpu").numpy()
    host, _ = jctrng.uniform(np, KEY, _c64(ctr), n, np.dtype(dtype))
    dev, _ = jctrng.uniform(jnp, KEY, _c64(ctr), n, np.dtype(dtype))
    assert got.dtype == np.dtype(dtype) and got.shape == (n,)
    assert np.array_equal(got, host)
    assert np.array_equal(got, np.asarray(dev))
    if dtype == "float32":
        pal = uniform_pallas(n, interpret=True)(KEY[0], KEY[1], *ctr)
        assert np.array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("ctr", COUNTERS)
@pytest.mark.parametrize("n", SIZES + [4097])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_normal_within_libm_tolerance(dtype, n, ctr):
    got = ctrng.normal(KEY, ctr, n, getattr(torch, dtype), "cpu").numpy()
    host, _ = jctrng.normal(np, KEY, _c64(ctr), n, np.dtype(dtype))
    dev, _ = jctrng.normal(jnp, KEY, _c64(ctr), n, np.dtype(dtype))
    refs = [host, np.asarray(dev)]
    if dtype == "float32":
        refs.append(np.asarray(normal_pallas(n, interpret=True)(
            KEY[0], KEY[1], *ctr)))
        tol = dict(rtol=2e-6, atol=2e-6)
    else:
        tol = dict(rtol=0, atol=1e-13)
    assert got.dtype == np.dtype(dtype) and got.shape == (n,)
    for ref in refs:
        np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("kind", ["rand", "randn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rng_draw_on_cpu_is_the_plain_stream(kind, dtype):
    before = threefry.launches
    got = threefry.rng_draw(kind, KEY, (7, 0), 333, dtype, "cpu")
    want = threefry.plain_draw(kind, KEY, 7, 333, dtype, torch.device("cpu"))
    assert torch.equal(got, want)
    assert threefry.launches == before      # only a kernel launch counts


def test_rng_draw_refuses_what_it_has_no_kernel_for():
    with pytest.raises(ValueError):
        threefry.rng_draw("rand", KEY, 0, 8, torch.float16, "cpu")
    with pytest.raises(ValueError):
        threefry.rng_draw("randi", KEY, 0, 8, torch.float32, "cpu")
    with pytest.raises(ValueError):
        threefry.rng_draw("rand", KEY, 0, 8, torch.float32, "meta")



# --- the port's host numpy stream (the session's own draws) --------------- #

@pytest.mark.parametrize("ctr", COUNTERS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_stream_is_the_jax_packages(n, ctr, dtype):
    # the port's numpy stream is bit for bit the JAX package's numpy stream,
    # normals included (the same numpy libm)
    w = ctrng.np_raw_words(KEY, _c64(ctr), n)
    jw = jctrng.raw_words(np, KEY, _c64(ctr), n)
    assert all(np.array_equal(a, b) for a, b in zip(w, jw))
    for ours, theirs in ((ctrng.np_uniform, jctrng.uniform),
                         (ctrng.np_normal, jctrng.normal)):
        got, nb = ours(KEY, _c64(ctr), n, np.dtype(dtype))
        want, jnb = theirs(np, KEY, _c64(ctr), n, np.dtype(dtype))
        assert nb == jnb and got.dtype == want.dtype
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_session_state_is_the_jax_packages(seed):
    ours, theirs = ctrng.PhiloxState(seed), jctrng.PhiloxState(seed)
    assert ours.state_tuple() == theirs.state_tuple()
    for n, dt in ((5, "double"), (8, "single"), (3, "double")):
        assert np.array_equal(ctrng.host_rand(ours, n, dt),
                              jctrng.host_rand(theirs, n, dt))
        assert np.array_equal(ctrng.host_randn(ours, n, dt),
                              jctrng.host_randn(theirs, n, dt))
        assert ours.counter == theirs.counter
    for kind in ("rand", "randn"):
        for mclass in ("single", "double", np.float32):
            assert ctrng.blocks_for(kind, 7, mclass) == \
                jctrng.blocks_for(kind, 7, mclass)


# --- the normal kernels' Box-Muller transform (ops/boxmuller.py) ----------- #
#
# csrc/threefry.cu computes ln u1, sqrt and sin/cos of theta with its own
# reduction and polynomials; ops/boxmuller.py repeats that arithmetic with
# exactly emulated FMAs. The float32 model is swept over every value the
# stream can give (u1 = 1 - k 2^-24 and theta = fl(2 pi) k 2^-24 for all
# 2^24 k) against float64 references, and its normals against the port's
# plain stream and the JAX package's. Stated bounds: float32 ln u1 within
# 1 ulp, sin and cos within 1.5 ulp; float64 (2^18 samples against long
# double) ln u1 within 1.5 ulp, sin and cos within 1.5 ulp.

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runmat_tpu_torch", "csrc", "threefry.cu")
SWEEP_CHUNK = 1 << 22


def _ulps(got, ref, dtype):
    """|got - ref| in units of `dtype`'s spacing at ref."""
    ref = np.asarray(ref, np.longdouble)
    spacing = np.spacing(np.abs(ref).astype(dtype)).astype(np.longdouble)
    return np.asarray(np.abs(np.asarray(got, np.longdouble) - ref) / spacing,
                      np.float64)


def test_kernel_constants_are_the_models():
    src = open(CU).read()
    lits = re.findall(r"(-?0x[0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?p[+-]?\d+)(f?)",
                      src)
    f32 = [float.fromhex(h) for h, suffix in lits if suffix]
    f64 = [float.fromhex(h) for h, suffix in lits if not suffix]
    scalars32 = [boxmuller.TWO_PI_32, boxmuller.TWO_OVER_PI_32,
                 boxmuller.ROUND_32, *boxmuller.PIO2_32, *boxmuller.LN2_32]
    scalars64 = [boxmuller.TWO_PI_64, boxmuller.TWO_OVER_PI_64,
                 boxmuller.ROUND_64, *boxmuller.PIO2_64, *boxmuller.LN2_64]
    assert f32 == [float(c) for c in scalars32 + [*boxmuller.SIN_32,
                   *boxmuller.COS_32, *boxmuller.LOG_32]]
    assert f64 == scalars64 + [*boxmuller.SIN_64, *boxmuller.COS_64,
                               *boxmuller.LOG_64]
    # every float32 constant is a float32 value
    assert all(float(np.float32(c)) == c for c in f32)


@pytest.mark.parametrize("fma,dtype", [(boxmuller.fma32, np.float32),
                                       (boxmuller.fma64, np.float64)])
def test_fma_emulation_rounds_once(fma, dtype):
    rng = np.random.default_rng(11)
    a, b, c = (rng.standard_normal(2000).astype(dtype) * dtype(2.0) ** (
        rng.integers(-30, 30, 2000)).astype(dtype) for _ in range(3))
    got = fma(a, b, c)
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        x = dtype(float(exact))
        near = [np.nextafter(x, dtype(-np.inf)), x,
                np.nextafter(x, dtype(np.inf))]
        want = min(near, key=lambda y: (abs(Fraction(float(y)) - exact),
                                        int(np.asarray(y).view(
                                            np.int32 if dtype == np.float32
                                            else np.int64)) & 1))
        assert got[i] == want
    # a product on a float32 midpoint and a tiny c: a float64 sum rounded
    # twice would go to even
    one = np.float32(1)
    a = np.float32(1 + 2.0 ** -12)
    assert boxmuller.fma32(a, a, np.float32(2.0 ** -80)) == \
        np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    assert boxmuller.fma32(a, a, np.float32(-2.0 ** -80)) == \
        np.float32(1 + 2.0 ** -11)
    assert boxmuller.fma32(one, one, np.float32(0)) == one


def _sweep_f32():
    """Chunks of (k, u1, u2, ln u1, cos theta, sin theta) of the float32
    model over every k < 2^24."""
    for start in range(0, 1 << 24, SWEEP_CHUNK):
        k = np.arange(start, start + SWEEP_CHUNK, dtype=np.uint32)
        u1, u2 = boxmuller.uniforms_f32(k << 8, k << 8)
        c, s = boxmuller.sincos_f32(boxmuller.TWO_PI_32 * u2)
        yield k, u1, u2, boxmuller.log_f32(u1), c, s


def test_float32_model_over_every_input():
    worst = {"log": 0.0, "cos": 0.0, "sin": 0.0, "normal": 0.0}
    for k, u1, u2, lg, c, s in _sweep_f32():
        th = boxmuller.TWO_PI_32 * u2
        th64 = th.astype(np.float64)
        worst["log"] = max(worst["log"], _ulps(
            lg, np.log(u1.astype(np.float64)), np.float32).max())
        worst["cos"] = max(worst["cos"], _ulps(c, np.cos(th64),
                                               np.float32).max())
        worst["sin"] = max(worst["sin"], _ulps(s, np.sin(th64),
                                               np.float32).max())
        # the model's normals against the plain stream's formula
        # (ops/ctrng.py:normal on the same u1, u2) and the JAX package's
        # numpy one, under the unchanged float32 tolerance
        r = np.sqrt(np.float32(-2) * lg)
        z = np.concatenate([r * c, r * s])
        tu1, tu2 = torch.from_numpy(u1), torch.from_numpy(u2)
        tr = torch.sqrt(-2.0 * torch.log(tu1))
        tth = torch.tensor(2.0 * np.pi, dtype=torch.float32) * tu2
        plain = torch.cat([tr * torch.cos(tth), tr * torch.sin(tth)]).numpy()
        nr = np.sqrt(np.float32(-2.0) * np.log(u1))
        nth = np.float32(2.0 * np.pi) * u2
        host = np.concatenate([nr * np.cos(nth), nr * np.sin(nth)])
        for ref in (plain, host):
            np.testing.assert_allclose(z, ref, rtol=2e-6, atol=2e-6)
        worst["normal"] = max(worst["normal"], float(np.abs(z - host).max()))
    assert worst["log"] <= 1.0 and worst["cos"] <= 1.5 \
        and worst["sin"] <= 1.5, worst


def test_float32_model_is_the_kernel_arithmetic_near_the_edges():
    # u1 = 1 (k = 0): r = 0; u1 = 2^-24: the largest r; theta on both
    # sides of each quadrant boundary
    w = np.array([0, 1 << 8, 0xFFFFFFFF, 0x80000000, 0x40000000,
                  0xC0000000], np.uint32)
    c, s = boxmuller.box_muller_f32(w, w)
    u1, u2 = boxmuller.uniforms_f32(w, w)
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    th = (boxmuller.TWO_PI_32 * u2).astype(np.float64)
    np.testing.assert_allclose(c, r * np.cos(th), rtol=2e-7, atol=1e-12)
    np.testing.assert_allclose(s, r * np.sin(th), rtol=2e-7, atol=1e-12)
    assert c[0] == 0 and s[0] == 0
    assert abs(float(r[2]) - np.sqrt(-2 * np.log(2.0 ** -24))) < 1e-6


def test_float64_model_against_long_double():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 32, (4, 1 << 18), dtype=np.uint64).astype(
        np.uint32)
    w[:, :2] = [[0, 0xFFFFFFFF]] * 4
    u1 = 1.0 - boxmuller.u53(w[0], w[1])
    u2 = boxmuller.u53(w[2], w[3])
    ld = np.longdouble
    lg = boxmuller.log_f64(u1)
    assert _ulps(lg[1:], np.log(u1[1:].astype(ld)), np.float64).max() <= 1.5
    assert lg[0] == 0
    # u1 within 2^16 ulp of 1, where ln u1 ~ u1 - 1 must keep its digits
    near = 1.0 - np.arange(1, 1 << 16) * 2.0 ** -53
    assert _ulps(boxmuller.log_f64(near), np.log(near.astype(ld)),
                 np.float64).max() <= 1.0
    th = boxmuller.TWO_PI_64 * u2
    c, s = boxmuller.sincos_f64(th)
    assert _ulps(c, np.cos(th.astype(ld)), np.float64).max() <= 1.5
    assert _ulps(s, np.sin(th.astype(ld)), np.float64).max() <= 1.5
    zc, zs = boxmuller.box_muller_f64(*w)
    r = np.sqrt(-2.0 * np.log(u1))
    np.testing.assert_allclose(zc, r * np.cos(2 * np.pi * u2), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(zs, r * np.sin(2 * np.pi * u2), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("ctr", COUNTERS)
@pytest.mark.parametrize("n", [1, 2, 3, 4097])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_model_draws_match_the_jax_package(dtype, n, ctr):
    # the kernel's normals (its model over the stream's words) against the
    # JAX package's numpy, jnp and (f32) Pallas-interpret normals
    m = (n + 1) // 2
    if dtype == "float32":
        w0, w1 = jctrng.raw_words(np, KEY, _c64(ctr), m)
        zc, zs = boxmuller.box_muller_f32(w0, w1)
        tol = dict(rtol=2e-6, atol=2e-6)
    else:
        w0, w1 = jctrng.raw_words(np, KEY, _c64(ctr), 2 * m)
        zc, zs = boxmuller.box_muller_f64(w0[:m], w1[:m], w0[m:], w1[m:])
        tol = dict(rtol=0, atol=1e-13)
    got = np.concatenate([zc, zs])[:n]
    host, _ = jctrng.normal(np, KEY, _c64(ctr), n, np.dtype(dtype))
    dev, _ = jctrng.normal(jnp, KEY, _c64(ctr), n, np.dtype(dtype))
    refs = [host, np.asarray(dev)]
    if dtype == "float32":
        refs.append(np.asarray(normal_pallas(n, interpret=True)(
            KEY[0], KEY[1], *ctr)))
    for ref in refs:
        np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_transform_on_cpu_is_the_model(dtype):
    rows = 2 if dtype == torch.float32 else 4
    w = np.random.default_rng(9).integers(0, 1 << 32, (rows, 257),
                                          dtype=np.uint64).astype(np.uint32)
    got = threefry.device_transform(torch.from_numpy(w.astype(np.int64)),
                                    dtype)
    model = boxmuller.box_muller_f32 if rows == 2 else \
        boxmuller.box_muller_f64
    assert got.dtype == dtype and got.shape == (2, 257)
    assert np.array_equal(got.numpy(), np.stack(model(*w)))
    with pytest.raises(ValueError):
        threefry.device_transform(torch.zeros((3, 4), dtype=torch.int64),
                                  dtype)
