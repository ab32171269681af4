"""The port's plain PyTorch Threefry against the JAX package's three forms of
the same stream: the Pallas kernel in interpret mode, the jnp device path of
`ops/ctrng.py`, and its numpy host path.

Tolerances: words and uniforms (f32, f64) bit-exact; normals f32
atol=rtol=2e-6 and f64 atol=1e-13, because Box-Muller goes through each
backend's libm (log/cos/sin), which differ by a few ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runmat_tpu.ops import ctrng as jctrng
from runmat_tpu.ops.pallas.threefry import (normal_pallas, raw_words_pallas,
                                            uniform_pallas)
from runmat_tpu_torch.ops import ctrng, threefry

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

