"""FFT, signal filters and convolutions of the port against the JAX package
(the counterparts of `tests/test_device_conv.py` and the fft cases of
`tests/test_device_linalg.py`), on the same `.m` source through both
packages' device engines on the CPU (`tests/torch_both.py`), and the IIR
filter's plain version (`ops/iir.py`) against the JAX package's `_b_iir`
scan.

Tolerances: the IIR plain version within 1e-13 (float64) and 1e-6
(float32) of the largest output magnitude of the scan's, because XLA on
the CPU contracts the scan's multiply-adds into FMAs where the port rounds
each product and sum; the model of the kernel's chunked scan
(`iir.chunked_iir`) within `iir.TOL` (1e-10 float64, 1e-4 float32) of it,
its carried states rounded in another order, with the non-finite outputs
in the same places, and bit-equal to the plain version on its first
stretch (the kernel is held to the plain version the same way,
`tests/test_torch_cuda.py`); FFT results, filters and
convolutions within 1e-12 of the largest magnitude (at least 1;
pocketfft and torch's FFT, XLA's and torch's convolutions sum in other
orders), single ones 1e-5 or 1e-6; everything else (shapes, classes,
dtypes, residency, logical values) exactly.
"""

import jax
import numpy as np
import pytest
import torch

from runmat_tpu.accel.dense import _b_iir
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu_torch.ops import iir
from torch_both import close, run_both, same

RTOL = 1e-12


def _dev(b, names, rtol=RTOL):
    close(b, names, rtol)
    assert b.td["host_fallbacks"] == 0 == b.jd["host_fallbacks"], b.td


# --------------------------------------------------------------- the IIR

@pytest.mark.parametrize("order", range(1, 9))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_iir_plain_matches_the_jax_scan(dtype, order):
    jax.config.update("jax_enable_x64", True)
    f = jax.jit(_b_iir(JaxEngine(platform="cpu"), ()))
    rng = np.random.default_rng(100 + order)
    n = order + 1
    x = rng.standard_normal(257).astype(dtype)
    b = (rng.standard_normal(n) * 0.3).astype(dtype)
    a = (rng.standard_normal(n) * 0.1).astype(dtype)
    a[0] = 1
    z0 = (rng.standard_normal(n - 1) * 0.1).astype(dtype)
    want = np.asarray(f(x, b, a, z0))
    before = iir.launches
    got = iir.iir(*(torch.from_numpy(v) for v in (x, b, a, z0))).numpy()
    assert iir.launches == before          # a CPU tensor takes the plain form
    assert got.dtype == want.dtype == dtype
    tol = 1e-13 if dtype == np.float64 else 1e-6
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _jax_iir():
    jax.config.update("jax_enable_x64", True)
    return jax.jit(_b_iir(JaxEngine(platform="cpu"), ()))


def _random_filter(rng, order, dtype):
    """b, a (a[0] = 1) and z0 != 0 of a random filter; the feedback
    coefficients stay small enough for its poles to lie inside the unit
    circle (order 32: sum |a[1:]| < 1)."""
    n = order + 1
    b = (rng.standard_normal(n) * 0.3).astype(dtype)
    a = (rng.standard_normal(n) * (0.1 if order <= 8 else 0.02)).astype(dtype)
    a[0] = 1
    z0 = (rng.standard_normal(n - 1) * 0.1).astype(dtype)
    return b, a, z0


def _resonator(dtype, radius=0.999, theta=0.05):
    """A second-order filter with poles at radius * exp(+-i theta)."""
    b = np.array([0.02, 0.01, -0.005], dtype)
    a = np.array([1, -2 * radius * np.cos(theta), radius ** 2], dtype)
    return b, a, np.array([0.3, -0.2], dtype)


def _held(got, want, dtype):
    """got within iir.TOL of want's largest magnitude where want is finite,
    non-finite exactly where want is."""
    tol = iir.TOL[torch.float64 if dtype == np.float64 else torch.float32]
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    scale = np.abs(want[fin]).max()
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= tol * scale, (err, scale)


N_CHUNKED = 1000


@pytest.mark.parametrize("chunk", [1, 7, 64, N_CHUNKED, 4 * N_CHUNKED])
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6, 7, 8, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_iir_matches_the_jax_scan(dtype, order, chunk):
    # n is no multiple of 7 or 64; z0 is not zero
    rng = np.random.default_rng(200 + order)
    x = rng.standard_normal(N_CHUNKED).astype(dtype)
    b, a, z0 = _random_filter(rng, order, dtype)
    want = np.asarray(_jax_iir()(x, b, a, z0))
    args = [torch.from_numpy(v) for v in (x, b, a, z0)]
    got = iir.chunked_iir(*args, chunk).numpy()
    assert got.dtype == want.dtype == dtype
    _held(got, want, dtype)
    # the first stretch (the whole signal where n <= chunk) is the plain
    # version's, bit for bit
    plain = iir.plain_iir(*args).numpy()
    first = min(chunk, N_CHUNKED)
    assert np.array_equal(got[:first], plain[:first])


@pytest.mark.parametrize("chunk", [1, 16, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_iir_near_a_pole_of_radius_0999(dtype, chunk):
    # G = A^chunk stays near the identity's scale (0.999^64 = 0.94): the
    # carries reach across many stretches
    rng = np.random.default_rng(7)
    n = 64 * 64 + 13
    x = rng.standard_normal(n).astype(dtype)
    b, a, z0 = _resonator(dtype)
    want = np.asarray(_jax_iir()(x, b, a, z0))
    got = iir.chunked_iir(*(torch.from_numpy(v) for v in (x, b, a, z0)),
                          chunk).numpy()
    _held(got, want, dtype)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_iir_carries_a_non_finite_value(dtype, bad):
    # a NaN or Inf in the middle of stretch 9 of 16: every later output
    # is non-finite, through the stretch's end state and the carries
    rng = np.random.default_rng(11)
    chunk = 64
    x = rng.standard_normal(16 * chunk - 5).astype(dtype)
    x[9 * chunk + 30] = bad
    b, a, z0 = _random_filter(rng, 4, dtype)
    want = np.asarray(_jax_iir()(x, b, a, z0))
    got = iir.chunked_iir(*(torch.from_numpy(v) for v in (x, b, a, z0)),
                          chunk).numpy()
    assert np.isfinite(want[:9 * chunk + 30]).all()
    assert not np.isfinite(want[9 * chunk + 30:]).any()
    _held(got, want, dtype)


# the warp kernel's orders (csrc/iir_warp.cu: 33 .. 64, MAX_WARP_COEFS - 1)
WARP_ORDERS = [33, 39, iir.MAX_WARP_COEFS - 1]


def _stable_filter(rng, order, dtype):
    """b, a (a[0] = 1, sum |a[1:]| = 0.5, so every pole lies inside the
    unit circle) and z0 != 0 of a random filter."""
    n = order + 1
    b = (rng.standard_normal(n) * 0.3).astype(dtype)
    a = rng.standard_normal(n)
    a = (a * (0.5 / np.abs(a[1:]).sum())).astype(dtype)
    a[0] = 1
    z0 = (rng.standard_normal(n - 1) * 0.1).astype(dtype)
    return b, a, z0


def _warp_model(x, b, a, z0, chunk, group):
    """The warp kernel's model (sequential carries in groups) and the plain
    version on the same inputs."""
    args = [torch.from_numpy(v) for v in (x, b, a, z0)]
    return (iir.chunked_iir(*args, chunk, group).numpy(),
            iir.plain_iir(*args).numpy())


def test_warp_route_covers_orders_33_to_64():
    # the chunked scan up to 33 coefficients, the warp kernel up to 65
    assert iir.MAX_COEFS == 33 and iir.MAX_WARP_COEFS == 65
    assert WARP_ORDERS[-1] == 64
    for n in (1, 1 << 18, 1 << 22, 1 << 30):
        chunk, group = iir.warp_shape(n)
        assert chunk & (chunk - 1) == 0 and group & (group - 1) == 0


# L = 16 over 1000 samples: 63 stretches, carries in groups of 2 over six
# levels; L = 256: 4 stretches, one level
@pytest.mark.parametrize("chunk,group", [(16, 2), (256, 0)])
@pytest.mark.parametrize("order", WARP_ORDERS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_model_matches_the_jax_scan(dtype, order, chunk, group):
    rng = np.random.default_rng(300 + order)
    x = rng.standard_normal(N_CHUNKED).astype(dtype)
    b, a, z0 = _stable_filter(rng, order, dtype)
    want = np.asarray(_jax_iir()(x, b, a, z0))
    got, plain = _warp_model(x, b, a, z0, chunk, group)
    assert got.dtype == want.dtype == dtype
    _held(got, want, dtype)
    # stretch 0 is the plain version's, bit for bit
    assert np.array_equal(got[:chunk], plain[:chunk])


@pytest.mark.parametrize("chunk,group", [(64, 8), (512, 0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_model_near_a_pole_of_radius_0999(dtype, chunk, group):
    # order 39: a resonator with poles at 0.999 exp(+-0.05 i) times a
    # random order-37 part; the carries reach across many stretches
    rng = np.random.default_rng(39)
    n = 64 * 64 + 13
    x = rng.standard_normal(n).astype(dtype)
    b, a, z0 = _stable_filter(rng, 37, np.float64)
    _, res, _ = _resonator(np.float64)
    b = np.concatenate([b, rng.standard_normal(2) * 0.3]).astype(dtype)
    a = np.convolve(a, res).astype(dtype)
    z0 = (rng.standard_normal(39) * 0.1).astype(dtype)
    assert np.abs(np.roots(a.astype(np.float64))).max() > 0.998
    want = np.asarray(_jax_iir()(x, b, a, z0))
    got, plain = _warp_model(x, b, a, z0, chunk, group)
    _held(got, want, dtype)
    assert np.array_equal(got[:chunk], plain[:chunk])


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_model_carries_a_non_finite_value(dtype, bad):
    # order 39, a NaN or Inf in the middle of stretch 9 of 16: every later
    # output is non-finite, through the stretch's end state and the carries
    rng = np.random.default_rng(12)
    chunk = 64
    x = rng.standard_normal(16 * chunk - 5).astype(dtype)
    x[9 * chunk + 30] = bad
    b, a, z0 = _stable_filter(rng, 39, dtype)
    want = np.asarray(_jax_iir()(x, b, a, z0))
    got, plain = _warp_model(x, b, a, z0, chunk, 4)
    assert np.isfinite(want[:9 * chunk + 30]).all()
    assert not np.isfinite(want[9 * chunk + 30:]).any()
    _held(got, want, dtype)
    assert np.array_equal(got[:chunk], plain[:chunk])


def test_iir_wrapper_checks_its_inputs():
    x = torch.zeros(8, dtype=torch.float64)
    b = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="share"):
        iir.iir(x.float(), b, b, b[:2])
    with pytest.raises(ValueError, match="N - 1"):
        iir.iir(x, b, b, b)
    with pytest.raises(ValueError, match="share"):
        iir.iir(x.to(torch.int64), b, b, b[:2])
    y = iir.iir(torch.zeros(0, dtype=torch.float64), b, b, b[:2])
    assert y.shape == (0,)


def test_iir_zero_state_step_is_the_recurrence():
    # y_i = b0 x_i + z0; z_k = b_{k+1} x_i + z_{k+1} - a_{k+1} y_i
    x = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    b = torch.tensor([1.0, 0.5], dtype=torch.float64)
    a = torch.tensor([1.0, -0.5], dtype=torch.float64)
    y = iir.iir(x, b, a, torch.zeros(1, dtype=torch.float64))
    assert y.tolist() == [1.0, 1.0, 0.5, 0.25]


# --------------------------------------------------------------- filters

@pytest.mark.parametrize("mclass", ["double", "single"])
def test_filter_fir_and_iir(mclass):
    b = run_both(f"x = gpuArray({mclass}(sin(0.1*(1:400))));",
                 "y = filter([0.2 0.2 0.2 0.2 0.2], 1, x); "
                 "z = filter([1 0.5], [1 -0.8 0.2], x); "
                 "zc = filter([1 2 1]/4, [2 -0.4 0.1 0.05], x');")
    _dev(b, ["y", "z", "zc"])
    # double coefficients: a single signal filters in float64, as there
    if mclass == "single":
        assert b.ts.get("y").host().dtype == np.float64


def test_filter_iir_stays_on_the_device_and_counts_no_wait():
    b = run_both("x = gpuArray(sin(0.1*(1:400)));",
                 "r = filter([1 0.5], [1 -0.8 0.2], x);")
    assert b.ts.get("r").on_device
    _dev(b, ["r"])
    assert b.td["syncs"] == 0


def test_filter_butterworth_order_8():
    import scipy.signal as ss
    bb, aa = ss.butter(8, 0.2)
    lit = lambda v: "[" + " ".join(repr(float(t)) for t in v) + "]"
    b = run_both("x = gpuArray(cos(0.3*(1:500)) + 0.2*sin(2.1*(1:500)));",
                 f"y = filter({lit(bb)}, {lit(aa)}, x);")
    _dev(b, ["y"], rtol=1e-10)


# --------------------------------------------------------------- conv

@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_conv_modes(mode):
    b = run_both("x = gpuArray(sin(1:200)); k = gpuArray([1 2 3 2 1]/9);",
                 f"r = conv(x, k, '{mode}'); q = conv(k, x, '{mode}');"
                 f" e = conv(x, [1 -1 0.5 2], '{mode}');")
    _dev(b, ["r", "q", "e"])


def test_conv_column_orientation():
    b = run_both("x = gpuArray((1:50)'); k = gpuArray([1; 1; 1]);",
                 "r = conv(x, k); sz = size(r);")
    _dev(b, ["r", "sz"])
    assert b.ts.get("sz").host().reshape(-1).tolist() == [52, 1]


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("mclass", ["double", "single"])
def test_conv2_modes(mode, mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(cos(1:256), 16, 16)));"
                 f" K = {mclass}([1 0 -1; 2 0 -2; 1 0 -1]);"
                 f" K2 = {mclass}(ones(4, 2) / 8);",
                 f"r = conv2(A, K, '{mode}'); r2 = conv2(A, K2, '{mode}');")
    _dev(b, ["r", "r2"], rtol=RTOL if mclass == "double" else 1e-5)


# --------------------------------------------------------------- fft

@pytest.mark.parametrize("mclass", ["double", "single"])
def test_fft_ifft_with_length_and_dim(mclass):
    b = run_both(f"X = gpuArray({mclass}(reshape(sin(1:24), 4, 6)));"
                 f" v = gpuArray({mclass}(cos(1:16)));",
                 "Y = fft(X); Y2 = fft(X, 8, 2); Y3 = fft(X, 3, 1);"
                 " f = fft(v); g = ifft(f); h = ifft(v); r = real(ifft(fft(v)));"
                 " m = abs(f) + 1;")
    _dev(b, ["Y", "Y2", "Y3", "f", "g", "h", "r", "m"],
         rtol=RTOL if mclass == "double" else 1e-5)
    # an inverse transform stays complex on the device, as there
    assert b.ts.get("g").is_complex and b.ts.get("h").is_complex


def test_fft2_ifft2_roundtrip():
    b = run_both("A = gpuArray(reshape(sin(1:64), 8, 8));",
                 "F = fft2(A); B = real(ifft2(F)); e = norm(B - A, 'fro');"
                 " G = ifft2(F);")
    _dev(b, ["F", "B", "G"])
    assert float(b.ts.get("e").host().reshape(-1)[0]) < 1e-12


def test_fftshift_of_a_device_spectrum():
    b = run_both("v = gpuArray(1:8);",
                 "s = fftshift(fft(v)); t = ifftshift(abs(fft(v)));")
    close(b, ["s", "t"], RTOL)


def test_fft_of_a_complex_input():
    b = run_both("z = gpuArray(sin(1:32) + 1i*cos(1:32));",
                 "f = fft(z); g = ifft(f, 40); p = abs(f) .^ 2;")
    _dev(b, ["f", "g", "p"])


# --------------------------------------------------------------- analytic

@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("mclass", ["double", "single"])
def test_hilbert_and_envelope(mclass, n):
    b = run_both(f"x = gpuArray({mclass}(sin(0.3*(1:{n})) .* (1 + 0.5*cos(0.05*(1:{n})))));"
                 f" c = gpuArray({mclass}(cos(0.2*(1:{n}))'));",
                 "h = hilbert(x); e = envelope(x); hc = hilbert(c);"
                 " ec = envelope(c);")
    # single: the float32 FFT of pocketfft and of torch round apart
    _dev(b, ["h", "e", "hc", "ec"], RTOL if mclass == "double" else 1e-6)


def test_spectrogram_and_pwelch():
    b = run_both("x = gpuArray(sin(0.2*(1:2048)) + 0.1*cos(1.3*(1:2048)));",
                 "S = spectrogram(x, hann(256), 128, 256);"
                 " [S2, F, T] = spectrogram(x, 128);"
                 " p = pwelch(x, 256);")
    close(b, ["S", "S2", "F", "T", "p"], RTOL)
    # the STFT comes back to the host, a counted gather
    assert not b.ts.get("S").on_device
    assert b.td["gathers"] >= 3


def test_window_builtins_and_sinc():
    b = run_both("", "w1 = hann(16); w2 = hamming(9); w3 = blackman(8);"
                 " w4 = bartlett(7); w5 = rectwin(3); w6 = kaiser(10, 3);"
                 " s = sinc(-2:0.5:2);")
    same(b, ["w1", "w2", "w3", "w4", "w5", "w6", "s"])


# --------------------------------------------------------------- the script

def test_spectral_script_matches_the_jax_package():
    src = open("runmat_tpu_torch/workloads/spectral.m").read()
    b = run_both("N = 2^12;", src)
    for n in ("x", "y", "z", "X", "P", "yb", "env", "c", "G"):
        assert b.ts.get(n).on_device, n
    close(b, ["res", "P", "z", "yb", "env", "c", "s1k"], RTOL)
    close(b, ["G"], 1e-6)
    assert b.tr.output.strip().startswith("RESULT_ok SPECTRAL=")
    for k in ("compiles", "cache_hits", "host_fallbacks"):
        assert b.td[k] == b.jd[k], (k, b.td[k], b.jd[k])
    assert b.td["host_fallbacks"] == 0
