"""Complex values on the port's device engine: complex64/complex128
tensors, JaxEngine's native-complex mode (the one it takes on the CPU),
against the JAX package on the same `.m` source (`tests/torch_both.py`),
covering the surface `tests/test_complex_planes.py` pins for the
split-plane mode: upload and gather, elementwise math, arithmetic and
comparisons, matrix products, reductions and scans, indexed reads and
writes, structural ops, and FFTs.

MATLAB's rules where JaxEngine's native mode leaves them to jax.numpy:
`<`, `<=`, `>`, `>=` compare real parts, and `max`/`min` pick by modulus
(then by angle). There the port follows MATLAB, as the JAX package's host
engine and its split-plane mode do, and the tests hold it to the host
engine; jax.numpy orders complex numbers lexicographically.

Tolerances: values within 1e-13 (complex128) or 1e-5 (complex64) of the
largest magnitude (transcendental functions of numpy's, XLA's and torch's
libraries); classes, shapes, dtypes, residency and logical values exactly.
"""

import numpy as np
import pytest

from torch_both import close, run_both
from runmat_tpu_torch.session import Session as PortHostSession

Z = "z = gpuArray([1+2i, 3-4i, -2+1i, 0.5-0.25i]);"
W = "w = gpuArray([2-1i, -1+1i, -2+5i, 0.5+0.25i]);"


def host_values(src: str, names):
    """The port's host engine on the same source (MATLAB's complex
    rules, as `runtime/dispatch.py` and the reductions apply them)."""
    s = PortHostSession(accelerate=False)
    r = s.execute(src.replace("gpuArray", ""))
    assert r.error is None, r.error
    return [np.asarray(s.get(n).host()) for n in names]


@pytest.mark.parametrize("cls", ["double", "single"])
def test_upload_and_gather(cls):
    b = run_both(f"h = {cls}([1+2i, 3-4i; -0.5i, 7]);",
                 "g = gpuArray(h); back = gather(g + 0); re = real(g);"
                 " on = existsOnGPU(g);")
    close(b, ["g", "re"], 1e-6, device=True)
    close(b, ["back", "on"], 1e-13)
    assert b.ts.get("back").host().dtype == (
        np.complex128 if cls == "double" else np.complex64)
    assert b.td["host_fallbacks"] == 0


@pytest.mark.parametrize("cls", ["double", "single"])
def test_elementwise_surface(cls):
    b = run_both(f"z = gpuArray({cls}([1+2i, 3-4i, -2+1i, 0.5-0.25i]));",
                 "ab = abs(z); cj = conj(z); re = real(z); im = imag(z);"
                 " an = angle(z); sq = sqrt(z); ex = exp(z); lg = log(z);"
                 " sg = sign(z); ng = -z; sn = sin(z); tn = tanh(z);"
                 " rc = 1 ./ z; nn = isnan(z); fi = isfinite(z);"
                 " as = asin(z); ac = acos(z);")
    close(b, "ab cj re im an sq ex lg sg ng sn tn rc nn fi as ac".split(),
          1e-13 if cls == "double" else 1e-5, device=True)
    assert b.td["host_fallbacks"] == 0


def test_rounding_acts_on_each_part():
    # jax.numpy refuses floor/ceil of complex values; MATLAB (and the host
    # engine) round the real and imaginary parts on their own
    src = Z + ("fl = floor(z * 1.5); rd = round(z * 1.5); fx = fix(z * 1.5);"
               " ce = ceil(z * 1.5);")
    b = run_both("", src)
    names = ["fl", "rd", "fx", "ce"]
    assert b.tr.error is None, b.tr.error
    for n, want in zip(names, host_values(src, names)):
        got = b.ts.get(n)
        assert got.on_device and got.is_complex, n
        np.testing.assert_array_equal(got.host(), want, err_msg=n)


def test_binary_arithmetic_and_equality():
    b = run_both(Z + W, "s = z + w; d = z - w; m = z .* w; q = z ./ w;"
                 " p = z .^ 2; pc = z .^ (1+1i); mixed = z * 2 + 1;"
                 " cs = z * (2-3i) + (0.5+1i); eqv = z == z; nev = z ~= w;"
                 " rl = real(z) + w; ld = z .\\ w;")
    close(b, "s d m q p pc mixed cs eqv nev rl ld".split(), 1e-13,
          device=True)
    assert b.td["host_fallbacks"] == 0


def test_ordering_compares_real_parts():
    src = Z + W + ("lt = z < w; le = z <= w; gt = z > w; ge = z >= w;"
                   " lr = z < 0.75;")
    b = run_both(src)
    names = ["lt", "le", "gt", "ge", "lr"]
    for n, want in zip(names, host_values(src, names)):
        got = b.ts.get(n)
        assert got.on_device and got.mclass == "logical", n
        assert np.array_equal(got.host(), want), n
    # jax.numpy orders complex lexicographically: -2+1i < -2+5i there
    assert bool(b.js.get("lt").host()[0, 2]) and \
        not bool(b.ts.get("lt").host()[0, 2])


def test_max_min_by_modulus_then_angle():
    src = ("z = gpuArray([1+2i, 3-4i, -2+1i, 2-1i; 5i, -5, 1, NaN+1i]);"
           " mx = max(z); mn = min(z); ma = max(z, [], 2); mi = min(z, [], 2);"
           " m2 = max(z, 2.5); n2 = min(z, 0.5i);")
    b = run_both(src)
    names = ["mx", "mn", "ma", "mi"]
    for n, want in zip(names, host_values(src, names)):
        got = b.ts.get(n)
        assert got.on_device and got.is_complex, n
        np.testing.assert_array_equal(got.host(), want, err_msg=n)
    m2 = b.ts.get("m2").host()
    zh = np.array([[1 + 2j, 3 - 4j, -2 + 1j, 2 - 1j],
                   [5j, -5, 1, complex(np.nan, 1)]])
    want = np.where((np.abs(zh) > 2.5) | np.isnan(zh), zh, 2.5)
    want[1, 3] = 2.5                      # NaN is ignored
    np.testing.assert_array_equal(m2, want)


def test_matrix_products():
    b = run_both("A = gpuArray(reshape(sin(1:16), 4, 4) + 1i*reshape(cos(1:16), 4, 4));"
                 " B = gpuArray(reshape(1:16, 4, 4));"
                 " As = single(A);",
                 "C = A * A; D = A * B; E = B * A'; F = A.' * A;"
                 " Cs = As * As; G = A';")
    close(b, ["C", "D", "E", "F", "G"], 1e-13, device=True)
    close(b, ["Cs"], 1e-5, device=True)


def test_reductions_and_scans():
    b = run_both("z = gpuArray([1+2i, 3-4i, -2+1i; 0.5i, 2, -1-1i]);",
                 "s = sum(z); s2 = sum(z, 2); sa = sum(z, 'all'); m = mean(z);"
                 " p = prod(z); c = cumsum(z); c2 = cumsum(z, 2);"
                 " cp = cumprod(z); a = any(z); al = all(z); nz = nnz(z);")
    for n in ("s", "s2", "sa", "m"):
        assert b.ts.get(n).on_device, n
    # the rest take the host path in both packages, as the builtins route
    close(b, "s s2 sa m c c2 cp a al nz p".split(), 1e-13)
    assert b.td["host_fallbacks"] == 0


def test_index_reads_and_writes():
    b = run_both("z = gpuArray([1+2i, 3-4i, 5+6i, 7-8i]);"
                 " M = gpuArray([1+1i 2+2i; 3+3i 4+4i]);",
                 "a = z(2:3); g = z([4 1 1]); z(1) = 9 + 9i; z([2 4]) = [1i 2i];"
                 " col = M(:, 2); row = M(2, :); M(2, :) = [5i 6]; N = M;"
                 " fl = flipud(gpuArray([1+1i; 2+2i])); tp = gpuArray([1+1i; 2-3i])';"
                 " rs = reshape(gpuArray([1+1i 2+2i 3+3i 4+4i]), 2, 2);"
                 " ct = [z(1), z(2)]; ci = circshift(z, 1); k = kron(M, [1 1i]);")
    for n in ("a", "g", "col", "row", "fl", "tp", "rs"):
        assert b.ts.get(n).on_device, n
    close(b, "a g z col row fl tp rs ct ci k N".split(), 1e-13)
    assert b.td["host_fallbacks"] == 0


def test_a_real_write_into_a_complex_array_takes_the_host_path():
    # JaxEngine's gate (a write that changes complexity goes to the host)
    b = run_both("M = gpuArray([1+1i 2+2i; 3+3i 4+4i]);", "M(2, 1) = 0;")
    close(b, ["M"], 1e-13)
    assert np.array_equal(b.ts.get("M").host(), [[1 + 1j, 2 + 2j],
                                                  [0, 4 + 4j]])


def test_complex_result_of_real_inputs_stays_on_the_device():
    b = run_both("x = gpuArray([1 2 3 4]);",
                 "y = x + 1i; f = fft(x); g = abs(f) .^ 2 + 1; h = real(f) .* x;")
    close(b, ["y", "f", "g", "h"], 1e-13, device=True)
    assert b.td["host_fallbacks"] == 0
    # a complex node runs eagerly; the real ops fed by abs(f) fuse
    eager = [e for e in b.teng.launch_log if e.get("eager")]
    assert any("complex operand" in x for e in eager for x in e["eager"])


def test_compiles_and_cache_hits_equal_the_jax_package():
    b = run_both(Z + W, "for k = 1:3, s = abs(z .* w + k); end; t = sum(s);")
    for k in ("compiles", "cache_hits", "host_fallbacks"):
        assert b.td[k] == b.jd[k], (k, b.td[k], b.jd[k])


def test_std_var_of_complex_values():
    src = ("z = gpuArray([1+2i, 3-4i, NaN, 0.5i; 2, -1i, 1+1i, 4]);"
           " v = var(z); s = std(z, 0, 2); vn = var(z, 0, 2, 'omitnan');")
    b = run_both(src)
    names = ["v", "s", "vn"]
    for n, want in zip(names, host_values(src, names)):
        got = np.asarray(b.ts.get(n).host())
        np.testing.assert_allclose(got.real, want.real, rtol=1e-13,
                                   equal_nan=True, err_msg=n)


@pytest.mark.parametrize("op", ["abs", "real", "imag", "angle", "isnan"])
def test_real_result_of_a_complex_host_scalar(op):
    # a complex scalar on the host, taken to the device by auto-offload:
    # the port keeps it complex as the op's parameter and matches the host
    # engine; JaxEngine's native mode casts it to the real result type
    # first (abs(2i) is 0 there), a standing difference (ROADMAP Queue C)
    src = f"c = 3 - 2i; r = {op}(c);"
    b = run_both(src)
    (want,) = host_values(src, ["r"])
    got = np.asarray(b.ts.get("r").host())
    assert got.dtype == want.dtype and got.shape == want.shape
    # the module's tolerance: torch's complex abs and numpy's round apart
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
