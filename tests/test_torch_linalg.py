"""Dense linear algebra of the port against the JAX package: the
counterparts of `tests/test_device_linalg.py` and
`tests/test_conformance_linalg_options.py`, each builtin in double and
single and in its nargout forms, on the same `.m` source through both
packages' device engines on the CPU (`tests/torch_both.py`), and
`dense_linalg.m` at N = 64.

Tolerances: values that LAPACK computes by the same algorithm in both
(solve, inv, det, chol, qr, lu, triangular solves, singular values,
symmetric eigenvalues, norms) within 1e-10 (double) or 1e-4 (single) of
their largest magnitude: XLA and torch call LAPACK through other drivers
and sum in other orders. Where the two return another of several right
answers (eigenvalue order of a general matrix, eigenvector phases), the
port is held to invariants: residuals under 1e-10 (double), spectra as
sorted multisets. Classes, shapes, dtypes and residency equal exactly.
"""

import numpy as np
import pytest

from torch_both import close as both_close, run_both

A6 = "A = gpuArray(reshape(sin(1:36), 6, 6) + 6*eye(6));"
B6 = "B = gpuArray(reshape(1:12, 6, 2));"
S3 = "S = gpuArray([4 1 0; 1 3 1; 0 1 2]);"


def _tol(mclass):
    return 1e-10 if mclass == "double" else 1e-4


def close(b, names, tol=1e-10, device=True):
    """`torch_both.close`, and no host fallback in either package."""
    both_close(b, names, tol, device)
    assert b.td["host_fallbacks"] == 0 == b.jd["host_fallbacks"], b.td


def value(b, n):
    return float(np.asarray(b.ts.get(n).host()).reshape(-1)[0].real)


# ------------------------------------------------------------ solve family

@pytest.mark.parametrize("mclass", ["double", "single"])
def test_mldivide_square(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(sin(1:36), 6, 6) + 6*eye(6)));"
                 f" B = gpuArray({mclass}(reshape(1:12, 6, 2)));",
                 "x = A \\ B; r = norm(A*x - B, 'fro'); c = class(x);")
    close(b, ["x", "r"], _tol(mclass))
    assert b.ts.get("c").to_str() == mclass
    assert value(b, "r") < (1e-12 if mclass == "double" else 1e-3)


def test_mldivide_over_and_underdetermined():
    b = run_both("A = gpuArray([1 0; 1 1; 1 2; 1 3]); b = gpuArray([1;2;4;4.5]);"
                 " C = gpuArray([1 2 3; 4 5 7]); d = gpuArray([6; 16]);",
                 "x = A \\ b; y = C \\ d; r = norm(C*y - d);")
    close(b, ["x", "y", "r"])
    expect = np.linalg.lstsq(np.array([[1, 0], [1, 1], [1, 2], [1, 3]], float),
                             np.array([1, 2, 4, 4.5]), rcond=None)[0]
    np.testing.assert_allclose(b.ts.get("x").host().reshape(-1), expect,
                               rtol=1e-12)
    assert value(b, "r") < 1e-12


def test_mrdivide():
    b = run_both(A6 + B6, "x = B' / A; r = norm(x*A - B', 'fro');")
    close(b, ["x", "r"])


@pytest.mark.parametrize("flags", ["o.UT = true;", "o.LT = true;",
                                   "o.UT = true; o.TRANSA = true;",
                                   "o.LT = true; o.TRANSA = true;"])
def test_linsolve_triangular(flags):
    b = run_both(A6 + "b = gpuArray((1:6)');",
                 f"{flags} x = linsolve(A, b, o);")
    close(b, ["x"])


# ------------------------------------------------------------ factors

@pytest.mark.parametrize("mclass", ["double", "single"])
def test_inv_det_trace(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(sin(1:36), 6, 6) + 6*eye(6)));",
                 "Ai = inv(A); d = det(A); e = norm(Ai*A - eye(6));"
                 " t = trace(A); dn = det(-A);")
    close(b, ["Ai", "d", "e", "t", "dn"], _tol(mclass))


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_lu_all_forms(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(sin((1:36) .^ 1.7), 6, 6)));"
                 f" R = gpuArray({mclass}(reshape(cos((1:12) .^ 1.7), 4, 3)));",
                 "[L, U] = lu(A); [L3, U3, P] = lu(A); Y = lu(A);"
                 " [Lr, Ur, Pr] = lu(R); Yr = lu(R);"
                 " e2 = norm(L*U - A, 'fro'); e3 = norm(P*A - L3*U3, 'fro');")
    close(b, ["L", "U", "L3", "U3", "P", "Y", "Lr", "Ur", "Pr", "Yr", "e2",
              "e3"], _tol(mclass))


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_chol_upper_and_lower(mclass):
    b = run_both(f"S = gpuArray({mclass}([4 1 0; 1 3 1; 0 1 2]));",
                 "R = chol(S); L = chol(S, 'lower'); [R2, p] = chol(S);"
                 " e = norm(R'*R - S, 'fro'); el = norm(L*L' - S, 'fro');")
    close(b, ["R", "L", "R2", "e", "el"], _tol(mclass))
    close(b, ["p"], device=False)
    assert value(b, "p") == 0.0


def test_chol_not_positive_definite_flag_and_error():
    b = run_both("", "[R, p] = chol(gpuArray([1 2; 2 1]));"
                 " [R0, p0] = chol(gpuArray([1 0; 0 0]));"
                 " ok = false; try, chol(gpuArray([1 2; 2 1])); catch e,"
                 " ok = strcmp(e.identifier, 'MATLAB:posdef'); end;"
                 " ok2 = false; try, chol(gpuArray(diag([2 1 0]))); catch e2,"
                 " ok2 = strcmp(e2.identifier, 'MATLAB:posdef'); end")
    close(b, ["R", "p", "R0", "p0", "ok", "ok2"], device=False)
    assert value(b, "p") == 2.0 and value(b, "p0") == 2.0
    assert bool(b.ts.get("ok").host()) and bool(b.ts.get("ok2").host())


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_qr_forms(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(1:12, 4, 3) + eye(4, 3)));",
                 "[Q, R] = qr(A); [Qe, Re] = qr(A, 0); [Qc, Rc] = qr(A, 'econ');"
                 " R1 = qr(A); e = norm(Q*R - A, 'fro');"
                 " o = norm(Q'*Q - eye(4), 'fro');")
    close(b, ["Q", "R", "Qe", "Re", "Qc", "Rc", "R1", "e", "o"], _tol(mclass))
    assert b.ts.get("Qe").shape == (4, 3) and b.ts.get("Q").shape == (4, 4)


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_svd_forms(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(1:12, 4, 3) + 12*eye(4, 3)));",
                 "s = svd(A); [U, S, V] = svd(A); [Ue, Se, Ve] = svd(A, 'econ');"
                 " [U0, S0, V0] = svd(A, 0);"
                 " e = norm(U*S*V' - A, 'fro'); ee = norm(Ue*Se*Ve' - A, 'fro');")
    # singular vectors are unique up to sign: the values and the
    # reconstructions are compared, the factors' shapes and classes
    close(b, ["s", "S", "Se", "S0"], _tol(mclass))
    for n in ("U", "V", "Ue", "Ve", "U0", "V0"):
        assert b.ts.get(n).shape == b.js.get(n).shape, n
        assert b.ts.get(n).mclass == b.js.get(n).mclass, n
    assert value(b, "e") < 1e-4 and value(b, "ee") < 1e-4


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_eig_symmetric_values_and_vectors(mclass):
    b = run_both(f"S = gpuArray({mclass}([4 1 0; 1 3 1; 0 1 2]));",
                 "w = eig(S); [V, D] = eig(S); e = norm(S*V - V*D, 'fro');")
    close(b, ["w", "D", "e"], _tol(mclass))
    assert value(b, "e") < (1e-12 if mclass == "double" else 1e-5)


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_eig_general_real_spectrum_stays_on_the_device(mclass):
    b = run_both(f"A = gpuArray({mclass}([4 1 0; 1 3 1; 2 1 5]));",
                 "w = eig(A);")
    assert b.ts.get("w").mclass == b.js.get("w").mclass == mclass
    assert b.ts.get("w").on_device and b.js.get("w").on_device
    got = np.sort(b.ts.get("w").host().reshape(-1))
    want = np.sort(b.js.get("w").host().reshape(-1))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_eig_general_complex_spectrum():
    b = run_both("A = gpuArray([0 1; -2 -3]); B = gpuArray([1 -2; 4 1]);",
                 "wr = sort(real(eig(A))); wc = eig(B);")
    close(b, ["wr"], device=False)
    got = np.sort_complex(b.ts.get("wc").host().reshape(-1))
    want = np.sort_complex(b.js.get("wc").host().reshape(-1))
    assert b.ts.get("wc").is_complex and b.js.get("wc").is_complex
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("n", [2, 5, 24])
def test_eig_full_residual(n):
    rng = np.random.default_rng(11 + n)
    lit = "[" + ";".join(" ".join(repr(float(v)) for v in row)
                         for row in rng.standard_normal((n, n))) + "]"
    b = run_both(f"A = gpuArray({lit});",
                 "[V, D] = eig(A); res = gather(norm(A*V - V*D) / norm(A));"
                 " w = diag(D);")
    assert b.tr.error is None, b.tr.error
    assert value(b, "res") < 1e-10
    got = np.sort_complex(b.ts.get("w").host().reshape(-1).astype(complex))
    want = np.sort_complex(b.js.get("w").host().reshape(-1).astype(complex))
    np.testing.assert_allclose(got, want, atol=1e-10)
    assert b.td["compiles"] + b.td["cache_hits"] == \
        b.jd["compiles"] + b.jd["cache_hits"]


def test_eig_full_pure_complex_pair():
    b = run_both("A = gpuArray([0 -2; 1 0]);",
                 "[V, D] = eig(A); res = gather(norm(A*V - V*D)); dd = gather(D);")
    assert value(b, "res") < 1e-12
    dd = np.asarray(b.ts.get("dd").host())
    assert np.iscomplexobj(dd) and abs(abs(dd[0, 0].imag) - np.sqrt(2)) < 1e-12


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_norm_rank_pinv_cond(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(sin(1:36), 6, 6) + 6*eye(6)));"
                 f" v = gpuArray({mclass}([3 -4 1]));",
                 "nf = norm(A, 'fro'); n1 = norm(A, 1); ni = norm(A, inf);"
                 " n2 = norm(A); rk = rank(A); rk1 = rank(A, 7); P = pinv(A);"
                 " ep = norm(P*A - eye(6), 'fro'); c = cond(A); c1 = cond(A, 1);"
                 " v2 = norm(v); v1 = norm(v, 1); vi = norm(v, inf);"
                 " vm = norm(v, -inf); v3 = norm(v, 3);")
    close(b, ["nf", "n1", "ni", "n2", "rk", "rk1", "P", "ep", "v2", "v1",
              "vi", "vm", "v3"], _tol(mclass))
    close(b, ["c", "c1"], _tol(mclass), device=False)


def test_fro_norm_of_a_vector_on_the_device():
    # JaxEngine's vector-norm builder raises on 'fro' and its failure memo
    # sends the kind to the host (a counted fallback); the port's takes it
    # as the 2-norm on the device, the value MATLAB gives
    b = run_both("v = gpuArray([3 -4 12]);", "vf = norm(v, 'fro');")
    assert b.tr.error is None and b.jr.error is None
    assert value(b, "vf") == float(b.js.get("vf").host().reshape(-1)[0]) \
        == 13.0
    assert b.td["host_fallbacks"] == 0
    assert b.jd["host_fallbacks"] == 1


def test_rank_of_a_singular_matrix():
    b = run_both("A = gpuArray([1 2 3; 2 4 6; 1 0 1]);",
                 "r = rank(A); P = pinv(A); e = norm(A*P*A - A, 'fro');")
    close(b, ["r", "P", "e"])
    assert value(b, "r") == 2.0


def test_ishermitian_steers_eig_like_the_jax_package():
    b = run_both("S = gpuArray([2 1; 1 2]); N = gpuArray([2 1; 1.5 2]);",
                 "ws = eig(S); wn = eig(N);")
    close(b, ["ws"])
    for k in ("compiles", "cache_hits", "host_fallbacks"):
        assert b.td[k] == b.jd[k], k


def test_a_singular_solve_gives_what_lapack_gives():
    b = run_both("A = gpuArray([1 2; 2 4]); y = gpuArray([1; 2]);",
                 "x = A \\ y; bad = any(~isfinite(x));")
    assert bool(b.ts.get("bad").host()) == bool(b.js.get("bad").host())


# ------------------------------------------------------------ the script

def test_dense_linalg_script_matches_the_jax_package():
    src = open("runmat_tpu_torch/workloads/dense_linalg.m").read()
    b = run_both("N = 64;", src)
    for n in ("A", "S", "R", "x", "Q", "Rq", "s", "e", "L", "U", "P", "Si",
              "Pp"):
        assert b.ts.get(n).on_device, n
    close(b, ["s", "e", "x", "R", "d", "r", "tr"], 1e-10)
    close(b, ["res"], 1e-10, device=False)
    for n in ("res_chol", "res_solve", "res_qr", "res_lu", "res_inv",
              "res_pinv"):
        assert value(b, n) < 1e-12, n
    got = np.sort_complex(b.ts.get("w").host().reshape(-1).astype(complex))
    want = np.sort_complex(b.js.get("w").host().reshape(-1).astype(complex))
    np.testing.assert_allclose(got, want, atol=1e-10)
    assert b.tr.output.strip().startswith("RESULT_ok LINALG=")
    for k in ("compiles", "cache_hits", "host_fallbacks"):
        assert b.td[k] == b.jd[k], (k, b.td[k], b.jd[k])
    # on the CPU no torch.linalg call waits for a card
    assert b.td["syncs"] == 0
