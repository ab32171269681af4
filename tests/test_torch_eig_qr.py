"""The general eigenproblem of the port (`runmat_tpu_torch/accel/eig_qr.py`
and the plain versions of its kernels, `ops/eig_qr.py`) against the JAX
package's `runmat_tpu/accel/eig_qr.py`, on the CPU in float64, function by
function, on inputs made with numpy from a seed.

Fixtures: random matrices of n = 0, 1, 2, 3, 5, 24 and 64, and the
fixtures of `tests/test_device_linalg.py`: a defective 2 I + superdiagonal,
a nilpotent-like shift, a symmetric B + B', kron(eye(4), [1 2; 3 4]), a pure
complex pair, and a graded matrix (rows and columns spanning 10^-8..10^8)
for `balance`.

Tolerances, relative to the largest magnitude of the input (or of the
eigenvalues):
* `balance`, `balance_d`, `hessenberg`, `hessenberg_q`: 1e-12 (XLA and
  torch sum the dot products in other orders).
* `francis_qr_z` on the same padded Hessenberg matrix: `ok` and the
  iteration count equal (the JAX loop converges within the port's count
  and not within one fewer); the same 2x2 blocks; T and Z within 1e-10
  outside the rows and columns of 2x2 blocks, each block's eigenvalues
  within 1e-10 and the subspace its two columns of Z span (Z_b Z_b')
  within 1e-10. Inside a 2x2 block the iteration leaves the block's
  representation turning sweep by sweep (it stops only the subdiagonal
  below it), so a difference of one ulp in a product (XLA's CPU dot
  fuses some of its sums, torch's and the kernel's sums round apart)
  turns the final block, its rows of T and its columns of Z by an O(1)
  rotation; everything else is unique up to rounding. Z T Z' = H_in
  within 1e-10 holds for the port as for the JAX version.
* `eig_values`, `eig_full`: wr and wi in the same order within 1e-10 of
  the largest eigenvalue; V column by column within 1e-9 up to a factor of
  modulus one (a complex column's phase follows its block's rotation).
  The defective and nilpotent-like fixtures are matched greedily within
  1e-6, as the JAX test matches them, with V held to its residual.
* `_house3`: bit for bit against the JAX function run op by op.
* The builders `eig_qr` and `eig_full` of the port's DenseOps call neither
  torch.linalg.eig nor torch.linalg.eigvals.
* The schedule model of the eig_francis kernel (`tests/torch_francis_model.py`)
  under random and adversarial schedules, at small sizes that reach every
  hand-off and at the kernel's own: no access unordered by the kernel's
  synchronisation, no deadlock, and T, Z and info equal to
  `plain_francis` value for value.
"""

import jax
import numpy as np
import pytest
import torch

from runmat_tpu.accel import eig_qr as J
from runmat_tpu_torch.accel import eig_qr as P
from runmat_tpu_torch.ops import eig_qr as K

jax.config.update("jax_enable_x64", True)
jnp = jax.numpy

TOL_STEP = 1e-12
TOL_QR = 1e-10
TOL_V = 1e-9
TOL_ILL = 1e-6


def _fixture(name: str) -> np.ndarray:
    if name.startswith("random"):
        n = int(name[len("random"):])
        return np.random.default_rng(100 + n).standard_normal((n, n))
    if name == "defective":
        return np.eye(12) * 2 + np.diag(np.ones(11), 1)
    if name == "nilpotent":
        return np.diag(np.ones(15), -1)
    if name == "symmetric":
        B = np.random.default_rng(12).standard_normal((32, 32))
        return B + B.T
    if name == "kron":
        return np.kron(np.eye(4), np.array([[1.0, 2], [3, 4]]))
    if name == "complex_pair":
        return np.array([[0.0, -1], [1, 0]])
    if name == "graded":
        rng = np.random.default_rng(9)
        d = 10.0 ** np.linspace(-8, 8, 10)
        return d[:, None] * rng.standard_normal((10, 10)) / d[None, :]
    raise KeyError(name)


RANDOM = [f"random{n}" for n in (0, 1, 2, 3, 5, 24, 64)]
ILL = ("defective", "nilpotent")
FIXTURES = RANDOM + ["defective", "nilpotent", "symmetric", "kron",
                     "complex_pair", "graded"]
NONEMPTY = [f for f in FIXTURES if f != "random0"]
SQUARE = [f for f in NONEMPTY if f != "random1"]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _scale(a) -> float:
    return max(1.0, float(np.max(np.abs(a)))) if np.size(a) else 1.0


def _jit(fn):
    return jax.jit(lambda *a: fn(jnp, *a))


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * _scale(want), (what, err)


@pytest.mark.parametrize("name", NONEMPTY)
def test_balance_and_balance_d(name):
    A = _fixture(name)
    want = np.asarray(_jit(J.balance)(A))
    _close(P.balance(_t(A)).numpy(), want, TOL_STEP, "balance")
    wa, wd = (np.asarray(v) for v in _jit(J.balance_d)(A))
    ga, gd = P.balance_d(_t(A))
    _close(ga.numpy(), wa, TOL_STEP, "balance_d A")
    _close(gd.numpy(), wd, TOL_STEP, "balance_d d")
    if name == "graded":      # balancing evens the grading out
        assert np.max(np.abs(ga.numpy())) < 1e-3 * np.max(np.abs(A))


@pytest.mark.parametrize("name", NONEMPTY)
def test_hessenberg_and_hessenberg_q(name):
    A = np.asarray(_jit(J.balance)(_fixture(name)))
    wh, wq = (np.asarray(v) for v in _jit(J.hessenberg_q)(A))
    gh, gq = P.hessenberg_q(_t(A))
    _close(gh.numpy(), wh, TOL_STEP, "H")
    _close(gq.numpy(), wq, TOL_STEP, "Q")
    _close(P.hessenberg(_t(A)).numpy(), np.asarray(_jit(J.hessenberg)(A)),
           TOL_STEP, "H alone")
    assert np.all(np.tril(gh.numpy(), -2) == 0)       # exact zeros
    _close(gq.numpy() @ gh.numpy() @ gq.numpy().T, A, TOL_STEP, "QHQ'")


def _padded_hessenberg(A: np.ndarray) -> np.ndarray:
    n = A.shape[0]
    Hp = np.zeros((n + 3, n + 3))
    Hp[:n, :n] = np.asarray(_jit(J.hessenberg)(np.asarray(
        _jit(J.balance)(A))))
    return Hp


_FRANCIS = jax.jit(lambda H, m: J.francis_qr_z(jnp, H, H.shape[0] - 3, m))


def _blocks(T: np.ndarray, n: int) -> np.ndarray:
    """The rows (and columns) of T's 2x2 blocks."""
    sub = np.diagonal(T, -1)[:n - 1] != 0
    inb = np.zeros(n, bool)
    inb[:-1] |= sub
    inb[1:] |= sub
    return inb


@pytest.mark.parametrize("name", SQUARE)
def test_francis_qr_z(name):
    A = _fixture(name)
    n = A.shape[0]
    Hp = _padded_hessenberg(A)
    maxit = 40 * n + 100
    wT, wZ, wok = (np.asarray(v) for v in _FRANCIS(Hp, maxit))
    gT, gZ, info = K.francis(_t(Hp), n, maxit, True)
    ok, it, chain = info.tolist()
    assert bool(ok) == bool(wok)
    # the JAX loop ends within the port's count of iterations, not one fewer
    assert bool(_FRANCIS(Hp, it)[2]) and not bool(_FRANCIS(Hp, it - 1)[2])
    assert 0 <= chain <= it * n          # bulge positions of the sweeps
    gT, gZ = gT.numpy(), gZ.numpy()
    inb = _blocks(wT, n)
    assert np.array_equal(inb, _blocks(gT, n)), name
    s = _scale(Hp)
    out = ~inb
    _close(gT[:n, :n][np.ix_(out, out)], wT[:n, :n][np.ix_(out, out)],
           TOL_QR * s / _scale(wT), "T outside the 2x2 blocks")
    _close(gZ[:n, :n][:, out], wZ[:n, :n][:, out], TOL_QR, "Z columns")
    wr_w, wi_w, _, _ = (np.asarray(v) for v in J._quasi_eigs(
        jnp, jnp.asarray(wT[:n, :n]), n))
    wr_g, wi_g, _, _ = (v.numpy() for v in P._quasi_eigs(
        torch.from_numpy(gT[:n, :n].copy()), n))
    _close(wr_g, wr_w, TOL_QR * s / _scale(wr_w), "block eigenvalues re")
    _close(wi_g, wi_w, TOL_QR * s / _scale(wr_w), "block eigenvalues im")
    for i in np.flatnonzero(np.diagonal(wT, -1)[:n - 1] != 0):
        zb_w, zb_g = wZ[:n, i:i + 2], gZ[:n, i:i + 2]
        _close(zb_g @ zb_g.T, zb_w @ zb_w.T, TOL_QR, f"block {i} subspace")
    _close(gZ[:n, :n] @ gT[:n, :n] @ gZ[:n, :n].T, Hp[:n, :n], TOL_QR,
           "Z T Z'")
    H2, ok2 = P.francis_qr(_t(Hp), n, maxit)
    assert bool(ok2) == bool(ok) and np.array_equal(H2.numpy(), gT)


def _match_greedy(got, want, tol):
    got = list(np.asarray(got, complex))
    err = 0.0
    for w in np.asarray(want, complex):
        d = [abs(g - w) for g in got]
        j = int(np.argmin(d))
        err = max(err, d[j])
        got.pop(j)
    assert err <= tol * _scale(np.abs(want)), err


@pytest.mark.parametrize("name", FIXTURES)
def test_eig_values_in_the_same_order(name):
    A = _fixture(name)
    wr, wi, wok = (np.asarray(v) for v in _jit(J.eig_values)(A))
    gr, gi, gok = P.eig_values(_t(A))
    assert bool(gok) == bool(wok)
    assert gr.dtype == gi.dtype == torch.float64
    if name in ILL:
        _match_greedy(gr.numpy() + 1j * gi.numpy(), wr + 1j * wi, TOL_ILL)
        return
    s = _scale(np.abs(wr + 1j * wi))
    _close(gr.numpy(), wr, TOL_QR * s / _scale(wr), "wr")
    _close(gi.numpy(), wi, TOL_QR * s / _scale(wi), "wi")


@pytest.mark.parametrize("name", FIXTURES)
def test_eig_full_in_the_same_order(name):
    A = _fixture(name)
    n = A.shape[0]
    Vr, Vi, wr, wi, wok = (np.asarray(v) for v in _jit(J.eig_full)(A))
    gVr, gVi, gr, gi, gok = (v.numpy() for v in P.eig_full(_t(A)))
    assert bool(gok) == bool(wok)
    assert gVr.shape == Vr.shape == (n, n)
    if n == 0:
        return
    V, gV = Vr + 1j * Vi, gVr + 1j * gVi
    w, gw = wr + 1j * wi, gr + 1j * gi
    if name in ILL:
        _match_greedy(gw, w, TOL_ILL)
        res = np.linalg.norm(A @ gV - gV @ np.diag(gw)) / np.linalg.norm(A)
        assert res < 1e-10, res
        return
    s = _scale(np.abs(w))
    _close(gr, wr, TOL_QR * s / _scale(wr), "wr")
    _close(gi, wi, TOL_QR * s / _scale(wi), "wi")
    np.testing.assert_allclose(np.linalg.norm(gV, axis=0), 1.0, atol=1e-12)
    for j in range(n):
        c = np.vdot(V[:, j], gV[:, j])          # the columns' relative phase
        phase = c / abs(c) if abs(c) > 0 else 1.0
        err = float(np.max(np.abs(gV[:, j] - phase * V[:, j])))
        assert err <= TOL_V, (j, err)


@pytest.mark.parametrize("case", range(8))
def test_house3_bit_for_bit(case):
    rng = np.random.default_rng(case)
    x, y, z = (float(v) for v in rng.standard_normal(3) *
               10.0 ** rng.integers(-20, 20, 3))
    if case == 1:
        x = 0.0
    if case == 2:
        x = y = z = 0.0
    use3 = case % 3 != 0
    want = np.asarray(J._house3(jnp, jnp.float64(x), jnp.float64(y),
                                jnp.float64(z), use3))
    got = np.array(K._house3(x, y, z, use3))
    assert np.array_equal(got, want), (got, want)


def test_trevc_on_the_jax_schur_form():
    """The eigenvectors of one quasi-triangular T through both."""
    A = _fixture("random24")
    n = A.shape[0]
    T = np.asarray(_FRANCIS(_padded_hessenberg(A), 40 * n + 100)[0])[:n, :n]
    Tj = jnp.asarray(T)
    q = J._quasi_eigs(jnp, Tj, n)
    Yr, Yi = (np.asarray(v) for v in jax.jit(
        lambda *a: J.trevc(jnp, *a))(Tj, *q))
    gq = P._quasi_eigs(_t(T), n)
    for a, b in zip(q, gq):
        assert np.array_equal(np.asarray(a), b.numpy())
    gYr, gYi = P.trevc(_t(T), *gq)
    _close(gYr.numpy(), Yr, TOL_V, "Yr")
    _close(gYi.numpy(), Yi, TOL_V, "Yi")


def test_a_cpu_tensor_launches_nothing():
    A = _t(_fixture("random24"))
    before = K.launches
    P.eig_full(A)
    P.eig_values(A)
    assert K.launches == before


@pytest.mark.parametrize("with_z", [True, False])
def test_a_cpu_tensor_takes_plain_francis(monkeypatch, with_z):
    """francis on a CPU tensor is plain_francis (T, Z and info equal) and
    reaches no kernel entry."""
    def refuse(*a, **k):
        raise AssertionError("a kernel entry reached")

    monkeypatch.setattr(K, "_entry", refuse)
    n = 24
    Hp = _t(_padded_hessenberg(_fixture("random24")))
    before = K.launches
    T, Z, info = K.francis(Hp, n, 40 * n + 100, with_z)
    pT, pZ, pinfo = K.plain_francis(Hp, n, 40 * n + 100, with_z)
    assert K.launches == before
    assert torch.equal(T, pT) and torch.equal(info, pinfo)
    assert (Z is None and pZ is None) if not with_z else torch.equal(Z, pZ)


def test_the_bench_only_entries_are_named_only_by_linalgbench():
    """runmat_eig_francis_barrier (the earlier design) and
    runmat_eig_francis_chain (the chaser and helper alone) are defined in
    csrc/eig_qr.cu and named by linalgbench.py alone: ops/eig_qr.py's
    francis launches runmat_eig_francis."""
    import inspect
    from pathlib import Path
    pkg = Path(K.__file__).resolve().parents[1]
    names = ("runmat_eig_francis_barrier", "runmat_eig_francis_chain")
    files = sorted(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]
    naming = {p.relative_to(pkg.parent).as_posix() for p in files
              if any(name in p.read_text() for name in names)}
    assert naming == {"runmat_tpu_torch/linalgbench.py"}, naming
    cu = (pkg / "csrc" / "eig_qr.cu").read_text()
    for name in names + ("runmat_eig_francis",):
        assert f'extern "C" int {name}(' in cu, name
    src = inspect.getsource(K.francis)
    assert '"runmat_eig_francis"' in src
    assert not any(name in src for name in names)


@pytest.mark.parametrize("label", ["band 31", "band 32", "band 33",
                                   "band 67", "splits", "graded"])
def test_the_hand_off_cases(label):
    """The matrices the card holds eig_francis to plain_francis on
    (`linalgbench.francis_cases`) are padded upper Hessenberg, and the
    plain iteration converges on them with Z T Z' = H."""
    from runmat_tpu_torch import linalgbench
    Hp, n = linalgbench.francis_cases(torch.device("cpu"))[label]
    h = Hp.numpy()
    assert h.shape == (n + 3, n + 3)
    assert np.all(np.tril(h, -2) == 0) and not np.any(h[n:]) \
        and not np.any(h[:, n:])
    T, Z, info = K.francis(Hp, n, 40 * n + 100, True)
    assert info.tolist()[0] == 1
    T, Z = T.numpy()[:n, :n], Z.numpy()[:n, :n]
    _close(Z @ T @ Z.T, h[:n, :n], TOL_QR, "Z T Z'")
    if label == "splits":       # the deflated ends stay where they were
        assert T[1, 0] == 0 and T[n - 1, n - 2] == 0


# eig_francis' sizes in the schedule model: the kernel's own (csrc/eig_qr.cu:
# kBand, kRing, kHand, owner_slots, a warp) and two cut down, so that small
# matrices reach every hand-off, reuse ring entries within a sweep and have
# several owner warps and several indices a thread
MODEL_KERNEL = dict(band=32, ring=256, hand=64, slots=576, warp=32)
MODEL_SIZES = {"band 4, ring 2": dict(band=4, ring=2, hand=8, slots=8,
                                      warp=4),
               "band 8, ring 4": dict(band=8, ring=4, hand=16, slots=12,
                                      warp=4)}
MODEL_SCHEDULES = ("random", "chaser", "owners")


def _model_case(label: str):
    if label.startswith("random"):
        n = int(label[len("random"):])
        return torch.from_numpy(_padded_hessenberg(_fixture(label))), n
    from runmat_tpu_torch import linalgbench
    return linalgbench.francis_cases(torch.device("cpu"))[label]


def _model_equals_plain(label, with_z, sizes, schedule, seed=0):
    import torch_francis_model as FM
    Hp, n = _model_case(label)
    maxit = 40 * n + 100
    H, Zt, info, _ = FM.francis(Hp, n, maxit, with_z, schedule=schedule,
                                seed=seed, **sizes)
    pT, pZ, pinfo = K.plain_francis(Hp, n, maxit, with_z)
    assert info == pinfo.tolist(), (info, pinfo.tolist())
    assert torch.equal(torch.tensor(H, dtype=torch.float64), pT)
    if with_z:
        assert torch.equal(torch.tensor(Zt, dtype=torch.float64).mT, pZ)


@pytest.mark.parametrize("schedule", MODEL_SCHEDULES)
@pytest.mark.parametrize("sizes", sorted(MODEL_SIZES))
@pytest.mark.parametrize("label", ["random5", "random24", "splits",
                                   "graded"])
def test_the_schedule_model_equals_plain_francis(label, sizes, schedule):
    """The kernel's chaser, helper and owner warps as coroutines under one
    schedule, with Z: every read and write ordered by the kernel's counts,
    fences and barriers, and the result plain_francis's value for
    value."""
    _model_equals_plain(label, True, MODEL_SIZES[sizes], schedule, seed=7)


@pytest.mark.parametrize("schedule", MODEL_SCHEDULES)
def test_the_schedule_model_without_z(schedule):
    _model_equals_plain("random24", False, MODEL_SIZES["band 4, ring 2"],
                        schedule, seed=3)


def test_the_schedule_model_at_the_kernels_sizes():
    """n = 67 (2 kBand + 3) with the kernel's band, ring, hand-off slots and
    owner warps: columns enter the band from their owners."""
    _model_equals_plain("band 67", True, MODEL_KERNEL, "random", seed=1)


@pytest.mark.parametrize("schedule", MODEL_SCHEDULES)
def test_the_schedule_model_sees_an_unordered_ring_reuse(schedule):
    """With each owner warp's count a plain store read without acquire, the
    chaser's reuse of a ring entry is not ordered after the owners' reads
    of it, and the model says so."""
    import torch_francis_model as FM
    Hp, n = _model_case("random24")
    with pytest.raises(FM.Race, match="ring"):
        FM.francis(Hp, n, 40 * n + 100, True, schedule=schedule,
                   release=False, **MODEL_SIZES["band 4, ring 2"])


def test_the_builders_call_no_lapack_eig(monkeypatch):
    """eig_qr and eig_full of the port's DenseOps run the Francis QR, not
    torch.linalg.eig/eigvals."""
    import runmat_tpu_torch
    from runmat_tpu_torch.values import MatArray

    def refuse(*a, **k):
        raise AssertionError("torch.linalg.eig reached")

    monkeypatch.setattr(torch.linalg, "eig", refuse)
    monkeypatch.setattr(torch.linalg, "eigvals", refuse)
    A = _fixture("random24")
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    try:
        eng = runmat_tpu_torch.accel.active_engine()
        s.set("A", MatArray(A, "double"))
        r = s.execute("w = eig(gpuArray(A)); [V, D] = eig(gpuArray(A));"
                      " res = gather(norm(A*V - V*D) / norm(A));")
        assert r.error is None, r.error
        assert eng.stats["host_fallbacks"] == 0
        ops = [k for e in eng.launch_log if e["cat"] == "linalg"
               for k in e["ops"]]
        assert "eig_qr" in ops and "eig_full" in ops, ops
    finally:
        runmat_tpu_torch.uninstall()
    assert float(s.get("res").host().reshape(-1)[0]) < 1e-10
    want = np.asarray(_jit(J.eig_values)(A)[0])
    got = np.asarray(s.get("w").host()).reshape(-1)
    np.testing.assert_allclose(got.real, want, atol=TOL_QR * _scale(want))


# ------------------------------------------------- the resident eig_hess

def _hess_fixture(name: str) -> np.ndarray:
    """The order model's extra fixtures: a graded matrix (rows and columns
    spanning 10^-6..10^6), one whose column 3 falls to ~1e-200 below the
    diagonal, a whole matrix scaled to ~1e-200, the same with that column
    underflowing to zeros (blocks with no nonzero entry while the column's
    largest is tiny), and n = 40 (three rows a block, as at n > 32)."""
    rng = np.random.default_rng(25)
    if name == "graded48":
        d = 10.0 ** np.linspace(-6, 6, 48)
        return d[:, None] * rng.standard_normal((48, 48)) / d[None, :]
    a = rng.standard_normal((24, 24))
    if name == "tiny_column":
        a[5:, 3] *= 1e-200
        return a
    if name == "tiny":
        return a * 1e-200
    if name == "tiny_zeros":        # column 3 underflows to 0 below row 4
        a[5:, 3] *= 1e-200
        return a * 1e-200
    if name == "random40":
        return rng.standard_normal((40, 40))
    return _fixture(name)


HESS_FIXTURES = [(name, True) for name in NONEMPTY + [
    "graded48", "tiny_column", "tiny", "tiny_zeros", "random40"]] + [
    (name, False) for name in ("tiny_column", "tiny", "tiny_zeros",
                               "random40")]


@pytest.mark.parametrize("name, balanced", HESS_FIXTURES)
def test_the_resident_kernels_order_stays_within_hess_tol(name, balanced):
    """`ordered_hessenberg`, the resident eig_hess' order of sums (v'H
    reassociated from each block's frexp-scaled x'H, the blocks' sums in
    block order; the card's kernel equals it bit for bit), against the
    JAX `hessenberg_q` and `hessenberg` on the CPU: H within HESS_TOL of
    the largest |A|, Q within HESS_TOL, exact zeros below the
    subdiagonal. The input is balanced first, as eig balances it (and as
    `test_hessenberg_and_hessenberg_q` does: unbalanced, the graded
    fixtures' reduction is ill-conditioned, and plain_hessenberg's Q
    differs from the JAX one's by O(1) too); the tiny fixtures also
    unbalanced, so that the products of the 1e-200 column meet the
    block scaling directly."""
    A = _hess_fixture(name)
    if balanced:
        A = np.asarray(_jit(J.balance)(A))
    wh, wq = (np.asarray(v) for v in _jit(J.hessenberg_q)(A))
    gh, gq = K.ordered_hessenberg(_t(A), True)
    s = float(np.max(np.abs(A)))
    assert float(np.max(np.abs(gh.numpy() - wh))) <= K.HESS_TOL * s
    assert float(np.max(np.abs(gq.numpy() - wq))) <= K.HESS_TOL
    h1, q1 = K.ordered_hessenberg(_t(A), False)
    assert q1 is None and torch.equal(h1, gh)      # H does not depend on Q
    assert float(np.max(np.abs(h1.numpy() - np.asarray(
        _jit(J.hessenberg)(A))))) <= K.HESS_TOL * s
    assert np.all(np.tril(gh.numpy(), -2) == 0)


def test_the_route_is_a_function_of_n_from_the_shared_memory_budget():
    """eig_hess' design is `hess_route(n)`: the resident cluster where
    `hess_smem(n)` fits HESS_BUDGET (the H100's 227 KB a block), else the
    cooperative grid; the boundary is HESS_RESIDENT_N = 627, and the
    kernel library states the same formula, budget and cluster size."""
    from pathlib import Path
    routes = [K.hess_route(n) for n in range(3, 1025)]
    assert routes == ["cluster" if K.hess_smem(n) <= K.HESS_BUDGET
                      else "grid" for n in range(3, 1025)]
    assert routes == ["cluster"] * (K.HESS_RESIDENT_N - 2) + ["grid"] * (
        1024 - K.HESS_RESIDENT_N)
    assert K.HESS_RESIDENT_N == 627
    assert K.hess_smem(627) <= K.HESS_BUDGET < K.hess_smem(628)
    assert K.hess_smem(512) == 8 * (32 * 512 + 2 * (32 + 2 + 17 * 32 +
                                                    2 * 512) + 4)
    cu = (Path(K.__file__).resolve().parents[1] / "csrc" /
          "eig_qr.cu").read_text()
    assert f"constexpr size_t kResBudget = {K.HESS_BUDGET};" in cu
    assert f"constexpr int kResBlocks = {K.HESS_BLOCKS};" in cu
    assert ("return sizeof(double) * (R * N + 2 * (2 * kResBlocks + 2 + "
            "17 * R + 2 * N) +") in cu
    assert "if (res_smem(n) <= kResBudget) return hess_resident_run(" in cu


@pytest.mark.parametrize("name", ["runmat_eig_hess_grid",
                                  "runmat_eig_hess_floor",
                                  "runmat_eig_hess_profile"])
def test_the_eig_hess_bench_entries_are_named_only_by_linalgbench(name):
    """The cooperative design forced at any n (the earlier design, timed in
    turns), the barrier floors and the clock64 profile are defined in
    csrc/eig_qr.cu and named by linalgbench.py alone: ops/eig_qr.py's
    hessenberg launches runmat_eig_hess, which routes by n."""
    import inspect
    from pathlib import Path
    pkg = Path(K.__file__).resolve().parents[1]
    files = sorted(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]
    naming = {p.relative_to(pkg.parent).as_posix() for p in files
              if name in p.read_text()}
    assert naming == {"runmat_tpu_torch/linalgbench.py"}, naming
    assert f'extern "C" int {name}(' in (pkg / "csrc" /
                                         "eig_qr.cu").read_text()
    src = inspect.getsource(K.hessenberg)
    assert '"runmat_eig_hess"' in src and name not in src


def test_a_cpu_tensor_takes_plain_hessenberg(monkeypatch):
    """hessenberg on a CPU tensor is plain_hessenberg and reaches no kernel
    entry; the order model agrees with it within HESS_TOL."""
    def refuse(*a, **k):
        raise AssertionError("a kernel entry reached")

    monkeypatch.setattr(K, "_entry", refuse)
    A = _t(_fixture("random24"))
    before = K.launches
    H, Q = K.hessenberg(A, True)
    pH, pQ = K.plain_hessenberg(A, True)
    assert K.launches == before
    assert torch.equal(H, pH) and torch.equal(Q, pQ)
    oH, oQ = K.ordered_hessenberg(A, True)
    assert float(torch.max(torch.abs(oH - pH))) <= K.HESS_TOL * float(
        torch.max(torch.abs(A)))
    assert float(torch.max(torch.abs(oQ - pQ))) <= K.HESS_TOL


# ------------------------------------------ eig_trevc in dtrevc's order

def _trevc_fixture(name: str) -> np.ndarray:
    """A quasi-triangular T: `linalgbench.trevc_case`'s (n = 1, 2 and 3, 2x2
    blocks at both ends, repeated eigenvalues, graded), or the Schur form
    of a random matrix through the JAX Francis iteration ("random24",
    "random48")."""
    from runmat_tpu_torch import linalgbench
    if name.startswith("random"):
        A = _fixture(name) if name == "random24" else \
            np.random.default_rng(148).standard_normal((48, 48))
        n = A.shape[0]
        return np.asarray(_FRANCIS(_padded_hessenberg(A),
                                   40 * n + 100)[0])[:n, :n]
    return linalgbench.trevc_case(name)


TREVC_FIXTURES = ["n1", "n2", "n3", "random24", "random48", "ends",
                  "repeated", "graded"]


@pytest.mark.parametrize("name", TREVC_FIXTURES)
def test_ordered_trevc_against_the_jax_trevc(name):
    """`ordered_trevc`, the ring eig_trevc's order (each row's terms
    T[m, c] y_c subtracted in descending c; the card equals it bit for
    bit), against the JAX `trevc` under jax.jit on the CPU and against
    `plain_trevc`: Yr and Yi within TREVC_TOL of the largest |Y|, on the
    same (wr, wi, is2, prev2) read off T by both packages."""
    T = _trevc_fixture(name)
    n = T.shape[0]
    Tj = jnp.asarray(T)
    q = J._quasi_eigs(jnp, Tj, n)
    Yr, Yi = (np.asarray(v) for v in jax.jit(
        lambda *a: J.trevc(jnp, *a))(Tj, *q))
    gq = P._quasi_eigs(_t(T), n)
    for a, b in zip(q, gq):
        assert np.array_equal(np.asarray(a), b.numpy())
    oYr, oYi = K.ordered_trevc(_t(T), *gq)
    s = max(1.0, float(np.max(np.abs(Yr))), float(np.max(np.abs(Yi))))
    for got, want, what in ((oYr, Yr, "Yr"), (oYi, Yi, "Yi")):
        err = float(np.max(np.abs(got.numpy() - want)))
        assert err <= K.TREVC_TOL * s, (name, what, err, s)
    pYr, pYi = K.plain_trevc(_t(T), *gq)
    for got, want in ((oYr, pYr), (oYi, pYi)):
        assert float(torch.max(torch.abs(got - want))) <= K.TREVC_TOL * s


def test_the_repeated_fixture_fires_both_smin_replacements():
    """In "repeated" a 1x1 denominator (row 0 of column 3) and a 2x2
    determinant (rows 4-5 of column 8's block) come out exactly 0, so the
    model takes dtrevc's smin replacement in both forms, and its columns
    are finite."""
    T = _trevc_fixture("repeated")
    wr, wi, is2, prev2 = P._quasi_eigs(_t(T), 10)
    assert T[0, 0] - float(wr[3]) == 0.0 and float(wi[3]) == 0.0
    assert bool(is2[4]) and bool(is2[7]) and bool(prev2[8])
    m11r, mi = T[4, 4] - float(wr[8]), -float(wi[8])
    m22r = T[5, 5] - float(wr[8])
    assert m11r * m22r - mi * mi - T[4, 5] * T[5, 4] == 0.0
    assert m11r * mi + mi * m22r == 0.0
    Yr, Yi = K.ordered_trevc(_t(T), wr, wi, is2, prev2)
    assert torch.isfinite(Yr).all() and torch.isfinite(Yi).all()
    assert float(torch.max(torch.abs(Yr[:, 3]))) > 1e10     # y ~ r / smin


@pytest.mark.parametrize("schedule", ["random", "producer", "columns"])
@pytest.mark.parametrize("name", TREVC_FIXTURES)
def test_the_ring_kernel_model_equals_ordered_trevc(name, schedule):
    """The model of eig_trevc_ring (`tests/torch_trevc_model.py`: each
    block's producer and column warps under a schedule, the ring starting
    full of values no column holds, every lane's unmasked updates of its
    register slots) reads every ring slot while it holds the stage it
    expects, never deadlocks, and gives `ordered_trevc`'s Y bit for bit."""
    from torch_trevc_model import model_trevc
    T = _t(_trevc_fixture(name))
    q = P._quasi_eigs(T, T.shape[0])
    mYr, mYi = model_trevc(T, *q, schedule=schedule, seed=len(name))
    oYr, oYi = K.ordered_trevc(T, *q)
    assert torch.equal(mYr, oYr) and torch.equal(mYi, oYi)


def test_the_ring_kernel_model_across_register_slots():
    """The model at n = 70 (three register slots, 2x2 blocks whose rows
    straddle the slots at 31-32 and 63-64, and a block at the top) and a
    deeper ring of stages than the ring holds: still ordered_trevc's Y."""
    from torch_trevc_model import model_trevc
    rng = np.random.default_rng(70)
    T = np.triu(rng.standard_normal((70, 70)))
    for i in (0, 31, 63):
        T[i + 1, i + 1] = T[i, i]
        T[i + 1, i] = -abs(T[i, i + 1]) - 0.5
    T = _t(T)
    q = P._quasi_eigs(T, 70)
    assert int(q[2].sum()) == 3
    mYr, mYi = model_trevc(T, *q, schedule="producer")
    oYr, oYi = K.ordered_trevc(T, *q)
    assert torch.equal(mYr, oYr) and torch.equal(mYi, oYi)


def test_the_trevc_route_is_a_function_of_n():
    """eig_trevc's design is `trevc_route(n)` and nothing else: the ring up
    to TREVC_RING_N = 512 (16 register slots of 32 rows), the first warp
    design from 513; the ring's shared memory at 512 fits the H100's 227 KB
    a block; the kernel library states the same constants and formula."""
    from pathlib import Path
    routes = [K.trevc_route(n) for n in range(1, 1025)]
    assert routes == [K.trevc_route(n) for n in range(1, 1025)]
    assert routes == ["ring"] * 512 + ["warp"] * 512
    assert K.trevc_route(512) == "ring" and K.trevc_route(513) == "warp"
    assert K.TREVC_RING_N == 512
    assert K.trevc_smem(512) == 8 * (12 * 512 + 4 * 8 * 512) + 16 * 12 + \
        4 * 512 == 182464
    assert K.trevc_smem(512) <= K.HESS_BUDGET
    assert K.trevc_smem(1) == 8 * (12 * 32 + 4 * 8) + 16 * 12 + 4
    cu = (Path(K.__file__).resolve().parents[1] / "csrc" /
          "eig_qr.cu").read_text()
    assert f"constexpr int kTrevcCols = {K.TREVC_COLS};" in cu
    assert f"constexpr int kTrevcDepth = {K.TREVC_DEPTH};" in cu
    assert "constexpr int kTrevcSlots = 16;" in cu
    assert "constexpr int kTrevcRingN = 32 * kTrevcSlots;" in cu
    assert "if (n <= kTrevcRingN)\n    return trevc_ring_run<false>(" in cu


@pytest.mark.parametrize("name, benches", [
    ("runmat_eig_trevc_warp", {"linalgbench"}),
    ("runmat_eig_trevc_chain", {"linalgbench"})])
def test_the_eig_trevc_bench_entries_are_named_only_by_benches(name,
                                                               benches):
    """The earlier design forced at any n and the chain alone are defined
    in csrc/eig_qr.cu and named by the bench scripts alone: ops/eig_qr.py's
    trevc launches runmat_eig_trevc, which routes by n."""
    import inspect
    from pathlib import Path
    pkg = Path(K.__file__).resolve().parents[1]
    files = sorted(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]
    naming = {p.relative_to(pkg.parent).as_posix() for p in files
              if name in p.read_text()}
    assert naming == {f"runmat_tpu_torch/{b}.py" for b in benches}, naming
    assert f'extern "C" int {name}(' in (pkg / "csrc" /
                                         "eig_qr.cu").read_text()
    src = inspect.getsource(K.trevc)
    assert '"runmat_eig_trevc"' in src and name not in src


@pytest.mark.parametrize("name", ["eig_hess", "eig_francis", "eig_trevc"])
def test_chip_smoke_reads_each_eig_kernels_launch_key(name):
    """chip_smoke.py's kernel row of each eig kernel reads, in the eig_qr
    group, the key its wrapper counts at the main path's n = 512: the
    ring eig_trevc counts as "eig_trevc ring", the warp design above 512
    keeps "eig_trevc"."""
    import inspect

    import chip_smoke
    assert "randn(512, 512)" in chip_smoke.EIG_SOURCE
    key = chip_smoke.EIG_KEYS[name]
    assert chip_smoke._group(key) == "eig_qr"
    if name == "eig_trevc":
        assert key == K.TREVC_KEYS[K.trevc_route(512)] == "eig_trevc ring"
        assert K.TREVC_KEYS[K.trevc_route(513)] == "eig_trevc"
    else:
        assert key == name
        assert f'_launched("{name}", rc)' in inspect.getsource(K)


def test_a_cpu_tensor_takes_plain_trevc(monkeypatch):
    """trevc on a CPU tensor is plain_trevc and reaches no kernel entry."""
    def refuse(*a, **k):
        raise AssertionError("a kernel entry reached")

    monkeypatch.setattr(K, "_entry", refuse)
    T = _t(_trevc_fixture("ends"))
    q = P._quasi_eigs(T, T.shape[0])
    before = K.launches
    Yr, Yi = K.trevc(T, *q)
    pYr, pYi = K.plain_trevc(T, *q)
    assert K.launches == before
    assert torch.equal(Yr, pYr) and torch.equal(Yi, pYi)
