"""The port on an NVIDIA card: the Threefry and histogram kernels against
their plain PyTorch versions, the normal kernels' transform against its
numpy model (`ops/boxmuller.py`), and the slices against the port's host
engine (its `Session(accelerate=False)`). Marked `cuda`; each test skips
without a card. On a card machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`tests/conftest.py` imports jax). This file imports neither jax nor the
JAX package.
Tolerances: uniforms bit-exact; normals f32 atol=rtol=2e-6, f64
atol=rtol=1e-13; the transform equal to its model in f32 and within one
ulp in f64 (the model's square root is correctly rounded, the kernel's a
Goldschmidt iteration); histogram counts exact; workload results
rtol=1e-4.
"""

import io
import re

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KEY = (0x01234567, 0x89ABCDEF)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# the normal kernels take two values' blocks a thread per iteration and
# leave the last one to a tail: n = 4 and 6 end on a whole unit (m even
# and odd), 5 and 7 drop the last sine (m odd and even), 10^6 + 1..3 do
# the same at monte_carlo.m's size, which fills one wave; 2^26 is
# histogram_stats.m's draw, several units a thread
@pytest.mark.parametrize("ctr", [0, (0xFFFFFFFE, 1)])
@pytest.mark.parametrize("n", [1, 2, 3, 1023, 65537, 4, 5, 6, 7, 10 ** 6,
                               10 ** 6 + 1, 10 ** 6 + 2, 10 ** 6 + 3, 1 << 26])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_kernel_matches_plain(card, kind, dtype, n, ctr):
    from runmat_tpu_torch.ops import threefry
    before = threefry.launches
    got = threefry.rng_draw(kind, KEY, ctr, n, dtype, card)
    want = threefry.plain_draw(kind, KEY, ctr, n, dtype, card)
    torch.cuda.synchronize()
    assert threefry.launches == before + 1
    assert got.is_cuda and got.dtype == dtype and got.shape == (n,)
    if kind == "rand":
        assert torch.equal(got, want)
    else:
        tol = 2e-6 if dtype == torch.float32 else 1e-13
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_float32_transform_equals_its_model_everywhere(card):
    # every (u1, u2) of the float32 stream, bit for bit
    from runmat_tpu_torch.ops import boxmuller, threefry
    k = torch.arange(1 << 24, dtype=torch.int64, device=card) << 8
    got = threefry.device_transform(torch.stack([k, k]), torch.float32)
    w = np.arange(1 << 24, dtype=np.uint32) << 8
    assert np.array_equal(got.cpu().numpy(),
                          np.stack(boxmuller.box_muller_f32(w, w)))


def test_float64_transform_within_an_ulp_of_its_model(card):
    from runmat_tpu_torch.ops import boxmuller, threefry
    w = np.random.default_rng(17).integers(0, 1 << 32, (4, 1 << 20),
                                           dtype=np.uint64).astype(np.uint32)
    w[:, :2] = [[0, 0xFFFFFFFF]] * 4
    got = threefry.device_transform(
        torch.from_numpy(w.astype(np.int64)).to(card), torch.float64)
    want = np.stack(boxmuller.box_muller_f64(*w))
    got = got.cpu().numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("name,pre,label,var", [
    ("elementwise_math", "points = 100000;", "CHECK", "checksum"),
    ("monte_carlo", "M = 65536; T = 16;", "PRICE", "price"),
    ("image_normalize", "B = 8; H = 64; W = 96;", "MSE", "mse")])
def test_workload_on_card_matches_host(card, name, pre, label, var):
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.ops import threefry
    from runmat_tpu_torch.session import Session

    src = pre + "\n" + open(f"benchmarks/{name}.m").read()
    prev = accel.active_engine()
    accel.set_engine(None)
    host = Session(accelerate=False, stdout=io.StringIO())
    host.run_source(src)
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        before = threefry.launches
        r = s.execute(src)
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    assert r.error is None, r.error
    assert re.search(rf"RESULT_ok {label}=", r.output)
    want = float(host.get(var).host().reshape(-1)[0])
    got = float(s.get(var).host().reshape(-1)[0])
    assert abs(got - want) <= 1e-4 * abs(want)
    assert eng.stats["host_fallbacks"] == 0
    if name == "monte_carlo":
        assert eng.stats["loop_folds"] == 1
        assert threefry.launches - before == 16
    if name == "image_normalize":
        assert threefry.launches - before == 1


HIST_MODES = [("search", torch.float32, None), ("search", torch.float64, None),
              ("direct", torch.float32, (7, 0)),
              ("direct", torch.float32, (-1, -3)),
              ("direct", torch.float32, (-2, -4)),
              ("direct", torch.float32, (3, 5))]


# 1000, 4096 and 30000 bins cross the kernel's shared-memory layouts (per
# warp, per block, global counts) in every mode; 65536 takes direct mode
# to the global layout
@pytest.mark.parametrize("nb", [1, 3, 7, 80, 256, 257, 1000, 4096, 30000,
                                65536])
@pytest.mark.parametrize("n", [1, 3, 1023, 65537])
@pytest.mark.parametrize("mode,dtype,affine", HIST_MODES,
                         ids=["f32", "f64", "direct-k7-m0", "direct-k-1-m-3",
                              "direct-k-2-m-4", "direct-k3-m5"])
def test_histogram_kernel_matches_plain(card, mode, dtype, affine, n, nb):
    from runmat_tpu_torch.ops import histogram
    rng = np.random.default_rng(n * 1000 + nb)
    if affine is None:
        e = np.sort(rng.uniform(-2.0, 2.0, nb + 1))
        if nb >= 3:
            e[1] = e[2]                                  # a repeated edge
    else:
        k, m = affine
        e = (m + np.arange(nb + 1)) * 2.0 ** -k
    span = e[-1] - e[0]
    x = rng.uniform(e[0] - 0.2 * span, e[-1] + 0.2 * span, n)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    e = e.astype(np_dt)
    tiny = np.finfo(np_dt).smallest_subnormal
    special = [np.nan, e[0], e[-1], e[nb // 2], np.inf, -np.inf, tiny, -tiny,
               np.nextafter(e[nb // 2], np_dt(np.inf)),
               np.nextafter(e[nb // 2], np_dt(-np.inf)),
               np.nextafter(e[-1], np_dt(np.inf))]
    x[:min(n, len(special))] = special[:min(n, len(special))]
    xt = torch.from_numpy(x.astype(np_dt)).to(card)
    et = torch.from_numpy(e.astype(np_dt)).to(card)
    before = histogram.launches
    got = histogram.histcounts(xt, et, affine)
    torch.cuda.synchronize()
    assert histogram.launches == before + 1
    assert got.is_cuda and got.dtype == torch.int64 and got.shape == (nb,)
    if affine is None:
        want = histogram.plain_histcounts(xt, et)
    else:
        want = histogram.plain_histcounts_affine(xt, nb, *affine)
    assert torch.equal(got, want)
    ref = np.histogram(x.astype(np_dt).astype(np.float64),
                       bins=e.astype(np_dt).astype(np.float64))[0]
    assert np.array_equal(got.cpu().numpy(), ref)


def test_histogram_stats_on_card_matches_host(card):
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.ops import histogram
    from runmat_tpu_torch.session import Session

    src = "N = 1048576;\n" + open(
        "runmat_tpu_torch/workloads/histogram_stats.m").read()
    prev = accel.active_engine()
    accel.set_engine(None)
    host = Session(accelerate=False, stdout=io.StringIO())
    host.run_source(src)
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        before = histogram.launches
        r = s.execute(src)
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    assert r.error is None, r.error
    assert re.search(r"RESULT_ok HIST=", r.output)
    want = float(host.get("res").host().reshape(-1)[0])
    got = float(s.get("res").host().reshape(-1)[0])
    assert abs(got - want) <= 1e-4 * abs(want)
    assert histogram.launches - before == 3
    assert eng.stats["host_fallbacks"] == 0
    # histcounts routes before it gathers: u and z stay on the card
    assert s.get("u").on_device and s.get("z").on_device
    assert eng.stats["gather_bytes"] < 1 << 20


def _guide_cells(nb: int) -> int:
    """The kernel's largest guide table for nb bins (histogram.cu)."""
    cells = 64
    while cells < 4096 and cells < 8 * nb:
        cells *= 2
    return cells


def _edge_case(kind: str, nb: int, np_dt, rng):
    """Edges and values at the guide table's edges: clustered edges (many
    in one cell, so the bracket needs its binary search), repeated edges,
    and values on, and one ulp beside, every edge and many cell boundaries;
    NaN, +-Inf, +-0 and subnormals."""
    e = np.sort(rng.uniform(-2.0, 2.0, nb + 1))
    if kind == "clustered" and nb >= 2:
        k = nb // 2 + 1
        e = np.sort(np.concatenate([0.1 + rng.uniform(0, 1e-5, k),
                                    rng.uniform(-2.0, 2.0, nb + 1 - k)]))
    if kind == "repeated" and nb >= 2:
        e[1:nb // 2 + 1] = e[1]
    e = e.astype(np_dt)
    cells = _guide_cells(nb)
    bounds = (e[0] + (e[-1] - e[0]) * np.arange(cells + 1) / cells).astype(
        np_dt)
    near = np.concatenate([e, bounds])
    up, down = np.nextafter(near, np_dt(np.inf)), np.nextafter(
        near, np_dt(-np.inf))
    tiny = np.finfo(np_dt).smallest_subnormal
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, tiny, -tiny],
                       np_dt)
    span = float(e[-1] - e[0])
    x = np.concatenate([near, up, down, special,
                        rng.uniform(e[0] - 0.1 * span, e[-1] + 0.1 * span,
                                    65536).astype(np_dt)])
    return x.astype(np_dt), e


@pytest.mark.parametrize("kind", ["random", "clustered", "repeated"])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5, 6, 7, 8, 80, 1000, 4096,
                                30000, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_search_mode_at_the_guide_tables_edges(card, dtype, nb, kind):
    from runmat_tpu_torch.ops import histogram
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    x, e = _edge_case(kind, nb, np_dt, np.random.default_rng(nb))
    xt = torch.from_numpy(x).to(card)
    et = torch.from_numpy(e).to(card)
    want = histogram.plain_histcounts(xt, et)
    # a 16-byte-aligned start and two that are not
    for view in (xt, xt[1:], xt[3:]):
        got = histogram.histcounts(view, et)
        assert torch.equal(got, histogram.plain_histcounts(view, et))
    got = histogram.histcounts(xt, et)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ref = np.histogram(x.astype(np.float64), bins=e.astype(np.float64))[0]
    assert np.array_equal(got.cpu().numpy(), ref)


@pytest.mark.parametrize("ends", ["-inf", "+inf", "equal", "huge"])
def test_search_mode_without_a_usable_table(card, ends):
    # an infinite end, all edges equal or a span that overflows f32 take the
    # binary search over all edges
    from runmat_tpu_torch.ops import histogram
    e = np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32)
    if ends == "-inf":
        e[0] = -np.inf
    elif ends == "+inf":
        e[-1] = np.inf
    elif ends == "equal":
        e[:] = 0.25
    else:
        e = np.array([-3e38, -1.0, 0.0, 1.0, 3e38], np.float32)
    x = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                        np.nextafter(e, np.float32(-np.inf)),
                        np.array([np.nan, 0.3, -0.7, 2.0, -2.0], np.float32)])
    xt, et = torch.from_numpy(x).to(card), torch.from_numpy(e).to(card)
    assert torch.equal(histogram.histcounts(xt, et),
                       histogram.plain_histcounts(xt, et))
