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
rtol=1e-4; the generated kernels (`ops/fused.py`) as
`runmat_tpu_torch/fusebench.py` states (logical values, NaN patterns,
infinities, linspace and casts exactly, other values float32 rtol=atol=1e-6,
float64 1e-12, sums and means 1e-5 / 1e-12 of their largest magnitude); their
square arm (a `pow` whose scalar exponent is 2) equal to the correctly
rounded square bit for bit over all 2^32 float32 values.
"""

import collections
import io
import re

import numpy as np
import pytest
import torch

from runmat_tpu_torch import fusebench, plotbench

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


# ------------------------------------- indexing, structural ops, sort, sets
# Each op of the indexing slice on the card against the same op on CPU
# tensors, for the same inputs, exactly: plain torch both ways, so the card
# must give the same elements, the same order and the same NaN and +-0
# placement (its sorts are radix sorts; the keys are made canonical).

def _engines():
    from runmat_tpu_torch.accel.engine import TorchEngine
    kw = dict(auto_offload=True, offload_threshold=1)
    return TorchEngine("cuda", **kw), TorchEngine("cpu", **kw)


def _values(shape, dtype, seed):
    """Values on a 0.25 grid (many repeats) with NaN, -NaN, +-0 and +-Inf."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-8, 8, size=shape) * 4) / 4
    flat = x.reshape(-1)
    k = min(flat.size, 9)
    flat[rng.choice(flat.size, k, replace=False)] = \
        [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, -0.0, np.nan, 0.0][:k]
    return x.astype(dtype)


def _exact(build):
    """build(engine, MatArray) -> MatArray or list, on the card and on the
    CPU; every output equal in shape, dtype and value."""
    from runmat_tpu_torch.values import MatArray
    outs = []
    for eng in _engines():
        r = build(eng, MatArray)
        r = r if isinstance(r, (list, tuple)) else [r]
        outs.append([np.asarray(v.host()) for v in r])
    got, want = outs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w, equal_nan=True)


def _sub(M, idx):
    return M(np.asarray(idx, np.float64).reshape(1, -1) + 1, "double")


@pytest.mark.parametrize("shape", [(40, 25), (4096, 1 << 12)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_index_ops_on_card_match_cpu(card, shape, dtype):
    from runmat_tpu_torch.vm.indexing import COLON
    x = _values(shape, dtype, 1)
    mclass = "single" if dtype == np.float32 else "double"
    rng = np.random.default_rng(2)
    n = x.size
    lin = rng.permutation(n)[: n // 7]
    rows = rng.permutation(shape[0])[: shape[0] // 3]
    cols = rng.permutation(shape[1])[: shape[1] // 2]
    mask = rng.random(shape) < 0.3
    cases = [
        lambda e, M, d: e.index_read_general(d, [_sub(M, lin)]),
        lambda e, M, d: e.index_read_general(d, [_sub(M, np.arange(3, n, 5))]),
        lambda e, M, d: e.index_read_general(d, [_sub(M, rows), COLON]),
        lambda e, M, d: e.index_read_general(d, [_sub(M, rows), _sub(M, cols)]),
        lambda e, M, d: e.index_write(d, [_sub(M, lin)], M(np.array([[2.5]]),
                                                           "double")),
        lambda e, M, d: e.index_write(d, [_sub(M, lin)], e.upload(M(
            np.arange(lin.size, dtype=dtype).reshape(-1, 1), mclass))),
        lambda e, M, d: e.index_write(d, [COLON, _sub(M, cols)],
                                      M(np.array([[-1.0]]), "double")),
        lambda e, M, d: e.index_write(d, [_sub(M, rows), COLON], e.upload(M(
            np.ones((rows.size, shape[1]), dtype), mclass))),
        lambda e, M, d: e.index_write(d, [_sub(M, rows), _sub(M, cols)],
                                      e.upload(M(np.full(
                                          (rows.size, cols.size), 3, dtype),
                                          mclass))),
        lambda e, M, d: e.index_write(d, [COLON], M(np.array([[7.0]]),
                                                    "double")),
        lambda e, M, d: e.index_write(d, [COLON], e.upload(M(
            x[::-1].copy(), mclass))),
        lambda e, M, d: e.index_write(d, [M(mask, "logical")],
                                      M(np.array([[0.0]]), "double")),
        lambda e, M, d: e.index_write(d, [e.upload(M(mask.T.copy(),
                                                     "logical"))],
                                      M(np.array([[4.0]]), "double")),
    ]
    for k, case in enumerate(cases):
        def build(e, M):
            d = e.upload(M(x.copy(), mclass))
            out = case(e, M, d)
            assert out is not None and out.on_device, k
            return [out, d]         # the input is never written through
        _exact(build)


@pytest.mark.parametrize("n", [1000, 1 << 24])
def test_vector_index_ops_on_card_match_cpu(card, n):
    from runmat_tpu_torch.vm.indexing import COLON
    x = _values((n, 1), np.float32, 3)
    rng = np.random.default_rng(4)
    sub = rng.permutation(n)[: n // 3]

    def build(e, M):
        d = e.upload(M(x.copy(), "single"))
        r1 = e.index_read_general(d, [_sub(M, sub)])
        r2 = e.index_read_general(d, [_sub(M, np.arange(0, n, 1024))])
        w1 = e.index_write(d, [_sub(M, np.arange(0, n, 64))],
                           M(np.array([[0.0]]), "double"))
        w2 = e.index_write(d, [e.upload(M(np.abs(x) > 3, "logical"))],
                           M(np.array([[3.0]]), "double"))
        w3 = e.index_write(d, [_sub(M, sub)], e.upload(M(
            np.arange(sub.size, dtype=np.float32).reshape(-1, 1), "single")))
        w4 = e.index_write(d, [COLON], M(np.array([[1.0]]), "double"))
        return [r1, r2, w1, w2, w3, w4, d]
    _exact(build)


L_OPS = [("flipL", (0,)), ("flipL", (1,)), ("rollL", (7, 1)),
         ("rollL", ((1, -3), (0, 1))), ("tileL", ((2, 3), None)),
         ("rot90L", (1,)), ("rot90L", (3,)), ("permuteL", ((1, 0), None)),
         ("trilL", (0,)), ("trilL", (-2,)), ("triuL", (1,)), ("kronL", ())]


@pytest.mark.parametrize("shape", [(6, 5), (4096, 1 << 12)])
@pytest.mark.parametrize("op,static", L_OPS,
                         ids=[f"{o}{s}" for o, s in L_OPS])
def test_l_ops_on_card_match_cpu(card, op, static, shape):
    if op == "kronL" and shape[0] > 6:
        shape = (64, 64)
    x = _values(shape, np.float64, 5)
    r, c = shape
    out_shape = {"tileL": (2 * r, 3 * c), "rot90L": (c, r),
                 "permuteL": (c, r), "kronL": (r * 2, c * 3)}.get(op, shape)
    if op in ("tileL", "permuteL"):
        static = (static[0], shape)

    def build(e, M):
        xs = [e.upload(M(x.copy(), "double"))]
        if op == "kronL":
            xs.append(e.upload(M(np.arange(6.0).reshape(2, 3), "double")))
        return e.structural(op, xs, static, out_shape)
    _exact(build)


def test_permute_3d_on_card_matches_cpu(card):
    x = _values((64, 64, 8), np.float32, 6)
    for p in ((2, 0, 1), (1, 2, 0), (0, 2, 1)):
        out = tuple(x.shape[i] for i in p)
        _exact(lambda e, M: e.structural("permuteL", [e.upload(M(
            x.copy(), "single"))], (p, x.shape), out))


@pytest.mark.parametrize("n", [12, 1000, 1 << 24])
@pytest.mark.parametrize("descend", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sort_on_card_matches_cpu(card, dtype, descend, n):
    x = _values((n, 1), dtype, 7)
    mclass = "single" if dtype == np.float32 else "double"
    _exact(lambda e, M: e.sort(e.upload(M(x.copy(), mclass)), 0, descend,
                               True))
    if n == 12:
        return
    m = _values((1024, n // 1024), dtype, 8)
    _exact(lambda e, M: e.sort(e.upload(M(m.copy(), mclass)), 1, descend,
                               True))


@pytest.mark.parametrize("n", [1000, 1 << 24])
@pytest.mark.parametrize("stable", [False, True])
def test_unique_and_sets_on_card_match_cpu(card, stable, n):
    x = _values((n, 1), np.float32, 9)
    lv = np.arange(-8, 9, 2, dtype=np.float32).reshape(1, -1)
    lv[0, 0] = np.nan

    def build(e, M):
        d = e.upload(M(x.copy(), "single"))
        h = e.upload(M(lv.copy(), "single"))
        out = list(e.unique(d, stable, True))
        for op in ("union", "intersect", "setdiff", "setxor"):
            out += e.setop(op, d, h)
            out += e.setop(op, h, d)
        out += e.linalg("ismember", [d, h], out_class="logical")
        out += e.linalg("mode", [d], (), out_class="single")
        return out
    _exact(build)


@pytest.mark.parametrize("n", [1000, (1 << 24) + 1])
def test_median_mode_accumarray_on_card_match_cpu(card, n):
    x = _values((n, 1), np.float32, 10)
    m = _values((1000, 16), np.float64, 11)
    subs = np.random.default_rng(12).integers(1, 50, (n, 1)).astype(np.float64)

    def build(e, M):
        out = []
        for nan_mode in ("", "omitnan"):
            out.append(e.reduce("median", e.upload(M(x.copy(), "single")),
                                (0,), "single", nan_mode))
            for axes in ((0,), (1,), (0, 1)):
                out.append(e.reduce("median", e.upload(M(m.copy(), "double")),
                                    axes, "double", nan_mode))
        out += e.linalg("mode", [e.upload(M(x.copy(), "single"))], (),
                        out_class="single")
        out += e.linalg("accumarray", [e.upload(M(subs, "double")),
                                       e.upload(M(np.ones((n, 1), np.float32),
                                                  "single"))], (49,),
                        out_class="double")
        return out
    _exact(build)


def test_index_sets_on_card_matches_host(card):
    """index_sets.m at N = 2^20 on the card against the port's host engine:
    RANK within 1e-4, one for fold and one while fold, no host fallback."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.session import Session

    src = "N = 2^20;\n" + open("runmat_tpu_torch/workloads/index_sets.m").read()
    prev = accel.active_engine()
    accel.set_engine(None)
    host = Session(accelerate=False, stdout=io.StringIO())
    host.run_source(src)
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        r = s.execute(src)
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    assert r.error is None, r.error
    want = float(host.get("res").host().reshape(-1)[0])
    got = float(s.get("res").host().reshape(-1)[0])
    assert abs(got - want) <= 1e-4 * abs(want)
    st = eng.stats
    assert st["host_fallbacks"] == 0 and st["loop_folds"] == 1
    assert st["while_folds"] == 1


# ------------------------------------------- the folded loop as a CUDA graph

@pytest.mark.parametrize("ctr", [0, 12345, (0xFFFFFFFD, 7), (1 << 63) + 5])
@pytest.mark.parametrize("n", [1, 4, 5, 1023, 10 ** 6, 10 ** 6 + 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_device_counter_entry_equals_launch_arguments(card, kind, dtype, n,
                                                      ctr):
    from runmat_tpu_torch.accel.engine import counter_value
    from runmat_tpu_torch.ops import threefry
    c = ctr if isinstance(ctr, int) else ctr[0] | (ctr[1] << 32)
    t = torch.full((), counter_value(c), dtype=torch.int64, device=card)
    got = threefry.rng_draw(kind, KEY, t, n, dtype, card)
    want = threefry.rng_draw(kind, KEY, c, n, dtype, card)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


LOOP = ("rng(0); X = gpuArray(zeros(4096, 1, 'single'));\n"
        "for t = 1:24\n  U = rand(4096, 1, 'single');\n  X = X + U * t;\nend\n")


def _fold_on(device, runs=1):
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.ops import threefry
    prev = accel.active_engine()
    try:
        s = runmat_tpu_torch.session(device, auto_offload=True,
                                     offload_threshold=1)
        eng = accel.active_engine()
        before = threefry.launches
        outs = []
        for _ in range(runs):
            r = s.execute(LOOP)
            assert r.error is None, r.error
            outs.append((s.get("X").host().copy(), s.get("U").host().copy()))
        launches = threefry.launches - before
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    return outs, eng, launches


def test_captured_fold_equals_eager_fold(card):
    (got,), eng, launches = _fold_on("cuda")
    (want,), cpu, _ = _fold_on("cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    st = eng.stats
    assert st["loop_folds"] == 1 and st["graph_declines"] == 0
    assert st["graph_captures"] == 1 and st["graph_replays"] == 23
    assert launches == 24 and cpu.stats["graph_captures"] == 0
    (e,) = [e for e in eng.launch_log if e["cat"] == "device_loop"]
    assert e["graph"] == "captured" and e["replays"] == 23


def test_three_warm_runs_make_one_capture(card):
    outs, eng, launches = _fold_on("cuda", runs=4)
    for x, u in outs[1:]:
        assert np.array_equal(x, outs[0][0]) and np.array_equal(u, outs[0][1])
    st = eng.stats
    assert st["graph_captures"] == 1 and st["graph_declines"] == 0
    assert st["graph_replays"] == 23 + 3 * 24 and launches == 4 * 24
    graphs = [e["graph"] for e in eng.launch_log if e["cat"] == "device_loop"]
    assert graphs == ["captured", "cached", "cached", "cached"]


def test_a_body_that_waits_for_the_card_declines_the_capture(card,
                                                             monkeypatch):
    """A body op that reads the device back declines the capture before it
    starts: counted, with its reason, and the loop runs as a host loop of
    the same step, with the same values."""
    from runmat_tpu_torch.accel.engine import TorchEngine
    real = TorchEngine._exec

    def waits(self, op, *args, **kw):
        # the draw: the body's elementwise ops run in a generated kernel,
        # not through _exec
        out = real(self, op, *args, **kw)
        if op.startswith("rng:"):
            out.sum().item()
        return out

    monkeypatch.setattr(TorchEngine, "_exec", waits)
    (got,), eng, launches = _fold_on("cuda")
    monkeypatch.undo()
    (want,), _, _ = _fold_on("cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    st = eng.stats
    assert st["graph_declines"] == 1 and st["graph_captures"] == 0
    (e,) = [e for e in eng.launch_log if e["cat"] == "device_loop"]
    assert e["graph"].startswith("declined") and "synchroniz" in e["graph"]
    assert launches == 25         # iteration 0 ran twice, then 23 more


def test_while_body_is_captured(card):
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.session import Session
    src = ("x = gpuArray(single(linspace(1, 2, 1000)'));"
           " e = gpuArray(single(1)); k = 0;\nwhile e > 1e-5\n  x = 0.5 * (x + 2 ./ x);\n"
           "  e = max(abs(x .* x - 2));\n  k = k + 1;\nend\nr = gather(x);")
    prev = accel.active_engine()
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        for _ in range(2):
            r = s.execute(src)
            assert r.error is None, r.error
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    host = Session(accelerate=False)
    host.execute(src.replace("gpuArray", ""))
    assert np.array_equal(s.get("r").host(), host.get("r").host())
    trips = int(s.get("k").host().item())
    assert trips >= 3
    st = eng.stats
    assert st["while_folds"] == 2 and st["graph_captures"] == 1
    assert st["graph_replays"] == (trips - 1) + trips
    # the condition is still read once per iteration and once at the end
    assert st["syncs"] == 2 * (trips + 1)


@pytest.mark.parametrize("policy,limit", [("highest", 1e-5),
                                          ("high", 5e-3), ("bf16", 5e-2)])
def test_matmul_policy_on_card(card, policy, limit):
    """"highest" is FP32 (a float64 product of the same operands within
    FP32 accuracy); "high" (TF32) and "bf16" are coarser; no TF32 switch
    is left changed after the op."""
    from runmat_tpu_torch.accel.engine import TorchEngine
    from runmat_tpu_torch.values import MatArray
    rng = np.random.default_rng(11)
    a = rng.standard_normal((512, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 256)).astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    eng = TorchEngine("cuda", matmul_precision=policy)
    node = eng.matmul(eng.upload(MatArray(a, "single")),
                      eng.upload(MatArray(b, "single")), "single").dev
    got = eng.materialize(node).cpu().numpy().astype(np.float64)
    want = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= limit
    if policy == "highest":
        assert err <= 1e-5
    else:
        assert err > 1e-5
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


# ---------------------------------------------- the generated kernels


@pytest.mark.parametrize("name", [name for name, _ in
                                  fusebench.table_cases()])
def test_generated_kernel_matches_plain(card, name):
    from runmat_tpu_torch.accel.engine import TorchEngine
    from runmat_tpu_torch.ops import fused
    build = dict(fusebench.table_cases())[name]
    before = fused.launches
    r = fusebench.check(TorchEngine("cuda"), name, build)
    assert fused.launches - before == r["groups"] >= 1


def test_a_kernel_that_fails_to_compile_raises(card, monkeypatch):
    """A group the plan accepted whose kernel does not compile raises a
    MatError; nothing runs eagerly in its place."""
    from runmat_tpu_torch.accel.engine import TorchEngine
    from runmat_tpu_torch.errors import MatError
    from runmat_tpu_torch.ops import fused
    from runmat_tpu_torch.values import MatArray
    real = fused.source

    def broken(spec, big=False, sms=fused.SMS_DEFAULT):
        return real(spec, big, sms).replace("tl.store(", "tl.no_such_op(")

    monkeypatch.setattr(fused, "source", broken)
    eng = TorchEngine("cuda")
    x = eng.upload(MatArray(np.ones((64, 64), np.float32), "single"))
    y = eng.unary("exp", x, "single")
    with pytest.raises(MatError) as err:
        eng.materialize(y.dev)
    assert err.value.identifier == "RunMat:fusedKernel"
    assert eng.stats["eager_ops"] == 0 and y.dev.value is None


def test_a_fused_body_is_captured_without_compiling(card):
    """monte_carlo.m's step: its elementwise chain is one generated kernel
    inside the captured graph; the warm runs compile nothing and replay
    the kernel once a step."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.accel import loops
    from runmat_tpu_torch.ops import fused
    src = "M = 65536; T = 16;\n" + open("benchmarks/monte_carlo.m").read()
    prev = accel.active_engine()
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        r = s.execute(src)
        assert r.error is None, r.error
        compiled = set(fused.compiled)
        before = fused.by_label(fused.launches_by)["fused_map_f32"]
        for _ in range(2):
            r = s.execute(src)
            assert r.error is None, r.error
        graphs = [g for g in eng._jit_cache.values()
                  if isinstance(g, loops._Graph)]
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    st = eng.stats
    assert st["graph_captures"] == 1 and st["graph_declines"] == 0
    assert fused.compiled == compiled
    (graph,) = graphs
    assert fused.by_label(graph.kernels) == {"fused_map_f32": 1}
    # two warm runs of 16 replayed steps, plus the payoff's setup kernels
    assert fused.by_label(fused.launches_by)["fused_map_f32"] - before \
        >= 2 * 16


def _one_and_two(card, spec, inputs):
    """`spec` on the card through fused.launch (one_kernel where SPLITS ==
    1) and through the two kernels part_kernel + fin_kernel generated for
    the same Spec: the outputs of each."""
    from runmat_tpu_torch.accel import fuse
    from runmat_tpu_torch.ops import fused
    prepared = [fuse._operand(t, ls) for t, (ls, _) in
                zip(inputs, spec.inputs)]
    ins = [t for t, _ in prepared]
    flat = [x for _, st in prepared for x in st]

    def outputs():
        return [torch.empty(spec.rshape if m >= spec.reduce else spec.shape,
                            dtype=getattr(torch, spec.body[m][2]),
                            device=card) for m in spec.outputs]
    one = outputs()
    fused.launch(spec, ins, [st for _, st in prepared], one, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    gen = fused._Gen(spec, False, sms)
    kernels = [gen.part_kernel(), gen.fin_kernel()]
    text = fused._PRELUDE.format(what="part and fin of a one-kernel group")
    text += "".join(fused._HELPERS[h] for h in sorted(gen.helpers))
    text += "".join("\n\n" + "\n".join(k) + "\n" for k in kernels)
    mod = fused.module(text)
    lay = fused.layout(spec, sms)
    two = outputs()
    part = torch.empty(lay["SPLITS"] * lay["K"], device=card,
                       dtype=getattr(torch, spec.body[spec.reduce][2]))
    pre = [o for o, m in zip(two, spec.outputs) if m < spec.reduce]
    post = [o for o, m in zip(two, spec.outputs) if m >= spec.reduce]
    fused._run(mod, "part_kernel", lay["grid"], ins + pre + [part] + flat,
               {"BK": lay["BK"], "BR": lay["BR"]}, lay["num_warps"])
    fused._run(mod, "fin_kernel", lay["fin_grid"], [part] + ins + post + flat,
               {"BKF": lay["BKF"], "BS": lay["BS"]}, lay["fin_warps"])
    torch.cuda.synchronize()
    return one, two


@pytest.mark.parametrize("case", ["sum of 1024 float32",
                                  "mean of rows, prologue, pow epilogue 2",
                                  "mean of rows, prologue, pow epilogue 1.8",
                                  "sum of rows float64"])
def test_one_kernel_equals_the_two_kernels_bit_for_bit(card, case):
    """A map-reduce that one program a segment covers (SPLITS == 1) runs
    as one launch of one_kernel, and gives the pair part_kernel +
    fin_kernel's outputs bit for bit: the one partial was the whole sum."""
    from runmat_tpu_torch.ops import fused
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    F32, F64 = "float32", "float64"
    if case == "sum of 1024 float32":     # elementwise_math's checksum
        spec = fused.Spec(shape=(1, 1024), inputs=(((1, 1024), F32),),
                          body=(("r:sum", ((0, 1), "", F32), F32,
                                 (("x", 0),)),),
                          reduce=0, outputs=(0,), rshape=(1, 1))
        inputs = [torch.randn(1024, device=card, generator=gen)]
    elif case.startswith("mean of rows"):
        spec = fused.Spec(
            shape=(16, 1000), inputs=(((16, 1000), F32), ((1, 1), F32)),
            body=(("b:mul", (F32,), F32, (("x", 0), ("x", 0))),
                  ("r:mean", ((1,), "", F32), F32, (("v", 0),)),
                  ("b:pow", (F32,), F32, (("v", 1), ("x", 1)))),
            reduce=1, outputs=(0, 1, 2), rshape=(16, 1))
        e = 2.0 if case.endswith(" 2") else 1.8
        inputs = [torch.randn(16, 1000, device=card, generator=gen),
                  torch.full((), e, device=card)]
    else:
        spec = fused.Spec(shape=(4096, 257), inputs=(((4096, 257), F64),),
                          body=(("r:sum", ((1,), "", F64), F64,
                                 (("x", 0),)),),
                          reduce=0, outputs=(0,), rshape=(4096, 1))
        inputs = [torch.randn(4096, 257, dtype=torch.float64, device=card,
                              generator=gen)]
    assert fused.layout(spec)["SPLITS"] == 1
    assert "def one_kernel(" in fused.source(spec)
    before = fused.launches
    one, two = _one_and_two(card, spec, inputs)
    assert fused.launches == before + 1
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int32 if a.dtype == torch.float32
                                  else torch.int64),
                           b.view(torch.int32 if b.dtype == torch.float32
                                  else torch.int64))


def test_generated_square_arm_is_the_rounded_square_everywhere(card):
    from runmat_tpu_torch.accel.engine import TorchEngine
    sweep = fusebench.square_sweep(TorchEngine("cuda"))
    assert sweep["values"] == 1 << 32 and sweep["kernel_differ"] == 0


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_generated_square_arm_calls_no_pow(card, dt):
    """The kernels of `x .^ e` (a map) and of a mean of it with `.^ e` in
    its epilogue: in the Triton IR the arm for 2 multiplies a value by
    itself and calls no libdevice pow, the other arm calls it; the machine
    code holds that pow inline (a MUFU) or as a call."""
    from runmat_tpu_torch.accel import fuse
    from runmat_tpu_torch.accel.engine import TorchEngine
    from runmat_tpu_torch.ops import fused
    eng = TorchEngine("cuda")
    p, outs, _ = dict(fusebench.table_cases())[f"pow scalar 2 {dt}"](
        eng.device)
    plan = fuse.plan(p.entries, outs)
    before = collections.Counter(fused.launches_by)
    eng.run_program(p.entries, p.values, outs, plan)
    torch.cuda.synchronize()
    launched = fused.launches_by - before
    assert len(launched) == len(plan.groups) == 2, launched
    for _, module in launched:
        arm = fusebench.square_arm(module)
        assert arm and all(
            a["ifs"] == 1 and a["ir_ok"] and a["mufu"] + a["calls"] > 0
            for v in arm.values() for a in v), arm


def test_generated_kernel_in_a_fold_follows_its_exponent(card):
    """A folded loop whose exponent switches between 2 and 3 each
    iteration, captured once and replayed, equals the eager fold on the
    CPU: the replays take the arm of each iteration's exponent."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    src = ("x = gpuArray(single(linspace(0.5, 1.5, 4096)'));"
           " y = gpuArray(zeros(4096, 1, 'single'));\n"
           "for t = 1:24\n  e = 2 + mod(t, 2);\n"
           "  y = y * single(0.5) + x .^ e;\nend\n")
    got = {}
    prev = accel.active_engine()
    try:
        for dev in ("cuda", "cpu"):
            s = runmat_tpu_torch.session(dev)
            eng = accel.active_engine()
            r = s.execute(src)
            assert r.error is None, r.error
            got[dev] = (s.get("y").host().copy(), dict(eng.stats))
            runmat_tpu_torch.uninstall()
    finally:
        accel.set_engine(prev)
    st = got["cuda"][1]
    assert st["loop_folds"] == 1 and st["graph_declines"] == 0
    assert st["graph_captures"] == 1 and st["graph_replays"] == 23
    assert got["cpu"][1]["graph_captures"] == 0
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------- linear algebra, FFT and filters

def _iir_held(got, want, chunk):
    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import iir
    r = linalgbench.held(got, want, chunk, iir.TOL[want.dtype])
    assert r["ok"], r
    return r


@pytest.mark.parametrize("order", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_kernel_equals_plain(card, dtype, order):
    # the first stretch bit for bit, the rest (3001 samples: 12 stretches)
    # within iir.TOL of the largest output: the carried states are rounded
    # in another order than the sequential scan's
    from runmat_tpu_torch.ops import iir
    gen = torch.Generator(device=card)
    gen.manual_seed(order)
    n = order + 1
    x = torch.randn(3001, dtype=dtype, device=card, generator=gen)
    b = torch.randn(n, dtype=dtype, device=card, generator=gen) * 0.3
    a = torch.randn(n, dtype=dtype, device=card, generator=gen) * 0.1
    z0 = torch.randn(n - 1, dtype=dtype, device=card, generator=gen) * 0.1
    before = iir.launches
    got = iir.iir(x, b, a, z0)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    assert iir.launches == before + 1
    _iir_held(got, want, iir.CHUNK)
    # a signal of one stretch is the sequential scan's, bit for bit
    short = x[:iir.CHUNK - 5]
    assert torch.equal(iir.iir(short, b, a, z0),
                       iir.plain_iir(short, b, a, z0))


def _iir_case(card, dtype, order, n, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    k = order + 1
    x = torch.randn(n, dtype=dtype, device=card, generator=gen)
    b = torch.randn(k, dtype=dtype, device=card, generator=gen) * 0.3
    a = torch.randn(k, dtype=dtype, device=card, generator=gen) * (
        0.1 if order <= 8 else 0.02)
    a[0] = 1
    z0 = torch.randn(k - 1, dtype=dtype, device=card, generator=gen) * 0.1
    return x, b, a, z0


@pytest.mark.parametrize("chunk,n", [(1, 5000), (4, 64 * 4 + 3),
                                     (16, 3001), (64, 1 << 16),
                                     (1024, 100_003), (1 << 20, 5000)])
@pytest.mark.parametrize("order", [1, 4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_kernel_over_many_stretches(card, dtype, order, chunk, n):
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _iir_case(card, dtype, order, n, 1000 * order + chunk)
    got = iir.launch(x, b, a, z0, chunk)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    _iir_held(got, want, chunk)


@pytest.mark.parametrize("chunk", [1, 16, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_kernel_near_a_pole_of_radius_0999(card, dtype, chunk):
    from runmat_tpu_torch.ops import iir
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    x = torch.randn(1 << 16, dtype=dtype, device=card, generator=gen)
    r, th = 0.999, 0.05
    b = torch.tensor([0.02, 0.01, -0.005], dtype=dtype, device=card)
    a = torch.tensor([1, -2 * r * np.cos(th), r * r], dtype=dtype,
                     device=card)
    z0 = torch.tensor([0.3, -0.2], dtype=dtype, device=card)
    got = iir.launch(x, b, a, z0, chunk)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    _iir_held(got, want, chunk)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_kernel_carries_a_non_finite_value(card, dtype, bad):
    # in the middle of stretch 40 of 64: every later output is non-finite
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _iir_case(card, dtype, 4, 64 * 256 - 9, 3)
    i = 40 * 256 + 100
    x[i] = bad
    got = iir.launch(x, b, a, z0, 256)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want[:i]).all())
    assert not bool(torch.isfinite(want[i:]).any())
    _iir_held(got, want, 256)


def test_iir_kernel_three_scan_levels(card):
    # 2^22 + 3 stretches of one sample: the carry scan takes three levels
    # of blocks of 2048 carries
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _iir_case(card, torch.float64, 2, (1 << 22) + 3, 17)
    got = iir.launch(x, b, a, z0, 1)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    _iir_held(got, want, 1)


def test_iir_kernel_refuses_what_it_does_not_take(card):
    # the chunked scan's wrapper refuses more than MAX_COEFS coefficients
    # (`iir` sends those to the sequential kernel instead)
    from runmat_tpu_torch.ops import iir
    n = iir.MAX_COEFS + 1
    x = torch.zeros(8, dtype=torch.float64, device=card)
    c = torch.ones(n, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="at most"):
        iir.launch(x, c, c, c[1:])
    with pytest.raises(ValueError, match="one device"):
        iir.iir(x, c[:3].cpu(), c[:3], c[:2])


# the warp kernel's orders (csrc/iir_warp.cu: 33 .. MAX_WARP_COEFS - 1)
WARP_ORDERS = [33, 39, 64]


def _warp_case(card, dtype, order, n, seed, pole=False):
    """A random filter of `order` with sum |a[1:]| = 0.5 (stable), or with
    `pole` a resonator of radius 0.999 times a random order - 2 part, and
    a nonzero state."""
    x, b, a, z0 = _iir_case(card, dtype, order, n, seed)
    a = a.double()
    a[1:] *= 0.5 / float(a[1:].abs().sum())
    if pole:
        r, th = 0.999, 0.05
        res = torch.tensor([1, -2 * r * np.cos(th), r * r],
                           dtype=torch.float64)
        a = torch.tensor(np.convolve(a[:order - 1].cpu().numpy(),
                                     res.numpy()), device=card)
    return x, b, a.to(dtype), z0


@pytest.mark.parametrize("order", WARP_ORDERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_warp_kernel_equals_plain(card, dtype, order):
    # through iir.iir at its default shape (iir.warp_shape): a signal of
    # one stretch bit for bit; 3001 samples (12 stretches) the first L
    # bit for bit, the rest within iir.TOL of the largest output
    from runmat_tpu_torch.ops import iir
    assert iir.MAX_COEFS < order + 1 <= iir.MAX_WARP_COEFS
    x, b, a, z0 = _warp_case(card, dtype, order, 3001, 500 + order)
    before = collections.Counter(iir.launches_by)
    got = iir.iir(x, b, a, z0)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    name = "iir_warp f64" if dtype == torch.float64 else "iir_warp f32"
    assert collections.Counter(iir.launches_by) - before == {name: 1}
    chunk = iir.warp_shape(x.numel())[0]
    _iir_held(got, want, chunk)
    short = x[:chunk - 5]
    assert torch.equal(iir.iir(short, b, a, z0),
                       iir.plain_iir(short, b, a, z0))


# (L, g, n): carry groups of 4 over 156 stretches (four levels), one
# level, 256 stretches in groups of 32 (two levels), a ragged last
# stretch over 98 stretches in groups of 8, and 2048 stretches of 32 in
# groups of 2 (the kernel's eight levels, the last one longer)
@pytest.mark.parametrize("chunk,group,n", [(32, 4, 5000), (256, 0, 3001),
                                           (256, 32, 1 << 16),
                                           (1024, 8, 100_003),
                                           (32, 2, 1 << 16)])
@pytest.mark.parametrize("order", WARP_ORDERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_warp_kernel_over_many_stretches(card, dtype, order, chunk,
                                             group, n):
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _warp_case(card, dtype, order, n, 1000 * order + chunk)
    got = iir.warp_launch(x, b, a, z0, chunk, group)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    _iir_held(got, want, chunk)


@pytest.mark.parametrize("chunk,group", [(64, 8), (512, 0), (256, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_warp_kernel_near_a_pole_of_radius_0999(card, dtype, chunk,
                                                    group):
    # order 39: the carries reach across many stretches
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _warp_case(card, dtype, 39, 1 << 16, 7, pole=True)
    assert np.abs(np.roots(a.double().cpu().numpy())).max() > 0.998
    got = iir.warp_launch(x, b, a, z0, chunk, group)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    _iir_held(got, want, chunk)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_warp_kernel_carries_a_non_finite_value(card, dtype, bad):
    # order 39, in the middle of stretch 40 of 64: every later output is
    # non-finite
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _warp_case(card, dtype, 39, 64 * 256 - 9, 3)
    i = 40 * 256 + 100
    x[i] = bad
    got = iir.warp_launch(x, b, a, z0, 256, 4)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want[:i]).all())
    assert not bool(torch.isfinite(want[i:]).any())
    _iir_held(got, want, 256)


@pytest.mark.parametrize("ncoef,route", [(33, "iir"), (34, "iir_warp"),
                                         (65, "iir_warp"),
                                         (66, "iir_seq")])
def test_iir_routes_by_order(card, ncoef, route):
    # orders 1-32 the scan, 33-64 the warp kernel, above the sequential one
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _warp_case(card, torch.float64, ncoef - 1, 2000, ncoef)
    before = collections.Counter(iir.launches_by)
    got = iir.iir(x, b, a, z0)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    assert collections.Counter(iir.launches_by) - before == \
        {f"{route} f64": 1}
    if route == "iir_seq":
        assert torch.equal(got, want)
    else:
        _iir_held(got, want, iir.CHUNK if route == "iir"
                  else iir.warp_shape(2000)[0])


def test_iir_warp_kernel_refuses_what_it_does_not_take(card):
    # more than MAX_WARP_COEFS coefficients, a chunk or group that is no
    # power of two
    from runmat_tpu_torch.ops import iir
    x = torch.zeros(8, dtype=torch.float64, device=card)
    c = torch.ones(iir.MAX_WARP_COEFS + 1, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="at most"):
        iir.warp_launch(x, c, c, c[1:])
    c = c[:40]
    with pytest.raises(ValueError, match="power of two"):
        iir.warp_launch(x, c, c, c[1:], 48, 0)
    with pytest.raises(ValueError, match="power of two"):
        iir.warp_launch(x, c, c, c[1:], 64, 3)


@pytest.mark.parametrize("ncoef,n", [(200, 2500), (2100, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iir_high_orders_take_the_sequential_kernel(card, dtype, ncoef, n):
    # above MAX_WARP_COEFS: csrc/iir_seq.cu, every output bit-equal to the
    # plain version (2100 coefficients keep the state in device memory,
    # not in shared memory); orders 33-64 take the warp kernel
    # (test_iir_warp_kernel_equals_plain)
    from runmat_tpu_torch.ops import iir
    x, b, a, z0 = _iir_case(card, dtype, ncoef - 1, n, ncoef)
    a[1:] *= 0.5 / max(1.0, float(a[1:].abs().sum()))
    before = collections.Counter(iir.launches_by)
    got = iir.iir(x, b, a, z0)
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    name = "iir_seq f64" if dtype == torch.float64 else "iir_seq f32"
    assert collections.Counter(iir.launches_by) - before == {name: 1}
    assert torch.equal(got, want)


def _run_on_card(src: str):
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    prev = accel.active_engine()
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        r = s.execute(src)
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    assert r.error is None, r.error
    return s, eng


def test_single_conv2_runs_in_true_fp32(card):
    """cuDNN runs a float32 convolution in TF32 unless told not to; the
    port's conv2 turns it off around the call and restores it."""
    fp32 = torch.backends.cudnn.conv.fp32_precision
    s, _ = _run_on_card("A = gpuArray(single(reshape(sin((1:2^16) .^ 1.3), "
                        "256, 256))); K = single(reshape(cos(1:25), 5, 5));"
                        " G = conv2(A, K, 'same'); G64 = conv2(double(A), "
                        "double(K), 'same');")
    assert torch.backends.cudnn.conv.fp32_precision == fp32
    g = np.asarray(s.get("G").host()).astype(np.float64)
    want = np.asarray(s.get("G64").host())
    # TF32 keeps ~3 decimal digits: its error here is ~1e-3 of the largest
    assert np.abs(g - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("script,pre", [("dense_linalg", "N = 1024;"),
                                        ("spectral", "N = 2^18;")])
def test_new_scripts_wait_only_where_counted(card, script, pre):
    """Each script on the card: no host fallback, and every wait torch's
    sync debug mode sees is one the engine counts (torch.linalg's waits
    among `syncs`, named in `sync_reasons`)."""
    from runmat_tpu_torch import syncs
    src = pre + "\n" + open(f"runmat_tpu_torch/workloads/{script}.m").read()
    s, eng = _run_on_card(src)
    assert eng.stats["host_fallbacks"] == 0
    r = syncs.script_syncs(src)
    assert r["warnings"] == r["counted"], r["sites"]
    if script == "dense_linalg":
        assert sum(eng.sync_reasons.values()) == eng.stats["syncs"] > 0


def _on(device: str, src: str, names):
    """`src` on a session of `device` taking every array; the named values
    on the host."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    prev = accel.active_engine()
    try:
        s = runmat_tpu_torch.session(device, auto_offload=True,
                                     offload_threshold=1)
        r = s.execute(src)
        assert r.error is None, r.error
        return [np.asarray(s.get(n).host()) for n in names], \
            accel.active_engine()
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)


def test_complex_values_on_card_match_the_cpu(card):
    """The complex surface on the card against the same engine on the CPU
    (the CPU tests hold that one to the JAX package): within 1e-12 of the
    largest magnitude (cuFFT, cuBLAS and the card's libm round apart)."""
    src = ("z = [1+2i, 3-4i, -2+1i, 0.5-0.25i]; w = [2-1i, -1+1i, -2+5i, 2i];"
           " M = reshape(sin(1:16) + 1i*cos(1:16), 4, 4);"
           " a = abs(z) + angle(w); e = exp(z) .* log(w) ./ sqrt(z);"
           " lt = z < w; eq = z == w; mx = max(M); mn = min(M, [], 2);"
           " m2 = max(z, w); s = sum(M); mu = mean(M, 2); c = cumsum(z);"
           " P = M * M'; g = M(2:3, [1 4]); M(1, :) = z; f = fft(M);"
           " sg = sign(z); rd = round(1.5 * z); v = var(M);"
           " x = zeros(1, 16); for t = 1:16, x(t) = abs(t + 2i); end")
    names = ["a", "e", "lt", "eq", "mx", "mn", "m2", "s", "mu", "c", "P",
             "g", "M", "f", "sg", "rd", "v", "x"]
    got, eng = _on("cuda", src, names)
    want, _ = _on("cpu", src, names)
    assert eng.stats["host_fallbacks"] == 0 and eng.stats["loop_folds"] == 1
    for n, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, n
        if w.dtype.kind == "b":
            assert np.array_equal(g, w), n
            continue
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= 1e-12 * scale, n


# ------------------------------------------ interpolation, selection and pages

def _card_and_host(src: str, names):
    """`src` in a card session taking every array and in the port's host
    engine (so `src` names no gpuArray); the named values of each on the
    host, and the card's engine."""
    import runmat_tpu_torch
    from runmat_tpu_torch.session import Session
    got, eng = _on("cuda", src, names)
    s = Session(accelerate=False, stdout=io.StringIO())
    r = s.execute(src)
    assert r.error is None, r.error
    runmat_tpu_torch.uninstall()
    return got, [np.asarray(s.get(n).host()) for n in names], eng


def _held(names, got, want, tol):
    for n, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (n, g.shape,
                                                           w.shape)
        assert np.array_equal(np.isnan(g), np.isnan(w)), n
        scale = max(1.0, float(np.nanmax(np.abs(w), initial=0.0)))
        assert np.nanmax(np.abs(g - w), initial=0.0) <= tol * scale, n


@pytest.mark.parametrize("ncoef", [34, 41, 201])     # orders 33, 40, 200
def test_filter_of_a_high_order_on_a_device_array(card, ncoef):
    # orders 33 and 40 take the warp kernel, 200 the sequential one
    from runmat_tpu_torch.ops import iir
    m = ncoef - 1
    # the card session takes every array (x too); b and a are read on the
    # host by the builtin
    src = (f"rng(3); x = randn(20000, 1); b = ones(1, {ncoef}) / {ncoef};"
           f" a = [1 (0.5 / {m}) * ones(1, {m})]; w = filter(b, a, x);")
    before = collections.Counter(iir.launches_by)
    got, want, eng = _card_and_host(src, ["w"])
    route = "iir_warp" if ncoef <= iir.MAX_WARP_COEFS else "iir_seq"
    assert collections.Counter(iir.launches_by) - before == \
        {f"{route} f64": 1}
    assert eng.stats["host_fallbacks"] == 0
    # the host engine filters with its own recurrence (scipy's lfilter)
    _held(["w"], got, want, 1e-12)


def test_interp_maxk_and_pages_on_device_arrays(card):
    src = ("rng(7); N = 2^16; t = linspace(0, 1, N)'; x = sin(40*t) + "
           "0.1*randn(N, 1); tq = linspace(0, 1, N)' .^ 1.5;"
           " y = interp1(t, x, tq); yn = interp1(t, x, [tq; -1; NaN; 2]);"
           " top = maxk(abs(y), 64); low = mink(y, 16); r = maxk(y', 5);"
           " A = randn(8, 8, 64) + 8*eye(8); B = randn(8, 8, 64);"
           " C = pagemtimes(A, B); D = pagefun(@mtimes, A, B);"
           " E = pagemtimes(A, 'transpose', B, 'none');"
           " X = pagemldivide(A, B); Ai = pageinv(A); nC = pagenorm(C, 'fro');"
           " n1 = pagenorm(C, 1); ni = pagenorm(C, Inf); n2 = pagenorm(C);"
           " T = pagectranspose(A);")
    names = ["y", "yn", "top", "low", "r", "C", "D", "E", "X", "Ai", "nC",
             "n1", "ni", "n2", "T"]
    got, want, eng = _card_and_host(src, names)
    assert eng.stats["host_fallbacks"] == 0
    kinds = [k for e in eng.launch_log if e["cat"] == "linalg"
             for k in e["ops"]]
    for kind in ("interp1lin", "topk", "pagemtimes", "pagesolve", "pageinv",
                 "pagenorm", "pagectranspose"):
        assert kind in kinds, (kind, kinds)
    # the interpolated values and what is picked from them within 1e-10
    # of the largest magnitude: the query grid's `.^ 1.5` rounds apart by
    # an ulp on the card and the host, times slopes of up to ~3e4 between
    # noisy samples; cuBLAS and cuSOLVER against LAPACK, and the pages'
    # normal draws (a few ulps apart), within 1e-12
    _held(names[:5], got[:5], want[:5], 1e-10)
    _held(names[5:], got[5:], want[5:], 1e-12)
    assert np.array_equal(got[names.index("C")], got[names.index("D")])


def test_parfeval_on_a_device_array_while_the_card_computes(card):
    # a task's engine calls and the main thread's take turns under the
    # engine's lock; each side's result is what it computes alone
    src = ("rng(2); A = randn(512); f = parfeval(@(M) sum(M(:) .^ 2)"
           ", 1, A); acc = 0; for k = 1:40, acc = acc + sum(A(:) * k); end;"
           " B = A * A; r = fetchOutputs(f); s = sum(A(:) .^ 2);"
           " c = sum(B(:));")
    names = ["r", "s", "acc", "c"]
    got, want, eng = _card_and_host(src, names)
    assert got[0] == got[1]
    _held(names, got, want, 1e-9)


# ------------------------------------------------- the sparse CG kernels
# (csrc/spcg.cu via ops/spcg.py; runmat_tpu_torch/spbench.py makes the
# cases): the product bit for bit against plain_spmv, a solve within 1e-8
# of plain_cg's largest entry, bit for bit the same when repeated and bit
# for bit plain_cg(ordered=True)'s (the kernels' order of summing), each
# tail's scalars the ordered model's


@pytest.mark.parametrize("case", range(7))
def test_spmv_kernel_matches_plain(card, case):
    from runmat_tpu_torch import spbench
    from runmat_tpu_torch.ops import spcg
    label, *csr = spbench.spmv_case(card, case)
    before = spcg.launches
    r = spbench.spmv_held(spcg, *csr)
    assert spcg.launches == before + 1
    assert r["equal"], (label, r)


@pytest.mark.parametrize("case", [0, 1, 4])
def test_the_earlier_spmv_design_matches_plain(card, case):
    # the one-thread-a-row yardstick the product is timed against, which
    # no path launches and no count sees
    from runmat_tpu_torch import spbench
    from runmat_tpu_torch.ops import spcg
    label, rowptr, col, val, p = spbench.spmv_case(card, case)
    before = collections.Counter(spcg.launches_by)
    got = torch.empty_like(p)
    spbench.earlier_product(spcg, p.numel(), rowptr, col, val, p, got)
    assert collections.Counter(spcg.launches_by) == before
    assert torch.equal(got, spcg.plain_spmv(rowptr, col, val, p)), label


@pytest.mark.parametrize("case", range(2))
def test_cg_kernels_match_plain_and_repeat_bit_for_bit(card, case):
    from runmat_tpu_torch import spbench
    from runmat_tpu_torch.ops import spcg
    label, *system = spbench.cg_cases(card)[case]
    r = spbench.cg_held(spcg, *system)
    assert r["ok"], (label, r)


def test_each_cg_kernel_matches_the_jax_body(card):
    from runmat_tpu_torch import histbench, spbench
    from runmat_tpu_torch.ops import spcg
    r = spbench.step_rows(spcg, histbench.time_ms, 3, N=128)
    assert r["start_ok"] and r["timed_ok"]
    assert all(row["ok"] for row in r["rows"].values()), r["rows"]


def test_cg_zero_b_is_done_before_the_first_iteration(card):
    from runmat_tpu_torch import spbench
    from runmat_tpu_torch.ops import spcg
    rowptr, col, val = spbench.poisson_csr(64, card)
    invd = spbench.inverse_diagonal(rowptr, col, val)
    before = collections.Counter(spcg.launches_by)
    x, k = spcg.cg(rowptr, col, val, torch.zeros(64 * 64, dtype=torch.float64,
                                                 device=card), invd)
    assert k == 0 and not bool(x.any())
    # the start's one launch, then one chunk in which nothing runs
    assert collections.Counter(spcg.launches_by) - before == {
        "cg_update": 1 + spcg.CHUNK, "spmv_f64": spcg.CHUNK,
        "cg_direction": spcg.CHUNK}


def _cg_system(card, case: str) -> tuple:
    """(rowptr, col, val, b, invd): the [-1 2 -1] stencil on a grid of one
    block (200 rows) or of two whose second holds one row (257), or a
    system of `spbench.cg_cases`, with a seeded b."""
    from runmat_tpu_torch import spbench
    if case.startswith("tridiagonal"):
        n = int(case.split()[1])
        rowptr, col, val = spbench.tridiagonal_csr(n, card)
        b = torch.from_numpy(np.random.default_rng(n).standard_normal(
            n)).to(card)
        return rowptr, col, val, b, spbench.inverse_diagonal(rowptr, col, val)
    return tuple(spbench.cg_cases(card)[int(case.split()[1])][1:])


CG_SYSTEMS = ["tridiagonal 200", "tridiagonal 257", "case 0", "case 1"]


@pytest.mark.parametrize("case", CG_SYSTEMS)
def test_cg_tails_equal_the_ordered_model(card, case):
    # a start, then one spmv_f64 and one cg_update launch: p.Ap, alpha,
    # r.z, r.r and beta the ordered model's bit for bit, k = 1, not done
    from runmat_tpu_torch import spbench
    from runmat_tpu_torch.ops import spcg
    rowptr, col, val, b, invd = _cg_system(card, case)
    s = spcg._Solver(rowptr, col, val, 1e-10, 10 * b.numel())
    s.load(rowptr, col, val, invd)
    check, err = spbench.first_iteration(spcg, s, b, invd)
    assert all(check.values()), (check, err)
    assert s.ctl.tolist() == [0, 1] and s.count.tolist() == [0, 0]


@pytest.mark.parametrize("case", CG_SYSTEMS)
def test_cg_equals_the_ordered_model_bit_for_bit(card, case):
    from runmat_tpu_torch.ops import spcg
    rowptr, col, val, b, invd = _cg_system(card, case)
    cache = {}
    x1, k1 = spcg.cg(rowptr, col, val, b, invd, cache=cache)
    x2, k2 = spcg.cg(rowptr, col, val, b, invd, cache=cache)
    xo, ko = spcg.plain_cg(rowptr, col, val, b, invd, ordered=True)
    assert k1 == k2 == ko > 0
    assert torch.equal(x1, x2) and torch.equal(x1, xo)


def test_cg_after_a_failed_launch_starts_with_zeroed_counters(card,
                                                              monkeypatch):
    # a launch fails while the graph is captured; the cached solver's
    # counters are then left as a fault inside a tail would leave them,
    # and the next solve is still the ordered model's
    from runmat_tpu_torch.ops import spcg
    rowptr, col, val, b, invd = _cg_system(card, "case 0")
    cache, failed = {}, []
    entry = spcg._entry

    def fail_once(name, argtypes):
        if name == "runmat_cg_direction" and not failed:
            failed.append(name)
            return lambda *a: 1
        return entry(name, argtypes)

    monkeypatch.setattr(spcg, "_entry", fail_once)
    with pytest.raises(RuntimeError, match="cg_direction kernel launch"):
        spcg.cg(rowptr, col, val, b, invd, cache=cache)
    solver = cache["solver"]
    assert solver.graph is None
    solver.count.copy_(torch.tensor([3, 7], dtype=torch.int32))
    x, k = spcg.cg(rowptr, col, val, b, invd, cache=cache)
    xo, ko = spcg.plain_cg(rowptr, col, val, b, invd, ordered=True)
    assert cache["solver"] is solver and k == ko and torch.equal(x, xo)
    assert solver.count.tolist() == [0, 0]


def test_sparse_solve_waits_equal_the_chunk_reads(card):
    from runmat_tpu_torch import syncs
    from runmat_tpu_torch.ops import spcg
    src = "N = 48;\n" + open(
        "runmat_tpu_torch/workloads/sparse_poisson.m").read()
    r = syncs.script_syncs(src)
    assert r["warnings"] == r["counted"], r
    cg = [site for site in r["sites"] if site.startswith(
        "runmat_tpu_torch/ops/spcg.py")]
    assert len(cg) == 1 and r["sites"][cg[0]] == r["syncs"] >= 1, r
    # the script's x against the host engine (its host CG)
    got, want, eng = _card_and_host(src, ["x"])
    k = [e["iterations"] for e in eng.launch_log if e["cat"] == "sparse_cg"]
    assert len(k) == 1 and eng.sync_reasons["cg"] == \
        max(1, -(-k[0] // spcg.CHUNK))
    _held(["x"], got, want, 1e-8)


def test_a_failed_launch_raises_and_nothing_falls_back(card, monkeypatch):
    from runmat_tpu_torch import spbench
    from runmat_tpu_torch.ops import spcg
    rowptr, col, val = spbench.poisson_csr(64, card)
    p = torch.ones(64 * 64, dtype=torch.float64, device=card)
    with pytest.raises(RuntimeError, match="spmv_f64 kernel launch failed"):
        spcg._spmv(-1, rowptr, col, val, p, p, None, None)
    monkeypatch.setattr(spcg, "plain_cg", None)
    monkeypatch.setattr(spcg, "plain_spmv", None)
    monkeypatch.setattr(spcg, "_entries", {
        "runmat_spmv_f64": lambda *a: 1, "runmat_cg_update": lambda *a: 0,
        "runmat_cg_direction": lambda *a: 0})
    with pytest.raises(RuntimeError, match="spmv_f64 kernel launch failed"):
        spcg.cg(rowptr, col, val, p, spbench.inverse_diagonal(rowptr, col,
                                                              val))


def test_a_source_that_does_not_compile_raises(card, monkeypatch, tmp_path):
    from runmat_tpu_torch.ops import _build, spcg
    (tmp_path / "spcg.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(spcg, "_entries", {})
    p = torch.ones(4, dtype=torch.float64, device=card)
    rowptr = torch.arange(5, dtype=torch.int64, device=card)
    col = torch.arange(4, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        spcg.spmv(rowptr, col, p, p)


# ------------------------------------------------------------ deep learning


def test_lstm_cell_kernels_match_plain(card):
    # forward with and without the saved activations, backward with dh'
    # and dc', either alone; at dl_vowels' (4*100, 27) and two odd shapes
    from runmat_tpu_torch import dlbench
    from runmat_tpu_torch.ops import lstm
    before = dict(lstm.launches_by)
    for name, r in dlbench.held_cell(lstm, card).items():
        assert r["equal"], (name, r)
        assert lstm.launches_by[name] > before.get(name, 0)


def test_lstm_sequence_kernels_match_ordered_plain(card):
    # both kernels bit-equal to plain_seq_*(ordered=True) at dl_vowels'
    # layer, (7, 8, 5), (1, 1, 1), H = 37 (no cluster size divides it), a
    # batch of one and dl_vowels' predict (270 sequences over three
    # clusters); forward and reverse, 'last' and 'sequence', the forward
    # with and without what the backward needs
    from runmat_tpu_torch import dlbench
    from runmat_tpu_torch.ops import lstm_seq
    before = dict(lstm_seq.launches_by)
    cluster = lstm_seq.layout(dlbench.H, dlbench.N)[0]
    for name, r in dlbench.held_seq(lstm_seq, card, [cluster]).items():
        assert r["equal"], (name, r)
        assert lstm_seq.launches_by[name] > before.get(name, 0)


def test_lstm_sequence_smem_formula_is_the_kernels(card):
    from runmat_tpu_torch.ops import lstm_seq
    for h, n in ((100, 27), (1, 1), (37, 9), (8, 5), (250, 27), (100, 1081)):
        for c in lstm_seq.CLUSTER_SIZES:
            assert lstm_seq.kernel_smem(h, n, c) == \
                lstm_seq.smem_bytes(h, n, c)


def _seq_run(lstm_seq, x, last):
    out, saved = lstm_seq.forward(x["zx"], x["wh"], True, last)
    dz = lstm_seq.backward_dz(x["wh"], saved[1], saved[2],
                              x["dhlast"] if last else x["dhs"], last)
    return [out, *saved, dz]


@pytest.mark.parametrize("last", [True, False], ids=["last", "sequence"])
def test_lstm_sequence_kernels_repeat_and_replay_bit_equal(card, last):
    # two launches give the same bits, and so does a replay of both
    # launched inside a captured CUDA graph
    from runmat_tpu_torch import dlbench
    from runmat_tpu_torch.ops import lstm_seq
    x = dlbench.seq_inputs(card, seed=5)
    first = _seq_run(lstm_seq, x, last)
    second = _seq_run(lstm_seq, x, last)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = dict(lstm_seq.captured)
    with torch.cuda.stream(side):
        graph.capture_begin()
        held = _seq_run(lstm_seq, x, last)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert lstm_seq.captured["lstm_seq_fwd"] == \
        before.get("lstm_seq_fwd", 0) + 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(held, first))


@pytest.mark.parametrize("h,n,seq", [(512, 4, False), (100, 270, True)],
                         ids=["too-wide", "clusters-share-the-batch"])
def test_the_layer_runs_the_path_its_shape_routes_to(card, h, n, seq):
    # H = 512: no cluster's shared memory holds one column's slices, so
    # the layer takes addmm and the cell kernel a step; dl_vowels' predict
    # (270 sequences) is one launch of clusters that share the columns
    from runmat_tpu_torch.ops import lstm, lstm_seq
    from runmat_tpu_torch.runtime.builtins import dl_layers
    assert bool(lstm_seq.layout(h, n)[0]) == seq
    layers = [{"Type": "sequenceInput", "InputSize": 2.0},
              {"Type": "lstm", "NumHiddenUnits": float(h),
               "OutputMode": "sequence"}]
    net = dl_layers.DlNetwork(layers, device=card)
    fwd, sfwd = lstm.launches_by["lstm_fwd"], \
        lstm_seq.launches_by["lstm_seq_fwd"]
    x = np.random.default_rng(1).normal(size=(2, 3, n))
    y = net.predict_np(x)
    assert y.shape == (h, 3, n) and np.isfinite(y).all()
    assert lstm.launches_by["lstm_fwd"] - fwd == (0 if seq else 3)
    assert lstm_seq.launches_by["lstm_seq_fwd"] - sfwd == (1 if seq else 0)
    cpu = dl_layers.DlNetwork(layers, device=torch.device("cpu"))
    assert np.allclose(y, cpu.predict_np(x), rtol=1e-5, atol=1e-5)


def test_a_failed_sequence_launch_raises(card, monkeypatch):
    # a cluster the card refuses raises MatError; neither the cell kernel
    # nor the plain version runs in its place
    from runmat_tpu_torch import dlbench
    from runmat_tpu_torch.errors import MatError
    from runmat_tpu_torch.ops import lstm, lstm_seq
    x = dlbench.seq_inputs(card, t=3, h=8, n=5)
    cell, seq = lstm.launches, lstm_seq.launches
    monkeypatch.setattr(lstm_seq, "plain_seq_forward", None)
    with pytest.raises(MatError, match="preparing a cluster of 32"):
        lstm_seq.forward(x["zx"], x["wh"], True, False, 32)
    dev = torch.cuda.current_device()
    monkeypatch.setattr(lstm_seq, "_prepared", {(dev, 8, 5, 32)})
    with pytest.raises(MatError, match="lstm_seq_fwd launch failed"):
        lstm_seq.forward(x["zx"], x["wh"], True, False, 32)
    torch.cuda.synchronize()
    assert lstm.launches == cell and lstm_seq.launches == seq
    # the card is still usable
    out, _ = lstm_seq.forward(x["zx"], x["wh"], True, False)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def test_optim_kernel_matches_plain(card):
    from runmat_tpu_torch import dlbench
    from runmat_tpu_torch.ops import optim
    for name, r in dlbench.held_optim(optim, card).items():
        assert r["equal"] and r["t_ok"], (name, r)
        assert optim.launches_by[name] >= 12


# a thread takes one element, a block 512: 1 to 5 fill a few threads of
# one block; the scripts' 21690 and 46109 and 2^20 + 3 (several waves'
# worth) end in a part block
@pytest.mark.parametrize("n", [1, 3, 4, 5, 21690, 46109, (1 << 20) + 3])
def test_optim_kernel_bit_equal_at_every_size(card, n):
    from runmat_tpu_torch import dlbench
    from runmat_tpu_torch.ops import optim
    before = dict(optim.launches_by)
    for name, r in dlbench.held_optim(optim, card, sizes=[n]).items():
        assert r["equal"] and r["t_ok"], (name, n, r)
        # three steps from t = 0 and three from dlbench.LATE_T
        assert optim.launches_by[name] - before.get(name, 0) == 6


def test_optim_kernel_takes_a_view_at_offset_1(card, monkeypatch):
    # a view at offset 1 is contiguous but not 16-byte aligned: the
    # kernel's loads are 4 bytes wide, so it takes it, bit-equal to plain,
    # and nothing outside the view is written
    from runmat_tpu_torch.ops import optim
    plain = optim.plain_update
    monkeypatch.setattr(optim, "plain_update", None)
    for solver in ("adam", "sgdm"):
        base = torch.zeros(101, device=card)
        p = base[1:]
        st = optim.State(solver, p, 0.01)
        g = torch.zeros(101, device=card)[1:].fill_(0.5)
        q = torch.zeros(100, device=card)
        ref = optim.State(solver, q, 0.01)
        before = optim.launches
        optim.update(st, p, g)
        plain(ref, q, g)
        torch.cuda.synchronize()
        assert optim.launches == before + 1
        assert torch.equal(p, q) and torch.equal(st.m, ref.m)
        assert st.v is None or torch.equal(st.v, ref.v)
        assert float(st.t) == 1 and not base[0]


@pytest.mark.parametrize("solver", ["adam", "sgdm"])
def test_optim_t_advances_once_a_launch_and_a_replay(card, solver):
    from runmat_tpu_torch.ops import optim
    n = 46109
    p = torch.zeros(n, device=card)
    g = torch.full((n,), 0.5, device=card)
    st = optim.State(solver, p, 0.01)
    for k in range(1, 4):
        optim.update(st, p, g)
        torch.cuda.synchronize()
        assert float(st.t) == k
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        optim.update(st, p, g)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert float(st.t) == 3          # a capture runs nothing
    for k in range(1, 6):
        graph.replay()
        torch.cuda.synchronize()
        assert float(st.t) == 3 + k
    # the replays computed what eager steps compute
    q = torch.zeros(n, device=card)
    ref = optim.State(solver, q, 0.01)
    for _ in range(8):
        optim.plain_update(ref, q, g)
    assert torch.equal(p, q) and torch.equal(st.m, ref.m)


def test_optim_states_interleaved_keep_their_counts(card):
    # two Adam states (1 and 181 blocks) and an SGDM one, launched in turns
    from runmat_tpu_torch.ops import optim
    sizes = (100, 46109, 1000)
    ps = [torch.zeros(n, device=card) for n in sizes]
    sts = [optim.State(s, p, 0.01)
           for s, p in zip(("adam", "adam", "sgdm"), ps)]
    for k in range(6):
        for j, (st, p) in enumerate(zip(sts, ps)):
            if k % (j + 1) == 0:
                optim.update(st, p, torch.ones_like(p))
    torch.cuda.synchronize()
    assert [float(st.t) for st in sts] == [6, 3, 2]


def _small_training(card, solver="adam", epochs=2):
    """A small LSTM classifier and its data, on the card: (net, hx, hy,
    opts) for dl_layers._train."""
    from runmat_tpu_torch.runtime.builtins import dl_layers
    from runmat_tpu_torch.values import MatArray, StructArray
    layers = [{"Type": "sequenceInput", "InputSize": 3.0},
              {"Type": "lstm", "NumHiddenUnits": 8.0, "OutputMode": "last"},
              {"Type": "fc", "OutputSize": 4.0}, {"Type": "softmax"},
              {"Type": "classification"}]
    net = dl_layers.DlNetwork(layers, device=card)
    rng = np.random.default_rng(0)
    hx = rng.normal(size=(3, 6, 20))
    hy = dl_layers._labels_to_onehot(rng.integers(1, 5, 20).astype(float), 4)
    opts = StructArray.scalar({
        "Solver": MatArray.char_from_str(solver),
        "MaxEpochs": MatArray.scalar(float(epochs)),
        "MiniBatchSize": MatArray.scalar(5.0),
        "InitialLearnRate": MatArray.scalar(0.01)})
    return net, hx, hy, opts


def test_training_step_is_one_captured_graph(card):
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.ops import lstm, lstm_seq, optim
    from runmat_tpu_torch.runtime.builtins import dl_layers
    runmat_tpu_torch.install("cuda")
    try:
        eng = accel.active_engine()
        net, hx, hy, opts = _small_training(card, epochs=3)
        fwd, adam = lstm.launches_by["lstm_fwd"], optim.launches_by["optim_adam"]
        sfwd, sbwd = (lstm_seq.launches_by["lstm_seq_fwd"],
                      lstm_seq.launches_by["lstm_seq_bwd"])
        dl_layers._train(net, hx, hy, opts)
        steps = 3 * 4
        assert eng.stats["graph_captures"] == 1
        assert eng.stats["graph_replays"] == steps - dl_layers._TrainStep.WARMUP
        assert optim.launches_by["optim_adam"] - adam == steps
        (step,) = net._train_steps.values()
        assert float(step.state.t) == steps
        # the layer's 6 steps are one cluster launch each way a step
        assert lstm_seq.launches_by["lstm_seq_fwd"] - sfwd == steps
        assert lstm_seq.launches_by["lstm_seq_bwd"] - sbwd == steps
        assert lstm.launches_by["lstm_fwd"] == fwd
        # a second training of the same network replays the same graph
        dl_layers._train(net, hx, hy, opts)
        assert eng.stats["graph_captures"] == 1
        assert eng.stats["graph_replays"] == 2 * steps - 2
        assert float(step.state.t) == steps
    finally:
        runmat_tpu_torch.uninstall()


def test_a_failed_capture_raises(card, monkeypatch):
    from runmat_tpu_torch.errors import MatError
    from runmat_tpu_torch.runtime.builtins import dl_layers
    net, hx, hy, opts = _small_training(card)
    body = dl_layers._TrainStep.body

    def waits(self):
        g = body(self)
        if torch.cuda.is_current_stream_capturing():
            float(g.sum())          # a read back: refused inside a capture
        return g

    monkeypatch.setattr(dl_layers._TrainStep, "body", waits)
    with pytest.raises(MatError, match="capture of the training step failed"):
        dl_layers._train(net, hx, hy, opts)
    torch.cuda.synchronize()


def test_no_wait_inside_the_training_loop(card):
    from runmat_tpu_torch.runtime.builtins import dl_layers
    net, hx, hy, opts = _small_training(card, solver="sgdm")
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dl_layers._train(net, hx, hy, opts)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert np.isfinite(net.learnables_np()[0]).all()


def test_two_trainings_on_the_card_agree(card):
    from runmat_tpu_torch.runtime.builtins import dl_layers
    flats = []
    for _ in range(2):
        net, hx, hy, opts = _small_training(card, epochs=4)
        dl_layers._train(net, hx, hy, opts)
        flats.append(np.concatenate([a.reshape(-1)
                                     for a in net.learnables_np()]))
    assert np.array_equal(flats[0], flats[1])


def test_three_steps_on_the_card_match_the_cpu(card):
    from runmat_tpu_torch.runtime.builtins import dl_layers
    out = {}
    for dev in (card, torch.device("cpu")):
        net, hx, hy, opts = _small_training(dev)
        dl_layers._train(net, hx, hy, opts, max_steps=3)
        out[dev.type] = np.concatenate([a.reshape(-1)
                                        for a in net.learnables_np()])
    from runmat_tpu_torch import dlbench
    scale = float(np.abs(out["cpu"]).max())
    assert float(np.abs(out["cuda"] - out["cpu"]).max()) <= \
        dlbench.STEP_TOL["adam"] * scale


def test_dlgradient_on_the_card_matches_the_cpu(card):
    from runmat_tpu_torch import dlbench
    r = dlbench.dlfeval_snippet()
    assert r["rel_err"] <= 1e-12, r


# ------------------------------------------------------------ records path

SENSOR_SMALL = "D = 3; F = 4096; C = 4;\n"


def test_sensor_log_small_matches_the_host_engine(card):
    """sensor_log.m at 3 days of 4096 samples and 4 channels on the card:
    SENSOR within 1e-9 of the host engine, the daily statistics within
    1e-12 of their largest magnitude, the counts equal, its three kernel
    kinds launched, no host fallback, and every wait counted."""
    from runmat_tpu_torch import syncs
    from runmat_tpu_torch.ops import histogram, threefry
    src = SENSOR_SMALL + open("runmat_tpu_torch/workloads/sensor_log.m").read()
    names = ["mu", "sd", "mx", "n64", "n32"]
    draws = collections.Counter(threefry.launches_by)
    hist = collections.Counter(histogram.launches_by)
    got, want, eng = _card_and_host(src, names + ["res"])
    assert collections.Counter(threefry.launches_by)["randn float64"] > \
        draws["randn float64"]
    moved = collections.Counter(histogram.launches_by) - hist
    assert moved["search f64"] >= 1 and moved["direct f32"] >= 1
    assert eng.stats["host_fallbacks"] == 0
    res, ref = float(got[-1].reshape(-1)[0]), float(want[-1].reshape(-1)[0])
    assert abs(res - ref) <= 1e-9 * abs(ref)
    _held(names[:3], got[:3], want[:3], 1e-12)
    assert np.array_equal(got[3], want[3])
    assert np.array_equal(got[4].astype(np.float64), want[4])
    r = syncs.script_syncs(src)
    assert r["warnings"] == r["counted"], r["sites"]


def test_a_table_of_card_arrays(card):
    src = ("rng(1); x = randn(64, 3); y = x .^ 2; T = array2table([x y]);"
           " S = sortrows(T, 'Var4', 'descend'); A = table2array(S);"
           " h = height(S); TT = table2timetable(T, 'RowTimes',"
           " datetime(2026, 1, 1) + hours(0:63)'); W = retime(TT, 'daily',"
           " 'mean'); m = W.Var1;")
    got, want, eng = _card_and_host(src, ["A", "h", "m"])
    assert eng.stats["host_fallbacks"] == 0
    _held(["A", "h", "m"], got, want, 1e-12)


def test_save_and_load_of_a_card_array(card, tmp_path):
    """A MAT file of card arrays (saving moves them to the host, as in the
    JAX package) loads bit for bit in the host engine."""
    from runmat_tpu_torch.session import Session
    p = str(tmp_path / "card.mat")
    src = (f"rng(2); x = randn(1000, 7); s = single(x); k = int16(x * 100);"
           f" save('{p}', 'x', 's', 'k'); L = load('{p}');")
    (x, s, k), _ = _on("cuda", src, ["x", "s", "k"])
    host = Session(accelerate=False, stdout=io.StringIO())
    assert host.execute(f"W = load('{p}');").error is None
    for name, v in (("x", x), ("s", s), ("k", k)):
        h = np.asarray(host.get("W").get_scalar_field(name).host())
        assert h.dtype == v.dtype and np.array_equal(h, v), name


def test_a_handle_class_with_a_card_property(card):
    """A handle object holding a card array in a property and adding
    sum(x(:)) of card arrays to another, against the host engine. Through
    run_source: `execute`'s workspace preview formats the object's
    properties, which moves a card property to the host (as in the JAX
    package)."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.session import Session
    cls = ("classdef Acc < handle\nproperties\ndata = []\ntotal = 0\nend\n"
           "methods\nfunction add(obj, x)\nobj.data = x;\n"
           "obj.total = obj.total + sum(x(:));\nend\nend\nend\n")
    use = ("rng(5); x = randn(2048, 32); a = Acc(); a.add(x); a.add(x * 3);"
           " t = a.total; d = a.data; w = sum(abs(x(:)));")
    host = Session(accelerate=False, stdout=io.StringIO())
    for src in (cls, use):
        assert host.execute(src).error is None
    prev = accel.active_engine()
    try:
        s = runmat_tpu_torch.session("cuda", auto_offload=True,
                                     offload_threshold=1)
        s.stdout = io.StringIO()
        for src in (cls, use):
            s.run_source(src)
        assert s.get("a").props["data"].on_device
        t, d = (np.asarray(s.get(n).host()) for n in ("t", "d"))
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    w = float(host.get("w").host()[0, 0])
    assert abs(float(t.reshape(-1)[0]) - float(host.get("t").host()[0, 0])) \
        <= 1e-12 * w
    np.testing.assert_allclose(d, host.get("d").host(), rtol=0,
                               atol=1e-13 * w)


# ------------------------------------------- the colormap kernel, imfilter

CMAP_SHAPES = ((1, 1), (3, 5), (33, 65), (1081, 1921))


@pytest.mark.parametrize("shape", CMAP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", plotbench.CASES)
def test_cmap_kernel_matches_plain(card, case, dtype, shape):
    # the image bit for bit, lo, hi and hi2 equal (NaN where plain has it)
    from runmat_tpu_torch.ops import cmap
    from runmat_tpu_torch.plotbench import field
    a = field(case, shape, dtype, seed=shape[1], device=card)
    before = cmap.launches
    rgb, sc = cmap.cmap(a, "parula")
    want, wsc = cmap.plain_cmap(a, cmap.device_table("parula", card))
    torch.cuda.synchronize()
    assert cmap.launches == before + 1
    assert rgb.shape == tuple(shape) + (3,) and rgb.dtype == torch.uint8
    assert torch.equal(rgb, want)
    assert torch.equal(sc.isnan(), wsc.isnan())
    assert torch.equal(sc.nan_to_num(), wsc.nan_to_num())


@pytest.mark.parametrize("name", plotbench.COLORMAPS)
def test_cmap_kernel_matches_plain_for_every_colormap(card, name):
    from runmat_tpu_torch.ops import cmap
    ramp = torch.linspace(-1, 2, 3 * 256 * 7, dtype=torch.float64,
                          device=card).reshape(48, 112)
    for a in (ramp, ramp.float(), ramp[:, 1:]):   # the last not 16-aligned
        rgb, _ = cmap.cmap(a, name)
        want, _ = cmap.plain_cmap(a, cmap.device_table(name, card))
        assert torch.equal(rgb, want), (name, a.dtype)


def test_cmap_kernel_refuses_what_it_does_not_take(card):
    from runmat_tpu_torch.errors import MatError
    from runmat_tpu_torch.ops import cmap
    for a in (torch.zeros(4, dtype=torch.int32, device=card),
              torch.zeros(0, dtype=torch.float64, device=card)):
        with pytest.raises(MatError) as ei:
            cmap.cmap(a, "parula")
        assert ei.value.identifier == "RunMat:cmapKernel"


@pytest.mark.parametrize("boundary", ["constant", "replicate"])
@pytest.mark.parametrize("ksize", [(3, 3), (4, 4), (2, 5), (15, 15)])
def test_imfilter_on_the_card_matches_the_cpu(card, ksize, boundary):
    # cuDNN's sums in another order than the CPU's: within 1e-12 of the
    # largest output
    from runmat_tpu_torch.accel.dense import _b_imfilter
    g = torch.Generator().manual_seed(ksize[0] * 10 + ksize[1])
    x = torch.randn(270, 481, dtype=torch.float64, generator=g)
    k = torch.randn(ksize, dtype=torch.float64, generator=g)
    f = _b_imfilter(None, (boundary,))
    want = f(x, k)
    got = f(x.to(card), k.to(card)).cpu()
    assert got.shape == want.shape == x.shape
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


FIELD_SMALL = "H = 270; W = 480;\n"


def test_field_plot_small_matches_the_host_engine(card, tmp_path):
    """field_plot.m at 270 x 480 on the card: FIELD within 1e-12 of the
    host engine, imfilter and the colormap kernel on the card, no host
    fallback, the heat map bit for bit the plain colormap of the card's own
    Y, and every wait counted."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel, syncs
    from runmat_tpu_torch.ops import cmap
    from runmat_tpu_torch.plot import figure as figmod
    from runmat_tpu_torch.session import Session
    src = FIELD_SMALL + open("runmat_tpu_torch/workloads/field_plot.m").read()
    r = Session(accelerate=False, stdout=io.StringIO()).execute(src)
    assert r.error is None, r.error
    ref = float(re.search(r"FIELD=(\S+)", r.output).group(1))
    prev = accel.active_engine()
    before = cmap.launches
    by = cmap.launches_by["cmap f64"]
    try:
        s = runmat_tpu_torch.session("cuda")
        eng = accel.active_engine()
        r = s.execute(src)
        assert r.error is None, r.error
        got = float(re.search(r"FIELD=(\S+)", r.output).group(1))
        y = eng.materialize(s.get("Y").dev).cpu()
        img = figmod._FIGURES[int(s.get("f1").host()[0, 0])].ax.children[0]
        log = [e["ops"] for e in eng.launch_log if e["cat"] == "linalg"]
        fallbacks = eng.stats["host_fallbacks"]
        assert s.get("png_ok").host().all() and s.get("svg_ok").host().all()
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
        figmod.close_all()
    assert abs(got - ref) <= 1e-12 * abs(ref)
    assert ["imfilter"] in log and ["cmap"] in log and fallbacks == 0
    assert cmap.launches == before + 1
    assert cmap.launches_by["cmap f64"] == by + 1
    u8 = np.rint(img.data[::-1] * 255).astype(np.uint8)
    want, _ = cmap.plain_cmap(y, torch.from_numpy(cmap.table("parula")))
    assert np.array_equal(u8, want.numpy())
    r = syncs.script_syncs(src)
    assert r["warnings"] == r["counted"], r["sites"]


THERMAL = "runmat_tpu_torch/workloads/fea_thermal.m"


@pytest.mark.parametrize("R", [16, 32])
def test_fea_thermal_on_the_card_matches_the_cpu_engine(card, R, tmp_path,
                                                        monkeypatch):
    """fea_thermal.m at R = 16 and 32 (its STEP plate at edge length 0.35)
    on the card against TorchEngine("cpu"): T within spbench.X_TOL of the
    largest temperature, the device CG for the cube and the replay (its
    kernels launched as the chunks say), one histogram launch, the same
    counts, no host fallback, and every wait counted."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel, spbench, syncs
    from runmat_tpu_torch.ops import histogram, spcg
    monkeypatch.setenv("HOME", str(tmp_path))
    src = f"R = {R}; hs = 0.35;\n" + open(THERMAL).read()
    prev = accel.active_engine()
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            spcg.launches_by.clear()
            hist = collections.Counter(histogram.launches_by)
            s = runmat_tpu_torch.session(dev)
            eng = accel.active_engine()
            r = s.execute(src)
            assert r.error is None, r.error
            solves = [e for e in eng.launch_log if e["cat"] == "sparse_cg"]
            out[dev] = (np.array(s.get("T").host()), np.array(s.get("n").host()),
                        solves, dict(spcg.launches_by),
                        collections.Counter(histogram.launches_by) - hist,
                        dict(eng.stats), dict(eng.sync_reasons))
            runmat_tpu_torch.uninstall()
    finally:
        accel.set_engine(prev)
    (tc, nc, sc, _, _, _, _), (tg, ng, sg, lg, hg, st, why) = \
        out["cpu"], out["cuda"]
    assert [e["n"] for e in sg] == [e["n"] for e in sc] == \
        [(R + 1) ** 3 - 2 * (R + 1) ** 2, (R + 1) ** 3 - (R + 1) ** 2]
    chunks = sum(-(-e["iterations"] // spcg.CHUNK) for e in sg)
    assert lg["spmv_f64"] == lg["cg_direction"] == chunks * spcg.CHUNK
    assert lg["cg_update"] == chunks * spcg.CHUNK + len(sg)
    assert why["cg"] == chunks
    assert sum(hg.values()) == 1 and st["host_fallbacks"] == 0
    scale = float(np.abs(tc).max())
    assert float(np.abs(tg - tc).max()) <= spbench.X_TOL * scale
    assert np.array_equal(ng, nc) and ng.sum() == tg.size
    r = syncs.script_syncs(src)
    assert r["warnings"] == r["counted"], r["sites"]


def test_the_cli_on_the_card(card, tmp_path):
    """The port's CLI without --no-accel takes the card: accel-info names
    it, and a -e run computes on it."""
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, HOME=str(tmp_path))
    run = (lambda *a: subprocess.run(
        [sys.executable, "-m", "runmat_tpu_torch.cli", *a],
        capture_output=True, text=True, env=env, timeout=300))
    p = run("accel-info", "--json")
    assert p.returncode == 0, p.stderr
    info = json.loads(p.stdout)
    props = torch.cuda.get_device_properties(0)
    assert info["provider"]["platform"] == "gpu"
    assert info["card"]["name"] == torch.cuda.get_device_name(0)
    assert info["card"]["capability"] == f"{props.major}.{props.minor}"
    assert info["card"]["memory"] == props.total_memory
    p = run("-e", "x = gpuArray(1:10); fprintf('CARD_ok %g %d\\n', "
                  "gather(sum(x .^ 2)), isgpuarray(x));")
    assert p.returncode == 0, p.stderr
    assert "CARD_ok 385 1" in p.stdout


def test_the_spiller_under_a_small_budget_on_the_card(card):
    """A 4 MB budget: three 2.4 MB card arrays spill the coldest to the
    host, which read back equal and compute again on the card."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.accel.residency import make_workspace_spiller
    from runmat_tpu_torch.session import Session
    prev = accel.active_engine()
    try:
        eng = runmat_tpu_torch.install("cuda")
        eng.residency.budget_bytes = 4_000_000
        s = Session(accelerate=True, stdout=io.StringIO())
        eng.residency.pressure_hooks.append(make_workspace_spiller(s))
        s.run_source("rng(3); a = gpuArray(rand(300000, 1));"
                     " b = gpuArray(rand(300000, 1));"
                     " c = gpuArray(rand(300000, 1)); d = a + b + c;"
                     " t = gather(sum(d));", "t")
        import gc
        gc.collect()
        spilled = [n for n in "abcd" if not s.get(n).on_device]
        assert eng.residency.pressure_events >= 1 and spilled
        assert eng.residency.snapshot()["live_bytes"] <= 4_000_000
        host = Session(accelerate=False, stdout=io.StringIO())
        host.run_source("rng(3); a = rand(300000, 1); b = rand(300000, 1);"
                        " c = rand(300000, 1); d = a + b + c;", "t")
        for n in "abcd":
            assert np.array_equal(np.asarray(s.get(n).host()),
                                  np.asarray(host.get(n).host())), n
        s.run_source(f"u = gather(sum(gpuArray({spilled[0]}) * 2));", "t")
        want = 2 * np.asarray(host.get(spilled[0]).host()).sum()
        assert abs(float(s.get("u").host()[0, 0]) - want) <= 1e-9 * want
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)


def test_accel_calibrate_on_the_card(card, tmp_path, monkeypatch):
    """accel-calibrate writes the port's own file for this card, and a new
    engine on the card reads its threshold back."""
    import contextlib
    import json
    import runmat_tpu_torch
    from runmat_tpu_torch import accel, cli
    from runmat_tpu_torch.accel.engine import TorchEngine, calibration_path
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RUNMAT_TPU_OFFLOAD_THRESHOLD", raising=False)
    prev = accel.active_engine()
    try:
        runmat_tpu_torch.install("cuda")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["accel-calibrate"]) == 0
    finally:
        runmat_tpu_torch.uninstall()
        accel.set_engine(prev)
    cal = json.loads(open(calibration_path()).read())
    assert cal["platform"] == "gpu"
    assert cal["device"] == torch.cuda.get_device_name(0)
    assert TorchEngine("cuda").offload_threshold == cal["offload_threshold"]


@pytest.mark.parametrize("n", [3, 5, 24, 31, 32, 33, 64, 67, 128])
def test_eig_kernels_match_plain(card, n):
    """eig_hess, eig_francis and eig_trevc against their plain versions on
    the card, and the card's eigenvalues in the plain pipeline's order
    (`linalgbench.eig_held`); eig_francis with and without Z, at sizes
    about its 32-column band (31, 32, 33, 67) among them."""
    from runmat_tpu_torch import linalgbench
    r = linalgbench.eig_held(n, card)
    assert r["eig_francis"] == 0.0 and r["info"][0] == 1


@pytest.mark.parametrize("n", [3, 5, 17, 24, 64, 128, 627, 628])
def test_eig_hess_matches_plain_on_both_routes(card, n):
    """eig_hess with and without Q within HESS_TOL of plain_hessenberg (on
    the card up to 128, on the CPU at the route's boundary, 627 the last n
    of the resident cluster and 628 the first of the cooperative grid):
    blocks with few rows or none (3, 5, 17), and the eigenvalue sizes."""
    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import eig_qr
    assert eig_qr.hess_route(627) == "cluster"
    assert eig_qr.hess_route(628) == "grid"
    r = linalgbench.hess_held(n, card, None if n <= 128 else "cpu")
    assert r["route"] == eig_qr.hess_route(n)


@pytest.mark.parametrize("n", [5, 24, 64, 128])
def test_eig_hess_equals_its_order_model(card, n):
    """The resident eig_hess gives ordered_hessenberg's H and Q (the
    kernel's order of sums on the CPU) bit for bit."""
    from runmat_tpu_torch import linalgbench
    assert linalgbench.hess_held(n, card)["ordered_equal"]


def test_eig_hess_repeats_bit_for_bit(card):
    """20 launches of eig_hess with Q on one 128 matrix give one H and Q."""
    from runmat_tpu_torch import linalgbench
    assert linalgbench.hess_held(128, card, repeats=19)["repeats"] == 19


def test_eig_hess_earlier_design_matches_plain(card):
    """The bench-only cooperative design (the earlier kernel) still agrees
    with plain_hessenberg, at 64 and 512."""
    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import eig_qr
    for n in (64, 512):
        A = linalgbench.eig_matrix(n, card)
        H, Q = linalgbench.hess_grid(A, True)
        pH, pQ = eig_qr.plain_hessenberg(A.cpu(), True)
        s = float(torch.max(torch.abs(A)))
        assert float(torch.max(torch.abs(H.cpu() - pH))) <= \
            eig_qr.HESS_TOL * s
        assert float(torch.max(torch.abs(Q.cpu() - pQ))) <= eig_qr.HESS_TOL


@pytest.mark.parametrize("label", ["splits", "graded"])
def test_eig_francis_hand_offs_match_plain(card, label):
    """eig_francis equal to plain_francis, with and without Z, on a matrix
    that splits near both ends of the sweeps and on a graded one
    (`linalgbench.francis_cases`)."""
    from runmat_tpu_torch import linalgbench
    Hp, n = linalgbench.francis_cases(card)[label]
    linalgbench.francis_held(Hp, n, 40 * n + 100)


@pytest.mark.parametrize("label", ["band 31", "band 67", "128"])
def test_eig_francis_with_one_owner_warp_matches_plain(card, label):
    """eig_francis with its owners in one warp (2, 3, 5 indices a thread:
    the kernel's looped instantiation for n > 573, at small n) equal to
    plain_francis, with and without Z."""
    from runmat_tpu_torch import linalgbench
    if label == "128":
        Hp = torch.zeros((131, 131), dtype=torch.float64, device=card)
        Hp[:128, :128] = linalgbench.eig_hessenberg(128, card)
        n = 128
    else:
        Hp, n = linalgbench.francis_cases(card)[label]
    linalgbench.francis_held(Hp, n, 40 * n + 100,
                             linalgbench.CHAIN_ONE_OWNER_WARP)


def test_eig_francis_repeats_bit_for_bit(card):
    """20 launches of eig_francis with Z on one 128 H give one T, Z and
    info."""
    from runmat_tpu_torch import linalgbench
    Hp = torch.zeros((131, 131), dtype=torch.float64, device=card)
    Hp[:128, :128] = linalgbench.eig_hessenberg(128, card)
    assert linalgbench.francis_repeat(Hp, 128, 20)[0] == 1


@pytest.mark.parametrize("label", ["n1", "n2", "n3", "ends", "repeated",
                                   "graded"])
def test_eig_trevc_equals_its_order_model(card, label):
    """eig_trevc on `linalgbench.trevc_case`'s T (n = 1, 2, 3; 2x2 blocks
    at both ends; repeated eigenvalues, so the smin replacement fires in
    both forms; graded): one launch on the ring route, bit for bit
    ordered_trevc, within TREVC_TOL of plain_trevc, the earlier design
    too (`linalgbench.trevc_held`)."""
    from runmat_tpu_torch import linalgbench
    T = torch.tensor(linalgbench.trevc_case(label), dtype=torch.float64,
                     device=card)
    assert linalgbench.trevc_held(T)["route"] == "ring"


@pytest.mark.parametrize("n", list((5, 24, 64, 128, 512, 513)))
def test_eig_trevc_on_the_cards_schur_forms(card, n):
    """eig_trevc on the card's own Schur form of `eig_matrix(n)` on both
    sides of trevc_route's boundary: 512 the last n of the ring (bit for
    bit ordered_trevc), 513 the first of the warp design; each within
    TREVC_TOL of plain_trevc."""
    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.ops import eig_qr
    T = linalgbench.eig_kernels_run(n, card)["Tn"]
    r = linalgbench.trevc_held(T, plain_dev="cpu" if n >= 512 else None)
    assert r["route"] == eig_qr.trevc_route(n)
    assert eig_qr.trevc_route(512) == "ring"
    assert eig_qr.trevc_route(513) == "warp"


def test_eig_trevc_repeats_bit_for_bit(card):
    """20 launches of eig_trevc on one 128 T give one Y."""
    from runmat_tpu_torch import linalgbench
    T = linalgbench.eig_kernels_run(128, card)["Tn"]
    assert linalgbench.trevc_held(T, repeats=19)["repeats"] == 19


def test_eig_trevc_earlier_design_matches_plain(card):
    """The bench-only warp design (the first kernel) still agrees with
    plain_trevc, at 64 and 512; its chain-alone entry launches."""
    from runmat_tpu_torch import linalgbench
    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.ops import eig_qr
    for n in (64, 512):
        T = linalgbench.eig_kernels_run(n, card)["Tn"]
        q = EQ._quasi_eigs(T, n)
        Yr, Yi = linalgbench.trevc_bench(T, q, "warp")
        pYr, pYi = eig_qr.plain_trevc(T.cpu(), *(v.cpu() for v in q))
        s = max(1.0, float(pYr.abs().max()), float(pYi.abs().max()))
        assert float((Yr.cpu() - pYr).abs().max()) <= eig_qr.TREVC_TOL * s
        assert float((Yi.cpu() - pYi).abs().max()) <= eig_qr.TREVC_TOL * s
        linalgbench.trevc_bench(T, q, "chain")
        torch.cuda.synchronize()


def test_eig_kernels_refuse_what_they_do_not_take(card):
    from runmat_tpu_torch.errors import MatError
    from runmat_tpu_torch.ops import eig_qr
    a = torch.zeros((4, 4), dtype=torch.float32, device=card)
    with pytest.raises(MatError, match="eig_hess takes float64"):
        eig_qr.hessenberg(a, False)
    with pytest.raises(MatError, match="eig_francis of a"):
        eig_qr.francis(torch.zeros((5, 5), dtype=torch.float64,
                                   device=card), 4, 100, False)


def test_eig_on_the_card_launches_the_kernels(card):
    """w = eig(A) and [V, D] = eig(A) in a card session: eig_hess and
    eig_francis once for the values, all three for [V, D], no fallback,
    the eigenvalues in the order of the plain pipeline on the CPU."""
    import runmat_tpu_torch
    from runmat_tpu_torch import accel, ops
    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.ops import eig_qr
    s = runmat_tpu_torch.session("cuda")
    try:
        eng = accel.active_engine()
        ops.zero_launches()
        s.run_source("rng(4); A = gpuArray(randn(48, 48)); w = eig(A);"
                     " Ah = gather(A);", "t")
        assert dict(eig_qr.launches_by) == {"eig_hess": 1, "eig_francis": 1}
        ops.zero_launches()
        s.run_source("B = gpuArray(Ah); [V, D] = eig(B);"
                     " r = gather(norm(B*V - V*D) / norm(B));"
                     " d = gather(diag(D));", "t")
        assert dict(eig_qr.launches_by) == {"eig_hess": 1, "eig_francis": 1,
                                            "eig_trevc ring": 1}
        assert eng.stats["host_fallbacks"] == 0
    finally:
        runmat_tpu_torch.uninstall()
    A = torch.from_numpy(np.asarray(s.get("Ah").host()))
    wr, wi, ok = EQ.eig_values(A)
    want = (wr + 1j * wi).numpy()
    for name in ("w", "d"):
        got = np.asarray(s.get(name).host()).reshape(-1).astype(complex)
        assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))
    assert float(s.get("r").host().reshape(-1)[0]) < 1e-10
