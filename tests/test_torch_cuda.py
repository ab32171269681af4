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
float64 1e-12, sums and means 1e-5 / 1e-12 of their largest magnitude).
"""

import io
import re

import numpy as np
import pytest
import torch

from runmat_tpu_torch import fusebench

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
        before = fused.launches_by["fused_map_f32"]
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
    assert graph.kernels == {"fused_map_f32": 1}
    # two warm runs of 16 replayed steps, plus the payoff's setup kernels
    assert fused.launches_by["fused_map_f32"] - before >= 2 * 16
