"""The port's histogram (`runmat_tpu_torch/ops/histogram.py`) on the CPU: its
plain PyTorch versions against the Pallas kernels of
`runmat_tpu/ops/pallas/histogram.py` run in interpret mode, as
tests/test_pallas.py runs them, and both against the MATLAB oracle of that
file. Counts are integers: every comparison is exact. Inputs come from a
numpy seed and hold NaN, +-Inf and exact hits on e_0, an interior edge and
e_B. The CUDA kernel itself is held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from runmat_tpu.ops.pallas.histogram import (affine_edge_params,
                                             histcounts_pallas,
                                             histcounts_pallas_affine)
from runmat_tpu_torch.ops import histogram
from test_pallas import _matlab_hist_oracle


def _data(n, edges, seed, dtype=np.float32):
    """n values spread 15% beyond the edges, with the special values."""
    rng = np.random.default_rng(seed)
    lo, hi = float(edges[0]), float(edges[-1])
    span = hi - lo
    x = rng.random(n) * span * 1.3 + lo - 0.15 * span
    special = [np.nan, edges[0], edges[-1], edges[len(edges) // 2],
               np.inf, -np.inf, np.nan]
    k = min(n, len(special))
    x[rng.permutation(n)[:k]] = special[:k]
    return x.astype(dtype)


def _edges(nb, seed, repeat=False, dtype=np.float32):
    rng = np.random.default_rng(1000 + seed)
    e = np.sort(rng.uniform(-1.0, 1.0, nb + 1))
    if repeat and nb >= 2:
        e[nb // 2] = e[nb // 2 + 1]
    return e.astype(dtype)


def _oracle(x, e):
    return _matlab_hist_oracle(x.astype(np.float64), e.astype(np.float64))


def _plain(x, e):
    return histogram.plain_histcounts(torch.from_numpy(x),
                                      torch.from_numpy(e)).numpy()


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 10, 64, 128, 256])
@pytest.mark.parametrize("n", [1, 17, 1000, 4097, 5000])
def test_plain_matches_pallas_search(n, nb):
    e = _edges(nb, n + nb, repeat=nb % 2 == 1)
    x = _data(n, e, n * nb)
    want = np.asarray(histcounts_pallas(n, nb, interpret=True)(x, e))
    got = _plain(x, e)
    assert got.dtype == np.int64 and got.shape == (nb,)
    assert np.array_equal(got, want)


AFFINE = [(1, 0, 0), (2, 3, -1), (3, -1, 2), (4, 2, -3), (5, 0, 7),
          (6, -2, 0), (7, 4, 5), (8, 1, -8), (64, 6, 0), (16, -1, -4),
          (100, 3, 8), (256, 8, -128)]


@pytest.mark.parametrize("nb,k,m", AFFINE)
def test_plain_affine_matches_pallas_affine(nb, k, m):
    e = ((m + np.arange(nb + 1)) * 2.0 ** -k).astype(np.float32)
    assert affine_edge_params(e) == (k, m)
    n = 3000
    x = _data(n, e, nb + k)
    fn = histcounts_pallas_affine(n, nb, k, m, interpret=True, blk_e=256)
    want = np.asarray(fn(x))
    got = histogram.plain_histcounts_affine(torch.from_numpy(x), nb, k,
                                            m).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    # the same counts through the search over the same edges
    assert np.array_equal(_plain(x, e), want)


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5, 6, 7])
def test_small_bin_counts_match_the_matlab_oracle(nb):
    # affine edges with B < 8, both index forms and the Pallas kernels
    k, m = 2, nb - 4
    e = ((m + np.arange(nb + 1)) * 2.0 ** -k).astype(np.float32)
    x = _data(401, e, nb)
    want = _oracle(x, e)
    direct = histogram.histcounts(torch.from_numpy(x), torch.from_numpy(e),
                                  affine=(k, m)).numpy()
    assert np.array_equal(direct, want)
    assert np.array_equal(_plain(x, e), want)
    pallas = histcounts_pallas_affine(x.size, nb, k, m, interpret=True,
                                      blk_e=256)
    assert np.array_equal(np.asarray(pallas(x)), want)
    assert np.array_equal(
        np.asarray(histcounts_pallas(x.size, nb, interpret=True)(x, e)), want)


@pytest.mark.parametrize("nb,k,m", [(3, -2, -3), (8, -2, -3), (64, 5, -32),
                                    (2, 1, -1), (4, -40, -2)])
def test_affine_index_is_exact_beside_a_zero_edge(nb, k, m):
    # edges with m < 0 pass through 0; the neighbours of every edge, the
    # smallest subnormals and -0 land as the search puts them. (The Pallas
    # kernel's y = x*2^k - m rounds x = -2^-30 onto the zero edge.)
    e = ((m + np.arange(nb + 1)) * 2.0 ** -k).astype(np.float32)
    tiny = np.finfo(np.float32).smallest_subnormal
    x = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                        np.nextafter(e, np.float32(-np.inf)),
                        np.array([tiny, -tiny, 3 * tiny, -0.0, 2.0 ** -30,
                                  -2.0 ** -30, np.nan], np.float32)])
    x = x.astype(np.float32)
    want = _oracle(x, e)
    got = histogram.histcounts(torch.from_numpy(x), torch.from_numpy(e),
                               affine=(k, m)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(_plain(x, e), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nb", [1, 2, 5, 9])
def test_repeated_and_infinite_edges_match_the_oracle(nb, dtype):
    e = _edges(nb, nb, repeat=True, dtype=dtype)
    for ends in ((e[0], e[-1]), (-np.inf, e[-1]), (e[0], np.inf)):
        ee = e.copy()
        ee[0], ee[-1] = ends
        x = _data(777, e, nb, dtype)
        got = histogram.histcounts(torch.from_numpy(x),
                                   torch.from_numpy(ee)).numpy()
        assert np.array_equal(got, _oracle(x, ee)), ends


def test_float64_resolves_what_float32_cannot():
    # 1 + 2^-30 and 1 are one f32 value but two f64 values
    e = np.array([0.0, 1.0, 1.0 + 2.0 ** -30, 2.0])
    x = np.array([1.0, 1.0 + 2.0 ** -31, 1.0 + 2.0 ** -30, 2.0, np.nan])
    got = histogram.histcounts(torch.from_numpy(x),
                               torch.from_numpy(e)).numpy()
    assert got.tolist() == [0, 2, 2] == _oracle(x, e).tolist()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(10)
    for bad in (dict(edges=torch.zeros(1)),
                dict(edges=torch.zeros(3, dtype=torch.float64)),
                dict(edges=torch.zeros(3, dtype=torch.float64),
                     x=torch.zeros(10, dtype=torch.float64), affine=(1, 0)),
                dict(edges=torch.zeros(3), affine=(200, 0)),
                dict(edges=torch.zeros(3, device="meta"))):
        args = dict(x=x) | bad
        with pytest.raises(ValueError):
            histogram.histcounts(args["x"], args["edges"],
                                 affine=args.get("affine"))


@pytest.mark.parametrize("nb", [257, 4096, 1 << 16])
@pytest.mark.parametrize("n", [1 << 31, (1 << 32) + 5])
def test_wrapper_takes_any_bin_count_and_size(n, nb):
    # no bound on bins or values: 2^31 and more values, more than the
    # Pallas kernels' 256 bins. On meta tensors the checks pass and only
    # the device, which has no kernel, is refused.
    x = torch.empty(n, device="meta")
    e = torch.empty(nb + 1, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        histogram.histcounts(x, e)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        histogram.histcounts(x, e, affine=(3, -7))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nb", [257, 1000, 4096])
def test_many_bins_match_the_oracle(nb, dtype):
    # more bins than the Pallas kernels take: the port has one definition
    # for every bin count, in search and direct form
    e = _edges(nb, nb, repeat=True, dtype=dtype)
    x = _data(3001, e, nb, dtype)
    got = histogram.histcounts(torch.from_numpy(x), torch.from_numpy(e))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _oracle(x, e))
    k, m = 8, -(nb // 2)
    ea = ((m + np.arange(nb + 1)) * 2.0 ** -k).astype(np.float32)
    assert affine_edge_params(ea) == (k, m)
    xa = _data(3001, ea, nb + 1)
    direct = histogram.histcounts(torch.from_numpy(xa), torch.from_numpy(ea),
                                  affine=(k, m))
    assert np.array_equal(direct.numpy(), _oracle(xa, ea))


def test_cpu_calls_take_the_plain_version_without_a_launch():
    before = histogram.launches
    e = torch.linspace(0, 1, 9)
    histogram.histcounts(torch.rand(100), e)
    histogram.histcounts(torch.rand(100), e, affine=(3, 0))
    assert histogram.launches == before


@pytest.mark.parametrize("edges", [
    np.arange(129) / 128, (np.arange(-8, 9) * 0.25), np.arange(-40, 41) / 10,
    np.array([0.0, 1.0]), np.array([0.0, 1.0, 3.0]), np.linspace(-1, 1, 65),
    np.array([1.0, 1.0]), np.array([-np.inf, 0.0, 1.0])])
def test_affine_edge_params_is_the_jax_packages(edges):
    # the port's copy decides the direct index for the same edges
    e = np.asarray(edges, np.float32)
    assert histogram.affine_edge_params(e) == affine_edge_params(e)


# --- the kernel's guide table, modelled on the CPU ------------------------- #
# csrc/histogram.cu finds j(v) = #(e_k <= v) inside a bracket
# [T(c), T(c+1)] of a table over G cells, cell(v) = clamp(floor(v*inv + off),
# 0, G-1), T(c) = #(k : cell(e_k) < c), and settles j with exact compares.
# The model below builds the same table (in f64, rounding v*inv + off once
# more than the kernel's fma; any monotone cell() gives the same argument)
# and holds the bracket to the true j at the design's edges.

def _by_definition(x, e):
    """The cumulative-count definition, vectorised: ge_k = #(x >= e_k),
    counts = ge[:-1] - ge[1:], the last bin ge[B-1] - #(x > e_B)."""
    xs = np.sort(x[~np.isnan(x)].astype(np.float64))
    e64 = e.astype(np.float64)
    ge = xs.size - np.searchsorted(xs, e64, side="left")
    counts = ge[:-1] - ge[1:]
    counts[-1] = ge[-2] - (xs.size - np.searchsorted(xs, e64[-1],
                                                     side="right"))
    return counts


def _cell(v, inv, off, cells):
    t = np.asarray(v, np.float64) * inv + off
    return np.clip(np.floor(np.clip(t, 0, cells - 1)), 0, cells - 1).astype(
        np.int64)


def _filled_table(e64, inv, off, cells):
    """T(0..cells) as the kernel's prologue fills it: the thread of edge k
    writes k into the cells (cell(e_{k-1}), cell(e_k)], with cell(e_{-1}) =
    -1 and cell(e_{B+1}) = cells."""
    t = np.full(cells + 1, -1)
    nb = e64.size - 1
    for k in range(nb + 2):
        first = 0 if k == 0 else int(_cell(e64[k - 1], inv, off, cells)) + 1
        last = cells if k == nb + 1 else int(_cell(e64[k], inv, off, cells))
        assert np.all(t[first:last + 1] == -1), "a cell written twice"
        t[first:last + 1] = k
    assert np.all(t >= 0), "a cell left unwritten"
    return t


def _guide_bins(x, e, cells):
    x64, e64 = x.astype(np.float64), e.astype(np.float64)
    inv = cells / (e64[-1] - e64[0])
    off = -e64[0] * inv
    table = np.searchsorted(_cell(e64, inv, off, cells),
                            np.arange(cells + 1), side="left")
    assert np.array_equal(_filled_table(e64, inv, off, cells), table)
    inside = (x64 >= e64[0]) & (x64 <= e64[-1])
    c = _cell(x64[inside], inv, off, cells)
    lo, hi = table[c], table[c + 1]
    j = np.searchsorted(e64, x64[inside], side="right")
    assert np.all((lo <= j) & (j <= hi)), "bracket misses j"
    b = np.minimum(j, e.size - 1) - 1
    return np.bincount(b, minlength=e.size - 1), hi - lo


def _design_edges(kind, nb, dtype, rng):
    e = np.sort(rng.uniform(-2.0, 2.0, nb + 1))
    if kind == "clustered" and nb >= 2:
        k = nb // 2 + 1
        e = np.sort(np.concatenate([0.1 + rng.uniform(0, 1e-5, k),
                                    rng.uniform(-2.0, 2.0, nb + 1 - k)]))
    if kind == "repeated" and nb >= 2:
        e[1:nb // 2 + 1] = e[1]
    return e.astype(dtype)


def _design_values(e, cells, dtype, rng):
    bounds = (e[0] + (e[-1] - e[0]) * np.arange(cells + 1) / cells).astype(
        dtype)
    near = np.concatenate([e, bounds])
    tiny = np.finfo(dtype).smallest_subnormal
    return np.concatenate([
        near, np.nextafter(near, dtype(np.inf)),
        np.nextafter(near, dtype(-np.inf)),
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, tiny, -tiny], dtype),
        rng.uniform(e[0] - 0.5, e[-1] + 0.5, 4096).astype(dtype)]).astype(
            dtype)


@pytest.mark.parametrize("kind", ["random", "clustered", "repeated"])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5, 6, 7, 8, 80, 1000, 4096,
                                30000, 65536])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_guide_table_brackets_hold_the_bin(dtype, nb, kind):
    rng = np.random.default_rng(nb + 7)
    e = _design_edges(kind, nb, dtype, rng)
    for cells in (64, 1024, 4096):
        x = _design_values(e, cells, dtype, rng)
        counts, widths = _guide_bins(x, e, cells)
        assert np.array_equal(counts, _by_definition(x, e))
        if kind == "random" and cells >= 8 * nb:
            # the common case: most brackets hold no edge or one
            assert np.mean(widths <= 1) > 0.9


@pytest.mark.parametrize("kind", ["clustered", "repeated"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nb", [1, 3, 8, 80, 1000])
def test_plain_matches_the_oracle_at_the_design_edges(nb, dtype, kind):
    rng = np.random.default_rng(nb)
    e = _design_edges(kind, nb, dtype, rng)
    x = _design_values(e, 1024, dtype, rng)
    got = histogram.histcounts(torch.from_numpy(x), torch.from_numpy(e))
    assert np.array_equal(got.numpy(), _by_definition(x, e))
