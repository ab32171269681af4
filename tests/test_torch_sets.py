"""Sort, unique, the set operations, ismember, median, mode and accumarray
of the port against the JAX package, on the same `.m` source
(`tests/torch_both.py`) and, for random vectors, engine against engine.

The cases mirror `tests/test_device_dag.py` (59-99) and
`tests/test_device_search.py` (30-40, 134-240). Values and indices are
equal exactly (median in f64 and f32 alike: both take (a + b) * 0.5 of the
two middle values), and so are class, shape, dtype and residency: each
result the JAX package keeps on its device stays on the port's, and a
class the device route does not take (a logical sort) goes to the host in
both, counted in the port's `host_fallbacks`. The only values read back are
the lengths of data-dependent results and accumarray's largest subscript
(`syncs`).
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.values import MatArray as JaxMatArray
from runmat_tpu_torch.accel.engine import TorchEngine
from runmat_tpu_torch.values import MatArray as PortMatArray
from torch_both import OFFLOAD, run_both, same

SPECIAL = "[0 -0 1 NaN -NaN -Inf 0 -0 Inf 1 NaN 2]"


def _dev(b, names):
    for n in names:
        assert b.ts.get(n).on_device, n
    same(b, names)
    assert b.td["host_fallbacks"] == 0, b.td
    assert b.td["gather_bytes"] <= 8 * b.td["gathers"], b.td


# ------------------------------------------------------------------- sort

@pytest.mark.parametrize("mclass", ["double", "single"])
def test_sort_matches(mclass):
    b = run_both(f"A = gpuArray({mclass}([3 1 2 1; NaN 5 5 0; 2 2 -1 NaN]));",
                 "s1 = sort(A); s2 = sort(A, 2); s3 = sort(A, 'descend');"
                 " [v, i] = sort(A, 2, 'descend'); [w, j] = sort(A);")
    _dev(b, ["s1", "s2", "s3", "v", "i", "w", "j"])


def test_sort_indices_and_orientation():
    b = run_both("r = gpuArray([3 1 2]); c = gpuArray([3; 1; 2]);",
                 "[v, i] = sort(r); [u, k] = sort(c, 'descend');")
    _dev(b, ["v", "i", "u", "k"])
    assert np.array_equal(b.ts.get("i").host(), [[2, 3, 1]])


@pytest.mark.parametrize("direction", ["ascend", "descend"])
def test_sort_nan_signed_zero_and_stable_ties(direction):
    # NaN (either sign) last ascending and first descending, +-0 and equal
    # values keep their order: the indices show it
    b = run_both(f"x = gpuArray({SPECIAL});",
                 f"[v, i] = sort(x, '{direction}');"
                 f" [w, j] = sort(single(x), '{direction}');")
    _dev(b, ["v", "i", "w", "j"])
    v = b.ts.get("v").host().ravel()
    nan = np.isnan(v)
    assert nan[-2:].all() if direction == "ascend" else nan[:2].all()


def test_sort_of_a_logical_array_takes_the_host_path_counted():
    b = run_both("x = gpuArray([1 0 3]) > 0;", "s = sort(x);")
    same(b, ["s"])
    assert b.td["host_fallbacks"] == 1


# ----------------------------------------------------------------- median

@pytest.mark.parametrize("mclass", ["double", "single"])
def test_median_matches(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape([7 1 5 3 9 2 8 4 6 10 12 11"
                 " 0.5 -2 3 3 1 1 2 2], 4, 5)));",
                 "m = median(A); m2 = median(A, 2); ma = median(A, 'all');"
                 " n = nnz(A > 7); mv = median(A(:, 2));")
    _dev(b, ["m", "m2", "ma", "n", "mv"])


@pytest.mark.parametrize("nan_mode", ["", ", 'omitnan'", ", 'includenan'"])
def test_median_nan_modes(nan_mode):
    b = run_both("x = gpuArray([1 NaN 3 10]); A = gpuArray([1 NaN; NaN NaN;"
                 " 4 NaN; 2 NaN]);",
                 f"m = median(x{nan_mode}); c = median(A{nan_mode});"
                 f" r = median(A, 2{nan_mode});")
    _dev(b, ["m", "c", "r"])


def test_median_is_the_mean_of_the_two_middle_values():
    # torch.median would give 2 (the lower middle value)
    b = run_both("x = gpuArray([4 1 3 2]);", "m = median(x);")
    _dev(b, ["m"])
    assert b.ts.get("m").host().item() == 2.5


# ---------------------------------------------------------- unique, sets

def test_unique_sorted_and_stable():
    b = run_both("A = gpuArray([3 1 2 3 1 5]);",
                 "u = unique(A); us = unique(A, 'stable');"
                 " [v, ia, ic] = unique(A, 'stable');")
    _dev(b, ["u", "us", "v", "ia", "ic"])
    assert np.array_equal(b.ts.get("us").host(), [[3, 1, 2, 5]])


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_unique_three_outputs(mclass):
    b = run_both(f"A = gpuArray({mclass}([4 2 4 9 2])); M = gpuArray("
                 f"{mclass}([3 1; 1 NaN; 3 NaN]));",
                 "[u, ia, ic] = unique(A); [m, ja, jc] = unique(M);")
    _dev(b, ["u", "ia", "ic", "m", "ja", "jc"])
    A = np.array([4, 2, 4, 9, 2.0])
    u, ia, ic = (b.ts.get(n).host().ravel() for n in ("u", "ia", "ic"))
    assert np.array_equal(A[ia.astype(int) - 1], u)
    assert np.array_equal(u[ic.astype(int) - 1], A)


def test_unique_each_nan_distinct_and_signed_zero():
    b = run_both(f"A = gpuArray([1 NaN 2 NaN 1]); Z = gpuArray({SPECIAL});",
                 "u = unique(A); [z, za, zc] = unique(Z);"
                 " [s, sa, sc] = unique(Z, 'stable');")
    _dev(b, ["u", "z", "za", "zc", "s", "sa", "sc"])
    assert np.isnan(b.ts.get("u").host().ravel()[-2:]).all()


def test_unique_orientation():
    b = run_both("r = gpuArray([3 1 2]); c = gpuArray([3; 1; 2]);"
                 " M = gpuArray([3 1; 2 2]);",
                 "ur = unique(r); uc = unique(c); um = unique(M);")
    _dev(b, ["ur", "uc", "um"])
    assert b.ts.get("ur").shape == (1, 3) and b.ts.get("uc").shape == (3, 1)


def test_unique_reads_back_only_its_count():
    b = run_both("A = gpuArray(rand(1, 50000));",
                 "u = unique(A); ok = existsOnGPU(u);")
    assert b.ts.get("u").on_device
    assert b.td["gather_bytes"] <= 8 and b.td["syncs"] == 1
    assert b.td["sync_bytes"] == 8


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_set_operations(mclass):
    b = run_both(f"A = gpuArray({mclass}([5 1 3 3 7 NaN])); B = gpuArray("
                 f"{mclass}([3 8 5 NaN])); C = gpuArray([5; 1; 3]);",
                 "d = setdiff(A, B); u = union(A, B); i = intersect(A, B);"
                 " x = setxor(A, B); dc = setdiff(C, [1 2]);"
                 " uc = union(C, 9); ic = intersect(C, A);")
    _dev(b, ["d", "u", "i", "x", "dc", "uc", "ic"])


def test_set_operations_mixed_classes_and_host_operand():
    b = run_both("A = gpuArray(single([5 1 3])); h = [3 4 5];",
                 "u = union(A, h); d = setdiff(h, A); i = intersect(A, [1 1]);")
    _dev(b, ["u", "d", "i"])
    assert b.ts.get("u").mclass == "double"


def test_setxor_keeps_nan():
    b = run_both("A = gpuArray([NaN 1 2]); B = gpuArray([2 3]);",
                 "x = setxor(A, B); y = setxor(gpuArray(NaN), gpuArray(NaN));")
    _dev(b, ["x", "y"])
    x = b.ts.get("x").host().ravel()
    assert np.array_equal(x[:2], [1, 3]) and np.isnan(x[2])


def test_ismember():
    b = run_both("a = gpuArray([1 5 2 NaN 3; 0 -0 7 2 2]);"
                 " b = gpuArray([2 3 NaN 0]);",
                 "tf = ismember(a, b); t2 = ismember(a, [7 9]);"
                 " t3 = ismember(single(a), b);")
    _dev(b, ["tf", "t2", "t3"])


# ----------------------------------------------------- mode, accumarray

def test_mode_nan_and_tie_rules():
    b = run_both("", "a = mode(gpuArray([3 NaN 3 1 1]));"
                     " b = mode(gpuArray([2 1 2 1])); c = mode(gpuArray("
                     "[NaN NaN])); d = mode(gpuArray(single([2 7 2 9 2 7])'));"
                     " e = mode(gpuArray([-0 0 5 5 1]));")
    _dev(b, ["a", "b", "c", "d", "e"])
    assert b.ts.get("a").host().item() == 1.0
    assert np.isnan(b.ts.get("c").host().item())


def test_accumarray():
    b = run_both("subs = [1; 3; 1; 2]; vals = gpuArray([10 20 30 40]');"
                 " ds = gpuArray([2; 2; 5]); one = gpuArray(single([1; 1; 1]));",
                 "r = accumarray(subs, vals); rs = accumarray(subs, vals, 5);"
                 " rd = accumarray(ds, one, [6 1]); rc = accumarray(subs, 2);")
    for n in ("r", "rs", "rd"):
        assert b.ts.get(n).on_device, n
    same(b, ["r", "rs", "rd", "rc"])


# ------------------------------------------- random vectors, engine level

@pytest.fixture(scope="module")
def engines():
    return JaxEngine(platform="cpu", **OFFLOAD), TorchEngine("cpu", **OFFLOAD)


def _host(out):
    return [np.asarray(o.host()) for o in out]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w, equal_nan=True)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from([0.0, -0.0, 1.0, -1.5, 2.0, 2.0, np.nan,
                                 np.inf, -np.inf, 3.25]),
                min_size=1, max_size=40),
       st.booleans(), st.booleans(), st.booleans())
def test_random_vectors_with_nan_and_repeats(engines, vals, single, row,
                                             stable):
    x = np.array(vals, np.float32 if single else np.float64)
    x = x.reshape(1, -1) if row else x.reshape(-1, 1)
    mclass = "single" if single else "double"
    half = x.reshape(-1)[: max(1, x.size // 2)].reshape(1, -1)
    outs = []
    for eng, M in zip(engines, (JaxMatArray, PortMatArray)):
        d = eng.upload(M(x.copy(), mclass))
        h = eng.upload(M(half.copy(), mclass))
        ax = 1 if row else 0
        res = {"asc": eng.sort(d, ax, False, True),
               "desc": eng.sort(d, ax, True, True),
               "unique": eng.unique(d, stable, True)}
        for op in ("union", "intersect", "setdiff", "setxor"):
            res[op] = eng.setop(op, d, h)
        res["mode"] = eng.linalg("mode", [d], (), out_class=mclass)
        res["ismember"] = eng.linalg("ismember", [d, h],
                                     out_class="logical")
        outs.append({k: _host(v) for k, v in res.items()})
    want, got = outs
    for k in want:
        _equal(got[k], want[k])
