"""The page functions of `linalg2` and the two repairs of the slice that
copied it, against the JAX package, on the same `.m` source through both
packages' device engines on the CPU (`tests/torch_both.py`).

* `pagemtimes` (its 'none'/'transpose'/'ctranspose' modes, one page set
  broadcast against many, pages over two trailing dims, complex pages),
  `pageinv`, `pagemldivide`, `pagenorm` (ord 1, 2, Inf, 'fro') and
  `pagectranspose` through the port's device builders (`accel/dense.py`)
  against the JAX builders (`runmat_tpu/accel/dense.py:407-520`);
* `pagefun(@mtimes, A, B)`, which failed in the port before `linalg2` was
  copied, equal to the JAX package's and on the device in both;
* `filter` of order 39 (40 coefficients), which a card refused before
  the sequential IIR kernel (here its plain version);
* `sprandsym`, which builds a sparse value the port does not carry yet,
  raising `RunMat:notPorted`;
* `resample_pages.m`, the slice's script, at a small size.

Tolerances: products, solves, inverses and norms within 1e-12 (double)
or 1e-5 (single) of the largest magnitude (XLA's and torch's CPU kernels
sum in other orders); transposes exactly; `resample_pages.m` within 1e-12
(sin and the draws' transform round apart by an ulp); shapes, classes,
dtypes and residency exactly.
"""

import numpy as np
import pytest

import runmat_tpu_torch
from torch_both import close, run_both, same

TOL = {"double": 1e-12, "single": 1e-5}


def _dev(b, names, tol):
    close(b, names, tol, device=True)
    assert b.td["host_fallbacks"] == 0 == b.jd["host_fallbacks"], b.td


def _pages(mclass: str, shape_a, shape_b=None, cplx=False) -> str:
    def arr(name, shape, f):
        n = int(np.prod(shape))
        dims = ", ".join(map(str, shape))
        v = f"reshape({f}(1:{n}) + 0.25, {dims})"
        if cplx:
            v = f"complex({v}, reshape(cos(1:{n}), {dims}))"
        return f"{name} = gpuArray({mclass}({v}));"
    src = arr("A", shape_a, "sin")
    if shape_b is not None:
        src += " " + arr("B", shape_b, "cos")
    return src


@pytest.mark.parametrize("ta,tb", [("none", "none"), ("transpose", "none"),
                                   ("none", "transpose"),
                                   ("ctranspose", "ctranspose")])
@pytest.mark.parametrize("mclass", ["double", "single"])
def test_pagemtimes_modes(mclass, ta, tb):
    b = run_both(_pages(mclass, (3, 3, 5), (3, 3, 5)),
                 f"C = pagemtimes(A, '{ta}', B, '{tb}');")
    _dev(b, ["C"], TOL[mclass])


@pytest.mark.parametrize("shapes", [((4, 3, 2, 3), (3, 2)),
                                    ((3, 2), (2, 4, 5)),
                                    ((2, 3, 6), (3, 4, 6))])
def test_pagemtimes_pages_and_broadcast(shapes):
    b = run_both(_pages("double", *shapes), "C = pagemtimes(A, B);")
    _dev(b, ["C"], TOL["double"])


def test_pagemtimes_of_complex_pages():
    b = run_both(_pages("double", (3, 3, 4), (3, 3, 4), cplx=True),
                 "C = pagemtimes(A, 'ctranspose', B, 'none');"
                 " T = pagectranspose(A); nf = pagenorm(A, 'fro');")
    _dev(b, ["C", "nf"], TOL["double"])
    same(b, ["T"])


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_pageinv_and_pagemldivide(mclass):
    # one page of A against the pages of B: A1 is a 2-D array
    setup = _pages(mclass, (4, 4, 3, 2), (4, 2, 3, 2)) + \
        f" A = A + 4 * eye(4); A1 = gpuArray({mclass}(magic(4) + 9 * eye(4)));"
    b = run_both(setup, "Ai = pageinv(A); X = pagemldivide(A, B);"
                        " X1 = pagemldivide(A1, B);")
    _dev(b, ["Ai", "X", "X1"], TOL[mclass])


def test_a_singular_page_gives_non_finite_values_without_an_error():
    b = run_both("A = gpuArray(cat(3, eye(3) * 2, zeros(3)));",
                 "Ai = pageinv(A);")
    assert b.jr.error is None and b.tr.error is None
    assert b.ts.get("Ai").on_device
    for s in (b.js, b.ts):
        h = np.asarray(s.get("Ai").host())
        assert np.array_equal(h[:, :, 0], np.eye(3) / 2)
        assert not np.isfinite(h[:, :, 1]).any()


@pytest.mark.parametrize("ordv", ["1", "2", "Inf", "'fro'"])
@pytest.mark.parametrize("mclass", ["double", "single"])
def test_pagenorm_orders(mclass, ordv):
    setup = _pages(mclass, (3, 4, 2, 3)) + \
        f" A1 = gpuArray({mclass}(magic(4)));"
    b = run_both(setup, f"n = pagenorm(A, {ordv}); m = pagenorm(A1, {ordv});")
    _dev(b, ["n", "m"], TOL[mclass])


def test_pagectranspose_of_real_pages():
    b = run_both(_pages("single", (2, 3, 2, 2)), "T = pagectranspose(A);")
    assert b.ts.get("T").on_device
    same(b, ["T"])


def test_pagefun_mtimes_is_the_batched_product():
    # the port's copy of gpu.py:pagefun calls pagemtimes by name, which
    # only linalg2 registers
    b = run_both(_pages("double", (3, 2, 4), (2, 5, 4)),
                 "D = pagefun(@mtimes, A, B); C = pagemtimes(A, B);")
    _dev(b, ["D"], TOL["double"])
    assert np.array_equal(np.asarray(b.ts.get("D").host()),
                          np.asarray(b.ts.get("C").host()))


def test_filter_of_order_39_matches_the_jax_scan():
    # the card takes csrc/iir_warp.cu here (tests/test_torch_cuda.py); on
    # the CPU every route is the plain version
    b = run_both("rng(1); x = gpuArray(randn(3000, 1));",
                 "w = filter(ones(1, 40) / 40, [1 0.01*ones(1, 39)], x);")
    _dev(b, ["w"], 1e-13)


def test_sprandsym_matches_the_jax_package():
    # a seeded sprandsym(5, 0.3) and its symmetric refill sprandsym(S)
    b = run_both("rng(11);", "S = sprandsym(5, 0.3); T = sprandsym(S);"
                 " F = full(S); G = full(T); after = rand;")
    same(b, ["F", "G", "after"])
    for name in ("S", "T"):
        got, want = b.ts.get(name), b.js.get(name)
        assert type(got).__name__ == type(want).__name__ == "SparseMatrix"
        for attr in ("indptr", "rowind", "data"):
            assert np.array_equal(getattr(got, attr), getattr(want, attr))


def test_resample_pages_script_matches_the_jax_package():
    src = open("runmat_tpu_torch/workloads/resample_pages.m").read()
    b = run_both("N = 4096; P = 64;", src)
    assert b.jr.output == b.tr.output, (b.jr.output, b.tr.output)
    close(b, ["y", "top", "low", "w", "C", "D", "E", "X", "Ai", "nC"], 1e-12)
    assert b.td["host_fallbacks"] == 0 == b.jd["host_fallbacks"]
    kinds = [e["ops"][0] for e in b.teng.launch_log if e["cat"] == "linalg"]
    assert kinds == ["interp1lin", "topk", "topk", "iir", "pagemtimes",
                     "pagemtimes", "pagemtimes", "pagesolve", "pageinv",
                     "pagenorm"]
