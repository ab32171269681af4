"""interp1's and maxk/mink's device builders, the session's random stream
in the copied distribution builtins, and tasks on host threads, against
the JAX package on the CPU.

* `interp1lin` (`accel/dense.py`) against the JAX builder
  (`runmat_tpu/accel/dense.py:730-751`) through `tests/torch_both.py`: a
  query on the first and the last knot, outside the knots, NaN and +-Inf
  queries, duplicate knots (0/0 gives NaN), NaN knots (the JAX builder's
  broadcast count leaves them out; the port's binary search over the
  knots sorted counts the same), single operands, a matrix of queries;
* `topk` (maxk/mink of a vector) against the JAX builder
  (`dense.py:1019-1032`, lax.top_k): NaN against -Inf in maxk and against
  +Inf in mink, -0 against +0 (lax.top_k orders -0 below +0), k of 0 and
  beyond numel, a row vector's row result, single values;
* `normrnd`/`unifrnd`/`exprnd` (breadth3) and `unidrnd`/`randsample`/
  `trnd` (stats2) after `rng(seed)`: values and the stream's counter
  bit for bit in both packages' host sessions;
* `parfeval` on a device array while the main thread computes (the
  engine's calls serialised under its lock), equal to the JAX package's.

Tolerances: the selections and the stream exactly (a selection is a
permutation); interp1 within 1e-15 (double) or 1e-6 (single) of the
largest magnitude (at least 1), with NaNs in the same places: the port's
lerp keeps the JAX builder's order of operations, but XLA on the CPU
contracts its multiply and add into an FMA; the parfeval sums within 1e-12
of the largest magnitude; classes, shapes, dtypes and residency exactly.
"""

import numpy as np
import pytest

from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch.session import Session as PortSession
from torch_both import close, run_both, same


def _exact_device(b, names):
    for n in names:
        assert b.ts.get(n).on_device, n
    same(b, names)
    for n in names:
        w, g = (np.asarray(s.get(n).host()) for s in (b.js, b.ts))
        # -0 and +0 apart
        assert np.array_equal(np.signbit(g), np.signbit(w)), n
    assert b.td["host_fallbacks"] == 0 == b.jd["host_fallbacks"], b.td


# XLA on the CPU contracts the lerp's multiply and add into an FMA, which
# the port's builder (and the JAX builder on other backends) rounds apart
LERP_TOL = 1e-15


INTERP = {
    "knots-and-outside": ("x = gpuArray(0:4); v = gpuArray([1 4 9 16 25]);",
                          "q = gpuArray([4 0 2.5 -1 5 NaN Inf -Inf 3.75]);"),
    "duplicate-knots": ("x = gpuArray([0 1 1 2 3]); v = gpuArray([1 2 3 4 "
                        "5]);", "q = gpuArray([1 0.5 1.5 2 3]);"),
    "nan-knots": ("x = gpuArray([0 NaN 2 3 NaN]); v = gpuArray([1 2 3 4 5]);",
                  "q = gpuArray([0.5 2.5 Inf 3 NaN 0 -Inf]);"),
    "inf-knot": ("x = gpuArray([0 1 Inf]); v = gpuArray([1 2 3]);",
                 "q = gpuArray([0.5 Inf 2]);"),
    "single-knots": ("x = gpuArray(single([0 1 2 4])); v = gpuArray([1 2 4 "
                     "3]);", "q = gpuArray([0.25 1.75 3 4]);"),
    "single-values": ("x = gpuArray([0 1 2 4]); v = gpuArray(single([1 2 4 "
                      "3]));", "q = gpuArray(single([0.1 3.9 4.5]));"),
    "matrix-queries": ("x = gpuArray([-1 -0.75 -0.5 -0.25 0 0.25 0.5 0.75 "
                       "1]); v = gpuArray([0.3 -0.2 0.9 0.1 -0.6 0.4 0.8 "
                       "-0.1 0.5]);", "q = gpuArray(reshape([-1.2 -0.7 "
                                      "-0.35 0 0.1 0.45 0.8 1 1.2 -0.95 0.6 "
                                      "0.25], 3, 4));"),
    "column-knots": ("x = gpuArray((0:0.5:3)'); v = gpuArray((1:7)' .^ 2);",
                     "q = gpuArray([0.2; 2.9; 3]);"),
    # v shorter than x: XLA clamps the JAX builder's gather into v
    "magic-knots-short-values": ("x = gpuArray(magic(4)); v = gpuArray(1:5);",
                                 "q = gpuArray(1:5);"),
    "short-values-past-the-end": ("x = gpuArray(0:4); v = gpuArray([1 4 9]);",
                                  "q = gpuArray([0.5 1.5 2.5 3.5 4]);"),
    "short-values-inside": ("x = gpuArray([1 2 3 4]); v = gpuArray([10 20 "
                            "30]);", "q = gpuArray(2.5);"),
}


@pytest.mark.parametrize("case", INTERP, ids=list(INTERP))
def test_interp1lin_matches_the_jax_builder(case):
    setup, qs = INTERP[case]
    b = run_both(setup + " " + qs, "y = interp1(x, v, q);")
    assert b.ts.get("y").on_device
    close(b, ["y"], 1e-6 if "single" in case else LERP_TOL)
    assert b.td["host_fallbacks"] == 0 == b.jd["host_fallbacks"], b.td
    assert [e["ops"][0] for e in b.teng.launch_log
            if e["cat"] == "linalg"] == ["interp1lin"]


TOPK = {
    "nan-and-minus-inf": "v = gpuArray([-Inf NaN 3 -Inf NaN -Inf]);",
    "nan-and-plus-inf": "v = gpuArray([Inf NaN -3 Inf NaN Inf]);",
    "signed-zeros": "v = gpuArray([0 -0 0 -0 1 -1 -0]);",
    "ties": "v = gpuArray([2 5 2 5 2 1]);",
    "single": "v = gpuArray(single([0.5 -2 NaN 7 -0 3]));",
    "column": "v = gpuArray(sin(1:40)');",
}


@pytest.mark.parametrize("k", [0, 1, 3, 6, 50])
@pytest.mark.parametrize("case", TOPK, ids=list(TOPK))
def test_topk_matches_the_jax_builder(case, k):
    b = run_both(TOPK[case], f"a = maxk(v, {k}); b = mink(v, {k});"
                             f" c = maxk(v', {k}); d = mink(-v, {k});")
    _exact_device(b, ["a", "b", "c", "d"])


def test_topk_of_a_row_is_a_row():
    b = run_both("v = gpuArray(1:10);", "a = maxk(v, 3); b = mink(v', 3);")
    _exact_device(b, ["a", "b"])
    assert b.ts.get("a").shape == (1, 3) and b.ts.get("b").shape == (3, 1)


@pytest.mark.parametrize("src", [
    "rng(11); a = normrnd(0, 1, 3, 4); u = unifrnd(-1, 2, 1, 5);"
    " e = exprnd(2, 2, 3); p = poissrnd(4, 1, 6);",
    "rng(12); t = unidrnd(9, 2, 5); s = randsample(20, 6);"
    " r = trnd(3, 1, 4); w = wblrnd(1, 2, 1, 3);",
])
def test_session_stream_is_drawn_bit_for_bit(src):
    # both packages draw on the host from the session's Threefry stream
    sessions = [JaxSession(accelerate=False), PortSession(accelerate=False)]
    for s in sessions:
        r = s.execute(src + " after = rand(1, 3);")
        assert r.error is None, r.error
    js, ps = sessions
    assert ps.rng.counter == js.rng.counter > 0
    assert ps.rng.key == js.rng.key
    for name in js.workspace_names():
        w, g = np.asarray(js.get(name).host()), np.asarray(ps.get(name).host())
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_parfeval_on_a_device_array_while_the_main_thread_computes():
    setup = "rng(2); A = gpuArray(randn(64));"
    src = ("f = parfeval(@(M) sum(M(:) .^ 2), 1, A); acc = 0;"
           " for k = 1:20, acc = acc + sum(A(:) * k); end; B = A * A;"
           " r = fetchOutputs(f); s = sum(A(:) .^ 2); c = sum(B(:));")
    b = run_both(setup, src)
    close(b, ["r", "s", "acc", "c"], 1e-12)
    for sess in (b.js, b.ts):
        assert np.array_equal(np.asarray(sess.get("r").host()),
                              np.asarray(sess.get("s").host()))


def test_engine_calls_from_many_threads_lose_no_update():
    # more threads than cores, the interpreter switching threads every
    # microsecond: each upload's read-modify-write of the engine's counters
    # and of its dispatch sequence stays whole under the engine's lock
    import sys
    import threading

    from runmat_tpu_torch.accel.engine import TorchEngine
    from runmat_tpu_torch.values import MatArray as PortMatArray
    eng = TorchEngine("cpu")
    x = PortMatArray(np.arange(16.0).reshape(4, 4), "double")
    before = eng.stats["uploads"]

    def work():
        for _ in range(200):
            assert np.array_equal(eng.upload(x).host(), x.host())

    threads = [threading.Thread(target=work) for _ in range(32)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert eng.stats["uploads"] - before == 32 * 200
    assert eng.stats["gathers"] == 32 * 200
