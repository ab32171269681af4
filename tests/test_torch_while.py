"""The port's `while` fold against the JAX package's `lax.while_loop` fold
and against the interpreter, on the same `.m` source (`tests/torch_both.py`;
the cases of `tests/test_device_while.py`).

A loop of device math folds: the port runs its condition and body programs
until the condition, read back once per iteration (one byte, in `syncs`),
is false, and records one "device_while" launch with the iteration count.
The JAX package does the same in one `lax.while_loop` ("device_while" in its
jit cache). Values are equal exactly to the JAX package's and to the port's
interpreter (`Session(accelerate=False)`). A loop that runs zero times
leaves the workspace as it was, which is why every variable a folded loop
writes must exist before it; a `break` (not traceable) and a host side
effect (`sprintf`) leave the loop to the interpreter, the second counted in
`loop_bails` with its reason.
"""

import numpy as np

import runmat_tpu_torch
from torch_both import run_both, same

FOLD = ("x = gpuArray(ones(1000, 1, 'single'));"
        " err = gpuArray(single(1.0)); k = single(0);\n",
        "while err > 1e-3\n"
        "  x = x * single(0.5);\n"
        "  err = max(abs(x), [], 'all');\n"
        "  k = k + 1;\n"
        "end\n"
        "y = gather(err); kk = gather(k);")


def _folded(b, trips):
    assert b.td["while_folds"] == 1 and b.td["loop_bails"] == 0, b.td
    (entry,) = [e for e in b.teng.launch_log if e["cat"] == "device_while"]
    assert entry["iterations"] == trips
    # the condition is read back once per iteration and once at the end
    assert b.td["syncs"] == trips + 1 and b.td["sync_bytes"] == trips + 1
    assert any(k[0] == "device_while" for k in b.jeng._jit_cache)


def _host(src):
    s = runmat_tpu_torch.Session(accelerate=False)
    r = s.execute(src.replace("gpuArray", ""))
    assert r.error is None, r.error
    return s


def test_device_while_folds():
    b = run_both(*FOLD)
    assert b.ts.get("x").on_device
    same(b, ["x", "err", "k", "y", "kk"])
    _folded(b, 10)
    assert b.ts.get("y").host()[0, 0] == np.float32(0.5 ** 10)
    assert b.ts.get("kk").host()[0, 0] == 10.0


def test_device_while_matches_the_interpreter():
    # v converges to the fixed point of sqrt(v) + 0.1 (~1.191558); every
    # variable the body writes is read before (the JAX package's rule: a
    # value written first would have no carry to start from)
    setup = ("e = gpuArray(single(1.0)); v = gpuArray(single(2.0));"
             " n = single(0);\n")
    body = ("while e > 0.01\n"
            "  e = abs(sqrt(v) + single(0.1) - v);\n"
            "  v = sqrt(v) + single(0.1);\n"
            "  n = n + 1;\n"
            "end\n"
            "r = gather(v); nn = gather(n);")
    b = run_both(setup, body)
    same(b, ["r", "nn", "e", "v"])
    host = _host(setup + body)
    for n in ("r", "nn", "e", "v"):
        assert np.array_equal(b.ts.get(n).host(), host.get(n).host()), n
    _folded(b, int(host.get("nn").host().item()))


def test_zero_trip_while():
    src = ("while x > 100\n  w = w * 2; x = x * 2;\nend\n"
           "y = gather(w);")
    b = run_both("x = gpuArray(single(5)); w = single(7);\n", src)
    same(b, ["y", "w", "x"])
    assert b.ts.get("y").host()[0, 0] == 7.0     # the loop never ran
    _folded(b, 0)


def test_while_with_break_falls_back():
    src = ("while true\n  x = x + 1; k = k + 1;\n"
           "  if k >= 3, break; end\nend\n")
    b = run_both("x = single(0); k = 0;\n", src)
    same(b, ["x", "k"])
    assert b.ts.get("k").host()[0, 0] == 3.0
    assert b.td["while_folds"] == 0 and b.td["loop_bails"] == 0


def test_while_with_host_side_effect_falls_back():
    # q exists before the loop, so the gate traces it and bails at sprintf
    src = "while n < 3\n  n = n + 1; q = sprintf('%d', n);\nend"
    b = run_both("n = 0; q = 0;", src)
    assert b.tr.error is None and b.jr.error is None
    assert np.array_equal(b.ts.get("n").host(), b.js.get("n").host())
    assert b.ts.get("q").to_str() == b.js.get("q").to_str() == "3"
    assert b.td["while_folds"] == 0 and b.td["loop_bails"] == 1
    (entry,) = [e for e in b.teng.launch_log if e["cat"] == "loop_bail"]
    assert entry["reason"].startswith("_Bail")
