"""Indexed reads and writes and the structural ops of the port against the
JAX package, on the same `.m` source (`tests/torch_both.py`: JaxEngine and
TorchEngine on the CPU, both taking every array).

The cases mirror `tests/test_device_dag.py` (101-275 and 293-332): values,
class, shape and dtype are equal exactly, and a value the JAX package keeps
on its device stays on the port's. Where the JAX package takes the host path
(repeated subscripts with an array right-hand side, growth, a subscript out
of range, a logical read), the port takes it too and counts it in
`host_fallbacks`. A device route copies no array to the host (`gathers`
copies only scalars) and a range subscript is made on the device (nothing
is uploaded for it).

Two differences from the JAX package are not copied (ROADMAP Queue C): a
subscript that is not an integer raises the MATLAB error where the JAX
package's device route truncates it, and a device mask of another shape
than the vector it writes into is read in column-major order.
"""

import numpy as np
import pytest

import runmat_tpu_torch
from runmat_tpu_torch import accel
from runmat_tpu_torch.accel.engine import TorchEngine
from torch_both import OFFLOAD, run_both, same

A45 = "A = gpuArray(reshape(1:20, 4, 5));"
A3D = "T = gpuArray(single(reshape(1:24, 2, 3, 4)));"


def _on_device(b, names):
    for n in names:
        assert b.ts.get(n).on_device, n
    same(b, names)
    # no array came back: a gather here is a scalar that the offload
    # threshold of 1 put on the device (a `-1` in `[1 -1]`, read back as a
    # shift), as under JaxEngine
    assert b.td["gather_bytes"] <= 8 * b.td["gathers"], b.td
    assert b.td["host_fallbacks"] == 0, b.td


# ------------------------------------------------------------------ reads

@pytest.mark.parametrize("src,names", [
    ("B = A([3 1], [5 2 4]); C = B + 0;", ["B", "C"]),
    ("b = A([1 6 20]); c = A([2; 3]); d = A(end); M = A([1 2; 3 4]);",
     ["b", "c", "d", "M"]),
    ("r = A(1, [3 1 2]); c = A([2 4], 3); v = A(:); e = A([4 4 1], :);",
     ["r", "c", "v", "e"]),
], ids=["arbitrary", "linear", "orientation"])
def test_arbitrary_reads_stay_on_device(src, names):
    _on_device(run_both(A45, src), names)


def test_reads_of_vectors_and_3d_single():
    b = run_both(A3D + " w = gpuArray(1:5); wc = gpuArray((1:6)');",
                 "t1 = T([24 1 7]); t2 = T(2, [3 1], [4 4 1]);"
                 " t3 = T(:, 3, [2 1]); wr = w([5 1 1 2]); w2 = w([2; 3]);"
                 " w3 = wc([6 1]); w4 = wc([1 2; 3 4]);")
    _on_device(b, ["t1", "t2", "t3", "wr", "w2", "w3", "w4"])


def test_linear_subscripts_of_a_column_major_view():
    # reshape of a device vector is a column-major view of it: a linear
    # gather reads it in place, a linear write goes into a new tensor
    b = run_both("x = gpuArray(1:20); A = reshape(x, 4, 5); C = A;",
                 "g = A([2 7 20]); A([3 9]) = [70 80]; P = permute(C, [2 1]);"
                 " h = P([1 6 11]);")
    _on_device(b, ["g", "A", "C", "x", "h"])


def test_range_subscripts_upload_nothing():
    # 1:3:20 and [5 3 1] are made on the device from start, step and
    # length; [4 1 3] is uploaded
    b = run_both(A45, "r = A(1:3:20); s = A(4, [5 3 1]); t = A([4 1 3]);")
    _on_device(b, ["r", "s", "t"])
    assert b.td["upload_bytes"] == 3 * 8


@pytest.mark.parametrize("src", ["b = A(9);", "b = A(0);", "b = A(2, 7);",
                                 "b = A([1 6]);"])
def test_out_of_range_read_errors(src):
    b = run_both("A = gpuArray(1:5);", src)
    assert b.jr.error is not None and b.tr.error is not None
    assert b.tr.error.identifier == b.jr.error.identifier
    assert b.tr.error.message == b.jr.error.message
    assert b.td["host_fallbacks"] == 1


def test_logical_read_takes_the_host_path_counted():
    b = run_both("x = gpuArray(1:10);", "y = x(x > 5);")
    same(b, ["y"])
    assert not b.ts.get("y").on_device
    assert b.td["host_fallbacks"] == 1


# ------------------------------------------------------------------ writes

def test_slice_write_is_lazy():
    b = run_both(A45, "A(2, :) = 0; A(1, 2) = 99; A(3:4, 2:3) = -1;")
    _on_device(b, ["A"])
    assert b.td["dispatches"] == 0      # still lazy, as under JaxEngine
    assert b.jd["dispatches"] == 0


@pytest.mark.parametrize("src", [
    "A([1 3], [2 4]) = [100 200; 300 400]; A([1 5]) = -1;",
    "A([4 1], :) = gpuArray(reshape(101:110, 2, 5));",
    "A(:, [5 2]) = 7; A([3 2 1], [1 3]) = [1 2; 3 4; 5 6];",
    "A([20 1 7]) = [1; 2; 3]; A([2 3]) = gpuArray(single([8 9]));",
    "A(end, end) = 0; A(end) = -5; A(2, end) = 4;",
], ids=["scatterN", "rows-device-rhs", "mixed", "scatter1", "end"])
def test_scatter_writes(src):
    _on_device(run_both(A45, src), ["A"])


def test_scatter_into_3d_and_vectors():
    b = run_both(A3D + " w = gpuArray(zeros(1, 8)); c = gpuArray(ones(6, 1));",
                 "T(2, [3 1], [4 2]) = -1; T(:, 2, :) = 0; T([24 5]) = 9;"
                 " w([8 1 4]) = [1 2 3]; c([6; 2]) = [5; 6]; w(3:5) = 7;")
    _on_device(b, ["T", "w", "c"])


def test_mask_writes():
    b = run_both("M = gpuArray([16 2 3 13; 5 11 10 8; 9 7 6 12; 4 14 15 1]); M2 = M; M3 = M; w = gpuArray(1:6);"
                 " v = gpuArray(single(1:16));",
                 "M(M > 10) = 0; t = sum(M(:)); M2(logical(eye(4))) = -1;"
                 " M3(M3' > 8) = 5;"
                 " v(reshape([16 2 3 13; 5 11 10 8; 9 7 6 12; 4 14 15 1] > 8,"
                 " 1, 16)) = -2;")
    _on_device(b, ["M", "t", "M2", "M3", "v"])


def test_a_matrix_mask_into_a_vector_is_read_in_column_major_order():
    # ROADMAP Queue C: the JAX package lays a device mask of another shape
    # than the vector base out row-major ([0 2 3 0 0 0] here); MATLAB, the
    # host path and the port take the mask's column-major order
    src = "w(gpuArray([true false; false true; true true])) = 0;"
    b = run_both("w = gpuArray(1:6);", src)
    assert b.ts.get("w").on_device
    assert np.array_equal(b.ts.get("w").host(), [[0, 2, 0, 4, 0, 0]])
    assert np.array_equal(b.js.get("w").host(), [[0, 2, 3, 0, 0, 0]])
    host = runmat_tpu_torch.Session(accelerate=False)
    host.execute("w = 1:6; " + src.replace("gpuArray", ""))
    assert np.array_equal(host.get("w").host(), [[0, 2, 0, 4, 0, 0]])


def test_colon_fill():
    b = run_both(A45 + " B = A; C = A;",
                 "A(:) = 7; B(:) = 1:20; C(:) = gpuArray(single(20:-1:1));")
    _on_device(b, ["A", "B", "C"])


def test_duplicate_subscripts_last_write_wins_on_the_host():
    b = run_both("A = gpuArray(1:5); B = A;",
                 "A([2 2]) = [10 20]; B([3 3]) = 4;")
    # an array into repeated subscripts goes to the host, counted; a scalar
    # into them stays on the device
    assert not b.ts.get("A").on_device
    same(b, ["A", "B"])
    assert b.td["host_fallbacks"] == 1
    assert b.ts.get("A").host()[0, 1] == 20


def test_write_preserves_copy_on_write():
    b = run_both("A = gpuArray(1:5); M = gpuArray([16 2 3 13; 5 11 10 8; 9 7 6 12; 4 14 15 1]); N = M';",
                 "B = A; A(1) = 99; P = N; N(1, :) = 0; Q = M; M(M > 5) = 0;")
    _on_device(b, ["A", "B", "N", "P", "M", "Q"])
    assert np.array_equal(b.ts.get("B").host(), [[1, 2, 3, 4, 5]])
    assert np.array_equal(b.ts.get("A").host(), [[99, 2, 3, 4, 5]])


def test_write_then_read_chain():
    b = run_both("x = gpuArray(zeros(1, 8));",
                 "x(3:6) = 5; y = sin(x) + 1; t = sum(y);")
    _on_device(b, ["x", "y", "t"])


@pytest.mark.parametrize("src", ["A(5) = 9;", "A(2, 3) = 1;",
                                 "A(1) = int8(4);", "A(2) = 1i;",
                                 "A(1) = [];"])
def test_growth_class_change_and_deletion_take_the_host_path(src):
    b = run_both("A = gpuArray(1:3);", src)
    assert not b.ts.get("A").on_device
    same(b, ["A"])
    # deletion gathers before it asks the engine, in both packages
    assert b.td["host_fallbacks"] == (0 if "[]" in src else 1)


def test_find():
    b = run_both(A45, "f = find(A > 10); [r, c] = find(A == 15);"
                      " g = find(gpuArray([0 5 0 7 0 9]), 2);")
    same(b, ["f", "r", "c", "g"])


# --------------------------------------------------------- loop gate writes

def _folds(setup, loop, names, folds=1):
    b = run_both(setup, loop)
    same(b, names)
    assert b.td["loop_folds"] == folds, b.td
    assert b.td["host_fallbacks"] == 0
    log = [e for e in b.teng.launch_log if e["cat"] == "device_loop"]
    assert len(log) == folds
    return b


def test_loop_column_write_folds():
    b = _folds("X = gpuArray(reshape(1:80, 8, 10)); Z = gpuArray((1:10)*0.5);"
               " S = gpuArray(zeros(8, 10));",
               "for t = 1:10, S(:, t) = X(:, t) .* 2 + Z(t); end", ["S"])
    # the pending S and Z are made first, then the loop: as under JaxEngine
    assert b.td["dispatches"] == b.jd["dispatches"] == 3


def test_loop_mask_write_folds():
    _folds("M = gpuArray([16 2 3 13; 5 11 10 8; 9 7 6 12; 4 14 15 1]); A = gpuArray(ones(4));",
           "for t = 1:8, A = A + 1; A(M > 10) = 0; end", ["A"])


def test_loop_dynamic_subscripts_fold():
    _folds("v = gpuArray(zeros(1, 12)); X = gpuArray(reshape(1:40, 4, 10));"
           " acc = gpuArray(zeros(4, 1)); W = gpuArray(zeros(3, 10));",
           "for t = 1:10, v(t) = t * 2; acc = acc + X(:, t);"
           " W(2, t) = X(3, t) - t; end", ["v", "acc", "W"])


def test_loop_end_subscripts_fold():
    _folds("S = gpuArray(zeros(1, 8)); w = gpuArray(0);",
           "for t = 1:8, S(t) = t; w = w + S(end) + S(1); end", ["S", "w"])


def test_loop_out_of_range_loop_variable_bails_counted():
    b = run_both("v = gpuArray(zeros(1, 3));", "for t = 1:8, v(t) = t; end")
    same(b, ["v"])
    assert b.td["loop_folds"] == 0 and b.td["loop_bails"] == 1
    assert np.array_equal(b.ts.get("v").host(), [np.arange(1.0, 9.0)])


# --------------------------------------------------------- structural ops

STRUCTURAL = ("f1 = flip(A); f2 = fliplr(A); f3 = flipud(A);"
              " c1 = circshift(A, 1); c2 = circshift(A, 2, 2);"
              " c3 = circshift(A, [1 -1]); r = repmat(A, 2, 1);"
              " r2 = repmat(A, [1 2 2]); t = rot90(A); tm = rot90(A, 2);"
              " t3 = rot90(A, 3); k = kron(A, gpuArray(ones(2)));"
              " k2 = kron(A, [1 2]); p = permute(A, [2 1]);"
              " p3 = permute(A, [3 1 2]); tl = tril(A); tu = triu(A, 1);"
              " tl2 = tril(A, -1); tu2 = triu(A, 2);"
              " q = squeeze(gpuArray(reshape(1:8, 1, 2, 4)));")
NAMES = ["f1", "f2", "f3", "c1", "c2", "c3", "r", "r2", "t", "tm", "t3", "k",
         "k2", "p", "p3", "tl", "tu", "tl2", "tu2", "q"]


@pytest.mark.parametrize("mclass", ["double", "single"])
def test_structural_ops_stay_on_device(mclass):
    b = run_both(f"A = gpuArray({mclass}(reshape(1:12, 3, 4)));",
                 STRUCTURAL)
    _on_device(b, NAMES)


def test_structural_ops_in_3d():
    b = run_both(A3D, "p1 = permute(T, [3 1 2]); p2 = permute(T, [2 3 1]);"
                      " f = flip(T, 3); c = circshift(T, [1 -1 2]);"
                      " r = repmat(T, [1 2 1]); s = squeeze(T(1, :, :));")
    _on_device(b, ["p1", "p2", "f", "c", "r", "s"])


def test_structural_ops_fuse_with_elementwise():
    b = run_both("A = gpuArray(reshape(1:6, 2, 3));",
                 "y = sum(flipud(A) .* 2 + 1, 'all'); g = gather(y);")
    same(b, ["y", "g"])
    assert b.td["dispatches"] == 1


def test_an_exception_in_the_structural_route_is_counted(monkeypatch):
    def boom(self, *args):
        raise RuntimeError("structural failed")
    monkeypatch.setattr(TorchEngine, "structural", boom)
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    try:
        eng = accel.active_engine()
        r = s.execute("A = gpuArray(reshape(1:6, 2, 3)); B = flip(A);")
    finally:
        runmat_tpu_torch.uninstall()
    assert r.error is None
    assert not s.get("B").on_device
    assert np.array_equal(s.get("B").host(),
                          np.flip(np.arange(1.0, 7).reshape(2, 3, order="F"),
                                  0))
    assert eng.stats["host_fallbacks"] == 1
    (entry,) = [e for e in eng.launch_log if e["cat"] == "host_fallback"]
    assert entry["ops"] == ["flipL"]
    assert entry["reason"] == "RuntimeError: structural failed"


@pytest.mark.parametrize("src", ["c = A([1.5 2.7]);", "c = A(1, 2.5);",
                                 "A(1.5) = 0;", "A(NaN) = 0;"])
def test_a_fractional_subscript_raises_where_the_jax_package_truncates(src):
    # ROADMAP Queue C: the JAX package's device routes read A(1.5) as A(1)
    # (and write it so); the port sends a subscript that is not an integer
    # to the host path, which raises the MATLAB error as it does for a
    # host array
    b = run_both("A = gpuArray(1:5);", src)
    host = runmat_tpu_torch.Session(accelerate=False).execute(
        "A = 1:5; " + src)
    assert host.error is not None
    assert b.tr.error is not None
    assert b.tr.error.identifier == host.error.identifier
    assert b.tr.error.message == host.error.message
    if "NaN" not in src:
        assert b.jr.error is None
