"""TorchEngine (CPU) against JaxEngine (CPU), op by op on the main path.

Both engines take every array (`auto_offload=True, offload_threshold=1`),
get the same numpy inputs, each as its own package's `MatArray`, and are
read back through `MatArray.host()`.
Tolerances: float32 rtol=atol=1e-6, float64 rtol=atol=1e-12, integers and
logicals exact; the RNG streams as in test_torch_ctrng.py.
"""

import numpy as np
import pytest
import torch

from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.ops import ctrng as jctrng
from runmat_tpu.ops import table as jtable
from runmat_tpu.values import MatArray as JaxMatArray
from runmat_tpu.vm.indexing import COLON as JAX_COLON
from runmat_tpu_torch.accel.engine import TorchEngine, reshape_f
from runmat_tpu_torch.errors import MatError
from runmat_tpu_torch.ops import ctrng as tctrng
from runmat_tpu_torch.ops import table as ttable
from runmat_tpu_torch.values import MatArray as PortMatArray
from runmat_tpu_torch.vm.indexing import COLON as PORT_COLON

TOL = {"single": dict(rtol=1e-6, atol=1e-6),
       "double": dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture(scope="module")
def engines():
    kw = dict(auto_offload=True, offload_threshold=1)
    return JaxEngine(platform="cpu", **kw), TorchEngine("cpu", **kw)


class Value:
    """One numpy input, handed to each engine as its package's MatArray."""

    def __init__(self, data, mclass):
        self.data = np.asarray(data)
        self.mclass = mclass

    def host(self):
        return self.data


def MatArray(data, mclass):  # noqa: N802 - reads as the constructor it wraps
    return Value(data, mclass)


COLON = object()   # the colon subscript, as each package spells it


class Engine:
    """An engine whose methods take Values and COLON and pass them on as
    the engine's own package's MatArray and colon."""

    def __init__(self, eng):
        self.eng = eng
        port = isinstance(eng, TorchEngine)
        self.matarray = PortMatArray if port else JaxMatArray
        self.colon = PORT_COLON if port else JAX_COLON

    def _arg(self, a):
        if isinstance(a, Value):
            return self.matarray(a.data.copy(), a.mclass)
        if a is COLON:
            return self.colon
        if isinstance(a, list):
            return [self._arg(x) for x in a]
        return a

    def __getattr__(self, name):
        fn = getattr(self.eng, name)
        return lambda *args: fn(*(self._arg(a) for a in args))


def _data(shape, mclass, seed=0, special=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=shape)
    if special:
        flat = x.reshape(-1)
        flat[:6] = [np.nan, np.inf, -np.inf, 0.0, 0.5, -0.5][:flat.size]
    return x.astype(np.float32 if mclass == "single" else np.float64)


def _both(engines, build):
    """build(eng) -> MatArray on the device; both read back to the host."""
    return [build(Engine(e)).host() for e in engines]


def _close(got, want, mclass):
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    if got.dtype.kind in "biu":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL[mclass])


UNARY_FLOAT = sorted(n for n in ttable.UNARY
                     if n not in ("isnan", "isinf", "isfinite",
                                  "logical_not"))


@pytest.mark.parametrize("mclass", ["single", "double"])
@pytest.mark.parametrize("op", UNARY_FLOAT)
def test_unary(engines, op, mclass):
    assert op in jtable.UNARY
    x = MatArray(_data((5, 7), mclass), mclass)
    want, got = _both(engines, lambda e: e.unary(op, x, mclass))
    if op == "gamma" and mclass == "single":
        # exp(lgamma(x)) in f32: exp scales lgamma's last-bit differences by
        # |lgamma(x)| (up to ~3 here), a few ulp of the result
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    _close(got, want, mclass)


@pytest.mark.parametrize("op", ["isnan", "isinf", "isfinite", "logical_not"])
def test_unary_logical(engines, op):
    x = MatArray(_data((1, 9), "double"), "double")
    want, got = _both(engines, lambda e: e.unary(op, x, "logical"))
    _close(got, want, "double")


BINARY_ARITH = ["add", "sub", "mul", "div", "ldiv", "pow", "atan2", "hypot",
                "mod", "rem", "min2", "max2"]


@pytest.mark.parametrize("mclass", ["single", "double"])
@pytest.mark.parametrize("op", BINARY_ARITH)
def test_binary(engines, op, mclass):
    a = MatArray(_data((4, 6), mclass, seed=1), mclass)
    b = MatArray(_data((4, 6), mclass, seed=2)[::-1].copy(), mclass)
    want, got = _both(engines, lambda e: e.binary(op, a, b, mclass))
    _close(got, want, mclass)


@pytest.mark.parametrize("op", sorted(jtable.COMPARE_OPS | jtable.LOGICAL_OPS))
def test_binary_logical(engines, op):
    a = MatArray(_data((3, 5), "double", seed=3), "double")
    b = MatArray(np.round(_data((3, 5), "double", seed=3, special=False)),
                 "double")
    want, got = _both(engines, lambda e: e.binary(op, a, b, "logical"))
    _close(got, want, "double")


def test_binary_scalar_and_orientation(engines):
    # a host scalar rides as a parameter; a row with a column broadcasts to
    # the outer shape
    col = MatArray(_data((5, 1), "single", seed=4), "single")
    row = MatArray(_data((1, 3), "single", seed=5), "single")
    two = MatArray(np.array([[2.0]], np.float32), "single")
    want, got = _both(engines, lambda e: e.binary(
        "mul", e.binary("add", col, row, "single"), two, "single"))
    assert got.shape == (5, 3)
    _close(got, want, "single")


def test_pow_matlab_identities(engines):
    # x^0 == 1 for every x and 1^y == 1 for every y, NaN included
    a = MatArray(np.array([[np.nan, 1.0, -2.0, 1.0, np.inf]]), "double")
    b = MatArray(np.array([[0.0, np.nan, 0.5, np.inf, 0.0]]), "double")
    want, got = _both(engines, lambda e: e.binary("pow", a, b, "double"))
    _close(got, want, "double")
    assert np.array_equal(got[0, [0, 1, 3, 4]], [1.0, 1.0, 1.0, 1.0])


def test_integer_arithmetic_saturates(engines):
    a = MatArray(np.array([[100, -100, 7]], np.int8), "int8")
    b = MatArray(np.array([[50, -50, 2]], np.int8), "int8")
    for op in ("add", "sub", "mul", "div"):
        want, got = _both(engines, lambda e: e.binary(op, a, b, "int8"))
        _close(got, want, "double")


@pytest.mark.parametrize("src,dst", [("double", "single"),
                                     ("single", "double"),
                                     ("double", "logical"),
                                     ("single", "int32")])
def test_cast(engines, src, dst):
    x = MatArray(_data((3, 4), src, special=dst != "int32"), src)
    want, got = _both(engines, lambda e: e.convert(e.upload(x), dst))
    _close(got, want, dst if dst in TOL else "double")


@pytest.mark.parametrize("mclass", ["single", "double"])
def test_full_and_linspace(engines, mclass):
    want, got = _both(engines, lambda e: e.full((3, 4), 2.5, mclass))
    _close(got, want, mclass)
    for n in (1, 2, 7, 1000):
        want, got = _both(engines, lambda e: e.linspace(
            0.0, 4 * np.pi, n, mclass))
        assert got.shape == (1, n)
        _close(got, want, mclass)


def test_index_read_ranges(engines):
    vec = MatArray(_data((1, 50), "single", special=False), "single")
    mat = MatArray(_data((6, 5), "double", special=False), "double")
    r = MatArray(np.arange(3.0, 11.0).reshape(1, -1), "double")
    rows = MatArray(np.array([[2.0, 3.0, 4.0]]), "double")
    cases = [(vec, [r]), (vec, [COLON]), (mat, [COLON]),
             (mat, [rows, COLON]), (mat, [COLON, rows])]
    for base, args in cases:
        want, got = _both(engines, lambda e: e.index_read(e.upload(base),
                                                          args))
        _close(got, want, base.mclass)


def test_reshape_and_transpose(engines):
    x = MatArray(_data((4, 6), "double", special=False), "double")
    want, got = _both(engines, lambda e: e.reshape(e.upload(x), (3, 8)))
    _close(got, want, "double")
    want, got = _both(engines, lambda e: e.transpose(e.upload(x), False))
    _close(got, want, "double")
    np.testing.assert_array_equal(
        reshape_f(torch.from_numpy(x.host()), (3, 8)).numpy(),
        x.host().reshape((3, 8), order="F"))


def test_matmul(engines):
    a = MatArray(_data((5, 4), "double", special=False), "double")
    b = MatArray(_data((4, 3), "double", seed=9, special=False), "double")
    want, got = _both(engines, lambda e: e.matmul(a, b, "double"))
    _close(got, want, "double")


REDUCTIONS = [("sum", ""), ("sum", "omitnan"), ("mean", ""),
              ("mean", "omitnan"), ("min", ""), ("min", "includenan"),
              ("max", ""), ("max", "includenan"), ("prod", ""),
              ("prod", "omitnan"), ("any", ""), ("all", ""), ("nnz", ""),
              ("std0", ""), ("var1", ""), ("var0", "omitnan")]


@pytest.mark.parametrize("axes", [(1, 2), (0, 1, 2), (0,), (2,), (3,)],
                         ids=["dims23", "all", "dim1", "dim3", "dim4"])
@pytest.mark.parametrize("mclass", ["single", "double"])
@pytest.mark.parametrize("op,nan_mode", REDUCTIONS,
                         ids=[f"{o}-{m or 'default'}" for o, m in REDUCTIONS])
def test_reduce(engines, op, nan_mode, mclass, axes):
    x = _data((3, 4, 5), mclass, seed=6)
    x[1, 2, :] = np.nan                  # one all-NaN slice along dim 3
    xs = MatArray(x, mclass)
    keep = "logical" if op in ("any", "all") else mclass

    def build(e):
        return e.reduce(op, e.upload(xs), axes, keep, nan_mode)

    want, got = _both(engines, build)
    # 'native' keeps single; sums of 20 f32 values differ in order
    _close(got, want, "double" if keep == "logical" else mclass)


@pytest.mark.parametrize("mclass", ["single", "double"])
def test_reduce_vector_physical_axes(engines, mclass):
    # rank-1 storage of a column: reducing its singleton dim is the identity
    v = MatArray(_data((9, 1), mclass, special=False), mclass)
    for axes in ((0,), (1,), (0, 1)):
        want, got = _both(engines, lambda e: e.reduce(
            "sum", e.upload(v), axes, mclass, ""))
        _close(got, want, mclass)


@pytest.mark.parametrize("mclass", ["single", "double"])
@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_random(engines, kind, mclass):
    states = [jctrng.PhiloxState(seed=42), tctrng.PhiloxState(seed=42)]
    for st in states:
        st.advance(0xFFFFFFFE)           # the draw carries into the high word
    want, got = [e.random(kind, st, (7, 3, 2), mclass).host()
                 for e, st in zip(engines, states)]
    assert states[0].counter == states[1].counter
    assert got.shape == want.shape == (7, 3, 2)
    if kind == "rand":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_materialize_keeps_pinned_outputs(engines):
    # a chain whose middle value is a workspace variable: one pass gives
    # both, and intermediates are released along the way
    x = MatArray(_data((64, 1), "single", special=False), "single")
    outs = []
    for e in map(Engine, engines):
        mid = e.unary("exp", e.upload(x), "single")
        mid.dev.pinned = True
        top = e.binary("mul", mid, mid, "single")
        top = e.reduce("sum", top, (0, 1), "single", "")
        outs.append((top.host(), mid.dev.value is not None, mid.host()))
    (jt, jp, jm), (tt, tp, tm) = outs
    assert jp and tp
    _close(tt, jt, "single")
    _close(tm, jm, "single")


def test_cuda_engine_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    with pytest.raises(MatError) as ei:
        TorchEngine("cuda")
    assert ei.value.identifier == "parallel:gpu:device:NoDevice"


def test_outside_the_slice_declines_or_raises(engines):
    _, eng = engines
    x = PortMatArray(_data((4, 4), "double", special=False), "double")
    d = eng.upload(x)
    z = PortMatArray(np.array([[1j, 2.0]]), "double")
    before = eng.stats["host_fallbacks"]
    # linalg routes a resident operand; a kind without a builder (cmap,
    # ROADMAP: plotting.py) declines in linalg, counted because the operand
    # is on the device
    assert eng.route_linalg(d) is True
    assert eng.linalg("cmap", [d], ("parula",)) is None
    assert eng.stats["host_fallbacks"] == before + 1
    # a host operand of an unported kind declines without a count
    assert eng.linalg("cmap", [x], ("parula",)) is None
    assert eng.stats["host_fallbacks"] == before + 1
    # complex values and the fft route as JaxEngine routes them (A8): by
    # residency or the offload policy, complex or not
    assert eng.route_linalg(z) is True
    assert eng.route_fft(d) is True
    assert eng.stats["host_fallbacks"] == before + 1
    # sort, index_write and median run on the device
    vals, idx = eng.sort(d, 0, False, True)
    assert vals.on_device and idx.on_device
    np.testing.assert_array_equal(vals.host(), np.sort(x.host(), axis=0))
    w = eng.index_write(d, [PORT_COLON, PortMatArray(np.array([[2.0]]),
                                                     "double")],
                        PortMatArray(np.array([[0.0]]), "double"))
    want = x.host().copy()
    want[:, 1] = 0
    assert w.on_device and np.array_equal(w.host(), want)
    m = eng.reduce("median", d, (0,), "double", "")
    assert m is not None
    np.testing.assert_array_equal(m.host(), np.median(x.host(), axis=0,
                                                      keepdims=True))
    assert eng.stats["host_fallbacks"] == before + 1
    # a complex upload goes to the device and comes back unchanged
    zd = eng.upload(z)
    assert zd.on_device and zd.is_complex
    assert np.array_equal(zd.host(), z.host())
    assert eng.scan("cumsum", d, 0, False, False, "double") is not None
