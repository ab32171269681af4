"""The device colormap and imfilter of the port against the JAX package's
builders, on the CPU.

* `ops/cmap.py:plain_cmap` (the kernel's plain version) is bit-equal to
  the JAX package's `_b_cmap` under `jax.jit` on the CPU: the image, lo and
  hi, in float64 and float32, at small sizes including odd ones, over a
  normal field, NaNs, +-Inf, a constant field and an all-NaN field, and
  for every colormap of `plot/colors.py`. The colormap's bytes are
  `ops/cmap.py:table`, rounded in float32 as the JAX builder rounds them.
* The imfilter builder (`accel/dense.py:_b_imfilter`, F.pad and conv2d)
  within 1e-12 of the largest output of the JAX builder in float64 (XLA
  and torch sum the kernel's products in other orders; 1e-5 in float32),
  for both boundaries and odd, even and mixed kernel sizes.
* `imagesc` of a device array on both packages' engines (JaxEngine("cpu")
  and TorchEngine("cpu")): the image's RGB equal exactly and `clim`
  equal, the port with no host fallback and one colormap call.
"""

import jax
import numpy as np
import pytest
import torch

from runmat_tpu.accel.dense import _b_cmap, _b_imfilter
from runmat_tpu.accel.engine import JaxEngine
from runmat_tpu.plot import figure as jax_figures
from runmat_tpu_torch.accel.dense import _b_imfilter as port_imfilter
from runmat_tpu_torch.ops import cmap
from runmat_tpu_torch.plot import figure as port_figures
from runmat_tpu_torch.plotbench import CASES, COLORMAPS, field
from torch_both import no_engine, run_both  # noqa: F401

SHAPES = ((1, 1), (3, 5), (17, 23), (40, 64))
DTYPES = (np.float64, np.float32)


@pytest.fixture(scope="module")
def jax_engine():
    jax.config.update("jax_enable_x64", True)
    return JaxEngine(platform="cpu")


def _both_cmap(jax_engine, a: np.ndarray, name: str):
    want = [np.asarray(v) for v in
            jax.jit(_b_cmap(jax_engine, (name,)))(a)]
    lut = torch.from_numpy(cmap.table(name).copy())
    rgb, sc = cmap.plain_cmap(torch.from_numpy(a), lut)
    before = cmap.launches
    rgb2, sc2 = cmap.cmap(torch.from_numpy(a), name)
    assert cmap.launches == before     # a CPU tensor takes the plain version
    assert torch.equal(rgb2, rgb) and torch.equal(sc2.isnan(), sc.isnan())
    got = [rgb.numpy(), sc[0].numpy(), sc[1].numpy()]
    for w, g, what in zip(want, got, ("image", "lo", "hi")):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                          w.dtype)
        assert np.array_equal(g, w, equal_nan=w.dtype.kind == "f"), what


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("case", CASES)
def test_plain_cmap_is_the_jax_builder(jax_engine, case, dtype, shape):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    a = field(case, shape, tdt, seed=shape[0]).numpy()
    _both_cmap(jax_engine, a, "parula")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", COLORMAPS)
def test_every_colormap_is_the_jax_builder(jax_engine, name, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    # a ramp through every index, and a normal field
    ramp = np.linspace(-1, 2, 3 * 256).reshape(24, 32).astype(dtype)
    _both_cmap(jax_engine, ramp, name)
    _both_cmap(jax_engine, field("normal", (19, 21), tdt).numpy(), name)


def test_the_table_is_rounded_in_float32():
    # jet's float32 rounding differs from a float64 one in many entries:
    # the table must be the float32 one the JAX builder uses
    from runmat_tpu_torch.plot.colors import colormap
    lut = colormap("jet")
    f64 = (lut * 255 + 0.5).astype(np.uint8)
    assert not np.array_equal(cmap.table("jet"), f64)
    f32 = (lut.astype(np.float32) * np.float32(255)
           + np.float32(0.5)).astype(np.uint8)
    assert np.array_equal(cmap.table("jet"), f32)


# (id, kernel): odd, even, mixed and 1x1 sizes, and field_plot.m's
KERNELS = [
    ("3x3", np.arange(9.0).reshape(3, 3) / 36 - 0.1),
    ("4x4", np.random.default_rng(4).standard_normal((4, 4))),
    ("2x5", np.random.default_rng(5).standard_normal((2, 5))),
    ("1x1", np.array([[1.7]])),
    ("gauss15", None),
]


def _gauss15():
    ax = np.arange(15) - 7.0
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 18)
    return g / g.sum()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("boundary", ["constant", "replicate"])
@pytest.mark.parametrize("kid,k", KERNELS, ids=[k[0] for k in KERNELS])
def test_imfilter_builder_is_the_jax_builder(jax_engine, kid, k, boundary,
                                             dtype):
    k = (_gauss15() if k is None else k).astype(dtype)
    x = np.random.default_rng(7).standard_normal((20, 31)).astype(dtype)
    want = np.asarray(jax.jit(_b_imfilter(jax_engine, (boundary,)))(x, k))
    got = port_imfilter(None, (boundary,))(torch.from_numpy(x),
                                           torch.from_numpy(k)).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == want.dtype
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), kid


# imagesc of a device array: (id, setup, source)
IMAGESC = [
    ("double", "rng(5); Xd = gpuArray(rand(32, 45));", "imagesc(Xd);"),
    ("single", "rng(6); Xd = gpuArray(single(randn(17, 9)));",
     "imagesc(Xd);"),
    ("nan-inf", "rng(7); X = randn(20, 30); X(3, 4) = NaN; X(5, 6) = Inf;"
     " X(7, 8) = -Inf; Xd = gpuArray(X);", "imagesc(Xd);"),
    ("constant", "Xd = gpuArray(2.5 * ones(8, 12));", "imagesc(Xd);"),
    ("all-nan", "Xd = gpuArray(NaN(6, 7));", "imagesc(Xd);"),
    ("extent", "rng(8); Xd = gpuArray(rand(10, 14));",
     "imagesc(1:14, 1:10, Xd);"),
    ("colormap", "rng(9); Xd = gpuArray(rand(16, 16));",
     "colormap('hot'); imagesc(Xd);"),
    ("image", "rng(10); Xd = gpuArray(magic(9));", "image(Xd);"),
    ("uint8", "Xd = gpuArray(uint8(magic(6)));", "imagesc(Xd);"),
]


@pytest.fixture
def closed_figures():
    jax_figures.close_all()
    port_figures.close_all()
    yield
    jax_figures.close_all()
    port_figures.close_all()


@pytest.mark.parametrize("iid,setup,src", IMAGESC, ids=[c[0] for c in IMAGESC])
def test_imagesc_of_a_device_array_on_both_engines(closed_figures, iid,
                                                    setup, src):
    b = run_both(setup, src)
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    assert b.ts.get("Xd").on_device
    want = jax_figures.gca()
    got = port_figures.gca()
    (wi,), (gi,) = want.children, got.children
    assert gi.kind == wi.kind == "image"
    assert gi.data.dtype == wi.data.dtype and gi.data.shape == wi.data.shape
    assert np.array_equal(gi.data, wi.data)
    assert gi.extent == wi.extent
    # an all-NaN field's limits are NaN in both
    assert np.array_equal(np.array(got.clim), np.array(want.clim),
                          equal_nan=True), (got.clim, want.clim)
    assert b.td["host_fallbacks"] == 0
    assert [e["ops"] for e in b.teng.launch_log
            if e["cat"] == "linalg"][-1:] == [["cmap"]]



# ------------------------------------------------------- the plot path

FIELD_SMALL = "H = 90; W = 160;"
with open("runmat_tpu_torch/workloads/field_plot.m") as f:
    FIELD = f.read()


def _field(output: str) -> float:
    (line,) = [ln for ln in output.splitlines() if "RESULT_ok FIELD=" in ln]
    return float(line.split("=")[1])


def test_field_plot_host_sessions_agree(no_engine, closed_figures,
                                        monkeypatch):
    # both packages' host sessions: output, workspace and the two figures
    # equal exactly (torch_paired.PairedSession); the file names come from
    # tempname, which is random
    from torch_paired import PairedSession
    monkeypatch.setattr(PairedSession, "loose", ("base", "png", "svg"))
    r = PairedSession(accelerate=False).execute(FIELD_SMALL + "\n" + FIELD)
    assert r.error is None, r.error
    assert len(jax_figures._FIGURES) == 2


def test_field_plot_engines_agree(closed_figures):
    # JaxEngine("cpu") against TorchEngine("cpu"), both taking every
    # array: FIELD within 1e-12, Y within 1e-12 of its largest magnitude
    # (XLA's and torch's convolutions sum in other orders), the heat map
    # equal byte for byte, imfilter and the colormap on the port's engine.
    # Taking every array puts `row` on the device too: both packages read
    # X(row, :) and Y(row, :) on the host (the port counts that as a host
    # fallback), and the reads move X and Y to the host for good in both
    from torch_both import close
    b = run_both(FIELD_SMALL, FIELD)
    want, got = _field(b.jr.output), _field(b.tr.output)
    assert abs(got - want) <= 1e-12 * abs(want)
    close(b, ["X", "Y"], 1e-12)
    (wi,) = jax_figures._FIGURES[1].ax.children
    (gi,) = port_figures._FIGURES[1].ax.children
    assert np.array_equal(gi.data, wi.data) and gi.extent == wi.extent
    assert len(port_figures._FIGURES[2].ax.children) == 2
    ops = [e["ops"][0] for e in b.teng.launch_log if e["cat"] == "linalg"]
    assert "imfilter" in ops and "cmap" in ops
    assert {e["reason"] for e in b.teng.launch_log
            if e["cat"] == "host_fallback"} == {"subscript on the device"}
