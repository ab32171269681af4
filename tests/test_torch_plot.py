"""The port's plot modules (`runmat_tpu_torch/plot/*`) held to the JAX
package's on the same figures and the same numpy data.

* Figures built from numpy data with each package's own scene classes
  (surfaces in every style, lit and unlit, lines with NaN breaks, scatter,
  triangle meshes, patches with vertex colours, images, 2-D axes): the SVG
  text (full and draft), the PNG bytes, the WebGL scene export and a
  probe of the figure equal exactly.
* Figures drawn by MATLAB sources (every headline plot type) in both
  packages' host sessions: the same renders of each one's current figure.
* The volume algorithms (isosurface, isonormals, trilinear sampling,
  slice planes, streamlines, smooth3), the triangle rasterizer and the
  surface decimation stride, on the same inputs: equal exactly.
"""

import numpy as np
import pytest

from runmat_tpu.plot import figure as jfig
from runmat_tpu.plot import raster as jraster
from runmat_tpu.plot import shade3d as jshade
from runmat_tpu.plot import svg as jsvg
from runmat_tpu.plot import volumetric as jvol
from runmat_tpu.plot import webgl as jwebgl
from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch.plot import figure as tfig
from runmat_tpu_torch.plot import raster as traster
from runmat_tpu_torch.plot import shade3d as tshade
from runmat_tpu_torch.plot import svg as tsvg
from runmat_tpu_torch.plot import volumetric as tvol
from runmat_tpu_torch.plot import webgl as twebgl
from runmat_tpu_torch.session import Session as PortSession

JAX = (jfig, jsvg, jraster, jwebgl)
PORT = (tfig, tsvg, traster, twebgl)


def _peaks(n):
    x = np.linspace(-2, 2, n)
    X, Y = np.meshgrid(x, x)
    return X, Y, np.exp(-(X ** 2 + Y ** 2))


def _fig3d(F):
    f = F.Figure(99)
    f.ax.is3d = True
    return f


def _surface(style, lighting=None, n=10):
    def build(F):
        f = _fig3d(F)
        f.ax.add(F.Surface(*_peaks(n), style=style))
        if lighting is not None:
            f.ax.lights.append(F.Light(position=(0.3, -0.4, 1.0)))
            f.ax.lighting = lighting
        return f
    return build


def _line3(F):
    f = _fig3d(F)
    x = np.array([0.0, 1.0, np.nan, 2.0, 3.0])
    f.ax.add(F.Line(x, x, z=x, color=(1, 0, 0)))
    return f


def _scatter3(F):
    f = _fig3d(F)
    f.ax.add(F.Scatter([0, 1, 2], [0, 1, 2], z=[0, 1, 2], sizes=64.0))
    return f


def _trimesh(style, lit):
    def build(F):
        verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 1.0]])
        faces = np.array([[0, 1, 2], [1, 3, 2]])
        f = _fig3d(F)
        f.ax.add(F.TriMesh(verts, faces, cvals=verts[:, 2], style=style))
        if lit:
            f.ax.lights.append(F.Light())
        return f
    return build


def _patch(F):
    poly = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.0]])
    vc = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0.0]])
    f = _fig3d(F)
    f.ax.add(F.Patch([poly], facecolor=None, edgecolor=(0, 0, 0),
                     vertexcolors=[vc]))
    return f


def _image(F):
    rgb = np.random.default_rng(3).random((12, 17, 3))
    f = F.Figure(97)
    f.ax.add(F.ImageObj(rgb, (0.5, 17.5, 12.5, 0.5)))
    f.ax.clim = (0.0, 1.0)
    f.ax.colorbar = True
    return f


def _lines2d(F):
    f = F.Figure(98)
    f.ax.add(F.Line([0, 1, 2], [0, 1, 0.5], color=(0, 0, 1), style="--",
                    marker="o", label="a"))
    f.ax.add(F.Scatter([0.5, 1.5], [0.2, 0.8], color=(1, 0, 0)))
    f.ax.add(F.TextObj(1.0, 0.5, "peak"))
    f.ax.title, f.ax.xlabel, f.ax.ylabel = "t", "x", "y"
    f.ax.legend_on, f.ax.grid = True, True
    return f


def _lit_modes(mode):
    def build(F):
        g = np.linspace(-2, 2, 40)
        X, Y = np.meshgrid(g, g)
        f = _fig3d(F)
        f.ax.add(F.Surface(X, Y, np.sin(X) * np.cos(Y)))
        f.ax.lights.append(F.Light((1.0, 0.0, 1.0)))
        f.ax.lighting = mode
        return f
    return build


# (id, builder over a package's figure module, export_scene's max_faces)
FIGURES = [
    ("surface-faceted", _surface("faceted"), 120_000),
    ("surface-interp", _surface("interp"), 120_000),
    ("surface-mesh", _surface("mesh", n=8), 120_000),
    ("surface-flat-decimated", _surface("flat", n=200), 1000),
    ("surface-gouraud", _surface("interp", "gouraud"), 120_000),
    ("surface-lit-none", _lit_modes("none"), 120_000),
    ("surface-lit-flat", _lit_modes("flat"), 120_000),
    ("surface-lit-gouraud", _lit_modes("gouraud"), 120_000),
    ("line3-nan", _line3, 120_000),
    ("scatter3", _scatter3, 120_000),
    ("trimesh-interp", _trimesh("interp", False), 120_000),
    ("trimesh-flat-lit", _trimesh("flat", True), 120_000),
    ("patch-vertex-colors", _patch, 120_000),
    ("image", _image, 120_000),
    ("lines-2d", _lines2d, 120_000),
]


def _renders(pkg, fig, max_faces) -> dict:
    _, svg, raster, webgl = pkg
    return {"svg": svg.render_svg(fig),
            "draft": svg.render_svg(fig, draft=True),
            "png": raster.render_png(fig),
            "webgl": webgl.export_scene(fig, max_faces=max_faces),
            "probe": svg.probe_figure(fig, 0.5, 0.5)}


@pytest.mark.parametrize("fid,build,max_faces", FIGURES,
                         ids=[f[0] for f in FIGURES])
def test_a_numpy_figure_renders_alike(fid, build, max_faces):
    want = _renders(JAX, build(jfig), max_faces)
    got = _renders(PORT, build(tfig), max_faces)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k] == want[k], (fid, k)


# MATLAB sources: each draws one figure in a fresh host session
SOURCES = [
    "surf(peaks(12));", "mesh(peaks(12));", "contour(peaks(24));",
    "contourf(peaks(24));", "quiver([0 1], [0 1], [1 1], [0 1]);",
    "stem(1:8, (1:8).^2);", "rng(2); stairs(1:8, rand(1,8));",
    "errorbar(1:6, (1:6).^2, ones(1,6));", "bar(1:5, [3 1 4 1 5]);",
    "rng(4); histogram(randn(500,1));",
    "plot3(sin(0:.1:6), cos(0:.1:6), 0:.1:6);", "pie([1 2 3]);",
    "area(1:5, [2 4 1 5 3]);", "rng(1); scatter(rand(20,1), rand(20,1));",
    "imagesc(magic(8)); colorbar; colormap('jet');",
    "x = linspace(0, 2*pi, 50); plot(x, sin(x), 'r-', x, cos(x), 'b--o');"
    " legend('sin', 'cos'); title('trig'); xlabel('x'); ylabel('y');"
    " grid on;",
    "subplot(2, 1, 1); plot(1:5); subplot(2, 1, 2); bar([2 3 1]);",
    "semilogy(1:50, exp(0.2 * (1:50)));",
    "[X, Y] = meshgrid(linspace(-2, 2, 30)); Z = X .* exp(-X.^2 - Y.^2);"
    " surf(X, Y, Z); shading interp; camlight; lighting gouraud;",
    "[X, Y, Z] = meshgrid(linspace(-2, 2, 15)); V = X.^2 + Y.^2 + Z.^2;"
    " isosurface(X, Y, Z, V, 1.5);",
    "[x, y] = meshgrid(1:4); tri = delaunay(x(:), y(:));"
    " trisurf(tri, x(:), y(:), x(:) + y(:));",
    "fill3([0 1 1 0], [0 0 1 1], [0 0 1 1], 'r');",
    "t = 0:0.1:10; plot(t, exp(-t/3) .* sin(t)); hold on;"
    " plot(t, exp(-t/3), 'k:'); hold off; axis([0 10 -1 1]);",
]


def _session_figure(session_class, figs, src):
    figs.close_all()
    s = session_class(accelerate=False)
    r = s.execute(src)
    assert r.error is None, (src, r.error)
    fig = figs.current_figure()
    assert fig is not None, src
    return fig


@pytest.mark.parametrize("src", SOURCES)
def test_a_drawn_figure_renders_alike(src):
    try:
        want = _renders(JAX, _session_figure(JaxSession, jfig, src), 120_000)
        got = _renders(PORT, _session_figure(PortSession, tfig, src),
                       120_000)
    finally:
        jfig.close_all()
        tfig.close_all()
    for k in want:
        assert got[k] == want[k], (src, k)


# ----------------------------------------------------------- volumetric --- #

def _sphere_field(n=41, R=2.0):
    ax = np.linspace(-R, R, n)
    X, Y, Z = np.meshgrid(ax, ax, ax)
    return X, Y, Z, R - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)


def _same(want, got, path="") -> None:
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{path}[{i}]")
        return
    w, g = np.asarray(want), np.asarray(got)
    assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape)
    assert np.array_equal(g, w, equal_nan=w.dtype.kind in "fc"), path


def _isosurface(V, n):
    X, Y, Z, F = _sphere_field(n)
    return V.isosurface(X, Y, Z, F, 1.0)


def _isonormals(V):
    X, Y, Z, F = _sphere_field()
    v, _ = V.isosurface(X, Y, Z, F, 1.0)
    return V.isonormals(X, Y, Z, F, v)


def _trilinear(V):
    ax = np.linspace(0, 2, 5)
    X, Y, Z = np.meshgrid(ax, ax, ax)
    F = 2 * X + 3 * Y - Z + 0.5 * X * Y
    P = np.random.default_rng(0).random((50, 3)) * 2
    return V.trilinear(ax, ax, ax, F, P)


def _slices(V):
    X, Y, Z, F = _sphere_field(31)
    return V.slice_planes(X, Y, Z, F, 0.5, None, [0.0])


def _stream3(V):
    ax = np.linspace(-2, 2, 21)
    X, Y, Z = np.meshgrid(ax, ax, ax)
    return V.stream3(X, Y, Z, -Y, X, np.zeros_like(X), [[1.0, 0.0, 0.0]],
                     step=0.2, max_steps=400)


def _smooth3(method):
    def run(V):
        F = np.random.default_rng(1).random((9, 9, 9))
        return V.smooth3(F, method)
    return run


VOLUMETRIC = [
    ("isosurface", lambda V: _isosurface(V, 41)),
    ("isosurface-through-nodes", lambda V: _isosurface(V, 21)),
    ("isonormals", _isonormals),
    ("trilinear", _trilinear),
    ("slice-planes", _slices),
    ("stream3", _stream3),
    ("smooth3-box", _smooth3("box")),
    ("smooth3-gaussian", _smooth3("gaussian")),
]


@pytest.mark.parametrize("vid,run", VOLUMETRIC, ids=[v[0] for v in VOLUMETRIC])
def test_volume_algorithms_agree(vid, run):
    _same(run(jvol), run(tvol), vid)


def test_gouraud_triangle_and_decimation_stride_agree():
    cols = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    bufs = []
    for R in (jraster, traster):
        cv = R.Canvas(20, 20)
        cv.fill_tri(np.array([1.0, 18.0, 1.0]), np.array([1.0, 1.0, 18.0]),
                    cols)
        bufs.append(cv.buf)
    assert np.array_equal(bufs[0], bufs[1])
    for shape, cap in (((64, 64), 6000), ((1000, 1000), 6000), ((2, 2), 10)):
        assert tshade.stride_for(shape, cap) == jshade.stride_for(shape, cap)
