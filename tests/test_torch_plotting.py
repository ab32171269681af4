"""Plotting, control, image and graph modules in the port, held to the JAX package.

Every session-driven test of the JAX package's `tests/test_plotting.py`,
`test_plotting2.py`, `test_plot_shading.py`, `test_plot_volume.py`,
`test_control.py`, `test_misc2.py`, `test_domains_async.py`,
`test_graph2.py` and `test_sparse_graph_depth.py` runs with each of its
sessions a `torch_paired.PairedSession`: the same sources through both
packages' host sessions, output, errors, workspaces, the files they write
and the figures they touch held equal exactly. Left out, each set below
with its reason: the tests that drive the JAX package's server, the tests
that call the plot modules without a session (`test_torch_plot.py` holds
those modules to the JAX package's), a device-engine test
(`test_torch_cmap.py` runs it on both packages' engines) and a test that
builds its session inside itself (its scenario runs through both below).

Both packages keep their figures in module globals. An autouse fixture
runs `hold off` and `close all` in both packages' `plot.figure` before
and after every case, so no case leaves a figure or `hold on` behind for
another test on the same worker.
"""

import socket
import threading
import time

import numpy as np
import pytest

import runmat_tpu_torch
import test_control
import test_domains_async
import test_graph2
import test_misc2
import test_plot_interactive
import test_plot_shading
import test_plot_volume
import test_plotting
import test_plotting2
import test_sparse_graph_depth
import test_webgl_scene
from runmat_tpu.plot import figure as jax_figures
from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch import accel as taccel
from runmat_tpu_torch.plot import figure as port_figures
from runmat_tpu_torch.plot.svg import render_svg
from runmat_tpu_torch.session import Session as PortSession
from test_plot_shading import sess  # noqa: F401  (its cases' fixture)
from torch_both import no_engine  # noqa: F401
from torch_paired import run_paired, run_served_cli, session_tests

MODULES = (test_plotting, test_plotting2, test_plot_shading, test_plot_volume,
           test_control, test_misc2, test_domains_async, test_graph2,
           test_sparse_graph_depth, test_plot_interactive, test_webgl_scene)

# it makes the JAX package's CPU engine and a session with accelerate=True:
# the port gets TorchEngine("cpu"), and sin of its device array differs from
# XLA's CPU sin in the last bit (1 ulp at 12 of its 5000 values)
ENGINE = {"test_device_plot_single_gather"}
# it serves the figures of `run --show` from the JAX package's command line
# in a subprocess: run again with the port's (torch_paired.run_served_cli)
SERVED_CLI = {"test_run_show_serves_orbitable_figure"}
# they call plot/* without a session: tests/test_torch_plot.py holds the
# port's plot modules to the JAX package's on the same figures
DIRECT = {"test_lighting_modes_change_pixels", "test_stride_for_bounds_faces",
          "test_fill_tri_gouraud_interpolates",
          "test_isosurface_sphere_metrics",
          "test_isosurface_iso_through_grid_nodes_is_watertight",
          "test_isonormals_point_outward_on_sphere",
          "test_trilinear_exact_on_trilinear_function",
          "test_slice_planes_sample_field",
          "test_stream3_circular_field_closed_orbit",
          "test_smooth3_preserves_constants_and_smooths",
          "test_faceted_surface_exports_per_face_colors_and_edges",
          "test_interp_surface_shares_vertices",
          "test_gouraud_lighting_darkens_vertex_colors",
          "test_mesh_style_exports_colored_wireframe_only",
          "test_line_nan_breaks_segments",
          "test_scatter_exports_points_with_size",
          "test_trimesh_flat_lit_duplicates_interp_shares",
          "test_patch_fan_triangulation_with_vertex_colors",
          "test_decimation_caps_face_count",
          "test_ticks_normalized_and_labeled", "test_2d_axes_not_exported"}
# a device engine in both packages: tests/test_torch_cmap.py runs imagesc of
# a device array on JaxEngine("cpu") against TorchEngine("cpu")
DEVICE = {"test_imagesc_device_colormap_parity"}
# it imports the JAX package's Session inside itself:
# test_tcp_roundtrip_in_both below runs its scenario through both
OWN_SESSION = {"test_tcp_roundtrip"}

CASES = [(m, n) for m in MODULES for n in session_tests(m)
         if n not in DIRECT | DEVICE | OWN_SESSION]

# runtests' Duration is the clock
CLOCK = {"test_runtests": ("Duration",)}
# ARPACK starts from a random vector of its own whose state advances with
# every call in the process, so eigs and svds of a sparse matrix differ in
# their last bits from call to call in either package: within the JAX
# test's own 1e-9
NEAR = {"test_eigs_sparse_bridge_and_which_names": {"d": 1e-9, "r": 1e-9},
        "test_svds_sparse_and_smallest": {"s": 1e-9, "r": 1e-9}}


def _clean() -> None:
    for figs in (jax_figures, port_figures):
        for fig in figs._FIGURES.values():
            for ax in fig.axes:
                ax.hold = False          # hold off
        figs.close_all()                 # close all


@pytest.fixture(autouse=True)
def clean_figures(no_engine):
    # no engine active in either package (a test file run before on the
    # same worker may leave one), as the JAX tests expect
    _clean()
    yield
    _clean()


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, module, name):
    if name in SERVED_CLI:
        run_served_cli(request, monkeypatch, module, name)
        return
    run_paired(request, monkeypatch, module, name,
               clock=CLOCK.get(name, ()), near=NEAR.get(name),
               engine=name in ENGINE, ulps=1 if name in ENGINE else 0)


def _tcp_roundtrip(session_class) -> tuple:
    """tests/test_misc2.py:test_tcp_roundtrip's scenario in one package:
    a tcpserver on an ephemeral port, a client thread that sends a line
    and reads the reply."""
    s = session_class(accelerate=False)
    r1 = s.execute("srv = tcpserver(0);")
    assert r1.error is None, r1.error
    port = s.get("srv").sock.getsockname()[1]
    results = []

    def client():
        time.sleep(0.1)
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        c.sendall(b"hello\n")
        results.append(c.recv(100))
        c.close()

    t = threading.Thread(target=client)
    t.start()
    r2 = s.execute("conn = accept(srv); L = readline(conn); "
                   "write(conn, 'ack');")
    t.join()
    assert r2.error is None, r2.error
    return s.get("L").item(), results


def test_tcp_roundtrip_in_both():
    want = _tcp_roundtrip(JaxSession)
    assert want == ("hello", [b"ack"])
    assert _tcp_roundtrip(PortSession) == want


def test_device_plot_gathers_each_operand_once():
    """tests/test_plot_interactive.py:test_device_plot_single_gather's
    contract in the port, through Session alone: plot(x, y) of two device
    operands, the figure rendered twice, gathers each operand at most
    once."""
    prev = taccel.active_engine()
    try:
        s = runmat_tpu_torch.session("cpu")
        eng = taccel.active_engine()
        r = s.execute("close all; x = gpuArray(linspace(0, 6, 5000)); "
                      "y = sin(x);")
        assert r.error is None, r.error
        assert s.get("x").on_device and s.get("y").on_device
        g0 = eng.stats["gathers"]
        out = s.execute_request("plot(x, y);")
        assert out.ok and out.figures_touched == [1], out.error
        svg = [render_svg(port_figures.gcf()) for _ in range(2)]
        assert svg[0] == svg[1] and "<svg" in svg[0]
        gathers = eng.stats["gathers"] - g0
        assert 0 < gathers <= 2, f"{gathers} gathers for 2 device operands"
        line = port_figures.gca().children[-1]
        assert np.array_equal(line.y, s.get("y").host().reshape(-1))
    finally:
        runmat_tpu_torch.uninstall()
        taccel.set_engine(prev)
