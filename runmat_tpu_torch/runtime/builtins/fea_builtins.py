"""Copy of runmat_tpu/runtime/builtins/fea_builtins.py in the PyTorch port.

FEA builtin surface: meshing + the six pipelines, MATLAB-callable.

Reference parity: runmat-runtime/src/builtins/fea driving
runmat-analysis-fea (fea/src/lib.rs:16-21) and the meshing stack.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...fea import box_mesh
from ...fea import pipelines as P
from ...fea.mesh import TetMesh
from ...values import MatArray, StructArray, is_text, text_of
from ..registry import builtin


def _np(v):
    return v.host().astype(np.float64)


def _sc(v):
    return float(_np(v).reshape(-1)[0])


@builtin("femesh", category="fea", min_in=0, max_in=2)
def m_femesh(L=None, n=None):
    """mesh = femesh([Lx Ly Lz], [nx ny nz]) — structured box tet mesh."""
    Lv = tuple(_np(L).reshape(-1)[:3]) if L is not None else (1.0, 1.0, 1.0)
    nv = tuple(int(x) for x in _np(n).reshape(-1)[:3]) if n is not None \
        else (4, 4, 4)
    return box_mesh(Lv, nv)


@builtin("femesh_delaunay", category="fea", min_in=0, max_in=3)
def m_femesh_delaunay(L=None, h=None, seed=None):
    """mesh = femesh_delaunay([Lx Ly Lz], h[, seed]) — unstructured Delaunay
    tet mesh with target edge length h, smoothed + sliver-filtered
    (≙ runmat-meshing tetrahedron pipeline: generate -> optimize)."""
    from ...fea.delaunay import delaunay_mesh
    Lv = tuple(_np(L).reshape(-1)[:3]) if L is not None else (1.0, 1.0, 1.0)
    hv = float(_np(h).reshape(-1)[0]) if h is not None else min(Lv) / 4
    sd = int(_np(seed).reshape(-1)[0]) if seed is not None else 0
    return delaunay_mesh(Lv, hv, rng_seed=sd)


@builtin("femesh_info", category="fea", min_in=1, max_in=1)
def m_femesh_info(mesh):
    _check_mesh(mesh)
    q = mesh.quality()
    return StructArray.scalar({
        "nodes": MatArray.scalar(float(mesh.n_nodes)),
        "elements": MatArray.scalar(float(mesh.n_tets)),
        "min_quality": MatArray.scalar(float(q.min())),
        "mean_quality": MatArray.scalar(float(q.mean())),
        "volume": MatArray.scalar(float(np.abs(mesh.volumes()).sum())),
    })


def _check_mesh(mesh):
    if not isinstance(mesh, TetMesh):
        raise bad_arg("fea", "Expected a femesh object.")


def _fixed_nodes(mesh: TetMesh, spec) -> np.ndarray:
    """'x==0'-style face spec or explicit node indices (1-based)."""
    if is_text(spec):
        t = text_of(spec).replace(" ", "")
        axis = {"x": 0, "y": 1, "z": 2}.get(t[0])
        if axis is None or "==" not in t:
            raise bad_arg("fea", f"Bad boundary spec '{t}' (use e.g. 'x==0').")
        rhs = t.split("==")[1]
        if "L" in rhs:
            # 'x==L' means the far face; unstructured meshes have no dims
            extent = mesh.dims[axis] if mesh.dims is not None else \
                float(mesh.nodes[:, axis].max())
            rhs = rhs.replace("L", str(extent))
        return mesh.boundary_nodes(axis, float(rhs))
    return _np(spec).reshape(-1).astype(np.int64) - 1


@builtin("fea_linear_static", category="fea", min_in=5, max_in=5)
def m_fea_linear_static(mesh, E, nu, fixed, loads):
    """r = fea_linear_static(mesh, E, nu, 'x==0', [node fx fy fz; ...])"""
    _check_mesh(mesh)
    fn = _fixed_nodes(mesh, fixed)
    lv = _np(loads)
    if lv.ndim != 2 or lv.shape[1] != 4:
        raise bad_arg("fea_linear_static",
                      "Loads must be rows of [node fx fy fz].")
    forces = {int(r[0]) - 1: (r[1], r[2], r[3]) for r in lv}
    res = P.run_linear_static(mesh, _sc(E), _sc(nu), fn, forces)
    return StructArray.scalar({
        "displacement": MatArray(res["displacement"], "double"),
        "max_displacement": MatArray.scalar(res["max_displacement"]),
        "dofs": MatArray.scalar(float(res["dofs"])),
    })


@builtin("fea_modal", category="fea", min_in=5, max_in=6)
def m_fea_modal(mesh, E, nu, rho, fixed, nmodes=None):
    _check_mesh(mesh)
    fn = _fixed_nodes(mesh, fixed)
    k = int(_sc(nmodes)) if nmodes is not None else 4
    res = P.run_modal(mesh, _sc(E), _sc(nu), _sc(rho), fn, k)
    return StructArray.scalar({
        "frequencies_hz": MatArray(res["frequencies_hz"].reshape(-1, 1),
                                   "double"),
    })


@builtin("fea_thermal", category="fea", min_in=3, max_in=4)
def m_fea_thermal(mesh, k, bcs, heat=None):
    """r = fea_thermal(mesh, k, {'x==0', 100; 'x==L', 0}[, heat])"""
    _check_mesh(mesh)
    fixed = _bc_dict(mesh, bcs)
    res = P.run_thermal(mesh, _sc(k), fixed,
                        _sc(heat) if heat is not None else 0.0)
    return StructArray.scalar({
        "temperature": MatArray(res["temperature"].reshape(-1, 1), "double"),
        "max_temperature": MatArray.scalar(res["max_temperature"]),
        "min_temperature": MatArray.scalar(res["min_temperature"]),
    })


def _bc_dict(mesh, bcs) -> dict:
    from ...values import CellArray
    if not isinstance(bcs, CellArray):
        raise bad_arg("fea", "Boundary conditions must be a cell {spec, value}.")
    d = {}
    rows = bcs.data
    for r in range(rows.shape[0]):
        nodes = _fixed_nodes(mesh, rows[r, 0])
        val = _sc(rows[r, 1])
        for nidx in nodes:
            d[int(nidx)] = val
    return d


@builtin("fea_transient", category="fea", min_in=7, max_in=7)
def m_fea_transient(mesh, k, rho_c, bcs, T0, t_end, dt):
    _check_mesh(mesh)
    fixed = _bc_dict(mesh, bcs)
    res = P.run_transient(mesh, _sc(k), _sc(rho_c), fixed, _sc(T0),
                          _sc(t_end), _sc(dt))
    return StructArray.scalar({
        "temperature": MatArray(res["temperature"].reshape(-1, 1), "double"),
        "steps": MatArray.scalar(float(res["steps"])),
    })


@builtin("fea_nonlinear", category="fea", min_in=5, max_in=6)
def m_fea_nonlinear(mesh, E, nu, fixed, loads, nincr=None):
    _check_mesh(mesh)
    fn = _fixed_nodes(mesh, fixed)
    lv = _np(loads)
    forces = {int(r[0]) - 1: (r[1], r[2], r[3]) for r in lv}
    res = P.run_nonlinear(mesh, _sc(E), _sc(nu), fn, forces,
                          int(_sc(nincr)) if nincr is not None else 5)
    return StructArray.scalar({
        "displacement": MatArray(res["displacement"], "double"),
        "max_displacement": MatArray.scalar(res["max_displacement"]),
    })


@builtin("fea_electrostatic", category="fea", min_in=3, max_in=3)
def m_fea_electrostatic(mesh, eps, bcs):
    _check_mesh(mesh)
    fixed = _bc_dict(mesh, bcs)
    res = P.run_electromagnetic(mesh, _sc(eps), fixed)
    return StructArray.scalar({
        "potential": MatArray(res["potential"].reshape(-1, 1), "double"),
        "max_field": MatArray.scalar(res["max_field"]),
    })


@builtin("fea_node_coords", category="fea", min_in=1, max_in=1)
def m_fea_node_coords(mesh):
    _check_mesh(mesh)
    return MatArray(mesh.nodes.copy(), "double")


@builtin("fea_boundary_nodes", category="fea", min_in=2, max_in=2)
def m_fea_boundary_nodes(mesh, spec):
    _check_mesh(mesh)
    return MatArray((_fixed_nodes(mesh, spec) + 1.0).reshape(-1, 1), "double")


@builtin("fea_buckling", category="fea", min_in=5, max_in=6)
def m_fea_buckling(mesh, E, nu, fixed, loads, nmodes=None):
    """r = fea_buckling(mesh, E, nu, 'z==0', [node fx fy fz; ...][, k]):
    linear eigenvalue buckling — load multipliers of the applied load
    (fea/pipelines.py run_buckling; extends the reference's six-pipeline
    surface, runmat-analysis/fea/src/lib.rs:16-21)."""
    _check_mesh(mesh)
    fn = _fixed_nodes(mesh, fixed)
    lv = _np(loads)
    if lv.ndim != 2 or lv.shape[1] != 4:
        raise bad_arg("fea_buckling", "Loads must be rows of [node fx fy fz].")
    forces = {int(r[0]) - 1: (r[1], r[2], r[3]) for r in lv}
    k = int(_sc(nmodes)) if nmodes is not None else 4
    res = P.run_buckling(mesh, _sc(E), _sc(nu), fn, forces, k)
    return StructArray.scalar({
        "load_factors": MatArray(res["load_factors"].reshape(-1, 1),
                                 "double"),
        "critical_load_factor": MatArray.scalar(res["critical_load_factor"]),
    })


@builtin("fea_harmonic", category="fea", min_in=7, max_in=9)
def m_fea_harmonic(mesh, E, nu, rho, fixed, loads, freqs,
                   damping=None, nmodes=None):
    """r = fea_harmonic(mesh, E, nu, rho, 'z==0', loads, freqs_hz
    [, zeta, nmodes]): modal-superposition frequency response
    (fea/pipelines.py run_harmonic)."""
    _check_mesh(mesh)
    fn = _fixed_nodes(mesh, fixed)
    lv = _np(loads)
    if lv.ndim != 2 or lv.shape[1] != 4:
        raise bad_arg("fea_harmonic", "Loads must be rows of [node fx fy fz].")
    forces = {int(r[0]) - 1: (r[1], r[2], r[3]) for r in lv}
    fz = _np(freqs).reshape(-1)
    zeta = _sc(damping) if damping is not None else 0.02
    k = int(_sc(nmodes)) if nmodes is not None else 20
    res = P.run_harmonic(mesh, _sc(E), _sc(nu), _sc(rho), fn, forces, fz,
                         damping=zeta, n_modes=k)
    return StructArray.scalar({
        "frequencies_hz": MatArray(res["frequencies_hz"].reshape(-1, 1),
                                   "double"),
        "peak_amplitude": MatArray(res["peak_amplitude"].reshape(-1, 1),
                                   "double"),
        "probe_amplitude": MatArray(res["probe_amplitude"], "double"),
        "modal_frequencies_hz": MatArray(
            res["modal_frequencies_hz"].reshape(-1, 1), "double"),
    })
