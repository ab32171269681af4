"""Copy of runmat_tpu/runtime/builtins/fea2.py in the PyTorch port.

Typed FEA study-document API (`fea.*` namespace) + `geometry.*` queries.

Reference parity: runmat-runtime/src/builtins/fea/mod.rs (fea.load/study/
authorStudy/sweep/model/material/materialAssignment/boundaryCondition/
loadCase/step/domain/interface/runOptions/validate/plan/run/results/field/
plot/compare/trends) and builtins/geometry/ (geometry.load/inspect/
listRegions/meshes). The typed objects are structs with a `_fea` type tag;
fea.run drives the existing runmat_tpu.fea pipelines (batched TET4 assembly
on device). Run artifacts persist to an on-disk registry so fea.compare /
fea.trends work across sessions (≙ the reference's evidence artifacts).
"""

from __future__ import annotations

import json
import re
import time
import uuid

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, FunctionHandle, MatArray, StructArray,
                       fortran_ravel, is_text, text_of)
from ..registry import builtin
from .common import scalar_int


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _sc(v) -> float:
    return float(_f(v).reshape(-1)[0])


def _tagged(kind: str, fields: dict) -> StructArray:
    out = {"_fea": MatArray.char_from_str(kind)}
    out.update(fields)
    return StructArray.scalar(out)


def _tag_of(v) -> str:
    if isinstance(v, StructArray) and v.is_scalar and "_fea" in v.fields:
        return v.get_scalar_field("_fea").to_str()
    return ""


def _require(v, kind: str, what: str):
    if _tag_of(v) != kind:
        raise MatError("RunMat:fea:InvalidArgument",
                       f"fea: expected a {kind} object for {what}.")
    return v


# --------------------------------------------------------------- authoring --- #

@builtin("fea_material", category="fea", min_in=0)
def m_fea_material(*pairs):
    fields = {"E": MatArray.scalar(210e9), "nu": MatArray.scalar(0.3),
              "rho": MatArray.scalar(7800.0), "k": MatArray.scalar(45.0),
              "name": MatArray.char_from_str("steel")}
    i = 0
    pairs = list(pairs)
    while i + 1 < len(pairs):
        fields[text_of(pairs[i])] = pairs[i + 1]
        i += 2
    return _tagged("material", fields)


@builtin("fea_materialAssignment", category="fea", min_in=2, max_in=2)
def m_fea_material_assignment(material, region):
    _require(material, "material", "materialAssignment")
    return _tagged("materialAssignment",
                   {"material": material, "region": region})


@builtin("fea_boundaryCondition", category="fea", min_in=2)
def m_fea_boundary_condition(kind, where, value=None):
    return _tagged("boundaryCondition", {
        "kind": kind if is_text(kind) else MatArray.char_from_str("fixed"),
        "where": where,
        "value": value if value is not None else MatArray.scalar(0.0)})


@builtin("fea_load", category="fea", min_in=2)
def m_fea_load(kind, where, value=None):
    return _tagged("load", {
        "kind": kind, "where": where,
        "value": value if value is not None else MatArray.scalar(0.0)})


@builtin("fea_loadCase", category="fea", min_in=0)
def m_fea_load_case(*loads):
    data = np.empty((len(loads), 1), dtype=object)
    for i, l in enumerate(loads):
        data[i, 0] = l
    return _tagged("loadCase", {"loads": CellArray(data)})


@builtin("fea_step", category="fea", min_in=1)
def m_fea_step(physics, *pairs):
    fields = {"physics": physics}
    i = 0
    pairs = list(pairs)
    while i + 1 < len(pairs):
        fields[text_of(pairs[i])] = pairs[i + 1]
        i += 2
    return _tagged("step", fields)


@builtin("fea_domain", category="fea", min_in=1)
def m_fea_domain(physics, *pairs):
    return _tagged("domain", {"physics": physics})


@builtin("fea_interface", category="fea", min_in=2)
def m_fea_interface(a, b, *pairs):
    return _tagged("interface", {"a": a, "b": b})


@builtin("fea_runOptions", category="fea", min_in=0)
def m_fea_run_options(*pairs):
    fields = {"solver": MatArray.char_from_str("direct"),
              "tolerance": MatArray.scalar(1e-9),
              "maxIterations": MatArray.scalar(2000.0)}
    i = 0
    pairs = list(pairs)
    while i + 1 < len(pairs):
        fields[text_of(pairs[i])] = pairs[i + 1]
        i += 2
    return _tagged("runOptions", fields)


@builtin("fea_model", category="fea", min_in=1)
def m_fea_model(geometry, *components):
    mats, bcs, loads, steps = [], [], [], []
    for c in components:
        t = _tag_of(c)
        if t in ("material", "materialAssignment"):
            mats.append(c)
        elif t == "boundaryCondition":
            bcs.append(c)
        elif t in ("load", "loadCase"):
            loads.append(c)
        elif t == "step":
            steps.append(c)

    def cell(items):
        d = np.empty((len(items), 1), dtype=object)
        for i, x in enumerate(items):
            d[i, 0] = x
        return CellArray(d)

    return _tagged("model", {"geometry": geometry, "materials": cell(mats),
                             "boundaryConditions": cell(bcs),
                             "loads": cell(loads), "steps": cell(steps)})


@builtin("fea_study", category="fea", min_in=1)
def m_fea_study(model, *rest):
    _require(model, "model", "study")
    physics = "linear_static"
    opts = None
    for r in rest:
        if is_text(r):
            physics = text_of(r)
        elif _tag_of(r) == "runOptions":
            opts = r
        elif _tag_of(r) == "step":
            p = r.get_scalar_field("physics")
            physics = text_of(p) if is_text(p) else physics
    return _tagged("study", {
        "model": model,
        "physics": MatArray.char_from_str(physics),
        "options": opts if opts is not None else m_fea_run_options()})


@builtin("fea_authorStudy", category="fea", min_in=1)
def m_fea_author_study(evidence, *rest):
    """Author a study from compact mesh-authoring evidence (a struct with
    box + resolution, the minimal evidence contract)."""
    if not isinstance(evidence, StructArray):
        raise bad_arg("fea.authorStudy", "Expected an evidence struct.")
    model = m_fea_model(evidence, m_fea_material())
    return m_fea_study(model)


@builtin("fea_sweep", category="fea", min_in=1)
def m_fea_sweep(*studies):
    data = np.empty((len(studies), 1), dtype=object)
    for i, s in enumerate(studies):
        _require(s, "study", "sweep")
        data[i, 0] = s
    return _tagged("sweep", {"studies": CellArray(data)})


# ---------------------------------------------------------------- documents --- #

@builtin("fea_load_doc", category="fea", min_in=1, max_in=1)
def m_fea_load_doc(path):
    """Load a .fea study document (JSON: geometry box + physics + bcs)."""
    from ...fs import fs
    doc = json.loads(fs().read_bytes(text_of(path)).decode("utf-8"))
    geom = StructArray.scalar({
        "box": MatArray(np.array([doc.get("box", [1.0, 1.0, 1.0])]), "double"),
        "resolution": MatArray.scalar(float(doc.get("resolution", 4))),
    })
    mat = m_fea_material()
    model = m_fea_model(geom, mat)
    study = m_fea_study(model, MatArray.char_from_str(
        doc.get("physics", "linear_static")))
    return study


# ------------------------------------------------------------------ running --- #

def _geometry_mesh_with_surface(geom):
    """Mesh a geometry struct. Returns (TetMesh, surf) where surf is
    (verts, faces, face_ids) for tessellated B-rep geometries (enables
    face:N boundary-condition selection) or None for box specs."""
    from ...fea.mesh import box_mesh
    if isinstance(geom, StructArray) and geom.is_scalar \
            and "vertices" in geom.fields:
        v = _f(geom.get_scalar_field("vertices"))
        f = _f(geom.get_scalar_field("faces")).astype(np.int64) - 1
        fids = None
        if "faceIds" in geom.fields:
            fids = fortran_ravel(
                _f(geom.get_scalar_field("faceIds"))).astype(np.int64)
        ext = float((v.max(axis=0) - v.min(axis=0)).max())
        h = ext / 6.0
        if "resolution" in geom.fields:
            h = _sc(geom.get_scalar_field("resolution")) or h
        try:
            from ...fea.cavity import mesh_plc
            mesh = mesh_plc(v, f, h=h)
            if mesh.tets.size == 0:
                raise ValueError("empty cavity mesh")
        except Exception:
            from ...fea import surface as surf_mod
            mesh = surf_mod.mesh_surface(v, f, h)
        return mesh, (v, f, fids)
    box = [1.0, 1.0, 1.0]
    res = 4
    if isinstance(geom, StructArray) and geom.is_scalar:
        if "box" in geom.fields:
            box = [float(x) for x in
                   fortran_ravel(_f(geom.get_scalar_field("box")))]
        if "resolution" in geom.fields:
            res = int(_sc(geom.get_scalar_field("resolution")))
    return box_mesh(tuple(box[:3]), (res, res, res)), None


def _geometry_mesh(geom):
    return _geometry_mesh_with_surface(geom)[0]


class _Selector:
    """Resolve BC/load 'where' selectors to mesh node sets.

    Supported: 'face:N' (B-rep face identity from STEP import — the
    selection tier of ≙ runmat-geometry/core diagnostics), plane
    selectors 'x=0' / 'x=min' / 'x=max' (likewise y, z), and explicit
    1-based node index arrays."""

    def __init__(self, mesh, surf):
        self.mesh = mesh
        self.surf = surf
        self._face_sets = None

    def face_sets(self):
        if self._face_sets is None:
            if self.surf is None or self.surf[2] is None:
                raise MatError(
                    "RunMat:fea:NoFaceIds",
                    "face:N selectors need a geometry with B-rep face "
                    "identities (geometry.load of a STEP part).")
            from ...fea.select import face_node_sets
            v, f, fids = self.surf
            self._face_sets = face_node_sets(self.mesh.nodes, v, f, fids)
        return self._face_sets

    def nodes(self, where):
        if is_text(where):
            txt = text_of(where).strip().lower()
            if txt.startswith("face:"):
                fid = int(txt[5:])
                sets = self.face_sets()
                if fid not in sets:
                    raise MatError(
                        "RunMat:fea:UnknownFace",
                        f"No mesh nodes on face:{fid}; known faces: "
                        + ", ".join(str(k) for k in sorted(sets)))
                return sets[fid]
            m = re.match(r"^([xyz])\s*={1,2}\s*(min|max|[-+0-9.eE]+)$", txt)
            if m:
                ax = "xyz".index(m.group(1))
                col = self.mesh.nodes[:, ax]
                span = float(col.max() - col.min()) or 1.0
                val = {"min": col.min(), "max": col.max()}.get(
                    m.group(2), None)
                if val is None:
                    val = float(m.group(2))
                return np.where(np.abs(col - val) < 1e-9 * span + 1e-12)[0]
            raise MatError("RunMat:fea:BadSelector",
                           f"Unrecognized selector '{text_of(where)}'.")
        idx = fortran_ravel(_f(where)).astype(np.int64) - 1
        return idx


def _authored_conditions(model, sel):
    """Collect user-authored BCs/loads off the model; None per slot means
    'not authored' (callers keep the canonical defaults)."""
    out = {"fixed": None, "forces": None, "temp": None, "volt": None}
    bcs = model.get_scalar_field("boundaryConditions")
    for bc in bcs.data.reshape(-1):
        kind = text_of(bc.get_scalar_field("kind")).lower()
        nodes = sel.nodes(bc.get_scalar_field("where"))
        val = bc.get_scalar_field("value")
        if kind in ("fixed", "clamp", "displacement"):
            prev = out["fixed"] if out["fixed"] is not None \
                else np.array([], dtype=np.int64)
            out["fixed"] = np.unique(np.concatenate([prev, nodes]))
        elif kind in ("temperature", "temp"):
            t = out["temp"] or {}
            t.update({int(i): _sc(val) for i in nodes})
            out["temp"] = t
        elif kind in ("voltage", "potential"):
            vdict = out["volt"] or {}
            vdict.update({int(i): _sc(val) for i in nodes})
            out["volt"] = vdict
    loads = model.get_scalar_field("loads")
    items = []
    for ld in loads.data.reshape(-1):
        if _tag_of(ld) == "loadCase":
            items += list(ld.get_scalar_field("loads").data.reshape(-1))
        else:
            items.append(ld)
    for ld in items:
        kind = text_of(ld.get_scalar_field("kind")).lower()
        if kind not in ("force", "traction", "pressure"):
            continue
        nodes = sel.nodes(ld.get_scalar_field("where"))
        if nodes.size == 0:
            continue
        vec = fortran_ravel(_f(ld.get_scalar_field("value")))
        if vec.size < 3:
            vec = np.array([0.0, 0.0, float(vec[0]) if vec.size else 0.0])
        per = vec[:3] / nodes.size
        f = out["forces"] or {}
        for i in nodes:
            old = f.get(int(i), (0.0, 0.0, 0.0))
            f[int(i)] = (old[0] + per[0], old[1] + per[1], old[2] + per[2])
        out["forces"] = f
    return out


def _run_registry_path() -> str:
    import os
    return os.path.expanduser("~/.runmat_tpu/fea_runs.json")


def _load_runs() -> list:
    from ...fs import fs
    try:
        return json.loads(fs().read_bytes(_run_registry_path()).decode("utf-8"))
    except Exception:
        return []


def _save_runs(runs: list) -> None:
    import os
    from ...fs import fs
    fs().mkdir(os.path.dirname(_run_registry_path()))
    fs().write_bytes(_run_registry_path(), json.dumps(runs).encode("utf-8"))


@builtin("fea_validate", category="fea", min_in=1, max_in=1)
def m_fea_validate(study):
    issues = []
    t = _tag_of(study)
    if t == "sweep":
        return _tagged("validation", {"valid": MatArray.logical_scalar(True),
                                      "issues": CellArray.empty()})
    if t != "study":
        issues.append("not a study object")
    else:
        model = study.get_scalar_field("model")
        if model.get_scalar_field("materials").size == 0:
            issues.append("no materials assigned")
    data = np.empty((len(issues), 1), dtype=object)
    for i, s in enumerate(issues):
        data[i, 0] = MatArray.char_from_str(s)
    return _tagged("validation", {
        "valid": MatArray.logical_scalar(not issues),
        "issues": CellArray(data)})


@builtin("fea_plan", category="fea", min_in=1, max_in=1)
def m_fea_plan(study):
    _require(study, "study", "plan")
    model = study.get_scalar_field("model")
    mesh = _geometry_mesh(model.get_scalar_field("geometry"))
    return _tagged("plan", {
        "physics": study.get_scalar_field("physics"),
        "numNodes": MatArray.scalar(float(mesh.nodes.shape[0])),
        "numElements": MatArray.scalar(float(mesh.tets.shape[0])),
        "dofs": MatArray.scalar(float(mesh.nodes.shape[0] * 3)),
    })


def _first_material(model):
    mats = model.get_scalar_field("materials")
    if mats.size == 0:
        return m_fea_material()
    m = mats.data.reshape(-1)[0]
    if _tag_of(m) == "materialAssignment":
        m = m.get_scalar_field("material")
    return m


def _structural_field_arrays(r: dict) -> dict:
    """Recovered structural fields -> MATLAB result-struct entries
    (≙ post/fields.rs AnalysisField names)."""
    out = {}
    names = {"stress": "stress", "strain": "strain",
             "von_mises": "vonMises", "nodal_von_mises": "nodalVonMises",
             "principal": "principalStress",
             "strain_energy_density": "strainEnergyDensity",
             "reactions": "reactions"}
    for key, mname in names.items():
        if key in r:
            a = np.asarray(r[key], np.float64)
            if a.ndim == 1:
                a = a.reshape(-1, 1)
            out[mname] = MatArray(a, "double")
    if "total_strain_energy" in r:
        out["totalStrainEnergy"] = MatArray.scalar(
            float(r["total_strain_energy"]))
    return out


@builtin("fea_run", category="fea", min_in=1, max_in=2, pass_ctx=True)
def m_fea_run(study, opts=None, ctx=None):
    from ...fea import pipelines as P
    t = _tag_of(study)
    if t == "sweep":
        studies = study.get_scalar_field("studies")
        results = np.empty((studies.size, 1), dtype=object)
        for i, s in enumerate(studies.data.reshape(-1)):
            results[i, 0] = m_fea_run(s, opts, ctx=ctx)
        return _tagged("sweepResult", {"runs": CellArray(results)})
    _require(study, "study", "run")
    model = study.get_scalar_field("model")
    physics = study.get_scalar_field("physics").to_str()
    mesh, surf = _geometry_mesh_with_surface(
        model.get_scalar_field("geometry"))
    mat = _first_material(model)
    E = _sc(mat.get_scalar_field("E"))
    nu = _sc(mat.get_scalar_field("nu"))
    rho = _sc(mat.get_scalar_field("rho"))
    kth = _sc(mat.get_scalar_field("k"))
    t0 = time.perf_counter()
    # canonical study boundary conditions: clamp the x=0 face, load the
    # free-end nodes (x = max) downward — authored BCs/loads on the model
    # (including face:N selectors against B-rep face IDs) override these.
    fixed_nodes = np.where(mesh.nodes[:, 0] < 1e-12)[0]
    free_end = np.where(mesh.nodes[:, 0] >= mesh.nodes[:, 0].max() - 1e-12)[0]
    forces = {int(i): (0.0, 0.0, -1e4 / max(free_end.size, 1))
              for i in free_end}
    fixed_temp = {int(i): 300.0 for i in fixed_nodes}
    sel = _Selector(mesh, surf)
    authored = _authored_conditions(model, sel)
    if authored["fixed"] is not None:
        fixed_nodes = authored["fixed"]
    if authored["forces"] is not None:
        forces = authored["forces"]
    if authored["temp"] is not None:
        fixed_temp = authored["temp"]
    if physics in ("linear_static", "static"):
        r = P.run_linear_static(mesh, E, nu, fixed_nodes, forces)
        fields = {"displacement": MatArray(r["displacement"], "double")}
        fields.update(_structural_field_arrays(r))
    elif physics == "modal":
        r = P.run_modal(mesh, E, nu, rho, fixed_nodes, n_modes=4)
        fields = {"frequencies": MatArray(
            np.asarray(r["frequencies_hz"]).reshape(-1, 1), "double")}
    elif physics == "thermal":
        r = P.run_thermal(mesh, kth, fixed_temp, heat=100.0)
        fields = {"temperature": MatArray(
            np.asarray(r["temperature"]).reshape(-1, 1), "double"),
            "flux": MatArray(np.asarray(r["flux"]), "double"),
            "nodalFlux": MatArray(np.asarray(r["nodal_flux"]), "double")}
    elif physics == "transient":
        r = P.run_transient(mesh, kth, rho * 450.0, fixed_temp,
                            T0=300.0, t_end=1.0, dt=0.1)
        fields = {"temperature": MatArray(
            np.asarray(r["temperature"]).reshape(-1, 1), "double")}
    elif physics == "nonlinear":
        r = P.run_nonlinear(mesh, E, nu, fixed_nodes, forces, n_increments=3)
        fields = {"displacement": MatArray(r["displacement"], "double")}
        fields.update(_structural_field_arrays(r))
    elif physics in ("thermomechanical", "thermo_mechanical", "coupled"):
        hot_end = {int(i): 400.0 for i in free_end}
        temps = dict(fixed_temp)
        temps.update(hot_end)
        r = P.run_thermomechanical(mesh, E, nu, alpha=1.2e-5, k=kth,
                                   fixed_nodes=fixed_nodes,
                                   fixed_temp=temps, T_ref=300.0)
        fields = {"temperature": MatArray(
            np.asarray(r["temperature"]).reshape(-1, 1), "double"),
            "displacement": MatArray(r["displacement"], "double")}
    elif physics in ("electromagnetic", "electrostatic"):
        em_fixed = {int(i): 0.0 for i in fixed_nodes}
        em_fixed.update({int(i): 1.0 for i in free_end})
        if authored["volt"] is not None:
            em_fixed = authored["volt"]
        r = P.run_electromagnetic(mesh, 8.854e-12, em_fixed)
        fields = {"potential": MatArray(
            np.asarray(r["potential"]).reshape(-1, 1), "double")}
    else:
        raise MatError("RunMat:fea:UnknownPhysics",
                       f"fea: unknown physics '{physics}'.")
    wall = time.perf_counter() - t0
    run_id = uuid.uuid4().hex[:12]
    summary = {k: float(np.max(np.abs(v.host()))) for k, v in fields.items()}
    runs = _load_runs()
    runs.append({"run_id": run_id, "physics": physics, "wall_s": wall,
                 "when": time.time(), "summary": summary,
                 "nodes": int(mesh.nodes.shape[0])})
    _save_runs(runs[-200:])
    geom = model.get_scalar_field("geometry")
    spec = {"physics": physics, "E": E, "nu": nu, "rho": rho, "k": kth,
            "box": [1.0, 1.0, 1.0], "resolution": 4}
    if isinstance(geom, StructArray) and geom.is_scalar:
        if "box" in geom.fields:
            spec["box"] = [float(x) for x in
                           fortran_ravel(_f(geom.get_scalar_field("box")))]
        if "resolution" in geom.fields:
            spec["resolution"] = int(_sc(geom.get_scalar_field(
                "resolution")))
    out = {"_fea": MatArray.char_from_str("runResult"),
           "runId": MatArray.char_from_str(run_id),
           "physics": MatArray.char_from_str(physics),
           "wallTime": MatArray.scalar(wall),
           "spec": MatArray.char_from_str(json.dumps(spec)),
           "mesh": StructArray.scalar({
               "nodes": MatArray(mesh.nodes, "double"),
               "elements": MatArray(mesh.tets.astype(np.float64) + 1, "double"),
           })}
    out.update(fields)
    return StructArray(
        {k: np.array([[v]], dtype=object) for k, v in out.items()}, (1, 1))


@builtin("fea_results", category="fea", min_in=1, max_in=1)
def m_fea_results(run):
    if _tag_of(run) in ("runResult", "sweepResult"):
        return run
    raise bad_arg("fea.results", "Expected a run result.")


@builtin("fea_field", category="fea", min_in=2, max_in=2)
def m_fea_field(run, name):
    key = text_of(name)
    if isinstance(run, StructArray) and key in run.fields:
        return run.get_scalar_field(key)
    raise MatError("RunMat:fea:NoField", f"fea: no field '{key}' in results.")


@builtin("fea_plot", category="fea", min_in=2, max_in=2, pass_ctx=True)
def m_fea_plot(run, name, ctx=None):
    """Render the mesh boundary surface colored by the (nodal) field —
    element fields are averaged to nodes first (≙ the reference's field
    visualization through the runmat-plot patch pipeline)."""
    field = m_fea_field(run, name)
    h = field.host().astype(np.float64)
    mesh = run.get_scalar_field("mesh")
    nodes = mesh.get_scalar_field("nodes").host().astype(np.float64)
    tets = mesh.get_scalar_field("elements").host().astype(np.int64) - 1
    mag = np.linalg.norm(h, axis=1) if h.ndim == 2 and h.shape[1] > 1 \
        else h.reshape(-1)
    if mag.size == tets.shape[0]:                 # element field -> nodal
        from ...fea.mesh import TetMesh
        from ...fea.post import nodal_average
        mag = nodal_average(TetMesh(nodes, tets, None, None), mag)
    # boundary triangles: tet faces seen exactly once
    faces = np.concatenate([tets[:, c] for c in
                            ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))])
    key = np.sort(faces, axis=1)
    uniq, inv, cnt = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    bfaces = faces[np.nonzero(cnt[inv] == 1)[0]]
    from ...plot import figure as figmod
    from .plotting import _prep_ax
    ax = _prep_ax()
    ax.is3d = True
    if mag.size == nodes.shape[0] and bfaces.size:
        t = figmod.TriMesh(nodes, bfaces, cvals=mag, style="interp")
        ax.add(t)
        ax.clim = (float(np.nanmin(mag)), float(np.nanmax(mag)))
    else:                                         # fallback: node cloud
        ctx.interp.call_named("scatter3", [
            MatArray(nodes[:, 0].reshape(-1, 1), "double"),
            MatArray(nodes[:, 1].reshape(-1, 1), "double"),
            MatArray(nodes[:, 2].reshape(-1, 1), "double")], 0, ctx.frame)
    figmod.bump_rev()
    return MatArray(mag.reshape(-1, 1), "double")


@builtin("fea_compare", category="fea", min_in=2, max_in=2)
def m_fea_compare(id_a, id_b):
    runs = {r["run_id"]: r for r in _load_runs()}
    a = runs.get(text_of(id_a))
    b = runs.get(text_of(id_b))
    if a is None or b is None:
        raise MatError("RunMat:fea:UnknownRun", "fea.compare: unknown run id.")
    keys = sorted(set(a["summary"]) | set(b["summary"]))
    diffs = {k: MatArray.scalar(abs(a["summary"].get(k, 0.0)
                                    - b["summary"].get(k, 0.0)))
             for k in keys}
    return _tagged("comparison", {
        "runA": MatArray.char_from_str(a["run_id"]),
        "runB": MatArray.char_from_str(b["run_id"]),
        "samePhysics": MatArray.logical_scalar(a["physics"] == b["physics"]),
        "maxAbsDiff": StructArray.scalar(diffs)})


@builtin("fea_trends", category="fea", min_in=0, max_in=1)
def m_fea_trends(n=None):
    k = scalar_int(n, "n") if n is not None else 10
    runs = _load_runs()[-k:]
    m = len(runs)
    fields = {"runId": np.empty((m, 1), dtype=object),
              "physics": np.empty((m, 1), dtype=object),
              "wallTime": np.empty((m, 1), dtype=object)}
    for i, r in enumerate(runs):
        fields["runId"][i, 0] = MatArray.char_from_str(r["run_id"])
        fields["physics"][i, 0] = MatArray.char_from_str(r["physics"])
        fields["wallTime"][i, 0] = MatArray.scalar(r["wall_s"])
    return StructArray(fields, (m, 1))


# ------------------------------------------------- evidence / governance --- #

def _field_digest(arr: np.ndarray) -> str:
    """Replay-stable digest: canonicalize to 9 significant digits (absorbs
    LAPACK/iteration noise across replays on one platform) then sha256
    (≙ the reference's artifact trust chain, scripts/fea/{governance,
    thermo_artifacts} + CI artifact-replay stability, ci.yml:326-332)."""
    import hashlib
    a = np.asarray(arr, dtype=np.float64).reshape(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        mag = np.where(a == 0, 1.0, np.power(
            10.0, 8 - np.floor(np.log10(np.abs(np.where(a == 0, 1.0, a))))))
    canon = np.round(a * mag) / mag
    canon[~np.isfinite(a)] = 0.0
    return hashlib.sha256(canon.tobytes()).hexdigest()


def _evidence_payload(run) -> dict:
    spec = json.loads(run.get_scalar_field("spec").to_str())
    mesh = run.get_scalar_field("mesh")
    nodes = _f(mesh.get_scalar_field("nodes"))
    elems = _f(mesh.get_scalar_field("elements"))
    fields = {}
    for name in run.fields:
        if name in ("_fea", "runId", "physics", "wallTime", "spec", "mesh"):
            continue
        v = run.get_scalar_field(name)
        if isinstance(v, MatArray):
            h = v.host()
            fields[name] = {"shape": list(h.shape),
                            "digest": _field_digest(h),
                            "max_abs": float(np.max(np.abs(h)))
                            if h.size else 0.0}
    import platform as plat
    payload = {
        "schema": "runmat-tpu.fea.evidence/1",
        "runId": run.get_scalar_field("runId").to_str(),
        "physics": run.get_scalar_field("physics").to_str(),
        "spec": spec,
        "mesh": {"n_nodes": int(nodes.shape[0]),
                 "n_tets": int(elems.shape[0]),
                 "digest": _field_digest(nodes)},
        "fields": fields,
        "env": {"python": plat.python_version(), "numpy": np.__version__,
                "machine": plat.machine()},
    }
    return payload


@builtin("fea_evidence", category="fea", min_in=2, max_in=2)
def m_fea_evidence(run, path):
    """fea.evidence(run, path): write a content-hashed evidence artifact for
    a run — spec, mesh/field digests, environment manifest, and a hash
    chained to the previous artifact in the local registry (tamper-evident
    provenance; ≙ scripts/fea/governance generate_*/validate_* pairs)."""
    import hashlib
    from ...fs import fs
    if _tag_of(run) != "runResult":
        raise bad_arg("fea.evidence", "Expected a run result.")
    payload = _evidence_payload(run)
    chain_path = _run_registry_path().replace("fea_runs.json",
                                              "fea_evidence_chain.json")
    try:
        parent = json.loads(fs().read_bytes(chain_path).decode())["head"]
    except Exception:
        parent = None
    payload["chain"] = {"parent": parent}
    digest = hashlib.sha256(json.dumps(payload, sort_keys=True)
                            .encode()).hexdigest()
    payload["chain"]["hash"] = digest
    fs().write_bytes(text_of(path), json.dumps(payload, indent=1).encode())
    import os as _os
    fs().mkdir(_os.path.dirname(chain_path))
    fs().write_bytes(chain_path, json.dumps({"head": digest}).encode())
    return StructArray.scalar({"hash": MatArray.char_from_str(digest),
                               "path": path})


@builtin("fea_verifyEvidence", category="fea", min_in=1, max_in=1,
         pass_ctx=True)
def m_fea_verify_evidence(path, ctx=None):
    """fea.verifyEvidence(path): validate an evidence artifact — recompute
    the chain hash, re-run the recorded study spec, and compare field
    digests (replay stability; ≙ governance validate_* + CI
    artifact-replay job)."""
    import hashlib
    from ...fs import fs
    doc = json.loads(fs().read_bytes(text_of(path)).decode())
    problems: list = []
    recorded = doc.get("chain", {}).get("hash")
    probe = json.loads(json.dumps(doc))
    probe["chain"].pop("hash", None)
    recomputed = hashlib.sha256(json.dumps(probe, sort_keys=True)
                                .encode()).hexdigest()
    if recorded != recomputed:
        problems.append("chain hash mismatch (artifact was modified)")
    spec = doc["spec"]
    geom = StructArray.scalar({
        "box": MatArray(np.array([spec["box"]]), "double"),
        "resolution": MatArray.scalar(float(spec["resolution"]))})
    # replay with the RECORDED material, not defaults — a non-default E/nu
    # run must verify against itself
    mat_args = []
    for key in ("E", "nu", "rho", "k"):
        if key in spec:
            mat_args += [MatArray.char_from_str(key),
                         MatArray.scalar(float(spec[key]))]
    model = m_fea_model(geom, m_fea_material(*mat_args))
    study = m_fea_study(model, MatArray.char_from_str(spec["physics"]))
    rerun = m_fea_run(study, ctx=ctx)
    fresh = _evidence_payload(rerun)
    if fresh["mesh"]["digest"] != doc["mesh"]["digest"]:
        problems.append("mesh digest mismatch")
    for name, rec in doc.get("fields", {}).items():
        got = fresh["fields"].get(name)
        if got is None:
            problems.append(f"field '{name}' missing on replay")
        elif got["digest"] != rec["digest"]:
            problems.append(f"field '{name}' digest mismatch "
                            f"(max_abs {rec['max_abs']:.6g} -> "
                            f"{got['max_abs']:.6g})")
    ok = not problems
    cells = np.empty((len(problems), 1), dtype=object)
    for i, p in enumerate(problems):
        cells[i, 0] = MatArray.char_from_str(p)
    return StructArray.scalar({
        "ok": MatArray.logical_scalar(ok),
        "problems": CellArray(cells)})


@builtin("fea", category="fea", max_in=0)
def m_fea_namespace():
    """The fea package namespace (same mechanism as containers.Map/data.*)."""
    names = {"material": "fea_material",
             "materialAssignment": "fea_materialAssignment",
             "boundaryCondition": "fea_boundaryCondition",
             "load": "fea_load_doc_or_load",
             "loadCase": "fea_loadCase", "step": "fea_step",
             "domain": "fea_domain", "interface": "fea_interface",
             "runOptions": "fea_runOptions", "model": "fea_model",
             "study": "fea_study", "authorStudy": "fea_authorStudy",
             "sweep": "fea_sweep", "validate": "fea_validate",
             "plan": "fea_plan", "run": "fea_run", "results": "fea_results",
             "field": "fea_field", "plot": "fea_plot",
             "compare": "fea_compare", "trends": "fea_trends",
             "evidence": "fea_evidence",
             "verifyEvidence": "fea_verifyEvidence"}
    return StructArray.scalar({
        k: FunctionHandle("named", name=v) for k, v in names.items()})


@builtin("fea_load_doc_or_load", category="fea", min_in=1, pass_ctx=True)
def m_fea_load_dispatch(first, *rest, ctx=None):
    """fea.load is overloaded in the reference: a path loads a document, a
    (kind, where, value) triple authors a load object."""
    if is_text(first) and not rest and text_of(first).endswith(".fea"):
        return m_fea_load_doc(first)
    return m_fea_load(first, *rest)


# ----------------------------------------------------------- geometry.* --- #

@builtin("geometry_load", category="geometry", min_in=1, max_in=1)
def m_geometry_load(path):
    """Load a geometry description: .json box spec, or a triangulated
    surface (.stl ascii/binary, .obj, .ply ascii/binary) with vertex
    welding into an indexed (vertices, faces) mesh (≙ runmat-geometry-io
    import + runmat-meshing-cad prep)."""
    from ...fs import fs
    p = text_of(path)
    raw = fs().read_bytes(p)
    if p.endswith(".json"):
        doc = json.loads(raw.decode("utf-8"))
        return StructArray.scalar({
            "box": MatArray(np.array([doc.get("box", [1.0, 1.0, 1.0])]),
                            "double"),
            "resolution": MatArray.scalar(float(doc.get("resolution", 4)))})
    from ...fea import surface as surf
    if p.endswith(".stl"):
        v, f = surf.load_stl(raw)
    elif p.endswith(".obj"):
        v, f = surf.load_obj(raw.decode("utf-8", "replace"))
    elif p.endswith(".ply"):
        v, f = surf.load_ply(raw)
    elif p.endswith((".step", ".stp")):
        # Part-21 B-rep tessellation with face identities (≙ runmat-
        # geometry-io OCCT import; the B-rep kernel is fea/brep.py)
        from ...fea.step_import import load_step_brep
        v, f, fids, finfo = load_step_brep(raw.decode("utf-8", "replace"))
        rows = len(finfo)
        cols = {"id": [], "type": [], "area": [], "centroid": []}
        for rec in finfo:
            cols["id"].append(MatArray.scalar(float(rec["id"])))
            cols["type"].append(MatArray.char_from_str(rec["type"]))
            cols["area"].append(MatArray.scalar(float(rec["area"])))
            cols["centroid"].append(
                MatArray(np.asarray(rec["centroid"]).reshape(1, 3),
                         "double"))
        fields = {}
        for k, vals in cols.items():
            arr = np.empty((rows, 1), dtype=object)
            for i, x in enumerate(vals):
                arr[i, 0] = x
            fields[k] = arr
        return StructArray.scalar({
            "vertices": MatArray(v, "double"),
            "faces": MatArray(f.astype(np.float64) + 1, "double"),
            "faceIds": MatArray(fids.astype(np.float64).reshape(-1, 1),
                                "double"),
            "faceInfo": StructArray(fields, (rows, 1)),
            "watertight": MatArray.logical_scalar(surf.is_watertight(f))})
    else:
        raise bad_arg("geometry.load", f"Unsupported geometry format: {p}")
    return StructArray.scalar({
        "vertices": MatArray(v, "double"),
        "faces": MatArray(f.astype(np.float64) + 1, "double"),
        "watertight": MatArray.logical_scalar(surf.is_watertight(f))})


@builtin("geometry_inspect", category="geometry", min_in=1, max_in=1)
def m_geometry_inspect(g):
    if not isinstance(g, StructArray):
        raise bad_arg("geometry.inspect", "Expected a geometry struct.")
    if "vertices" in g.fields:
        v = g.get_scalar_field("vertices").host()
        return StructArray.scalar({
            "kind": MatArray.char_from_str("mesh"),
            "numVertices": MatArray.scalar(float(v.shape[0])),
            "bounds": MatArray(np.vstack([v.min(axis=0), v.max(axis=0)]),
                               "double")})
    box = fortran_ravel(_f(g.get_scalar_field("box")))
    return StructArray.scalar({
        "kind": MatArray.char_from_str("box"),
        "volume": MatArray.scalar(float(np.prod(box))),
        "bounds": MatArray(np.vstack([np.zeros(3), box]), "double")})


@builtin("geometry_listRegions", category="geometry", min_in=1, max_in=1)
def m_geometry_list_regions(g):
    """Addressable regions: 'domain' plus one 'face:N' selector per B-rep
    face when the geometry carries face identities (STEP import)."""
    names = ["domain"]
    if isinstance(g, StructArray) and g.is_scalar and "faceIds" in g.fields:
        fids = np.unique(fortran_ravel(
            _f(g.get_scalar_field("faceIds"))).astype(np.int64))
        names += [f"face:{int(i)}" for i in fids if i > 0]
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        data[i, 0] = MatArray.char_from_str(n)
    return CellArray(data)


@builtin("geometry_meshes", category="geometry", min_in=1, max_in=2)
def m_geometry_meshes(g, res=None):
    """Mesh a geometry: box specs go through the structured/Delaunay box
    pipeline; surface geometries (vertices+faces) go through the
    surface-bounded mesher (≙ plc -> tetrahedron generate/recover/
    reconnect/optimize). res is the target edge length h for surfaces."""
    if isinstance(g, StructArray) and "vertices" in g.fields:
        from ...fea import surface as surf
        v = _f(g.get_scalar_field("vertices"))
        f = _f(g.get_scalar_field("faces")).astype(np.int64) - 1
        ext = float((v.max(axis=0) - v.min(axis=0)).max())
        if res is not None and is_text(res) \
                and text_of(res).lower() == "adaptive":
            # curvature-adaptive sizing field (≙ runmat-meshing/size)
            from ...fea.sizing import discrete_curvature_sizing
            h = discrete_curvature_sizing(v, f)
        else:
            h = _sc(res) if res is not None else ext / 6.0
        # cavity pipeline first (boundary recovery + dihedral optimization,
        # ≙ tetrahedron generate/cavity/recover/optimize); the earlier
        # surface-bounded mesher stays as the fallback
        try:
            from ...fea.cavity import mesh_plc
            mesh = mesh_plc(v, f, h=h)
            if mesh.tets.size == 0:
                raise ValueError("empty cavity mesh")
        except Exception:
            mesh = surf.mesh_surface(
                v, f, h.hmax if callable(h) else h)
        return StructArray.scalar({
            "nodes": MatArray(mesh.nodes, "double"),
            "elements": MatArray(mesh.tets.astype(np.float64) + 1,
                                 "double")})
    mesh = _geometry_mesh(g)
    return StructArray.scalar({
        "nodes": MatArray(mesh.nodes, "double"),
        "elements": MatArray(mesh.tets.astype(np.float64) + 1, "double")})


@builtin("geometry_save", category="geometry", min_in=2, max_in=2)
def m_geometry_save(g, path):
    """Export a surface geometry to binary STL (≙ geometry-io export)."""
    from ...fea import surface as surf
    from ...fs import fs
    if not (isinstance(g, StructArray) and "vertices" in g.fields):
        raise bad_arg("geometry.save", "Expected a surface geometry struct.")
    v = _f(g.get_scalar_field("vertices"))
    f = _f(g.get_scalar_field("faces")).astype(np.int64) - 1
    fs().write_bytes(text_of(path), surf.save_stl(v, f))
    return None


@builtin("geometry_meshQuality", category="geometry", min_in=1, max_in=1)
def m_geometry_mesh_quality(m):
    """Quality report for a mesh struct (radius-ratio stats + volume;
    ≙ runmat-meshing-core quality contracts)."""
    from ...fea.delaunay import mesh_quality_report
    from ...fea.mesh import TetMesh
    if not (isinstance(m, StructArray) and "nodes" in m.fields):
        raise bad_arg("geometry.meshQuality", "Expected a mesh struct.")
    nodes = _f(m.get_scalar_field("nodes"))
    tets = _f(m.get_scalar_field("elements")).astype(np.int64) - 1
    rep = mesh_quality_report(TetMesh(nodes, tets, None, None))
    return StructArray.scalar({k: MatArray.scalar(float(v))
                               for k, v in rep.items()})


@builtin("geometry", category="geometry", max_in=0)
def m_geometry_namespace():
    names = {"load": "geometry_load", "inspect": "geometry_inspect",
             "listRegions": "geometry_listRegions",
             "meshes": "geometry_meshes", "save": "geometry_save",
             "meshQuality": "geometry_meshQuality"}
    return StructArray.scalar({
        k: FunctionHandle("named", name=v) for k, v in names.items()})


# ------------------------------------------------------------ leaf functions --- #

@builtin("blsimpv", category="finance", min_in=5, max_in=5)
def m_blsimpv(s, k, r, t, price):
    """Implied Black-Scholes volatility (bisection on the call price)."""
    from scipy import special as spc
    S, K, R, T, P = (_sc(x) for x in (s, k, r, t, price))

    def call(sig):
        if sig <= 0:
            return max(S - K * np.exp(-R * T), 0.0)
        d1 = (np.log(S / K) + (R + sig * sig / 2) * T) / (sig * np.sqrt(T))
        d2 = d1 - sig * np.sqrt(T)
        N = lambda x: 0.5 * spc.erfc(-x / np.sqrt(2))
        return S * N(d1) - K * np.exp(-R * T) * N(d2)

    lo, hi = 1e-6, 5.0
    for _ in range(100):
        mid = (lo + hi) / 2
        if call(mid) < P:
            lo = mid
        else:
            hi = mid
    return MatArray.scalar((lo + hi) / 2)


@builtin("macd", category="finance", min_in=1, max_in=1, pass_nargout=True)
def m_macd(prices, nargout=1):
    """MACD line (EMA12 - EMA26) and 9-period signal line."""
    p = fortran_ravel(_f(prices))

    def ema(x, n):
        a = 2.0 / (n + 1)
        out = np.empty_like(x)
        out[0] = x[0]
        for i in range(1, x.size):
            out[i] = a * x[i] + (1 - a) * out[i - 1]
        return out

    line = ema(p, 12) - ema(p, 26)
    signal = ema(line, 9)
    outs = [MatArray(line.reshape(-1, 1), "double"),
            MatArray(signal.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


@builtin("lassoglm", category="stats/ml", min_in=2, pass_nargout=True,
         pass_ctx=True)
def m_lassoglm(X, y, *rest, ctx=None, nargout=1):
    """L1-regularized logistic regression (binomial) via proximal gradient."""
    hx = _f(X)
    hy = fortran_ravel(_f(y))
    lam = 0.01
    rest = list(rest)
    for i in range(len(rest) - 1):
        if is_text(rest[i]) and text_of(rest[i]).lower() == "lambda":
            lam = float(_f(rest[i + 1]).reshape(-1)[0])
    n, p = hx.shape
    w = np.zeros(p)
    b0 = 0.0
    lr = 1.0 / (np.linalg.norm(hx, 2) ** 2 / n + 1e-9)
    for _ in range(500):
        z = hx @ w + b0
        mu = 1 / (1 + np.exp(-z))
        g = hx.T @ (mu - hy) / n
        gb = float((mu - hy).mean())
        w_new = w - lr * g
        w_new = np.sign(w_new) * np.maximum(np.abs(w_new) - lr * lam, 0)
        b_new = b0 - lr * gb
        if np.abs(w_new - w).max() < 1e-10 and abs(b_new - b0) < 1e-10:
            w, b0 = w_new, b_new
            break
        w, b0 = w_new, b_new
    out = MatArray(w.reshape(-1, 1), "double")
    if nargout <= 1:
        return out
    fitinfo = StructArray.scalar({"Intercept": MatArray.scalar(b0),
                                  "Lambda": MatArray.scalar(lam)})
    return [out, fitinfo]


@builtin("imfinfo", category="image", min_in=1, max_in=1)
def m_imfinfo(path):
    from ...fs import fs
    p = text_of(path)
    raw = fs().read_bytes(p)
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        import struct
        w, h = struct.unpack(">II", raw[16:24])
        bitdepth = raw[24]
        color_type = raw[25]
        return StructArray.scalar({
            "Filename": MatArray.char_from_str(p),
            "FileSize": MatArray.scalar(float(len(raw))),
            "Format": MatArray.char_from_str("png"),
            "Width": MatArray.scalar(float(w)),
            "Height": MatArray.scalar(float(h)),
            "BitDepth": MatArray.scalar(float(bitdepth) *
                                        (3 if color_type == 2 else 1)),
            "ColorType": MatArray.char_from_str(
                "truecolor" if color_type in (2, 6) else "grayscale"),
        })
    raise MatError("MATLAB:imagesci:imfinfo:whatFormat",
                   "Unable to determine the file format.")


@builtin("zplane", category="math/signal", min_in=2, max_in=2, pass_ctx=True,
         pass_nargout=True)
def m_zplane(b, a, ctx=None, nargout=0):
    zb = np.roots(fortran_ravel(_f(b)))
    pa = np.roots(fortran_ravel(_f(a)))
    if nargout >= 1:
        return [MatArray(np.asarray(zb).reshape(-1, 1), "double"),
                MatArray(np.asarray(pa).reshape(-1, 1), "double")][:nargout]
    th = np.linspace(0, 2 * np.pi, 100)
    ctx.interp.call_named("plot", [
        MatArray(np.cos(th).reshape(1, -1), "double"),
        MatArray(np.sin(th).reshape(1, -1), "double")], 0, ctx.frame)
    if zb.size:
        ctx.interp.call_named("scatter", [
            MatArray(np.real(zb).reshape(-1, 1), "double"),
            MatArray(np.imag(zb).reshape(-1, 1), "double")], 0, ctx.frame)
    if pa.size:
        ctx.interp.call_named("scatter", [
            MatArray(np.real(pa).reshape(-1, 1), "double"),
            MatArray(np.imag(pa).reshape(-1, 1), "double")], 0, ctx.frame)
    return None


@builtin("dataTipTextRow", category="plotting/ops", min_in=2, max_in=2)
def m_datatip_text_row(label, values):
    return StructArray.scalar({"Label": MatArray.char_from_str(text_of(label)),
                               "Value": values})


@builtin("subsref", category="introspection", min_in=2, max_in=2, pass_ctx=True)
def m_subsref(obj, s, ctx=None):
    """Function form of indexing: subsref(A, substruct('()', {...}))."""
    from ..indexing_bridge import apply_subs
    return apply_subs(ctx, obj, s, None, read=True)


@builtin("subsasgn", category="introspection", min_in=3, max_in=3, pass_ctx=True)
def m_subsasgn(obj, s, value, ctx=None):
    from ..indexing_bridge import apply_subs
    return apply_subs(ctx, obj, s, value, read=False)


@builtin("substruct", category="introspection", min_in=2)
def m_substruct(*args):
    n = len(args) // 2
    types = np.empty((1, n), dtype=object)
    subs = np.empty((1, n), dtype=object)
    for i in range(n):
        types[0, i] = args[2 * i]
        subs[0, i] = args[2 * i + 1]
    return StructArray({"type": types, "subs": subs}, (1, n))


@builtin("saveobj", category="introspection", min_in=1, max_in=1)
def m_saveobj(obj):
    return obj


@builtin("loadobj", category="introspection", min_in=1, max_in=1)
def m_loadobj(obj):
    return obj
