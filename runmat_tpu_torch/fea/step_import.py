"""Copy of runmat_tpu/fea/step_import.py in the PyTorch port.

STEP (ISO-10303-21) importer: tessellated B-rep shells with face IDs.

Reference parity: runmat-geometry/io/src/{occt,cad,import} — the reference
links OCCT for STEP import (occt/occt_bridge.cc) and flows face-selection
IDs into meshing and analysis. This build parses Part-21 directly (pure
python, no FFI) and routes every face through the B-rep kernel
(``fea/brep.py``), which covers the analytic+freeform subset that spans
engineering parts:

  * surfaces: PLANE, CYLINDRICAL_SURFACE, CONICAL_SURFACE,
    SPHERICAL_SURFACE, TOROIDAL_SURFACE, B_SPLINE_SURFACE_WITH_KNOTS;
  * edge curves: LINE, CIRCLE, ELLIPSE, B_SPLINE_CURVE_WITH_KNOTS;
  * topology: ADVANCED_FACE bounds (outer + holes), EDGE_LOOP /
    VERTEX_LOOP (cone apex, sphere pole), shared EDGE_CURVE
    discretization so adjacent faces stay watertight.

``load_step`` returns the welded (vertices, faces) shell;
``load_step_brep`` additionally returns per-triangle face IDs and a
face-info table — the selection surface that lets FEA boundary
conditions address ``face:N``.
"""

from __future__ import annotations

import re

import numpy as np

from ..errors import MatError
from . import brep as B

_ENT = re.compile(r"#(\d+)\s*=\s*([A-Z0-9_]+)\s*\((.*)\)\s*$", re.S)
_NUM = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[Ee][-+]?[0-9]+)?")


def _split_args(s: str) -> list:
    """Split a Part-21 argument list at top-level commas."""
    out, depth, cur, in_str = [], 0, [], False
    for ch in s:
        if in_str:
            cur.append(ch)
            if ch == "'":
                in_str = False
            continue
        if ch == "'":
            in_str = True
            cur.append(ch)
        elif ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def _parse(text: str) -> dict:
    """#id -> (TYPE, [raw args])."""
    body = text
    m = re.search(r"DATA\s*;(.*)ENDSEC\s*;", text, re.S)
    if m:
        body = m.group(1)
    ents = {}
    for stmt in body.split(";"):
        em = _ENT.match(stmt.strip())
        if em:
            ents[int(em.group(1))] = (em.group(2), _split_args(em.group(3)))
    if not ents:
        raise MatError("RunMat:step:BadFile",
                       "No Part-21 entities found in STEP data section.")
    return ents


def _ref(tok: str) -> int:
    return int(tok.strip().lstrip("#"))


def _refs(tok: str) -> list:
    return [int(t) for t in re.findall(r"#(\d+)", tok)]


def _floats(tok: str) -> list:
    return [float(x) for x in _NUM.findall(tok)]


def _ref_rows(tok: str) -> list:
    """Nested ref list ((#a,#b),(#c,#d)) -> [[a,b],[c,d]]."""
    tok = tok.strip()
    if tok.startswith("("):
        tok = tok[1:-1]
    return [_refs(part) for part in _split_args(tok)]


def _bool(tok: str) -> bool:
    return tok.strip() == ".T."


class _StepReader:
    """Entity graph -> brep objects, with shared caches so every curve /
    edge instance is built once (edge sharing = watertight shells)."""

    def __init__(self, ents: dict):
        self.e = ents
        self.curves: dict = {}
        self.edges: dict = {}
        self.surfaces: dict = {}
        self.unsupported: set = set()

    # -- geometry primitives ---------------------------------------------- #

    def point(self, i: int) -> np.ndarray:
        t, a = self.e[i]
        if t == "VERTEX_POINT":
            return self.point(_ref(a[1]))
        if t != "CARTESIAN_POINT":
            raise MatError("RunMat:step:BadRef", f"#{i} is {t}, not a point")
        v = _floats(a[1])[:3]
        while len(v) < 3:
            v.append(0.0)
        return np.array(v)

    def direction(self, i: int) -> np.ndarray:
        _t, a = self.e[i]
        v = np.array((_floats(a[1]) + [0.0, 0.0, 0.0])[:3])
        n = np.linalg.norm(v)
        return v / (n or 1.0)

    def frame(self, i: int) -> B.Frame:
        """AXIS2_PLACEMENT_3D -> Frame(origin, z, x)."""
        _t, a = self.e[i]
        origin = self.point(_ref(a[1]))
        z = self.direction(_ref(a[2])) if len(a) > 2 and "#" in a[2] else None
        x = self.direction(_ref(a[3])) if len(a) > 3 and "#" in a[3] else None
        return B.Frame(origin, z, x)

    # -- curves ------------------------------------------------------------ #

    def curve(self, i: int):
        if i in self.curves:
            return self.curves[i]
        try:
            cv = self._curve(i)
        except Exception:
            # malformed geometry (real exporters vary): edge() falls back
            # to the straight p0-p1 chord
            self.unsupported.add(self.e[i][0] + "(malformed)")
            cv = None
        self.curves[i] = cv
        return cv

    def _curve(self, i: int):
        t, a = self.e[i]
        if t == "LINE":
            p0 = self.point(_ref(a[1]))
            vt, va = self.e[_ref(a[2])]          # VECTOR
            if vt != "VECTOR":
                raise ValueError(f"LINE #{i} direction is {vt}")
            d = self.direction(_ref(va[1]))
            mag = _floats(va[2])[0] if len(va) > 2 and _NUM.search(va[2]) \
                else 1.0
            cv = B.LineCurve(p0, d * mag)
        elif t == "CIRCLE":
            cv = B.CircleCurve(self.frame(_ref(a[1])), _floats(a[2])[0])
        elif t == "ELLIPSE":
            cv = B.EllipseCurve(self.frame(_ref(a[1])),
                                _floats(a[2])[0], _floats(a[3])[0])
        elif t == "B_SPLINE_CURVE_WITH_KNOTS":
            deg = int(_floats(a[1])[0])
            ctrl = np.array([self.point(p) for p in _refs(a[2])])
            mults = [int(x) for x in _floats(a[6])]
            knots = _floats(a[7])
            kv = np.repeat(knots, mults)
            cv = B.BSplineCurve(deg, kv, ctrl)
        else:
            self.unsupported.add(t)
            cv = None
        return cv

    # -- surfaces ----------------------------------------------------------- #

    def surface(self, i: int):
        if i in self.surfaces:
            return self.surfaces[i]
        try:
            s = self._surface(i)
        except Exception:
            self.unsupported.add(self.e[i][0] + "(malformed)")
            s = None
        self.surfaces[i] = s
        return s

    def _surface(self, i: int):
        t, a = self.e[i]
        if t == "PLANE":
            s = B.Plane(self.frame(_ref(a[1])))
        elif t == "CYLINDRICAL_SURFACE":
            s = B.Cylinder(self.frame(_ref(a[1])), _floats(a[2])[0])
        elif t == "CONICAL_SURFACE":
            s = B.Cone(self.frame(_ref(a[1])), _floats(a[2])[0],
                       _floats(a[3])[0])
        elif t == "SPHERICAL_SURFACE":
            s = B.SphereSurf(self.frame(_ref(a[1])), _floats(a[2])[0])
        elif t == "TOROIDAL_SURFACE":
            s = B.Torus(self.frame(_ref(a[1])), _floats(a[2])[0],
                        _floats(a[3])[0])
        elif t == "B_SPLINE_SURFACE_WITH_KNOTS":
            du, dv = int(_floats(a[1])[0]), int(_floats(a[2])[0])
            rows = _ref_rows(a[3])
            ctrl = np.array([[self.point(p) for p in row] for row in rows])
            umult = [int(x) for x in _floats(a[8])]
            vmult = [int(x) for x in _floats(a[9])]
            uk = np.repeat(_floats(a[10]), umult)
            vk = np.repeat(_floats(a[11]), vmult)
            s = B.BSplineSurface(du, dv, uk, vk, ctrl)
        else:
            self.unsupported.add(t)
            s = None
        return s

    # -- topology ----------------------------------------------------------- #

    def edge(self, i: int):
        """EDGE_CURVE -> shared BrepEdge (or None if the curve type is
        outside the subset: falls back to the straight p0-p1 chord)."""
        if i in self.edges:
            return self.edges[i]
        _t, a = self.e[i]
        p0 = self.point(_ref(a[1]))
        p1 = self.point(_ref(a[2]))
        cv = self.curve(_ref(a[3]))
        same_sense = _bool(a[4])
        if cv is None:
            cv = B.LineCurve(p0, p1 - p0)
            same_sense = True
        e = B.BrepEdge(i, cv, p0, p1, forward=same_sense)
        self.edges[i] = e
        return e

    def loop(self, i: int):
        """EDGE_LOOP -> [(BrepEdge, sense)]; VERTEX_LOOP -> 3-D point."""
        t, a = self.e[i]
        if t == "VERTEX_LOOP":
            return self.point(_ref(a[1]))
        out = []
        for oe in _refs(a[1]):
            ot, oa = self.e[oe]
            if ot != "ORIENTED_EDGE":
                continue
            out.append((self.edge(_ref(oa[3])), _bool(oa[4])))
        return out

    def faces(self):
        fid = 0
        faces = []
        info = []
        for i in sorted(self.e):
            t, a = self.e[i]
            if t != "ADVANCED_FACE":
                continue
            surf = self.surface(_ref(a[2]))
            if surf is None:
                continue
            same_sense = _bool(a[3])
            loops = []
            for b in _refs(a[1]):
                bt, ba = self.e[b]
                if bt in ("FACE_OUTER_BOUND", "FACE_BOUND"):
                    loops.append(self.loop(_ref(ba[1])))
            fid += 1
            stype = self.e[_ref(a[2])][0]
            faces.append(B.BrepFace(fid, surf, loops, same_sense,
                                    stype=stype))
            info.append({"id": fid, "entity": i, "type": stype})
        return faces, info


def load_step_brep(text: str, rel_tol: float = 0.004):
    """Parse + tessellate a STEP file through the B-rep kernel.

    Returns (vertices, faces, face_ids, face_info): the welded triangle
    shell, the 1-based B-rep face ID of every triangle, and a list of
    per-face dicts {id, entity, type, area, centroid}."""
    ents = _parse(text)
    rd = _StepReader(ents)
    faces, info = rd.faces()
    if not faces:
        raise MatError(
            "RunMat:step:Unsupported",
            "No faces in the supported STEP subset (PLANE, CYLINDRICAL/"
            "CONICAL/SPHERICAL/TOROIDAL_SURFACE, B_SPLINE_SURFACE_WITH_"
            "KNOTS); found: "
            + (", ".join(sorted(rd.unsupported)) or "nothing"))
    if rd.unsupported:
        import sys
        print("runmat-tpu: step import skipped unsupported entities: "
              + ", ".join(sorted(rd.unsupported)), file=sys.stderr)
    v, f, ids = B.BrepModel(faces).tessellate(rel_tol=rel_tol)
    for rec in info:
        sel = ids == rec["id"]
        if sel.any():
            tri = v[f[sel]]
            n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            areas = 0.5 * np.linalg.norm(n, axis=1)
            rec["area"] = float(areas.sum())
            rec["centroid"] = (tri.mean(axis=1) * areas[:, None]
                               ).sum(axis=0) / max(areas.sum(), 1e-300)
        else:
            rec["area"] = 0.0
            rec["centroid"] = np.zeros(3)
    return v, f, ids, info


def load_step(text: str, rel_tol: float = 0.004):
    """Back-compat surface import: welded (vertices, faces) only."""
    v, f, _ids, _info = load_step_brep(text, rel_tol=rel_tol)
    return v, f
