"""Copy of runmat_tpu/fea/cavity.py in the PyTorch port.

Cavity-based incremental Delaunay (Bowyer-Watson) with PLC boundary
recovery and dihedral-quality optimization.

Reference parity: runmat-meshing/tetrahedron/src/{generate,cavity,recover,
reconnect,optimize}.rs — the reference's tet kernel inserts points by
carving the circumsphere-violating cavity and star-connecting its boundary,
recovers missing PLC facets with Steiner points, and optimizes on a
min-dihedral gate. The TPU build keeps the same pipeline host-side (meshing
is pointer-chasing, not FLOPs; the reference's kernel is host Rust for the
same reason) with numpy-vectorized predicates.
"""

from __future__ import annotations

import numpy as np

from .mesh import TetMesh


# --------------------------------------------------------------------------- #
# geometric predicates
# --------------------------------------------------------------------------- #

def _circumspheres(nodes: np.ndarray, tets: np.ndarray):
    """Circumcenter + squared radius per tet (vectorized)."""
    p0 = nodes[tets[:, 0]]
    A = np.stack([nodes[tets[:, k]] - p0 for k in (1, 2, 3)], axis=1)
    b = 0.5 * np.einsum("mkj,mkj->mk", A, A)
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-14
    centers = np.zeros_like(p0)
    Ainv = np.linalg.inv(np.where(ok[:, None, None], A,
                                  np.eye(3)[None, :, :]))
    centers = np.einsum("mjk,mk->mj", Ainv, b) + p0
    r2 = np.einsum("mj,mj->m", centers - p0, centers - p0)
    r2[~ok] = np.inf
    return centers, r2


def _volumes(nodes: np.ndarray, tets: np.ndarray) -> np.ndarray:
    a = nodes[tets[:, 0]]
    return np.einsum("ij,ij->i",
                     np.cross(nodes[tets[:, 1]] - a, nodes[tets[:, 2]] - a),
                     nodes[tets[:, 3]] - a) / 6.0


_FACES = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))


def dihedral_angles(nodes: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """All six dihedral angles per tet, degrees (M, 6) — the quality gate of
    the reference's optimize pass (tetrahedron/src/optimize.rs)."""
    p = nodes[tets]                              # (M, 4, 3)
    # outward face normals opposite each vertex
    normals = []
    for (i, j, k) in _FACES:
        nrm = np.cross(p[:, j] - p[:, i], p[:, k] - p[:, i])
        nn = np.linalg.norm(nrm, axis=1, keepdims=True)
        normals.append(nrm / np.maximum(nn, 1e-300))
    normals = np.stack(normals, axis=1)          # (M, 4, 3)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    angs = []
    for a, b in pairs:
        c = np.clip(-np.einsum("mj,mj->m", normals[:, a], normals[:, b]),
                    -1.0, 1.0)
        angs.append(np.degrees(np.arccos(c)))
    return np.stack(angs, axis=1)


# --------------------------------------------------------------------------- #
# Bowyer-Watson incremental insertion
# --------------------------------------------------------------------------- #

def _insphere(verts_ld: np.ndarray, tets: np.ndarray, p) -> np.ndarray:
    """Vectorized in-circumsphere predicate in extended precision
    (longdouble — the robustness substitute for the reference kernel's
    exact predicates): for POSITIVELY oriented tets, result > 0 iff p lies
    strictly inside the circumsphere."""
    q = verts_ld[tets] - np.asarray(p, np.longdouble)[None, None, :]
    lift = np.einsum("mkj,mkj->mk", q, q)            # |q|^2 per vertex
    a, b, c, d = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    la, lb, lc, ld_ = lift[:, 0], lift[:, 1], lift[:, 2], lift[:, 3]

    def det3(u, v, w):
        return (u[:, 0] * (v[:, 1] * w[:, 2] - v[:, 2] * w[:, 1])
                - u[:, 1] * (v[:, 0] * w[:, 2] - v[:, 2] * w[:, 0])
                + u[:, 2] * (v[:, 0] * w[:, 1] - v[:, 1] * w[:, 0]))

    return -(-la * det3(b, c, d) + lb * det3(a, c, d)
             - lc * det3(a, b, d) + ld_ * det3(a, b, c))


def _orient_positive(verts_ld: np.ndarray, arr: np.ndarray) -> np.ndarray:
    a = verts_ld[arr[:, 0]]
    vol = np.einsum(
        "ij,ij->i",
        np.cross(verts_ld[arr[:, 1]] - a, verts_ld[arr[:, 2]] - a),
        verts_ld[arr[:, 3]] - a)
    flip = vol < 0
    arr = arr.copy()
    arr[flip, 0], arr[flip, 1] = arr[flip, 1].copy(), arr[flip, 0].copy()
    return arr[vol != 0]


def _delaunay_qhull(pts: np.ndarray) -> np.ndarray:
    """Qhull fast path for large clouds: same contract as the cavity
    kernel (jittered predicates break exact cosphericity; output indexes
    the caller's unperturbed points; flat tets dropped)."""
    from scipy.spatial import Delaunay  # C-speed; exact-BW covers small n
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0))) or 1.0
    rng = np.random.default_rng(0x5EED)
    jit = pts + (rng.random(pts.shape) - 0.5) * (1e-9 * span)
    tets = np.asarray(Delaunay(jit).simplices, dtype=np.int64)
    a = pts[tets[:, 0]]
    vol = np.einsum("ij,ij->i",
                    np.cross(pts[tets[:, 1]] - a, pts[tets[:, 2]] - a),
                    pts[tets[:, 3]] - a)
    flip = vol < 0
    tets[flip, 0], tets[flip, 1] = tets[flip, 1].copy(), tets[flip, 0].copy()
    return tets[np.abs(vol) > 1e-12 * span ** 3]


def bowyer_watson(points: np.ndarray) -> np.ndarray:
    """Delaunay tetrahedralization by cavity insertion. Returns (M, 4) tet
    indices into `points` (positive orientation). The kernel is the
    reference's generate/cavity pipeline: for each point, collect the tets
    whose circumsphere contains it (the cavity), delete them, and star the
    cavity's boundary faces to the new point. In-sphere tests run in
    extended precision so slivers are carved, not skipped. Clouds past the
    quadratic-kernel knee route to Qhull with the same jitter contract."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if n >= 500:
        try:
            return _delaunay_qhull(pts)
        except Exception:
            pass  # degenerate cloud: fall through to the exact kernel
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = float(np.max(hi - lo)) or 1.0
    c = (lo + hi) / 2.0
    # enclosing super-tet: huge relative to the cloud so circumspheres
    # through super vertices approximate half-spaces (hull completeness);
    # longdouble predicates keep ~13 significant digits at this scale
    S = 1e5 * span
    super_pts = np.array([
        c + [0.0, 0.0, 3.0 * S],
        c + [-2.0 * S, -S, -S],
        c + [2.0 * S, -S, -S],
        c + [0.0, 2.0 * S, -S]])
    verts = np.vstack([pts, super_pts])
    verts_ld = verts.astype(np.longdouble)
    # simulation-of-simplicity substitute: a deterministic sub-roundoff
    # jitter applied to the PREDICATE coordinates only breaks exact
    # cosphericity (grid corners etc.); output connectivity still indexes
    # the caller's unperturbed points
    rng = np.random.default_rng(0x5EED)
    verts_ld = verts_ld + (rng.random(verts.shape) - 0.5) * (1e-9 * span)
    live = _orient_positive(verts_ld, np.array(
        [[n, n + 1, n + 2, n + 3]], dtype=np.int64))

    for pi in range(n):
        p = verts[pi]
        side = _insphere(verts_ld, live, np.asarray(verts_ld[pi]))
        in_cav = side > 0
        if not in_cav.any():
            continue
        cav = live[in_cav]
        keep = live[~in_cav]
        # boundary faces of the cavity (faces seen exactly once)
        face_count: dict = {}
        for tet in cav:
            for (i, j, k) in _FACES:
                f = (int(tet[i]), int(tet[j]), int(tet[k]))
                key = tuple(sorted(f))
                if key in face_count:
                    face_count.pop(key)
                else:
                    face_count[key] = f
        new_tets = [(f[0], f[1], f[2], pi) for f in face_count.values()]
        if new_tets:
            arr = _orient_positive(verts_ld,
                                   np.array(new_tets, dtype=np.int64))
            live = np.vstack([keep, arr])
        else:
            live = keep

    out = live[(live < n).all(axis=1)]
    out = np.ascontiguousarray(out, dtype=np.int64).reshape(-1, 4)
    # drop REAL-coordinate-flat tets (exactly-coplanar point sets survive
    # the jittered predicates as zero-volume slivers whose faces would
    # double-count both diagonals of planar quads)
    if out.size:
        vol = _volumes(pts, out)
        out = out[np.abs(vol) > 1e-12 * span ** 3]
    return out


# --------------------------------------------------------------------------- #
# PLC boundary recovery + carving
# --------------------------------------------------------------------------- #

def _tet_face_set(tets: np.ndarray) -> set:
    if not len(tets):
        return set()
    faces = np.concatenate([
        np.stack([tets[:, i], tets[:, j], tets[:, k]], axis=1)
        for (i, j, k) in _FACES])
    faces = np.unique(np.sort(faces, axis=1), axis=0)
    return set(map(tuple, faces.tolist()))


def _tet_edge_set(tets: np.ndarray) -> set:
    if not len(tets):
        return set()
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    edges = np.concatenate([
        np.stack([tets[:, i], tets[:, j]], axis=1) for (i, j) in pairs])
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    return set(map(tuple, edges.tolist()))


def recover_boundary(points: np.ndarray, faces: np.ndarray,
                     n_protected: int = None, max_rounds: int = 20):
    """Conforming-Delaunay boundary recovery (≙ tetrahedron/src/recover.rs).
    `points[:n_protected]` are PLC points (referenced by `faces`);
    the rest are free interior seeds. Per round, in priority order:

      1. delete free seeds encroaching a missing facet's diametral sphere
         (Shewchuk rule — seeds must never pin boundary non-conformity);
      2. split missing PLC edges at midpoints (kills non-locally-Delaunay
         diagonals);
      3. bisect the longest edge of facets whose interior is still crossed
         (Ruppert-style refinement of the facet and its coplanar
         neighbor).

    Returns (verts, tets, surface_faces) with the recovered (possibly
    split) boundary triangulation. Coplanar facet groups are free to end
    up with DIFFERENT diagonals than the input (region conformity, the
    PLC contract); exact per-facet identity is only required of the final
    subfacets returned."""
    pts_all = np.asarray(points, np.float64)
    if n_protected is None:
        n_protected = pts_all.shape[0]
    protected = pts_all[:n_protected].copy()
    free = pts_all[n_protected:].copy()
    tris = [tuple(int(v) for v in f) for f in np.asarray(faces)]
    scale = float(np.max(pts_all.max(axis=0) - pts_all.min(axis=0))) or 1.0
    ctol = 1e-8 * scale

    def _region_key(f):
        a, b, c = protected[f[0]], protected[f[1]], protected[f[2]]
        n = np.cross(b - a, c - a)
        nn = np.linalg.norm(n)
        if nn < 1e-300:
            return None
        n = n / nn
        k = int(np.argmax(np.abs(n)))
        if n[k] < 0:
            n = -n
        d = float(n @ a)
        return (round(n[0], 7), round(n[1], 7), round(n[2], 7),
                round(d / scale, 7))

    def _tri_area(p):
        return 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))

    n0 = protected.shape[0]
    best_missing = None
    stall = 0
    for _ in range(max_rounds):
        pts = np.vstack([protected, free]) if free.size else protected
        tets = bowyer_watson(pts)
        have_f = _tet_face_set(tets)
        missing = [f for f in tris if tuple(sorted(f)) not in have_f]
        if not missing:
            return pts, tets, np.array(tris, dtype=np.int64)
        # termination budget: curved shells (every facet its own plane)
        # can resist exact recovery — Ruppert splitting then diverges.
        # Best-effort is sound downstream: carve() decides by watertight
        # point-in-surface tests, not by facet identity.
        if best_missing is not None and len(missing) >= best_missing:
            stall += 1
        else:
            stall = 0
            best_missing = len(missing)
        if stall >= 3 or protected.shape[0] > 4 * n0 + 512:
            break
        # region conformity: coplanar facet groups may re-triangulate —
        # a region is satisfied when the tet faces lying on its plane
        # with centroids inside the region tile its full area
        regions: dict = {}
        for f in tris:
            key = _region_key(f)
            if key is None:
                continue
            r = regions.setdefault(key, {"facets": [], "area": 0.0})
            r["facets"].append(f)
            r["area"] += _tri_area(protected[list(f)])
        # vectorized plane membership: onplane[f, r] = all 3 verts of tet
        # face f lie within ctol of region plane r (curved shells make
        # every facet its own region, so this pairing is the hot loop)
        keys = list(regions.keys())
        face_arr = np.array(sorted(have_f), dtype=np.int64)
        fpts = pts[face_arr]                                   # (F,3,3)
        Nrm = np.array([k[:3] for k in keys], np.float64)      # (R,3)
        Dpl = np.array([k[3] * scale for k in keys])           # (R,)
        F = face_arr.shape[0]
        onplane = np.zeros((F, len(keys)), dtype=bool)
        step = max(1, int(4e6 // max(len(keys), 1)))
        for s in range(0, F, step):
            dist = np.abs(np.einsum("fvj,rj->frv", fpts[s:s + step], Nrm)
                          - Dpl[None, :, None])
            onplane[s:s + step] = (dist < ctol).all(axis=2)
        fareas = 0.5 * np.linalg.norm(
            np.cross(fpts[:, 1] - fpts[:, 0], fpts[:, 2] - fpts[:, 0]),
            axis=1)
        fcens = fpts.mean(axis=1)
        region_ok = {}
        covering: dict = {}
        for ri, key in enumerate(keys):
            r = regions[key]
            cand = np.nonzero(onplane[:, ri])[0]
            if cand.size == 0:
                region_ok[key] = r["area"] < 1e-7 * scale * scale
                covering[key] = []
                continue
            n = np.array(key[:3])
            # 2-D basis on the plane
            x = _any_perp(n)
            y = np.cross(n, x)
            fac = protected[np.array(r["facets"], dtype=np.int64)]
            fac2 = np.stack([fac @ x, fac @ y], axis=2)        # (M,3,2)
            c2 = np.stack([fcens[cand] @ x, fcens[cand] @ y],
                          axis=1)                              # (C,2)
            v0, v1, v2 = fac2[:, 0], fac2[:, 1], fac2[:, 2]    # (M,2)
            den = ((v1[:, 1] - v2[:, 1]) * (v0[:, 0] - v2[:, 0])
                   + (v2[:, 0] - v1[:, 0]) * (v0[:, 1] - v2[:, 1]))
            good = np.abs(den) >= 1e-300
            dsafe = np.where(good, den, 1.0)
            dx = c2[:, 0, None] - v2[None, :, 0]               # (C,M)
            dy = c2[:, 1, None] - v2[None, :, 1]
            l1 = ((v1[:, 1] - v2[:, 1])[None] * dx
                  + (v2[:, 0] - v1[:, 0])[None] * dy) / dsafe
            l2 = ((v2[:, 1] - v0[:, 1])[None] * dx
                  + (v0[:, 0] - v2[:, 0])[None] * dy) / dsafe
            inside = ((l1 >= -1e-9) & (l2 >= -1e-9)
                      & (l1 + l2 <= 1 + 1e-9) & good[None]).any(axis=1)
            cov = cand[inside]
            cover = float(fareas[cov].sum())
            region_ok[key] = abs(cover - r["area"]) < 1e-7 * scale * scale
            covering[key] = [tuple(int(v) for v in face_arr[i])
                             for i in cov]
        if all(region_ok.values()):
            # conforming via regions: return the covering faces as the
            # recovered surface triangulation
            out_faces = [list(fk) for key in regions
                         for fk in covering[key]]
            return pts, tets, np.array(out_faces, dtype=np.int64)
        missing = [f for f in missing
                   if not region_ok.get(_region_key(f), False)]
        if not missing:
            missing = [f for key, r in regions.items()
                       if not region_ok[key] for f in r["facets"]][:8]
        # 1) evict encroaching free seeds
        if free.size:
            kill = np.zeros(free.shape[0], dtype=bool)
            for f in missing:
                tri = protected[list(f)]
                c, r2 = _tri_circumsphere(tri)
                d2 = np.einsum("ij,ij->i", free - c, free - c)
                kill |= d2 < r2 * (1.0 + 1e-9)
            if kill.any():
                free = free[~kill]
                continue
        have_e = _tet_edge_set(tets)
        # 2) split missing PLC edges / longest edges of crossed facets
        bad_edges = set()
        for f in missing:
            ends = [(f[0], f[1]), (f[1], f[2]), (f[2], f[0])]
            found_missing_edge = False
            for (a, b) in ends:
                key = (a, b) if a < b else (b, a)
                if key not in have_e:
                    bad_edges.add(key)
                    found_missing_edge = True
            if not found_missing_edge:
                ln = [float(np.sum((protected[a] - protected[b]) ** 2))
                      for (a, b) in ends]
                a, b = ends[int(np.argmax(ln))]
                bad_edges.add((a, b) if a < b else (b, a))
        mid_of = {}
        for (a, b) in bad_edges:
            mid = (protected[a] + protected[b]) / 2.0
            protected = np.vstack([protected, mid[None, :]])
            mid_of[(a, b)] = protected.shape[0] - 1

        def split(tri):
            out = [tri]
            for (a, b), m in mid_of.items():
                nxt = []
                for t in out:
                    if a in t and b in t:
                        c = [v for v in t if v not in (a, b)][0]
                        # preserve winding relative to the original
                        ia, ib = t.index(a), t.index(b)
                        if (ia + 1) % 3 == ib:
                            nxt += [(a, m, c), (m, b, c)]
                        else:
                            nxt += [(b, m, c), (m, a, c)]
                    else:
                        nxt.append(t)
                out = nxt
            return out

        tris = [s for t in tris for s in split(t)]
    pts = np.vstack([protected, free]) if free.size else protected
    tets = bowyer_watson(pts)
    return pts, tets, np.array(tris, dtype=np.int64)


def _any_perp(z: np.ndarray) -> np.ndarray:
    v = np.array([1.0, 0.0, 0.0])
    if abs(float(z @ v)) > 0.9:
        v = np.array([0.0, 1.0, 0.0])
    v = v - (v @ z) * z
    return v / np.linalg.norm(v)


def _tri_circumsphere(tri: np.ndarray):
    """Diametral sphere of a 3-D triangle: circumcenter + squared radius."""
    a, b, c = tri
    ab, ac = b - a, c - a
    n = np.cross(ab, ac)
    nn = float(n @ n)
    if nn < 1e-300:
        cen = tri.mean(axis=0)
        r2 = max(float((p - cen) @ (p - cen)) for p in tri)
        return cen, r2
    cen = a + (np.cross((ab @ ab) * ac - (ac @ ac) * ab, n)) / (2.0 * nn)
    r2 = float((a - cen) @ (a - cen))
    return cen, r2


def carve(points: np.ndarray, tets: np.ndarray,
          surf_verts: np.ndarray, surf_faces: np.ndarray) -> np.ndarray:
    """Drop tets whose centroid lies outside the (watertight) surface."""
    from .surface import points_inside
    cen = points[tets].mean(axis=1)
    keep = points_inside(surf_verts, surf_faces, cen)
    return tets[keep]


# --------------------------------------------------------------------------- #
# quality optimization on the min-dihedral gate
# --------------------------------------------------------------------------- #

def optimize_dihedral(mesh: TetMesh, min_angle: float = 5.0,
                      iters: int = 8) -> TetMesh:
    """Improve the worst dihedral angles: alternating 2-3/3-2 reconnection
    (surface.reconnect) and boundary-pinned smoothing accepted only when
    the min dihedral does not regress (≙ optimize.rs flips + smoothing
    driven by the quality metric)."""
    from .surface import reconnect
    nodes, tets = mesh.nodes, mesh.tets
    boundary = _boundary_vertices(tets)
    best = float(dihedral_angles(nodes, tets).min()) if tets.size else 180.0
    for _ in range(iters):
        if best >= min_angle:
            break
        # reconnect is monotone (each flip raises the LOCAL min radius-
        # ratio, touching nothing else) — always take its result, even
        # when the single worst dihedral is untouched by any legal flip
        m2 = reconnect(TetMesh(nodes, tets, None, None))
        q2 = float(dihedral_angles(m2.nodes, m2.tets).min()) \
            if m2.tets.size else 180.0
        if m2.tets.shape != tets.shape or (m2.tets != tets).any():
            nodes, tets = m2.nodes, m2.tets
            boundary = _boundary_vertices(tets)
            if q2 > best:
                best = q2
                continue
            best = min(best, q2)
        moved = _smooth_interior(nodes, tets, boundary)
        q3 = float(dihedral_angles(moved, tets).min()) if tets.size else 180.0
        if q3 > best + 1e-9:
            nodes = moved
            best = q3
        else:
            break
    return TetMesh(nodes, tets, None, None)


def _boundary_vertices(tets: np.ndarray) -> np.ndarray:
    count: dict = {}
    for (i, j, k) in _FACES:
        for f in np.stack([tets[:, i], tets[:, j], tets[:, k]], axis=1):
            key = tuple(sorted(int(v) for v in f))
            count[key] = count.get(key, 0) + 1
    verts = set()
    for key, cval in count.items():
        if cval == 1:
            verts.update(key)
    return np.array(sorted(verts), dtype=np.int64)


def _smooth_interior(nodes: np.ndarray, tets: np.ndarray,
                     boundary: np.ndarray) -> np.ndarray:
    out = nodes.copy()
    n = nodes.shape[0]
    acc = np.zeros_like(nodes)
    cnt = np.zeros(n)
    for a in range(4):
        for b in range(4):
            if a == b:
                continue
            np.add.at(acc, tets[:, a], nodes[tets[:, b]])
            np.add.at(cnt, tets[:, a], 1.0)
    avg = acc / np.maximum(cnt[:, None], 1.0)
    interior = np.ones(n, dtype=bool)
    interior[boundary] = False
    for step in (0.4, 0.15, 0.05):
        cand = np.where(interior[:, None], (1 - step) * out + step * avg, out)
        if (_volumes(cand, tets) > 0).all():
            return cand
    return out


# --------------------------------------------------------------------------- #
# end-to-end: PLC surface -> quality tet mesh
# --------------------------------------------------------------------------- #

def mesh_plc(surf_verts: np.ndarray, surf_faces: np.ndarray,
             h: float = 0.0, min_dihedral: float = 5.0) -> TetMesh:
    """Mesh the interior of a watertight triangulated surface with the
    cavity kernel: boundary recovery -> carve -> dihedral optimization.
    `h` > 0 seeds interior points on an h-grid for element sizing."""
    sv = np.asarray(surf_verts, np.float64)
    sf = np.asarray(surf_faces, np.int64)
    if callable(h):
        # sizing-field-driven meshing (≙ runmat-meshing/size background
        # fields): FIRST remesh the shell to the field — a coarse B-rep
        # tessellation next to fine interior seeds breeds spire slivers
        # (fine seed cluster joined to a distant shell vertex) — THEN
        # seed the interior with octree leaves sized to h(x)
        from .sizing import adaptive_seeds
        from .surface import refine_surface
        sv, sf = refine_surface(sv, sf, h, iters=3)
        pts = sv.copy()
        seeds = adaptive_seeds(sv, sf, h)
        if len(seeds):
            pts = np.vstack([pts, seeds])
        h = 0.0
    else:
        pts = sv.copy()
    if h and h > 0:
        from .surface import points_inside
        lo = sv.min(axis=0)
        hi = sv.max(axis=0)
        axes = [np.arange(lo[d] + h / 2, hi[d], h) for d in range(3)]
        if all(len(a) for a in axes):
            G = np.stack(np.meshgrid(*axes, indexing="ij"),
                         axis=-1).reshape(-1, 3)
            # jitter interior seeds into general position
            rng = np.random.default_rng(0)
            G = G + (rng.random(G.shape) - 0.5) * 0.2 * h
            inside = points_inside(sv, sf, G)
            # keep seeds clear of the surface itself (exact point-to-
            # triangle distance; vertex distance alone lets seeds graze
            # large facets and breeds slivers)
            if inside.any():
                from .surface import dist_to_surface
                cand = G[inside]
                d = dist_to_surface(sv, sf, cand)
                pts = np.vstack([pts, cand[d > 0.4 * h]])
    verts, tets, faces = recover_boundary(pts, sf,
                                          n_protected=sv.shape[0])
    tets = carve(verts, tets, sv, sf)
    mesh = TetMesh(verts, tets, None, None)
    return optimize_dihedral(mesh, min_angle=min_dihedral)
