"""Copy of runmat_tpu/fea/surface.py in the PyTorch port.

Surface geometry + surface-bounded tetrahedral meshing.

Reference parity: runmat-meshing's CAD-prep → PLC → tetrahedron pipeline
(crates/runmat-meshing/{cad,plc,tetrahedron/src/{generate,recover,
reconnect,optimize}}) and runmat-geometry-ops triangulation/queries. The
reference meshes arbitrary B-rep boundaries through a piecewise-linear
complex with cavity insertion + boundary recovery; here the same user
capability — "mesh this watertight triangulated surface" — is built the
array-native way: vectorized point-in-surface classification over a
sizing-field point cloud, scipy Delaunay, outside-tet discard, then quality
passes (Laplacian smoothing with the boundary pinned + 2-3/3-2 face/edge
reconnection)."""

from __future__ import annotations

import math

import numpy as np

from .mesh import TetMesh


# --------------------------------------------------------------------------- #
# indexed surface construction / validation
# --------------------------------------------------------------------------- #

def weld_vertices(tris: np.ndarray, tol: float = 1e-9):
    """(T,3,3) facet soup -> (V,3) unique vertices + (T,3) int faces."""
    pts = np.asarray(tris, dtype=np.float64).reshape(-1, 3)
    key = np.round(pts / tol).astype(np.int64)
    _, idx, inv = np.unique(key, axis=0, return_index=True,
                            return_inverse=True)
    return pts[idx], inv.reshape(-1, 3)


def surface_edges(faces: np.ndarray):
    """Sorted (E,2) edge array with per-edge face counts."""
    e = np.vstack([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, counts = np.unique(e, axis=0, return_counts=True)
    return uniq, counts


def is_watertight(faces: np.ndarray) -> bool:
    """Closed 2-manifold check: every edge borders exactly two faces."""
    _, counts = surface_edges(faces)
    return bool(counts.size) and bool((counts == 2).all())


def points_inside(verts: np.ndarray, faces: np.ndarray,
                  pts: np.ndarray) -> np.ndarray:
    """Vectorized point-in-closed-surface via +x ray-crossing parity
    (Möller–Trumbore over all faces at once; a tiny direction jitter keeps
    rays off edges/vertices — the robustness trick the reference gets from
    exact predicates)."""
    tri = verts[faces]                       # (F, 3, 3)
    d = np.array([1.0, 1e-4, 2e-4])
    d /= np.linalg.norm(d)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e1 = v1 - v0                              # (F, 3)
    e2 = v2 - v0
    h = np.cross(d, e2)                       # (F, 3)
    a = np.einsum("fj,fj->f", e1, h)          # (F,)
    ok = np.abs(a) > 1e-14
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    inside = np.zeros(pts.shape[0], dtype=bool)
    # chunk points so the (P, F) intermediates stay in cache
    for lo in range(0, pts.shape[0], 2048):
        p = pts[lo:lo + 2048]                 # (P, 3)
        s = p[:, None, :] - v0[None, :, :]    # (P, F, 3)
        u = np.einsum("pfj,fj->pf", s, h) * inv_a
        q = np.cross(s, e1[None, :, :])       # (P, F, 3)
        v = np.einsum("pfj,j->pf", q, d) * inv_a
        t = np.einsum("pfj,fj->pf", q, e2) * inv_a
        hit = ok[None, :] & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-12)
        inside[lo:lo + 2048] = (hit.sum(axis=1) % 2) == 1
    return inside


def dist_to_surface(verts: np.ndarray, faces: np.ndarray,
                    pts: np.ndarray) -> np.ndarray:
    """Exact unsigned distance from each point to the triangulated
    surface (vectorized closest-point-on-triangle, Ericson RTCD §5.1.5).
    Seed-clearance tests must use this, not vertex distance — a point can
    be far from every shell VERTEX yet touch a large facet, which is
    exactly the sliver generator on coarsely tessellated B-rep shells."""
    tri = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]    # (F, 3)
    ab, ac, bc = b - a, c - a, c - b
    pts = np.atleast_2d(np.asarray(pts, np.float64))
    out = np.empty(pts.shape[0])
    for lo in range(0, pts.shape[0], 1024):
        p = pts[lo:lo + 1024][:, None, :]        # (P, 1, 3)
        ap, bp, cp = p - a, p - b, p - c         # (P, F, 3)
        d1 = np.einsum("fj,pfj->pf", ab, ap)
        d2 = np.einsum("fj,pfj->pf", ac, ap)
        d3 = np.einsum("fj,pfj->pf", ab, bp)
        d4 = np.einsum("fj,pfj->pf", ac, bp)
        d5 = np.einsum("fj,pfj->pf", ab, cp)
        d6 = np.einsum("fj,pfj->pf", ac, cp)
        vc = d1 * d4 - d3 * d2
        vb = d5 * d2 - d1 * d6
        va = d3 * d6 - d5 * d4
        # interior barycentric projection (generic case)
        den = va + vb + vc
        den = np.where(np.abs(den) < 1e-300, 1.0, den)
        v = vb / den
        w = vc / den
        q = a + v[..., None] * ab + w[..., None] * ac
        # edge AB region
        t = d1 / np.where(np.abs(d1 - d3) < 1e-300, 1.0, d1 - d3)
        on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
        q = np.where(on_ab[..., None],
                     a + np.clip(t, 0, 1)[..., None] * ab, q)
        # edge AC region
        t = d2 / np.where(np.abs(d2 - d6) < 1e-300, 1.0, d2 - d6)
        on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
        q = np.where(on_ac[..., None],
                     a + np.clip(t, 0, 1)[..., None] * ac, q)
        # edge BC region
        num, dnm = d4 - d3, (d4 - d3) + (d5 - d6)
        t = num / np.where(np.abs(dnm) < 1e-300, 1.0, dnm)
        on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
        q = np.where(on_bc[..., None],
                     b + np.clip(t, 0, 1)[..., None] * bc, q)
        # vertex regions
        q = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a, q)
        q = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b, q)
        q = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c, q)
        out[lo:lo + 1024] = np.linalg.norm(
            pts[lo:lo + 1024][:, None, :] - q, axis=2).min(axis=1)
    return out


# --------------------------------------------------------------------------- #
# surface-bounded Delaunay meshing
# --------------------------------------------------------------------------- #

def mesh_surface(verts: np.ndarray, faces: np.ndarray, h: float,
                 optimize: bool = True) -> TetMesh:
    """Tet-mesh the volume enclosed by a watertight triangulated surface.

    Pipeline (≙ generate → recover → optimize): surface vertices + an
    h-spaced interior grid (jittered off structured planes) → Delaunay of
    the union → discard tets whose centroid falls outside the surface →
    pinned-boundary smoothing + 2-3/3-2 reconnection."""
    from scipy.spatial import Delaunay

    from .delaunay import _tet_volumes

    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    if not is_watertight(faces):
        from ..errors import MatError
        raise MatError("RunMat:meshing:NotWatertight",
                       "Surface is not a closed 2-manifold (every edge "
                       "must border exactly two faces).")
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    axes = [np.arange(lo[k] + h / 2, hi[k], h) for k in range(3)]
    if all(a.size for a in axes):
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        grid = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        rng = np.random.default_rng(0)
        grid = grid + rng.uniform(-h / 8, h / 8, grid.shape)
        keep = points_inside(verts, faces, grid)
        interior = grid[keep]
    else:
        interior = np.empty((0, 3))
    pts = np.vstack([verts, interior])
    tri = Delaunay(pts)
    tets = tri.simplices.copy()
    vol = _tet_volumes(pts, tets)
    tets = tets[np.abs(vol) > 1e-14]
    cent = pts[tets].mean(axis=1)
    tets = tets[points_inside(verts, faces, cent)]
    vol = _tet_volumes(pts, tets)
    flip = vol < 0
    tets[flip, 0], tets[flip, 1] = tets[flip, 1].copy(), tets[flip, 0].copy()
    # drop orphan points (outside grid samples that ended in no kept tet)
    used = np.unique(tets)
    remap = -np.ones(pts.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    mesh = TetMesh(pts[used], remap[tets], None, None)
    if optimize and mesh.n_tets:
        boundary_n = (remap[:verts.shape[0]] >= 0).sum()
        mesh = smooth_pinned(mesh, n_pinned=int(boundary_n))
        mesh = reconnect(mesh)
    return mesh


def smooth_pinned(mesh: TetMesh, n_pinned: int, iters: int = 5) -> TetMesh:
    """Laplacian smoothing with the first n_pinned nodes (the surface)
    fixed; steps are accepted only if no tet inverts and min quality does
    not regress (≙ meshing-opt smoothing pass)."""
    from .delaunay import _radius_ratio, _tet_volumes

    nodes = mesh.nodes.copy()
    tets = mesh.tets
    n = nodes.shape[0]
    movable = np.arange(n) >= n_pinned
    for _ in range(iters):
        acc = np.zeros_like(nodes)
        cnt = np.zeros(n)
        for a in range(4):
            for b in range(4):
                if a != b:
                    np.add.at(acc, tets[:, a], nodes[tets[:, b]])
                    np.add.at(cnt, tets[:, a], 1.0)
        avg = acc / np.maximum(cnt[:, None], 1.0)
        q_now = _radius_ratio(nodes, tets).min() if tets.size else 1.0
        moved = False
        for step in (0.5, 0.2, 0.05):
            cand = np.where(movable[:, None],
                            (1 - step) * nodes + step * avg, nodes)
            vol = _tet_volumes(cand, tets)
            if (vol > 0).all() and \
                    _radius_ratio(cand, tets).min() >= q_now - 1e-12:
                nodes = cand
                moved = True
                break
        if not moved:
            break
    return TetMesh(nodes, tets, mesh.dims, mesh.shape)


# --------------------------------------------------------------------------- #
# reconnection: 2-3 face flips (≙ tetrahedron/src/reconnect)
# --------------------------------------------------------------------------- #

def reconnect(mesh: TetMesh, max_flips: int = None) -> TetMesh:
    """Quality-driven local reconnection: 2-3 face flips (interior face ->
    edge) and 3-2 edge flips (3-tet interior edge -> face) accepted when
    they raise the LOCAL minimum radius-ratio — so every flip is monotone
    in the global minimum too. The 3-2 flip is what removes boundary
    pancake slivers (all four vertices on the shell); 2-3 alone cannot."""
    from .delaunay import _radius_ratio, _tet_volumes

    nodes = mesh.nodes
    tets = [tuple(t) for t in mesh.tets]
    if max_flips is None:
        max_flips = max(200, len(tets))
    flips = 0
    changed = True
    while changed and flips < max_flips:
        changed = False
        face_map: dict = {}
        edge_map: dict = {}
        for ti, t in enumerate(tets):
            for f in ((t[0], t[1], t[2]), (t[0], t[1], t[3]),
                      (t[0], t[2], t[3]), (t[1], t[2], t[3])):
                face_map.setdefault(tuple(sorted(f)), []).append(ti)
            for i in range(4):
                for j in range(i + 1, 4):
                    e = (min(t[i], t[j]), max(t[i], t[j]))
                    edge_map.setdefault(e, []).append(ti)
        dead: set = set()
        added: list = []

        def try_swap(owners, new):
            """Accept old->new when volume is conserved and the local min
            radius-ratio strictly improves. Returns True on accept."""
            old_arr = np.array([tets[ti] for ti in owners])
            new_arr = np.array(new)
            vol_new = _tet_volumes(nodes, new_arr)
            if (np.abs(vol_new) < 1e-14).any():
                return False
            neg = vol_new < 0
            new_arr[neg, 0], new_arr[neg, 1] = \
                new_arr[neg, 1].copy(), new_arr[neg, 0].copy()
            if abs(np.abs(vol_new).sum()
                   - np.abs(_tet_volumes(nodes, old_arr)).sum()) > 1e-10:
                return False   # would change covered volume (boundary)
            if _radius_ratio(nodes, new_arr).min() <= \
                    _radius_ratio(nodes, old_arr).min() + 1e-9:
                return False
            dead.update(owners)
            added.extend(tuple(t) for t in new_arr)
            return True

        for face, owners in face_map.items():
            if len(owners) != 2 or flips >= max_flips:
                continue
            ta, tb = owners
            if ta in dead or tb in dead:
                continue
            a = [v for v in tets[ta] if v not in face]
            b = [v for v in tets[tb] if v not in face]
            if len(a) != 1 or len(b) != 1 or a[0] == b[0]:
                continue
            pa, pb = a[0], b[0]
            f0, f1, f2 = face
            if try_swap(owners, [(pa, pb, f0, f1), (pa, pb, f1, f2),
                                 (pa, pb, f2, f0)]):
                flips += 1
                changed = True
        for edge, owners in edge_map.items():
            if len(owners) != 3 or flips >= max_flips:
                continue
            if any(ti in dead for ti in owners):
                continue
            ea, eb = edge
            ring = set()
            for ti in owners:
                ring.update(x for x in tets[ti] if x != ea and x != eb)
            if len(ring) != 3:
                continue
            c, d, e = sorted(ring)
            # the 3 tets around (ea,eb) become 2 around face (c,d,e);
            # the edge must be interior: face (c,d,e) not already present
            if tuple(sorted((c, d, e))) in face_map and \
                    len(face_map[tuple(sorted((c, d, e)))]) >= 2:
                continue
            if try_swap(owners, [(c, d, e, ea), (c, e, d, eb)]):
                flips += 1
                changed = True
        if changed:
            tets = [t for i, t in enumerate(tets) if i not in dead] + added
    return TetMesh(nodes, np.array(tets, dtype=np.int64),
                   mesh.dims, mesh.shape)


# --------------------------------------------------------------------------- #
# surface file formats (OBJ / PLY / STL ascii+binary)
# --------------------------------------------------------------------------- #

def load_obj(text: str):
    verts, faces = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) for p in parts[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            for k in range(1, len(idx) - 1):   # fan-triangulate polygons
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.array(verts, dtype=np.float64), np.array(faces, dtype=np.int64)


def load_ply(raw: bytes):
    """ASCII and binary_little_endian PLY with float vertex xyz."""
    head_end = raw.find(b"end_header\n")
    if head_end < 0:
        raise ValueError("not a PLY file")
    header = raw[:head_end].decode("ascii", "replace").splitlines()
    body = raw[head_end + len(b"end_header\n"):]
    fmt = "ascii"
    n_v = n_f = 0
    v_props: list = []
    cur = None
    for line in header:
        p = line.split()
        if not p:
            continue
        if p[0] == "format":
            fmt = p[1]
        elif p[0] == "element":
            cur = p[1]
            if p[1] == "vertex":
                n_v = int(p[2])
            elif p[1] == "face":
                n_f = int(p[2])
        elif p[0] == "property" and cur == "vertex":
            v_props.append((p[1], p[2]))
    if fmt == "ascii":
        lines = body.decode("ascii", "replace").split("\n")
        verts = np.array([[float(x) for x in ln.split()[:3]]
                          for ln in lines[:n_v]])
        faces = []
        for ln in lines[n_v:n_v + n_f]:
            p = [int(x) for x in ln.split()]
            idx = p[1:1 + p[0]]
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
        return verts, np.array(faces, dtype=np.int64)
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format: {fmt}")
    sizes = {"float": 4, "float32": 4, "double": 8, "float64": 8,
             "uchar": 1, "uint8": 1, "char": 1, "int8": 1,
             "short": 2, "ushort": 2, "int": 4, "uint": 4,
             "int32": 4, "uint32": 4}
    stride = sum(sizes[t] for t, _ in v_props)
    verts = np.empty((n_v, 3))
    off = 0
    for i in range(n_v):
        rec = body[off:off + stride]
        o = 0
        got = []
        for t, name in v_props:
            if name in ("x", "y", "z"):
                dt = "<f4" if sizes[t] == 4 else "<f8"
                got.append(float(np.frombuffer(rec[o:o + sizes[t]],
                                               dtype=dt)[0]))
            o += sizes[t]
        verts[i] = got[:3]
        off += stride
    faces = []
    for _ in range(n_f):
        cnt = body[off]
        off += 1
        idx = np.frombuffer(body[off:off + 4 * cnt], dtype="<i4")
        off += 4 * cnt
        for k in range(1, cnt - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.array(faces, dtype=np.int64)


def load_stl(raw: bytes):
    """Binary or ASCII STL -> welded (V, F)."""
    if raw[:5] == b"solid" and b"facet" in raw[:500]:
        tris = []
        cur: list = []
        for line in raw.decode("ascii", "replace").splitlines():
            p = line.split()
            if p[:1] == ["vertex"]:
                cur.append([float(x) for x in p[1:4]])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
        soup = np.array(tris, dtype=np.float64)
    else:
        import struct
        n = struct.unpack("<I", raw[80:84])[0]
        rec = np.frombuffer(raw[84:84 + n * 50], dtype=np.uint8)
        soup = rec.reshape(n, 50)[:, 12:48].copy().view(
            np.float32).reshape(n, 3, 3).astype(np.float64)
    return weld_vertices(soup)


def save_stl(verts: np.ndarray, faces: np.ndarray) -> bytes:
    """Binary STL with computed facet normals."""
    import struct
    tri = np.asarray(verts, dtype=np.float64)[np.asarray(faces,
                                                         dtype=np.int64)]
    n = tri.shape[0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    nrm = np.cross(e1, e2)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.where(ln > 0, ln, 1.0)
    out = bytearray(b"runmat-tpu surface export".ljust(80, b"\0"))
    out += struct.pack("<I", n)
    rec = np.zeros((n, 50), dtype=np.uint8)
    payload = np.concatenate([nrm, tri.reshape(n, 9)],
                             axis=1).astype("<f4")
    rec[:, :48] = payload.view(np.uint8).reshape(n, 48)
    out += rec.tobytes()
    return bytes(out)


# --------------------------------------------------------------------------- #
# isotropic surface remeshing: edge split / collapse with quality gates
# (≙ runmat-meshing-tetrahedron optimize.rs surface ops + size fields)
# --------------------------------------------------------------------------- #

def _edge_faces(faces: np.ndarray) -> dict:
    """(a<b) edge -> list of face indices."""
    ef: dict = {}
    for fi, (a, b, c) in enumerate(faces):
        for e in ((a, b), (b, c), (c, a)):
            key = (min(e), max(e))
            ef.setdefault(key, []).append(fi)
    return ef


def refine_surface(verts: np.ndarray, faces: np.ndarray, h,
                   iters: int = 3):
    """Isotropic remeshing toward target edge length h (float or callable
    sizing field h(x)->(n,)): long edges (> 4/3 h) split at midpoints,
    short edges (< 4/5 h) collapse to midpoints when the link condition
    holds (watertightness preserved), then tangential Laplacian smoothing
    constrained to preserve sharp feature edges. Returns (verts, faces)
    watertight (≙ meshing/size sizing-field adaptivity + optimize edge
    operations; classic Botsch-Kobbelt remeshing schedule)."""
    v = np.asarray(verts, np.float64).copy()
    f = np.asarray(faces, np.int64).copy()

    def target(p):
        if callable(h):
            return np.asarray(h(np.atleast_2d(p)), np.float64)
        return np.full(np.atleast_2d(p).shape[0], float(h))

    for _ in range(iters):
        # ---- 1) split long edges
        ef = _edge_faces(f)
        lengths = {e: np.linalg.norm(v[e[0]] - v[e[1]]) for e in ef}
        mids = {e: (v[e[0]] + v[e[1]]) / 2.0 for e in ef}
        to_split = [e for e, L in lengths.items()
                    if L > 4.0 / 3.0 * float(target(mids[e])[0])
                    and len(ef[e]) == 2]
        if to_split:
            new_faces = list(map(tuple, f))
            mid_idx = {}
            for e in to_split:
                mid_idx[e] = v.shape[0]
                v = np.vstack([v, mids[e][None, :]])
            out = []
            for tri in new_faces:
                tris = [tri]
                for e, m in mid_idx.items():
                    nxt = []
                    for t in tris:
                        if e[0] in t and e[1] in t:
                            a, b = e
                            c = [x for x in t if x not in e][0]
                            ia, ib = t.index(a), t.index(b)
                            if (ia + 1) % 3 == ib:
                                nxt += [(a, m, c), (m, b, c)]
                            else:
                                nxt += [(b, m, c), (m, a, c)]
                        else:
                            nxt.append(t)
                    tris = nxt
                out.extend(tris)
            f = np.array(out, dtype=np.int64)
        # ---- 2) collapse short edges (link condition + no flips).
        # Feature preservation: crease vertices (sharp dihedral) must not
        # move — a collapse with one sharp endpoint absorbs the other INTO
        # it; both-sharp edges are left alone (volume stays exact on
        # prismatic parts).
        ef = _edge_faces(f)
        fnormals = {}
        for fi, (a, b, c) in enumerate(f):
            nrm = np.cross(v[b] - v[a], v[c] - v[a])
            nn = np.linalg.norm(nrm)
            fnormals[fi] = nrm / nn if nn > 1e-300 else np.zeros(3)
        sharp_v: set = set()
        for e, fl in ef.items():
            if len(fl) == 2:
                if float(fnormals[fl[0]] @ fnormals[fl[1]]) < \
                        math.cos(math.radians(30)):
                    sharp_v.update(e)
            else:
                sharp_v.update(e)
        star: dict = {}
        for fi, tri in enumerate(f):
            for x in tri:
                star.setdefault(int(x), set()).add(fi)
        dead_faces: set = set()
        merged = np.arange(v.shape[0])
        touched: set = set()
        for e, fl in ef.items():
            if len(fl) != 2:
                continue
            a, b = e
            if a in touched or b in touched:
                continue
            L = float(np.linalg.norm(v[a] - v[b]))
            # both-sharp edges are pinned — EXCEPT coincident vertices
            # (midpoint collapses can land two verts on the same point;
            # merging them moves no geometry, so sharpness is moot)
            if a in sharp_v and b in sharp_v and L > 1e-12:
                continue
            if L >= 0.8 * float(target((v[a] + v[b]) / 2.0)[0]):
                continue
            # link condition: shared neighbors of a and b must be exactly
            # the two opposite vertices of the shared faces
            na = {int(x) for fi in star[a] for x in f[fi]} - {a}
            nb = {int(x) for fi in star[b] for x in f[fi]} - {b}
            opp = set()
            for fi in fl:
                opp.update(int(x) for x in f[fi] if x not in e)
            if na & nb != opp:
                continue
            if a in sharp_v:
                keep, drop = a, b
                v[keep] = v[a]                  # sharp vertex stays put
            elif b in sharp_v:
                keep, drop = b, a
            else:
                keep, drop = a, b
                v[keep] = (v[a] + v[b]) / 2.0
            merged[drop] = keep
            touched |= {a, b} | na | nb
            dead_faces.update(fl)
        if dead_faces or (merged != np.arange(v.shape[0])).any():
            f = np.array([tri for fi, tri in enumerate(f)
                          if fi not in dead_faces], dtype=np.int64)
            f = merged[f]
            # drop degenerate faces (repeated vertices after merge)
            ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & \
                (f[:, 0] != f[:, 2])
            f = f[ok]
        # ---- 2.5) edge flips (the Botsch-Kobbelt equalization step):
        # flip a near-coplanar edge when it raises the min quality of its
        # two triangles and creates no fold-over or duplicate edge.
        # Without this, repeated midpoint splits accumulate skinny
        # triangles that no amount of collapsing or smoothing repairs.
        ef = _edge_faces(f)
        norms = {}
        for fi, (a, b, c) in enumerate(f):
            n = np.cross(v[b] - v[a], v[c] - v[a])
            nn = np.linalg.norm(n)
            norms[fi] = n / nn if nn > 1e-300 else np.zeros(3)

        def _tq(t):
            pa, pb, pc = v[t[0]], v[t[1]], v[t[2]]
            ar = 0.5 * np.linalg.norm(np.cross(pb - pa, pc - pa))
            s = ((pb - pa) ** 2).sum() + ((pc - pa) ** 2).sum() \
                + ((pc - pb) ** 2).sum()
            return 4.0 * math.sqrt(3.0) * ar / s if s > 1e-300 else 0.0

        edge_set = set(ef.keys())
        consumed: set = set()
        fmut = [tuple(map(int, t)) for t in f]
        for e, fl in ef.items():
            if len(fl) != 2:
                continue
            f1, f2 = fl
            if f1 in consumed or f2 in consumed:
                continue
            # a degenerate (zero-area) face has no meaningful normal and
            # may ALWAYS be flipped — flipping it away changes no geometry
            degen = np.linalg.norm(norms[f1]) < 0.5 \
                or np.linalg.norm(norms[f2]) < 0.5
            if not degen and float(norms[f1] @ norms[f2]) \
                    < math.cos(math.radians(10)):
                continue                       # curved/sharp: leave alone
            a, b = e
            t1, t2 = fmut[f1], fmut[f2]
            c = next(x for x in t1 if x not in e)
            d = next(x for x in t2 if x not in e)
            if c == d or tuple(sorted((c, d))) in edge_set:
                continue
            i = t1.index(a)
            if t1[(i + 1) % 3] != b:           # orient t1 as a->b
                a, b = b, a
            new1, new2 = (a, d, c), (d, b, c)
            if min(_tq(new1), _tq(new2)) <= min(_tq(t1), _tq(t2)) + 1e-12:
                continue
            base = norms[f1] + norms[f2]
            n1 = np.cross(v[d] - v[a], v[c] - v[a])
            n2 = np.cross(v[b] - v[d], v[c] - v[d])
            if float(n1 @ base) <= 0 or float(n2 @ base) <= 0:
                continue                       # fold-over
            fmut[f1], fmut[f2] = new1, new2
            consumed.update((f1, f2))
            edge_set.discard(tuple(sorted((a, b))))
            edge_set.add(tuple(sorted((c, d))))
        if consumed:
            f = np.array(fmut, dtype=np.int64)
        # ---- 3) tangential smoothing, feature edges pinned
        ef = _edge_faces(f)
        normals = {}
        for fi, (a, b, c) in enumerate(f):
            n = np.cross(v[b] - v[a], v[c] - v[a])
            nn = np.linalg.norm(n)
            normals[fi] = n / nn if nn > 1e-300 else np.zeros(3)
        sharp: set = set()
        for e, fl in ef.items():
            if len(fl) == 2:
                d = float(normals[fl[0]] @ normals[fl[1]])
                if d < math.cos(math.radians(30)):
                    sharp.update(e)
            else:
                sharp.update(e)
        acc = np.zeros_like(v)
        cnt = np.zeros(v.shape[0])
        for (a, b) in ef:
            acc[a] += v[b]
            acc[b] += v[a]
            cnt[a] += 1
            cnt[b] += 1
        has = cnt > 0
        avg = np.where(has[:, None], acc / np.maximum(cnt[:, None], 1), v)
        vert_normal = np.zeros_like(v)
        for fi, tri in enumerate(f):
            for x in tri:
                vert_normal[x] += normals[fi]
        nn = np.linalg.norm(vert_normal, axis=1, keepdims=True)
        vert_normal = vert_normal / np.maximum(nn, 1e-300)
        move = (avg - v) * 0.4
        # project the move into the tangent plane (no volume shrink)
        move -= (np.einsum("ij,ij->i", move, vert_normal))[:, None] \
            * vert_normal
        pin = np.zeros(v.shape[0], dtype=bool)
        pin[list(sharp)] = True
        v = np.where(pin[:, None], v, v + move)
        # ---- 4) weld exactly-coincident vertices (midpoint collapses on
        # structured grids can land two verts on the same point without an
        # edge between them) and drop the then-degenerate faces
        wtol = max(float((v.max(axis=0) - v.min(axis=0)).max()), 1.0) * 1e-9
        key = np.round(v / wtol).astype(np.int64)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        if first.size < v.shape[0]:
            f = first[inv][f]
            ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & \
                (f[:, 0] != f[:, 2])
            f = f[ok]
        # compact unused vertices
        used = np.unique(f)
        remap = -np.ones(v.shape[0], dtype=np.int64)
        remap[used] = np.arange(used.size)
        v = v[used]
        f = remap[f]
    return v, f
