"""Copy of runmat_tpu/runtime/builtins/graph2.py in the PyTorch port.

Graph algorithms batch 2 + array grouping utilities + image color space
conversions.

Reference parity: runmat-runtime/src/builtins/graph/{bfsearch,dfsearch,
conncomp,distances,findedge,indegree,outdegree,neighbors,predecessors,
successors,toposort,treelayout}.rs; builtins/array/{combinations,discretize,
findgroups,groupcounts,grp2idx,splitapply}.rs; builtins/image/color/*.rs.
"""

from __future__ import annotations

import heapq

import numpy as np

from ...errors import MatError
from ...values import (CellArray, MatArray, StringArray, fortran_ravel,
                       text_of)
from ..registry import builtin
from .common import scalar_int
from .domains import MatGraph


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _node(v) -> int:
    return int(_f(v).reshape(-1)[0]) - 1


# ------------------------------------------------------------------- graphs --- #

@builtin("bfsearch", category="graph", min_in=2, max_in=2)
def m_bfsearch(g: MatGraph, start):
    s = _node(start)
    seen = [False] * g.n
    seen[s] = True
    order = [s]
    q = [s]
    while q:
        u = q.pop(0)
        for vtx, _w in sorted(g.adj[u]):
            if not seen[vtx]:
                seen[vtx] = True
                order.append(vtx)
                q.append(vtx)
    return MatArray(np.array(order, dtype=np.float64).reshape(-1, 1) + 1, "double")


@builtin("dfsearch", category="graph", min_in=2, max_in=2)
def m_dfsearch(g: MatGraph, start):
    s = _node(start)
    seen = [False] * g.n
    order = []
    stack = [s]
    while stack:
        u = stack.pop()
        if seen[u]:
            continue
        seen[u] = True
        order.append(u)
        for vtx, _w in sorted(g.adj[u], reverse=True):
            if not seen[vtx]:
                stack.append(vtx)
    return MatArray(np.array(order, dtype=np.float64).reshape(-1, 1) + 1, "double")


def _undirected_adj(g: MatGraph):
    if not g.directed:
        return g.adj
    adj = [list(a) for a in g.adj]
    for u in range(g.n):
        for vtx, w in g.adj[u]:
            adj[vtx].append((u, w))
    return adj


@builtin("conncomp", category="graph", min_in=1, max_in=1)
def m_conncomp(g: MatGraph):
    """Connected components (weak components for digraphs)."""
    adj = _undirected_adj(g)
    comp = [0] * g.n
    c = 0
    for s in range(g.n):
        if comp[s]:
            continue
        c += 1
        q = [s]
        comp[s] = c
        while q:
            u = q.pop()
            for vtx, _w in adj[u]:
                if not comp[vtx]:
                    comp[vtx] = c
                    q.append(vtx)
    return MatArray(np.array(comp, dtype=np.float64).reshape(1, -1), "double")


@builtin("distances", category="graph", min_in=1, max_in=3)
def m_distances(g: MatGraph, s=None, t=None):
    """All-pairs (or single-source) shortest path distances (Dijkstra)."""
    def dijkstra(src: int) -> np.ndarray:
        dist = np.full(g.n, np.inf)
        dist[src] = 0.0
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u]:
                continue
            for vtx, w in g.adj[u]:
                nd = d + w
                if nd < dist[vtx]:
                    dist[vtx] = nd
                    heapq.heappush(pq, (nd, vtx))
        return dist

    if s is None:
        D = np.vstack([dijkstra(i) for i in range(g.n)])
        return MatArray(D, "double")
    srcs = (_f(s).reshape(-1).astype(int) - 1).tolist()
    D = np.vstack([dijkstra(i) for i in srcs])
    if t is not None:
        tix = _f(t).reshape(-1).astype(int) - 1
        D = D[:, tix]
    return MatArray(D, "double")


@builtin("findedge", category="graph", min_in=3, max_in=3)
def m_findedge(g: MatGraph, s, t):
    si = _f(s).reshape(-1).astype(int) - 1
    ti = _f(t).reshape(-1).astype(int) - 1
    # edge index = position in the (sorted by source) edge list
    edges = []
    for u in range(g.n):
        for vtx, _w in g.adj[u]:
            if g.directed or u <= vtx:
                edges.append((u, vtx))
    out = []
    for a, b in zip(si, ti):
        idx = 0
        for k, (u, vtx) in enumerate(edges):
            if (u, vtx) == (a, b) or (not g.directed and (u, vtx) == (b, a)):
                idx = k + 1
                break
        out.append(float(idx))
    return MatArray(np.array(out).reshape(-1, 1), "double")


@builtin("indegree", category="graph", min_in=1, max_in=2)
def m_indegree(g: MatGraph, nodes=None):
    deg = np.zeros(g.n)
    for u in range(g.n):
        for vtx, _w in g.adj[u]:
            deg[vtx] += 1
    if not g.directed:
        deg = np.array([len(a) for a in g.adj], dtype=np.float64)
    if nodes is not None:
        ix = _f(nodes).reshape(-1).astype(int) - 1
        deg = deg[ix]
    return MatArray(deg.reshape(-1, 1), "double")


@builtin("outdegree", category="graph", min_in=1, max_in=2)
def m_outdegree(g: MatGraph, nodes=None):
    deg = np.array([len(a) for a in g.adj], dtype=np.float64)
    if nodes is not None:
        ix = _f(nodes).reshape(-1).astype(int) - 1
        deg = deg[ix]
    return MatArray(deg.reshape(-1, 1), "double")


@builtin("neighbors", category="graph", min_in=2, max_in=2)
def m_neighbors(g: MatGraph, node):
    u = _node(node)
    adj = _undirected_adj(g)
    ns = sorted({vtx for vtx, _w in adj[u]})
    return MatArray(np.array(ns, dtype=np.float64).reshape(-1, 1) + 1, "double")


@builtin("predecessors", category="graph", min_in=2, max_in=2)
def m_predecessors(g: MatGraph, node):
    u = _node(node)
    ps = sorted({w for w in range(g.n) if any(vtx == u for vtx, _ in g.adj[w])})
    return MatArray(np.array(ps, dtype=np.float64).reshape(-1, 1) + 1, "double")


@builtin("successors", category="graph", min_in=2, max_in=2)
def m_successors(g: MatGraph, node):
    u = _node(node)
    ss = sorted({vtx for vtx, _w in g.adj[u]})
    return MatArray(np.array(ss, dtype=np.float64).reshape(-1, 1) + 1, "double")


@builtin("toposort", category="graph", min_in=1, max_in=1)
def m_toposort(g: MatGraph):
    indeg = [0] * g.n
    for u in range(g.n):
        for vtx, _w in g.adj[u]:
            indeg[vtx] += 1
    q = sorted(u for u in range(g.n) if indeg[u] == 0)
    order = []
    while q:
        u = q.pop(0)
        order.append(u)
        for vtx, _w in sorted(g.adj[u]):
            indeg[vtx] -= 1
            if indeg[vtx] == 0:
                q.append(vtx)
        q.sort()
    if len(order) != g.n:
        raise MatError("MATLAB:graphfun:toposort:NotDAG",
                       "Graph must be acyclic for a topological sort.")
    return MatArray(np.array(order, dtype=np.float64).reshape(1, -1) + 1, "double")


@builtin("treelayout", category="graph", min_in=1, max_in=1, pass_nargout=True)
def m_treelayout(parent, nargout=1):
    """x/y layout coordinates for a tree given parent pointers."""
    p = _f(parent).reshape(-1).astype(int)
    n = p.size
    depth = np.zeros(n, dtype=int)
    for i in range(n):
        d, j = 0, i
        while p[j] != 0 and d < n:
            j = p[j] - 1
            d += 1
        depth[i] = d
    maxd = depth.max() if n else 0
    y = 1.0 - depth / max(maxd + 1, 1)
    x = np.zeros(n)
    for lvl in range(maxd + 1):
        idx = np.where(depth == lvl)[0]
        for k, i in enumerate(idx):
            x[i] = (k + 1) / (len(idx) + 1)
    outs = [MatArray(x.reshape(1, -1), "double"), MatArray(y.reshape(1, -1), "double")]
    return outs[:max(1, nargout)]


# ------------------------------------------------------- grouping utilities --- #

def _group_keys(g):
    """Group variable -> (codes array starting at 1, unique key values)."""
    if isinstance(g, (StringArray, CellArray)):
        if isinstance(g, StringArray):
            texts = [t or "" for t in g.data.reshape(-1, order="F")]
        else:
            texts = [e.to_str() for e in g.data.reshape(-1, order="F")]
        uniq = sorted(set(texts))
        code = {k: i + 1 for i, k in enumerate(uniq)}
        return np.array([code[t] for t in texts], dtype=np.float64), uniq
    h = fortran_ravel(_f(g))
    uniq, codes = np.unique(h, return_inverse=True)
    return codes.astype(np.float64) + 1, uniq.tolist()


@builtin("grp2idx", category="array/grouping", min_in=1, max_in=1, pass_nargout=True)
def m_grp2idx(g, nargout=1):
    codes, uniq = _group_keys(g)
    out = MatArray(codes.reshape(-1, 1), "double")
    if nargout <= 1:
        return out
    data = np.empty((len(uniq), 1), dtype=object)
    for i, k in enumerate(uniq):
        data[i, 0] = MatArray.char_from_str(str(k) if not isinstance(k, float)
                                            else f"{k:g}")
    return [out, CellArray(data)]


@builtin("findgroups", category="array/grouping", min_in=1, pass_nargout=True)
def m_findgroups(*gs, nargout=1):
    all_codes = [
        _group_keys(g)[0] for g in gs]
    combo = np.zeros(all_codes[0].size)
    mult = 1.0
    for c in all_codes:
        combo = combo * (c.max() + 1) + c
    uniq, codes = np.unique(combo, return_inverse=True)
    out = MatArray((codes + 1.0).reshape(-1, 1), "double")
    if nargout <= 1:
        return out
    # second output: representative key values of the first grouping variable
    firsts = []
    c0 = all_codes[0]
    for u in uniq:
        firsts.append(c0[combo == u][0])
    return [out, MatArray(np.array(firsts).reshape(1, -1), "double")]


@builtin("groupcounts", category="array/grouping", min_in=1, max_in=1)
def m_groupcounts(g):
    codes, uniq = _group_keys(g)
    counts = np.bincount(codes.astype(int))[1:]
    return MatArray(counts.astype(np.float64).reshape(-1, 1), "double")


@builtin("splitapply", category="array/grouping", min_in=3, pass_ctx=True)
def m_splitapply(f, *rest, ctx=None):
    gvar = rest[-1]
    datas = rest[:-1]
    codes = fortran_ravel(_f(gvar)).astype(int)
    k = codes.max() if codes.size else 0
    results = []
    from ...values import FunctionHandle
    for gi in range(1, k + 1):
        mask = codes == gi
        args = []
        for d in datas:
            h = d.host()
            if h.ndim == 2 and h.shape[1] > 1 and h.shape[0] == codes.size:
                args.append(MatArray(h[mask, :], d.mclass))
            else:
                flat = h.reshape(-1, order="F")[mask]
                args.append(MatArray(flat.reshape(-1, 1), d.mclass))
        r = ctx.interp.call_value(f, args, 1, ctx.frame) if isinstance(f, FunctionHandle) \
            else ctx.interp.call_named(text_of(f), args, 1, ctx.frame)
        results.append(_f(r[0]).reshape(-1))
    if not results:
        return MatArray.empty()
    width = max(r.size for r in results)
    out = np.vstack([np.pad(r, (0, width - r.size), constant_values=np.nan)
                     for r in results])
    return MatArray(out, "double")


@builtin("discretize", category="array/grouping", min_in=2, max_in=2, pass_nargout=True)
def m_discretize(x, edges, nargout=1):
    h = _f(x)
    e = fortran_ravel(_f(edges))
    idx = np.digitize(h, e, right=False).astype(np.float64)
    idx[(h < e[0]) | (h > e[-1])] = np.nan
    idx[h == e[-1]] = e.size - 1
    out = MatArray(idx, "double")
    if nargout <= 1:
        return out
    return [out, MatArray(e.reshape(1, -1), "double")]


@builtin("combinations", category="array/grouping", min_in=1)
def m_combinations(*arrays):
    """Cartesian product of the input vectors as a matrix (one row per
    combination, first input varies slowest — MATLAB table semantics
    flattened to numeric columns)."""
    vecs = [fortran_ravel(_f(a)) for a in arrays]
    grids = np.meshgrid(*vecs, indexing="ij")
    cols = [g.reshape(-1) for g in grids]
    return MatArray(np.column_stack(cols), "double")


@builtin("combvec", category="array/grouping", min_in=1)
def m_combvec(*arrays):
    """combvec(A1, A2, ...): all column combinations, last input varies
    fastest (deep-learning toolbox)."""
    mats = [_f(a) if _f(a).ndim == 2 else _f(a).reshape(1, -1) for a in arrays]
    out = mats[0]
    for m in mats[1:]:
        n1, n2 = out.shape[1], m.shape[1]
        top = np.repeat(out, n2, axis=1)
        bot = np.tile(m, (1, n1))
        out = np.vstack([top, bot])
    return MatArray(out, "double")


# ------------------------------------------------------- image color spaces --- #

def _img(v) -> np.ndarray:
    h = v.host().astype(np.float64)
    if v.mclass == "uint8":
        h = h / 255.0
    elif v.mclass == "uint16":
        h = h / 65535.0
    return h


def _wrap_like(r: np.ndarray, proto) -> MatArray:
    if proto.mclass == "uint8":
        return MatArray(np.clip(np.round(r * 255), 0, 255).astype(np.uint8), "uint8")
    if proto.mclass == "uint16":
        return MatArray(np.clip(np.round(r * 65535), 0, 65535).astype(np.uint16), "uint16")
    return MatArray(r, proto.mclass if proto.mclass in ("double", "single") else "double")


@builtin("rgb2hsv", category="image/color", min_in=1, max_in=1)
def m_rgb2hsv(img):
    h = _img(img)
    r, g, b = h[..., 0], h[..., 1], h[..., 2]
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    d = mx - mn
    hh = np.zeros_like(mx)
    with np.errstate(divide="ignore", invalid="ignore"):
        hh = np.where(mx == r, np.mod((g - b) / d, 6), hh)
        hh = np.where(mx == g, (b - r) / d + 2, hh)
        hh = np.where(mx == b, (r - g) / d + 4, hh)
    hh = np.where(d == 0, 0.0, hh) / 6.0
    s = np.where(mx == 0, 0.0, d / np.where(mx == 0, 1.0, mx))
    return _wrap_like(np.stack([hh, s, mx], axis=-1),
                      img if img.mclass in ("double", "single") else img)


@builtin("hsv2rgb", category="image/color", min_in=1, max_in=1)
def m_hsv2rgb(img):
    x = _img(img)
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = np.floor(h).astype(int) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return MatArray(np.stack([r, g, b], axis=-1), "double")


_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_WHITE = np.array([0.950456, 1.0, 1.088754])


def _lab_f(t):
    d = 6.0 / 29
    return np.where(t > d ** 3, np.cbrt(t), t / (3 * d * d) + 4.0 / 29)


def _lab_finv(t):
    d = 6.0 / 29
    return np.where(t > d, t ** 3, 3 * d * d * (t - 4.0 / 29))


@builtin("rgb2lab", category="image/color", min_in=1, max_in=1)
def m_rgb2lab(img):
    x = _img(img)
    # sRGB -> linear
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _RGB2XYZ.T
    xyz = xyz / _WHITE
    fx, fy, fz = _lab_f(xyz[..., 0]), _lab_f(xyz[..., 1]), _lab_f(xyz[..., 2])
    L = 116 * fy - 16
    a = 500 * (fx - fy)
    b = 200 * (fy - fz)
    return MatArray(np.stack([L, a, b], axis=-1), "double")


@builtin("lab2rgb", category="image/color", min_in=1, max_in=1)
def m_lab2rgb(img):
    x = img.host().astype(np.float64)
    L, a, b = x[..., 0], x[..., 1], x[..., 2]
    fy = (L + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200
    xyz = np.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], axis=-1) * _WHITE
    lin = xyz @ np.linalg.inv(_RGB2XYZ).T
    srgb = np.where(lin <= 0.0031308, 12.92 * lin, 1.055 * lin ** (1 / 2.4) - 0.055)
    return MatArray(np.clip(srgb, 0, 1), "double")


@builtin("ind2rgb", category="image/color", min_in=2, max_in=2)
def m_ind2rgb(idx, cmap):
    ix = idx.host().astype(np.int64)
    if idx.mclass in ("double", "single"):
        ix = ix - 1  # 1-based for float indices
    cm = _f(cmap)
    ix = np.clip(ix, 0, cm.shape[0] - 1)
    return MatArray(cm[ix], "double")


@builtin("gray2rgb", category="image/color", min_in=1, max_in=1)
def m_gray2rgb(img):
    h = img.host()
    if h.ndim == 3:
        return img
    return MatArray(np.stack([h, h, h], axis=-1), img.mclass)


@builtin("im2uint8", category="image/color", min_in=1, max_in=1)
def m_im2uint8(img):
    h = img.host()
    if img.mclass == "uint8":
        return img
    if img.mclass == "uint16":
        return MatArray((h.astype(np.float64) / 257.0).round().astype(np.uint8), "uint8")
    return MatArray(np.clip(np.round(h.astype(np.float64) * 255), 0, 255).astype(np.uint8),
                    "uint8")


@builtin("im2uint16", category="image/color", min_in=1, max_in=1)
def m_im2uint16(img):
    h = img.host()
    if img.mclass == "uint16":
        return img
    if img.mclass == "uint8":
        return MatArray((h.astype(np.float64) * 257.0).astype(np.uint16), "uint16")
    return MatArray(np.clip(np.round(h.astype(np.float64) * 65535), 0, 65535).astype(np.uint16),
                    "uint16")


@builtin("imhist", category="image", min_in=1, max_in=2, pass_nargout=True)
def m_imhist(img, n=None, nargout=1):
    nb = scalar_int(n, "n") if n is not None else 256
    h = img.host().astype(np.float64)
    if img.mclass == "uint8":
        h = h / 255.0
    elif img.mclass == "uint16":
        h = h / 65535.0
    counts, edges = np.histogram(h.reshape(-1), bins=nb, range=(0.0, 1.0))
    centers = (edges[:-1] + edges[1:]) / 2
    outs = [MatArray(counts.astype(np.float64).reshape(-1, 1), "double"),
            MatArray(centers.reshape(-1, 1), "double")]
    return outs[:max(1, nargout)]


# ------------------------------------------------ flows + centralities --- #

@builtin("maxflow", category="math/graph", min_in=3, max_in=3,
         pass_nargout=True)
def m_maxflow(g: MatGraph, s, t, nargout=1):
    """Edmonds-Karp max flow from s to t over edge weights as capacities
    (BFS augmenting paths; exceeds the reference's graph surface)."""
    src, dst = _node(s), _node(t)
    n = g.n
    cap = {}
    for u in range(n):
        for v, w in g.adj[u]:
            cap[(u, v)] = cap.get((u, v), 0.0) + float(w)
            cap.setdefault((v, u), 0.0)
    flow = 0.0
    from collections import deque
    while True:
        parent = {src: None}
        q = deque([src])
        while q and dst not in parent:
            u = q.popleft()
            for (a, b), c in cap.items():
                if a == u and b not in parent and c > 1e-15:
                    parent[b] = u
                    q.append(b)
        if dst not in parent:
            break
        path = []
        v = dst
        while parent[v] is not None:
            path.append((parent[v], v))
            v = parent[v]
        aug = min(cap[e] for e in path)
        for (a, b) in path:
            cap[(a, b)] -= aug
            cap[(b, a)] += aug
        flow += aug
    return MatArray.scalar(flow)


@builtin("centrality", category="math/graph", min_in=2, max_in=2)
def m_centrality(g: MatGraph, kind):
    """degree/indegree/outdegree/closeness/pagerank/betweenness node
    centralities."""
    k = text_of(kind).lower()
    n = g.n
    if k in ("degree", "indegree", "outdegree"):
        out = np.zeros(n)
        indeg = np.zeros(n)
        for u in range(n):
            out[u] = len(g.adj[u])
            for v, _w in g.adj[u]:
                indeg[v] += 1
        if not g.directed:
            return MatArray(out.reshape(-1, 1), "double")
        if k == "outdegree":
            return MatArray(out.reshape(-1, 1), "double")
        if k == "indegree":
            return MatArray(indeg.reshape(-1, 1), "double")
        return MatArray((out + indeg).reshape(-1, 1), "double")
    if k == "closeness":
        from collections import deque
        c = np.zeros(n)
        for s in range(n):
            dist = np.full(n, np.inf)
            dist[s] = 0
            q = deque([s])
            while q:
                u = q.popleft()
                for v, _w in g.adj[u]:
                    if np.isinf(dist[v]):
                        dist[v] = dist[u] + 1
                        q.append(v)
            reach = np.isfinite(dist) & (np.arange(n) != s)
            tot = dist[reach].sum()
            if tot > 0:
                # MATLAB normalization: (R/(N-1)) * (R/total-distance)
                R = reach.sum()
                c[s] = (R * R) / ((n - 1) * tot)
        return MatArray(c.reshape(-1, 1), "double")
    if k == "pagerank":
        d = 0.85
        pr = np.full(n, 1.0 / n)
        outdeg = np.array([max(len(g.adj[u]), 1) for u in range(n)],
                          dtype=np.float64)
        for _ in range(100):
            nxt = np.full(n, (1 - d) / n)
            for u in range(n):
                share = d * pr[u] / outdeg[u]
                for v, _w in g.adj[u]:
                    nxt[v] += share
                if not g.adj[u]:
                    nxt += d * pr[u] / n
            if np.abs(nxt - pr).max() < 1e-12:
                pr = nxt
                break
            pr = nxt
        return MatArray(pr.reshape(-1, 1), "double")
    if k == "betweenness":
        # Brandes' algorithm (unweighted)
        from collections import deque
        bc = np.zeros(n)
        for s in range(n):
            stack = []
            preds = [[] for _ in range(n)]
            sigma = np.zeros(n)
            sigma[s] = 1
            dist = np.full(n, -1)
            dist[s] = 0
            q = deque([s])
            while q:
                u = q.popleft()
                stack.append(u)
                for v, _w in g.adj[u]:
                    if dist[v] < 0:
                        dist[v] = dist[u] + 1
                        q.append(v)
                    if dist[v] == dist[u] + 1:
                        sigma[v] += sigma[u]
                        preds[v].append(u)
            delta = np.zeros(n)
            while stack:
                w = stack.pop()
                for u in preds[w]:
                    delta[u] += sigma[u] / sigma[w] * (1 + delta[w])
                if w != s:
                    bc[w] += delta[w]
        if not g.directed:
            bc /= 2.0
        return MatArray(bc.reshape(-1, 1), "double")
    raise bad_arg("centrality", f"Unknown centrality type '{text_of(kind)}'.")


@builtin("addnode", category="math/graph", min_in=2, max_in=2)
def m_addnode(g: MatGraph, k):
    """addnode(G, k): append k isolated nodes."""
    kk = int(_f(k).reshape(-1)[0])
    return MatGraph(g.n + kk, [list(a) for a in g.adj] +
                    [[] for _ in range(kk)], g.directed)


@builtin("addedge", category="math/graph", min_in=3, max_in=4)
def m_addedge(g: MatGraph, s, t, w=None):
    """addedge(G, s, t[, w]): append edges (grows the node set)."""
    si = _f(s).reshape(-1).astype(int) - 1
    ti = _f(t).reshape(-1).astype(int) - 1
    wi = _f(w).reshape(-1) if w is not None else np.ones(si.size)
    if wi.size == 1:
        wi = np.full(si.size, wi[0])
    n = max(g.n, int(max(si.max(initial=-1), ti.max(initial=-1)) + 1))
    adj = [list(a) for a in g.adj] + [[] for _ in range(n - g.n)]
    for a, b, ww in zip(si, ti, wi):
        adj[a].append((int(b), float(ww)))
        if not g.directed:
            adj[b].append((int(a), float(ww)))
    return MatGraph(n, adj, g.directed)


@builtin("rmnode", category="math/graph", min_in=2, max_in=2)
def m_rmnode(g: MatGraph, nodes):
    """rmnode(G, ids): drop nodes (and their edges), renumbering the rest."""
    drop = set(int(v) - 1 for v in _f(nodes).reshape(-1))
    keep = [u for u in range(g.n) if u not in drop]
    remap = {u: i for i, u in enumerate(keep)}
    adj = [[(remap[v], w) for v, w in g.adj[u] if v not in drop]
           for u in keep]
    return MatGraph(len(keep), adj, g.directed)


@builtin("rmedge", category="math/graph", min_in=3, max_in=3)
def m_rmedge(g: MatGraph, s, t):
    """rmedge(G, s, t): drop the listed edges (all parallel copies)."""
    si = _f(s).reshape(-1).astype(int) - 1
    ti = _f(t).reshape(-1).astype(int) - 1
    kill = set(zip(si.tolist(), ti.tolist()))
    if not g.directed:
        kill |= set(zip(ti.tolist(), si.tolist()))
    adj = [[(v, w) for v, w in g.adj[u] if (u, v) not in kill]
           for u in range(g.n)]
    return MatGraph(g.n, adj, g.directed)
