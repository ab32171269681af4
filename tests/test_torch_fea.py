"""The port's sparse builtins, iterative solvers and FEA core against the
JAX package's, through both packages' host sessions.

The snippets are those of the JAX package's `tests/test_sparse.py`,
`tests/test_itersolve.py`, `tests/test_fea.py`, `tests/test_fea_solvers.py`,
`tests/test_fea_buckling_harmonic.py` and `tests/test_delaunay_mesh.py`
that need no `fea2` (which the port does not carry yet), at their sizes,
and the sparse graph snippets of `tests/test_sparse_graph_depth.py` and
`tests/test_domains_async.py`, whose graphs are `domains`' and whose
algorithms are `graph2`'s (none of the six files above calls either). Each runs through `torch_both.host_parity`: the JAX
package's host session, the port's, and the port's session on
`TorchEngine("cpu")`, held equal exactly (the same numpy, scipy and LAPACK
calls on the same data). A mesh is cleared before the comparison: it
displays as its Python object.
"""

import pytest

from torch_both import EXACT, host_parity, no_engine  # noqa: F401


def _spd(n: int) -> str:
    """tests/test_itersolve.py's tridiagonal SPD system with a known x."""
    return (f"n = {n}; e = ones(n,1); A = spdiags([-e 4*e -e], -1:1, n, n);"
            " xt = (1:n)' / n; b = A * xt; ")


_CANTILEVER = ("L = 10; E = 1000; nu = 0.0; mesh = femesh([L 1 1], [20 2 2]);"
               " tip = fea_boundary_nodes(mesh, 'x==L'); k = numel(tip);"
               " loads = [tip, zeros(k,1), zeros(k,1), (-0.01/k)*ones(k,1)];"
               " res = fea_linear_static(mesh, E, nu, 'x==0', loads);"
               " x = res.max_displacement / (0.01*L^3/(3*E*(1/12)));"
               " clear mesh;")

# (id, source)
SNIPPETS = [
    # tests/test_sparse.py
    ("sparse-triplets", "x = full(sparse([1 2 3], [1 2 3], [4 5 6]));"
     " A = sparse([1 1], [1 1], [2 3]); d = full(A); d = d(1,1);"
     " D = [1 0 2; 0 0 3]; y = full(sparse(D));"),
    ("sparse-class", "A = speye(4); z = issparse(A); k = class(A);"
     " n = nnz(A); C = speye(3) + sparse([1], [3], [7], 3, 3);"
     " zc = issparse(C); v = full(C);"),
    ("sparse-products", "A = sparse([1 2 3], [1 2 3], [4 5 6]);"
     " x = A * [1; 2; 3]; S = speye(3) * sparse([1 2], [1 2], [3 4], 3, 3);"
     " zs = issparse(S); y = A \\ [4; 10; 18];"
     " T = full(sparse([1], [2], [5], 2, 3)');"),
    ("sparse-elementwise", "A = sparse([1 2], [1 2], [3 4]);"
     " B = A .* [2 0; 0 10]; zb = issparse(B); vb = full(B);"
     " E = abs(sparse([1], [1], [-3])); ze = issparse(E); r = A(2,2);"
     " A(1,2) = 9; za = issparse(A); v = full(A);"),
    ("sparse-diags", "x = full(spdiags([1 2 3]', 0, 3, 3));"
     " o = full(spones(sparse([1], [1], [42])));"
     " A = sparse([2 1], [1 2], [7 8]); [i, j, v] = find(A);"
     " nz = nonzeros(A); [Bd, d] = spdiags([4 1 0; 2 5 1; 0 3 6]);"),
    ("sprand", "rng(1); A = sprand(50, 40, 0.1); n = nnz(A);"
     " z = issparse(A); S = sprandsym(6, 0.4); after = rand;"),
    # tests/test_itersolve.py
    ("pcg", _spd(60) + "[x, flag, relres, it] = pcg(A, b, 1e-10, 200);"
     " err = norm(x - xt);"),
    ("pcg-default-maxit", "n = 400; e = ones(n,1);"
     " A = spdiags([-e 2*e -e], -1:1, n, n); xt = (1:n)' / n; b = A * xt;"
     " [x, flag] = pcg(A, b);"),
    ("pcg-ichol", _spd(200) + "L = ichol(A);"
     " [xp, fp, rp, itp] = pcg(A, b, 1e-10, 300, L, L');"
     " [xn, fn, rn, itn] = pcg(A, b, 1e-10, 300); errp = norm(xp - xt);"),
    ("ichol", _spd(20) + "L = ichol(A); lo = istril(full(L));"
     " rec = norm(full(L*L' - A));"),
    ("bicgstab", "n = 50; e = ones(n,1);"
     " A = spdiags([-0.5*e 4*e -1.5*e], -1:1, n, n); xt = cos((1:n)');"
     " b = A * xt; [x, flag, relres] = bicgstab(A, b, 1e-10, 200);"
     " err = norm(x - xt);"),
    ("gmres", "n = 40; e = ones(n,1);"
     " A = spdiags([-0.3*e 3*e -1.2*e], -1:1, n, n); xt = sin((1:n)');"
     " b = A * xt; [x, flag, relres, it] = gmres(A, b, 10, 1e-10, 20);"
     " err = norm(x - xt);"),
    ("gmres-unrestarted", "n = 30;"
     " A = spdiags([-ones(n,1) 4*ones(n,1) -ones(n,1)], -1:1, n, n);"
     " xt = ones(n,1); b = A * xt; [x, flag] = gmres(A, b, [], 1e-12, 30);"
     " err = norm(x - xt);"),
    ("pcg-dense-function", "A = [4 1 0; 1 4 1; 0 1 4]; xt = [1; 2; 3];"
     " b = A * xt; prec = @(r) r ./ diag(A);"
     " [x, flag] = pcg(A, b, 1e-12, 50, prec); err = norm(x - xt);"),
    # tests/test_fea_solvers.py
    ("ilu", "A = sparse([4 -1 0; -1 4 -1; 0 -1 4]); [L, U] = ilu(A);"
     " W = ilu(A); e = norm(full(L*U - A), 'fro'); dl = full(L);"
     " du = full(U);"),
    # tests/test_fea.py
    ("femesh", "m = femesh([2 1 1], [4 2 2]); i = femesh_info(m);"
     " m2 = femesh([1 1 1], [3 3 3]); i2 = femesh_info(m2);"
     " q = i2.min_quality; clear m m2;"),
    ("fea-thermal", "m = femesh([1 1 1], [5 3 3]); c = fea_node_coords(m);"
     " r = fea_thermal(m, 3.7, {'x==0', 100; 'x==L', 0});"
     " x = max(abs(r.temperature - (100 * (1 - c(:,1))))); clear m;"),
    ("fea-electrostatic", "m = femesh([1 1 1], [4 2 2]);"
     " r = fea_electrostatic(m, 1, {'x==0', 1; 'x==L', 0});"
     " x = r.max_field; clear m;"),
    ("fea-cantilever", _CANTILEVER),
    ("fea-modal", "mesh = femesh([10 1 1], [12 2 2]);"
     " r = fea_modal(mesh, 1000, 0.0, 1.0, 'x==0', 2);"
     " x = r.frequencies_hz(1); clear mesh;"),
    ("fea-transient", "m = femesh([1 1 1], [4 2 2]);"
     " r = fea_transient(m, 1, 0.01, {'x==0', 100; 'x==L', 0}, 0, 10, 1);"
     " c = fea_node_coords(m); x = max(abs(r.temperature - 100*(1 - c(:,1))));"
     " clear m;"),
    ("fea-nonlinear", "mesh = femesh([5 1 1], [10 2 2]);"
     " tip = fea_boundary_nodes(mesh, 'x==L'); k = numel(tip);"
     " loads = [tip, zeros(k,1), zeros(k,1), (-1e-6/k)*ones(k,1)];"
     " a = fea_linear_static(mesh, 100, 0.3, 'x==0', loads);"
     " b = fea_nonlinear(mesh, 100, 0.3, 'x==0', loads, 3);"
     " x = abs(a.max_displacement - b.max_displacement) / a.max_displacement;"
     " clear mesh;"),
    # tests/test_fea_buckling_harmonic.py
    ("fea-buckling-harmonic", "m = femesh([0.05 0.05 1], [2 2 18]);"
     " top = fea_boundary_nodes(m, 'z==L'); loads = [top(1) 0 0 -1000];"
     " b = fea_buckling(m, 210e9, 0.3, 'z==0', loads, 2);"
     " ok_b = double(b.critical_load_factor > 0);"
     " m2 = femesh([1 1 1], [2 2 2]); t2 = fea_boundary_nodes(m2, 'z==L');"
     " h = fea_harmonic(m2, 210e9, 0.3, 7800, 'z==0', [t2(1) 1e5 0 0],"
     " [100; 500; 900], 0.02, 6); ok_h = double(numel(h.peak_amplitude) == 3);"
     " clear m m2;"),
    # tests/test_delaunay_mesh.py
    ("femesh-delaunay", "m = femesh_delaunay([1 1 1], 0.35);"
     " info = femesh_info(m); q = info.min_quality;"
     " nodes = fea_node_coords(m); nn = size(nodes, 1);"
     " r = fea_linear_static(m, 210e9, 0.3, 'x==0', [nn 0 0 -1e4]);"
     " mx = max(abs(r.displacement(:))); clear m;"),
    # tests/test_sparse_graph_depth.py
    ("maxflow", "G = digraph([1 1 2 3], [2 3 4 4], [10 5 5 10]);"
     " r1 = maxflow(G, 1, 4); H = digraph([1 2], [2 3], [7 3]);"
     " r2 = maxflow(H, 1, 3); K = digraph([1], [2], [4]); K = addnode(K, 1);"
     " r3 = maxflow(K, 1, 3); clear G H K;"),
    ("centrality", "G = graph([1 2], [2 3]); cd = centrality(G, 'degree');"
     " cb = centrality(G, 'betweenness'); cc = centrality(G, 'closeness');"
     " D = digraph([1 2 3], [2 3 1]); cp = centrality(D, 'pagerank');"
     " clear G D;"),
    # tests/test_domains_async.py
    ("graph-shortestpath", "G = graph([1 2 3 1], [2 3 4 4], [1 1 1 5]);"
     " [p, d] = shortestpath(G, 1, 4); n = numnodes(G); e = numedges(G);"
     " A = adjacency(G); sa = issparse(A); F = full(A); dg = degree(G);"
     " clear G A;"),
    ("graph-sparse-matrix", "A = sparse([1 2 3 4], [2 3 4 5], ones(1, 4),"
     " 5, 5); G = graph(A + A'); n = numnodes(G); e = numedges(G);"
     " [bins, sizes] = conncomp(G); v = bfsearch(G, 1); d = distances(G);"
     " clear G;"),
]


@pytest.mark.parametrize("sid,src", SNIPPETS, ids=[s[0] for s in SNIPPETS])
def test_snippet_matches_the_jax_host_path(no_engine, sid, src):
    host_parity(sid, src, EXACT)
