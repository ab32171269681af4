"""Hold the sparse CG kernels to their plain versions on the card, and time
them at sparse_poisson.m's shapes.

    python3 runmat_tpu_torch/spbench.py [--tree DIR] [--N 1024] [--reps 50]

`spmv_cases` makes the matrices `spmv_f64` is held to `plain_spmv` on,
bit for bit (both add each row's products in ascending column order from
0, each rounded apart): rows that are empty, a row of 5000 nonzeros, a
matrix whose triangles differ in the last bits, and the main path's
five-point Poisson matrix (`poisson_csr`, N = 1024: 2^20 rows, 5,240,830
nonzeros). `cg_cases` makes the systems the whole solve (`spcg.cg`, the
four kernels in captured graphs) is held to `plain_cg` on: a 60^2
Poisson system and a seeded symmetric positive definite `sprandsym`-style
matrix; x within `X_TOL` of the largest entry of plain's (the two sum
their dot products in other orders), each residual at most 1e-10 of
norm(b). `step_rows` runs one iteration's five launches one at a time
from a solve's start on the Poisson matrix, holds each kernel to the torch
ops of the JAX loop's body on the same inputs, and times each kernel, the
whole iteration and its plain version with CUDA events
(`histbench.time_ms`), beside the least time the card could take (each
input read once and each output written once over 3.35 TB/s, or the
flops over the float64 rate outside the tensor cores, 34 TFLOP/s,
whichever is larger) and, where one PyTorch call computes the same
function, that call: `torch.sparse_csr_tensor(...) @ p` (cuSPARSE) for
the product, `torch.add(z, p, alpha=beta)` for the direction. Those calls
are yardsticks; the port calls neither. Run as a script, this file imports
`runmat_tpu_torch` from DIR (default: the checkout holding this file) and
prints the card's name and power limit, a line a row and one JSON line.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings

import numpy as np

N_POISSON = 1024                # sparse_poisson.m's default N
BYTES_PER_S = 3.35e12
F64_PER_S = 34e12               # float64 FMA rate outside the tensor cores
X_TOL = 1e-8                    # of the largest entry of x
RESIDUAL_TOL = 1e-10            # of norm(b), the loop's stopping test
# each kernel's scalars against the plain version's dots, relative: the
# same products summed in another order
SCALAR_TOL = 1e-12


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by) of a float64 function."""
    by_bytes = nbytes / BYTES_PER_S * 1e3
    by_ops = flops / F64_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def poisson_csr(N: int, dev) -> tuple:
    """The CSR of sparse_poisson.m's A (spdiags of [-e -e 4e -e -e] at
    [-N -1 0 1 N], n = N^2), built on `dev`: (rowptr, col, val)."""
    import torch
    n = N * N
    offs = torch.tensor([-N, -1, 0, 1, N], device=dev)
    vals = torch.tensor([-1.0, -1.0, 4.0, -1.0, -1.0], dtype=torch.float64,
                        device=dev)
    cols = torch.arange(n, device=dev)[:, None] + offs
    keep = (cols >= 0) & (cols < n)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = torch.cumsum(keep.sum(1), 0)
    return (rowptr, cols[keep].to(torch.int32),
            vals.expand(n, 5)[keep].contiguous())


def csr_of(A, dev) -> tuple:
    """The CSR of a port SparseMatrix on `dev`, as `_cg_device` builds it
    (the CSC of A')."""
    import torch
    t = A.transpose()
    return (torch.from_numpy(t.indptr.astype(np.int64)).to(dev),
            torch.from_numpy(t.rowind.astype(np.int32)).to(dev),
            torch.from_numpy(t.data.astype(np.float64)).to(dev))


def inverse_diagonal(rowptr, col, val):
    """1 / diag(A), with 1 where the diagonal is 0 or absent (the JAX
    package's `inv_d`)."""
    import torch
    n = rowptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=val.device),
                                   rowptr[1:] - rowptr[:-1])
    on = rows == col.long()
    d = torch.ones(n, dtype=torch.float64, device=val.device)
    d[rows[on]] = val[on]
    return 1.0 / torch.where(d == 0, torch.ones_like(d), d)


def spmv_cases(dev) -> list:
    """(label, rowptr, col, val, p) on `dev`."""
    import torch

    from runmat_tpu_torch.sparse import SparseMatrix
    rng = np.random.default_rng(13)
    out = []
    n = 200_000
    ii, jj = rng.integers(0, n, 600_000), rng.integers(0, n, 600_000)
    keep = ii % 3 != 1                            # a third of the rows empty
    A = SparseMatrix.from_triplets(ii[keep], jj[keep],
                                   rng.standard_normal(keep.sum()), n, n)
    out.append(("empty rows (n=200000)", A))
    n = 20_000
    ii = np.concatenate([np.full(5000, 7), rng.integers(0, n, 60_000)])
    jj = np.concatenate([rng.permutation(n)[:5000],
                         rng.integers(0, n, 60_000)])
    out.append(("a row of 5000 nonzeros (n=20000)",
                SparseMatrix.from_triplets(ii, jj,
                                           rng.standard_normal(ii.size),
                                           n, n)))
    n = 100_000
    i, j = rng.integers(0, n, 300_000), rng.integers(0, n, 300_000)
    v = rng.standard_normal(300_000)
    vt = v * (1 + 4 * np.finfo(float).eps * rng.standard_normal(v.size))
    out.append(("triangles that differ in the last bits (n=100000)",
                SparseMatrix.from_triplets(np.concatenate([i, j]),
                                           np.concatenate([j, i]),
                                           np.concatenate([v, vt]), n, n)))
    cases = [(label, *csr_of(A, dev)) for label, A in out]
    cases.append((f"sparse_poisson.m's A (N={N_POISSON})",
                  *poisson_csr(N_POISSON, dev)))
    return [(label, rp, c, v,
             torch.from_numpy(rng.standard_normal(rp.numel() - 1)).to(dev))
            for label, rp, c, v in cases]


def spmv_held(spcg, rowptr, col, val, p) -> dict:
    """The kernel against plain_spmv, bit for bit."""
    import torch
    got = spcg.spmv(rowptr, col, val, p)
    want = spcg.plain_spmv(rowptr, col, val, p)
    torch.cuda.synchronize()
    return {"equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got - want).abs().max())
            if got.numel() else 0.0}


def cg_cases(dev) -> list:
    """(label, rowptr, col, val, b, invd) on `dev`: a 60^2 Poisson system
    and a seeded sprandsym-style one (random symmetric off-diagonals in
    [-1, 1], a dominant diagonal of 14), each with a seeded b."""
    import torch

    from runmat_tpu_torch.sparse import SparseMatrix
    rng = np.random.default_rng(17)
    rp, c, v = poisson_csr(60, dev)
    cases = [("poisson 60^2", rp, c, v)]
    n = 20_000
    i, j = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    w = rng.uniform(-1, 1, 6 * n)
    d = np.arange(n)
    A = SparseMatrix.from_triplets(np.concatenate([i, j, d]),
                                   np.concatenate([j, i, d]),
                                   np.concatenate([w, w, np.full(n, 14.0)]),
                                   n, n)
    cases.append((f"sprandsym-style SPD (n={n}, nnz={A.nnz})",
                  *csr_of(A, dev)))
    return [(label, rp, c, v,
             torch.from_numpy(rng.standard_normal(rp.numel() - 1)).to(dev),
             inverse_diagonal(rp, c, v)) for label, rp, c, v in cases]


def residual(rowptr, col, val, x, b) -> float:
    """norm(A x - b) / norm(b), with A x by scipy on the host."""
    import scipy.sparse as sps
    A = sps.csr_matrix((val.cpu().numpy(), col.cpu().numpy(),
                        rowptr.cpu().numpy()),
                       shape=(b.numel(), b.numel()))
    bh = b.cpu().numpy()
    return float(np.linalg.norm(A @ x.cpu().numpy() - bh) /
                 np.linalg.norm(bh))


def cg_held(spcg, rowptr, col, val, b, invd) -> dict:
    """The kernels' solve (twice: bit for bit the same) against
    plain_cg."""
    import torch
    x1, k1 = spcg.cg(rowptr, col, val, b, invd)
    x2, k2 = spcg.cg(rowptr, col, val, b, invd)
    xp, kp = spcg.plain_cg(rowptr, col, val, b, invd)
    torch.cuda.synchronize()
    err = float((x1 - xp).abs().max())
    scale = float(xp.abs().max())
    res = residual(rowptr, col, val, x1, b)
    repeat = bool(torch.equal(x1, x2)) and k1 == k2
    return {"iterations": k1, "plain_iterations": kp, "repeat": repeat,
            "max_abs_err": err, "rel_err": err / scale, "residual": res,
            "ok": repeat and err <= X_TOL * scale and res <= RESIDUAL_TOL}


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def step_rows(spcg, time_ms, reps: int, N: int = N_POISSON) -> dict:
    """One iteration of sparse_poisson.m's solve, its five launches one at
    a time, each held to the JAX body's torch ops on the same inputs and
    timed; the rows of the kernel JSON line, and the iteration's."""
    import torch
    dev = torch.device("cuda")
    f64 = torch.float64
    rowptr, col, val = poisson_csr(N, dev)
    n, nnz = rowptr.numel() - 1, val.numel()
    b = (1 + torch.sin(torch.arange(1, n + 1, dtype=f64, device=dev) *
                       np.pi / N)) / (N + 1) ** 2
    invd = inverse_diagonal(rowptr, col, val)
    s = spcg._Solver(rowptr, col, val, RESIDUAL_TOL, 10 * n)
    s.load(rowptr, col, val, invd)
    s.start(b)
    rz0 = float(torch.dot(b, invd * b))
    check = {"init": _rel(s.sc[0], rz0) <= SCALAR_TOL and
             torch.equal(s.z, invd * b) and torch.equal(s.p, s.z) and
             int(s.ctl[0]) == 0}
    err = {}
    # spmv_f64 with its partials
    p = s.p.clone()
    spcg._spmv(n, s.rowptr, s.col, s.val, s.p, s.ap, s.part, s.ctl)
    want = spcg.plain_spmv(rowptr, col, val, p)
    err["spmv_f64"] = float((s.ap - want).abs().max())
    check["spmv_f64"] = torch.equal(s.ap, want)
    # cg_scalars: alpha
    s._scalars(spcg._ALPHA)
    alpha = s.sc[2].clone()
    plain_alpha = torch.dot(s.r, s.z) / torch.dot(p, want)
    err["cg_scalars"] = _rel(alpha, plain_alpha)
    # cg_update with the kernel's alpha
    x0, r0 = s.x.clone(), s.r.clone()
    s._update(init=False)
    xw = x0 + alpha * p
    rw = r0 - alpha * want
    zw = invd * rw
    err["cg_update"] = max(float((s.x - xw).abs().max()),
                           float((s.r - rw).abs().max()),
                           float((s.z - zw).abs().max()))
    check["cg_update"] = torch.equal(s.x, xw) and torch.equal(s.r, rw) and \
        torch.equal(s.z, zw)
    # cg_scalars: beta, k, the flag
    rz = s.sc[0].clone()
    s._scalars(spcg._BETA)
    plain_beta = torch.dot(rw, zw) / rz
    err["cg_scalars"] = max(err["cg_scalars"], _rel(s.sc[3], plain_beta))
    check["cg_scalars"] = err["cg_scalars"] <= SCALAR_TOL and \
        s.ctl.tolist() == [0, 1]
    # cg_direction with the kernel's beta
    beta = s.sc[3].clone()
    p0 = s.p.clone()
    s._direction()
    pw = zw + beta * p0
    err["cg_direction"] = float((s.p - pw).abs().max())
    check["cg_direction"] = torch.equal(s.p, pw)
    torch.cuda.synchronize()

    nb = spcg.blocks(n)
    vec = 8 * n
    work = {   # (bytes, flops) each input read once, each output written once
        "spmv_f64": (8 * (n + 1) + 12 * nnz + vec + vec + 8 * nb,
                     2 * nnz + 2 * n),
        "cg_scalars": (8 * 2 * nb + 8 * 4, 2 * nb),
        "cg_update": (5 * vec + 3 * vec + 8 * 2 * nb, 8 * n),
        "cg_direction": (3 * vec, 2 * n),
    }
    s.ctl.zero_()
    with warnings.catch_warnings():       # "support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(rowptr, col.to(torch.int64), val,
                                      (n, n), check_invariants=False)
    beta_f = float(beta)
    runs = {
        "spmv_f64": (lambda: spcg._spmv(n, s.rowptr, s.col, s.val, s.p,
                                        s.ap, s.part, s.ctl),
                     lambda: spcg.plain_spmv(rowptr, col, val, s.p),
                     lambda: csr @ s.p),
        "cg_scalars": (lambda: s._scalars(spcg._ALPHA),
                       lambda: torch.dot(s.r, s.z) / torch.dot(s.p, s.ap),
                       None),
        "cg_update": (lambda: s._update(init=False),
                      lambda: (s.x + alpha * s.p, s.r - alpha * s.ap,
                               invd * (s.r - alpha * s.ap)),
                      None),
        "cg_direction": (lambda: s._direction(),
                         lambda: s.z + beta * s.p,
                         lambda: torch.add(s.z, s.p, alpha=beta_f)),
    }
    rows = {}
    for name, (kernel, plain, library) in runs.items():
        ms = time_ms(kernel, reps)
        plain_ms = time_ms(plain, max(2, reps // 10))
        library_ms = None if library is None else time_ms(library, reps)
        bms, by = bound(*work[name])
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bms, "bound_by": by, "bytes": work[name][0],
                      "max_abs_err": err[name], "ok": bool(check[name])}
    # one iteration: the five launches, eagerly and as CHUNK of them in the
    # captured graph (the path's form), per iteration
    # (each from a solve's start, so that no iteration timed is past the
    # last, which would do nothing)
    s.start(b)
    it_ms = time_ms(s.step, reps)
    s.start(b)
    s._capture()
    graph_ms = time_ms(s.graph.replay, max(2, reps // 10)) / spcg.CHUNK
    s.start(b)

    def plain_step():
        ap = spcg.plain_spmv(rowptr, col, val, s.p)
        a = torch.dot(s.r, s.z) / torch.dot(s.p, ap)
        xn, rn = s.x + a * s.p, s.r - a * ap
        zn = invd * rn
        return xn, zn + (torch.dot(rn, zn) / torch.dot(s.r, s.z)) * s.p

    ib = sum(work[k][0] for k in work) + work["cg_scalars"][0]
    ifl = sum(work[k][1] for k in work) + work["cg_scalars"][1]
    bms, by = bound(ib, ifl)
    iteration = {"ms": it_ms, "graph_ms": graph_ms,
                 "plain_ms": time_ms(plain_step, max(2, reps // 10)),
                 "bound_ms": bms, "bound_by": by, "bytes": ib,
                 "library_ms": rows["spmv_f64"]["library_ms"]}
    return {"n": n, "nnz": nnz, "init_ok": bool(check["init"]),
            "rows": rows, "iteration": iteration}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--N", type=int, default=N_POISSON)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path[0] = os.path.abspath(args.tree)
    import torch
    if not torch.cuda.is_available():
        print("spbench: no CUDA card", file=sys.stderr)
        return 1
    from runmat_tpu_torch import histbench
    from runmat_tpu_torch.ops import spcg
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    for label, *csr in spmv_cases(dev):
        print(f"spmv_f64 {label}: {spmv_held(spcg, *csr)}")
    for label, *sys_ in cg_cases(dev):
        print(f"cg {label}: {cg_held(spcg, *sys_)}")
    r = step_rows(spcg, histbench.time_ms, args.reps, args.N)
    for name, row in r["rows"].items():
        print(f"{name}: {row}")
    print(f"iteration: {r['iteration']}")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
