"""Hold the sparse CG kernels to their plain versions on the card, and time
them at sparse_poisson.m's shapes.

    python3 runmat_tpu_torch/spbench.py [--tree DIR] [--N 1024] [--reps 50]

`spmv_cases` makes the matrices `spmv_f64` is held to `plain_spmv` on,
bit for bit (both add each row's products in ascending column order from
0, each rounded apart): rows that are empty, a row of 5000 nonzeros, a
matrix whose triangles differ in the last bits, and the main path's
five-point Poisson matrix (`poisson_csr`, N = 1024: 2^20 rows, 5,240,830
nonzeros). `cg_cases` makes the systems the whole solve (`spcg.cg`, the
three kernels in captured graphs) is held to on: a 60^2 Poisson system
and a seeded symmetric positive definite `sprandsym`-style matrix; x and
k equal to `plain_cg(..., ordered=True)`'s bit for bit (the kernels'
order of summing, in torch ops), x within `X_TOL` of the largest entry
of `plain_cg`'s (the JAX loop's ops, whose dot products sum in another
order), each residual at most 1e-10 of norm(b). `first_iteration` runs a
solve's start and one iteration's three launches one at a time, holds
each kernel's vectors to the torch ops of the JAX loop's body on the same
inputs and each tail's scalars (p.Ap and alpha; r.z, r.r, beta, k and the
done flag; at the start b.b) to the ordered model, bit for bit.
`step_rows` does that on the path's matrix and times each kernel, the
product without its partials and the update without its tail (the tails'
times are the differences), the whole iteration and its plain version
with CUDA events (`histbench.time_ms`), beside the least time the card
could take (each input read once and each output written once over 3.35
TB/s, or the flops over the float64 rate outside the tensor cores, 34
TFLOP/s, whichever is larger) and, where one PyTorch call computes the
same function, that call: `torch.sparse_csr_tensor(...) @ p` (cuSPARSE)
for the product, `torch.add(z, p, alpha=beta)` for the direction. Those
calls are yardsticks; the port calls neither. Run as a script, this file
imports `runmat_tpu_torch` from DIR (default: the checkout holding this
file) and prints the card's name and power limit, a line a row and one
JSON line. Needs a CUDA card.
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
    """The kernels' solve (twice: bit for bit the same) against the
    ordered model, bit for bit, and against plain_cg."""
    import torch
    x1, k1 = spcg.cg(rowptr, col, val, b, invd)
    x2, k2 = spcg.cg(rowptr, col, val, b, invd)
    xo, ko = spcg.plain_cg(rowptr, col, val, b, invd, ordered=True)
    xp, kp = spcg.plain_cg(rowptr, col, val, b, invd)
    torch.cuda.synchronize()
    err = float((x1 - xp).abs().max())
    scale = float(xp.abs().max())
    res = residual(rowptr, col, val, x1, b)
    repeat = bool(torch.equal(x1, x2)) and k1 == k2
    ordered = bool(torch.equal(x1, xo)) and k1 == ko
    return {"iterations": k1, "plain_iterations": kp, "repeat": repeat,
            "ordered": ordered, "max_abs_err": err, "rel_err": err / scale,
            "residual": res, "ok": repeat and ordered and
            err <= X_TOL * scale and res <= RESIDUAL_TOL}


def tridiagonal_csr(n: int, dev) -> tuple:
    """The CSR of the n x n [-1 2 -1] stencil on `dev`: grids of one block
    (n <= 256) and of two whose second holds one row (n = 257)."""
    import torch
    i = torch.arange(n, device=dev)
    cols = i[:, None] + torch.tensor([-1, 0, 1], device=dev)
    keep = (cols >= 0) & (cols < n)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = torch.cumsum(keep.sum(1), 0)
    vals = torch.tensor([-1.0, 2.0, -1.0], dtype=torch.float64, device=dev)
    return (rowptr, cols[keep].to(torch.int32),
            vals.expand(n, 3)[keep].contiguous())


def _diff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def first_iteration(spcg, s, b, invd) -> tuple:
    """On the loaded solver `s`: a solve's start, then one iteration's
    three launches one at a time. Each kernel's vectors against the JAX
    body's torch ops on the same inputs, each tail's scalars, k and the
    done flag against the ordered model (`spcg.ordered_dot`), bit for bit;
    the arrival counters back at 0. Returns ({step: ok}, {step: max abs
    err}), the steps "start" and the three kernels."""
    import torch
    dot, at = spcg.ordered_dot, spcg.SLOTS

    def scalars(**want) -> bool:
        return all(torch.equal(s.sc[at[k]], v) for k, v in want.items())

    def ctl(rr, bb, k) -> list:
        go = bool(torch.sqrt(rr) > s.tol * torch.sqrt(bb)) and k < s.maxit
        return [0 if go else 1, k]

    check, err = {}, {}
    s.start(b)
    z = invd * b
    bb, rz = dot(b, b), dot(b, z)
    check["start"] = torch.equal(s.z, z) and torch.equal(s.p, z) and \
        scalars(bb=bb, rz=rz, rr=bb) and s.ctl.tolist() == ctl(bb, bb, 0)
    err["start"] = max(_diff(s.z, z), _diff(s.sc[at["rz"]], rz))
    # spmv_f64 and its tail: p.Ap, alpha
    p = s.p.clone()
    s._product()
    ap = spcg.plain_spmv(s.rowptr, s.col, s.val, p)
    pap = dot(p, ap)
    alpha = rz / pap
    check["spmv_f64"] = torch.equal(s.ap, ap) and scalars(pap=pap,
                                                          alpha=alpha)
    err["spmv_f64"] = max(_diff(s.ap, ap), _diff(s.sc[at["alpha"]], alpha))
    # cg_update with the kernel's alpha, and its tail: r.z, r.r, beta, k,
    # the flag
    x0, r0 = s.x.clone(), s.r.clone()
    s._update(init=False)
    xw = x0 + alpha * p
    rw = r0 - alpha * ap
    zw = invd * rw
    rzn, rr = dot(rw, zw), dot(rw, rw)
    beta = rzn / rz
    check["cg_update"] = torch.equal(s.x, xw) and torch.equal(s.r, rw) and \
        torch.equal(s.z, zw) and scalars(rz=rzn, rr=rr, beta=beta, bb=bb) \
        and s.ctl.tolist() == ctl(rr, bb, 1)
    err["cg_update"] = max(_diff(s.x, xw), _diff(s.r, rw), _diff(s.z, zw),
                           _diff(s.sc[at["beta"]], beta))
    # cg_direction with the kernel's beta
    p0 = s.p.clone()
    s._direction()
    pw = zw + beta * p0
    check["cg_direction"] = torch.equal(s.p, pw)
    err["cg_direction"] = _diff(s.p, pw)
    counters = s.count.tolist() == [0, 0]
    torch.cuda.synchronize()
    return {k: bool(v) and counters for k, v in check.items()}, err


def step_rows(spcg, time_ms, reps: int, N: int = N_POISSON) -> dict:
    """One iteration of sparse_poisson.m's solve held by `first_iteration`,
    then each kernel timed, the product without its partials and the
    update without its tail (the tails' times are the differences), and
    the iteration eagerly and in the replayed graph; the rows of the
    kernel JSON line, the tails' and the iteration's."""
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
    check, err = first_iteration(spcg, s, b, invd)
    alpha = s.sc[spcg.SLOTS["alpha"]].clone()
    beta = s.sc[spcg.SLOTS["beta"]].clone()

    vec, tiles = 8 * n, 8 * spcg.blocks(n)
    product = (8 * (n + 1) + 12 * nnz + 2 * vec, 2 * nnz)
    update = (8 * vec + 2 * tiles, 9 * n)
    work = {   # (bytes, flops) each input read once, each output written
        # once; the tile partials written, and read back by the tail with
        # its scalars
        "spmv_f64": (product[0] + 2 * tiles + 8 * 3,
                     product[1] + 2 * n + tiles // 8 + 1),
        "cg_update": (update[0] + 2 * tiles + 8 * 7,
                      update[1] + tiles // 4 + 4),
        "cg_direction": (3 * vec, 2 * n),
    }
    s.ctl.zero_()
    with warnings.catch_warnings():       # "support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(rowptr, col.to(torch.int64), val,
                                      (n, n), check_invariants=False)
    beta_f = float(beta)
    runs = {
        "spmv_f64": (s._product,
                     lambda: spcg.plain_spmv(rowptr, col, val, s.p),
                     lambda: csr @ s.p),
        "cg_update": (lambda: s._update(init=False),
                      lambda: (s.x + alpha * s.p, s.r - alpha * s.ap,
                               invd * (s.r - alpha * s.ap)),
                      None),
        "cg_direction": (s._direction,
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
                      "max_abs_err": err[name], "ok": check[name]}
    # the kernels without their tails, the product without its partials
    bare = {"spmv_f64": (lambda: spcg._spmv(n, s.rowptr, s.col, s.val, s.p,
                                            s.ap, ctl=s.ctl), product),
            "cg_update": (lambda: s._update(init=False, tail=False), update)}
    tails = {}
    for name, (kernel, w) in bare.items():
        ms = time_ms(kernel, reps)
        tails[name] = {"ms": rows[name]["ms"] - ms, "kernel_ms": ms,
                       "kernel_bound_ms": bound(*w)[0],
                       "bytes": work[name][0] - w[0]}
    # no timed launch may have found the done flag set: it would have
    # returned at once
    timed_ok = s.ctl.tolist()[0] == 0
    # one iteration: the three launches, eagerly and as CHUNK of them in the
    # captured graph (the path's form), per iteration (each from a solve's
    # start, so that no iteration timed is past the last, which would do
    # nothing)
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

    ib = sum(w[0] for w in work.values())
    ifl = sum(w[1] for w in work.values())
    bms, by = bound(ib, ifl)
    iteration = {"ms": it_ms, "graph_ms": graph_ms,
                 "plain_ms": time_ms(plain_step, max(2, reps // 10)),
                 "bound_ms": bms, "bound_by": by, "bytes": ib,
                 "library_ms": rows["spmv_f64"]["library_ms"]}
    return {"n": n, "nnz": nnz, "start_ok": check["start"],
            "timed_ok": timed_ok, "rows": rows, "tails": tails,
            "iteration": iteration}


def tail_code() -> dict:
    """Each tail's loads of partials in flight before its first add, and
    the kernel's registers, from the library's machine code
    (`runmat_tpu_torch/sass.py`)."""
    from runmat_tpu_torch import sass
    code = sass.kernels(sass.disassemble())
    res = sass.resources()
    out = {}
    for name, key in (("spmv_f64", "spmv_kernel"),
                      ("cg_update", "update_kernel")):
        (mangled,) = [k for k in code if key in k]
        out[name] = {**sass.tail_loads(code[mangled]),
                     "registers": res.get(mangled, {}).get("REG")}
    return out


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
    for name, row in r["tails"].items():
        print(f"{name} tail: {row}")
    print(f"iteration: {r['iteration']}")
    r["tail_code"] = tail_code()
    print(f"tail code: {r['tail_code']}")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card,
                      **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
