"""Time the linear algebra, signal and page slices on the card: the IIR
kernels and the library calls of `dense_linalg.m`, `spectral.m` and
`resample_pages.m` at their default shapes.

    python3 runmat_tpu_torch/linalgbench.py [--tree DIR] [--reps 5]

`iir_inputs` makes spectral.m's IIR call (its 4th-order Butterworth
filter over 2^22 samples of the script's signal) and `iir_row` holds the
kernel (`ops/iir.py`, a chunked parallel scan) on such inputs to its plain
version over the whole signal (`held`: bit for bit on the first stretch of
`iir.CHUNK` samples, elsewhere within `iir.TOL` of the largest output
magnitude, non-finite values in the same places), and times both: the
kernel and each of its four phases with CUDA events, the plain version (a
loop on the host over the signal copied there, the copies included) once
on the host's clock; beside them the least time the card could take
(bytes: x read and y written once, 3.35 TB/s; operations: 4 (N - 1) + 2 a
sample at the card's float64 or float32 rate). `iir_sweep` times the
kernel at other stretch lengths on the same call. `seq_inputs` makes
resample_pages.m's order-39 filter (40 coefficients); `warp_row` holds the
warp kernel (`csrc/iir_warp.cu`, orders 33-64) on it to the plain version
as `held` does, and times it with its three phases beside the bound and the
sequential kernel; `seq_row` holds the sequential kernel (`csrc/iir_seq.cu`,
the orders above 64, and any order through `iir.seq_launch`) to the plain
version bit for bit over every output and times both beside the same
bound. `builder_rows` times resample_pages.m's device builders
(interp1lin, topk, the page functions; `builder_calls`) beside their
bounds and, where one PyTorch call computes the same function,
`torch.topk` or `torch.bmm`; `host_waits` makes each while the card is
busy, to show a wait inside a library that torch's sync debug mode does
not see. `library_rows` times
each call the two scripts make into cuSOLVER, cuFFT and cuDNN through
torch, at the scripts' shapes, beside its bound: the flop count of the textbook
algorithm over the card's peak for the type (float64 67 TFLOP/s, the
tensor cores' DMMA rate; float32 67 TFLOP/s outside the tensor cores), or
its inputs read and outputs written once over 3.35 TB/s, whichever is
larger. `eig_held` holds the general eigenproblem's three kernels (`ops/eig_qr.py`:
eig_hess, eig_francis, eig_trevc) to their plain versions on the card and
the card's pipeline to the plain one on the CPU (the eigenvalues in the
same order), and times the plain versions; `francis_held` holds
eig_francis to plain_francis on a given Hessenberg matrix; `trevc_held`
holds eig_trevc on a given quasi-triangular T to `ordered_trevc` bit for
bit (the ring design) and to plain_trevc within TREVC_TOL, on T from
`trevc_case` or the card's own Schur forms; `eig_rows`
times the kernels at dense_linalg.m's `eig(A(1:N/8, 1:N/8))` (512 f64)
beside their operations bound, cuSOLVER's geev (torch.linalg.eigvals and
eig: the earlier design) and, for eig_francis, the design with one block
barrier a position in turns and the chain of the chaser and helper warps
alone (owners idle) over the same iterations (the measured floor; the
bench-only entries `runmat_eig_francis_barrier` and
`runmat_eig_francis_chain`, which nothing else calls), for eig_trevc the
earlier design (a warp a column, `runmat_eig_trevc_warp`) in turns, its
chain alone (`runmat_eig_trevc_chain`: the longest columns' quotient,
shuffle and update chain, the measured floor) and cuSOLVER's geev on the
already quasi-triangular T (torch.linalg.eig(T): the whole geev, which
does more than trevc), and holds the eigenvalues to numpy's. Each time is the mean of `--reps` after a
warm-up, CUDA events
(`histbench.time_ms`). Run as a script, this file imports
`runmat_tpu_torch` from DIR (default: the checkout holding this file).
Prints the card's name and power limit, one line a call, then one JSON
line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

N_LINALG = 4096                 # dense_linalg.m's default N
N_SIGNAL = 1 << 22              # spectral.m's default N
BYTES_PER_S = 3.35e12
FLOPS = {"float64": 67e12, "float32": 67e12}
# spectral.m's butter(4, 0.1), as the script writes it
BUTTER_B = (0.00041659920440659937, 0.0016663968176263975,
            0.0024995952264395961, 0.0016663968176263975,
            0.00041659920440659937)
BUTTER_A = (1.0, -3.1806385488747191, 3.8611943489942133,
            -2.1121553551109691, 0.43826514226197977)
EIG_N = N_LINALG // 8           # dense_linalg.m's eig(A(1:N/8, 1:N/8))
EIG_HELD = (24, 64, 128)        # the sizes the eig kernels are held at
EIG_PLAIN_N = 128               # the plain versions are timed here
EIG_BAND = 32                   # eig_francis' band (csrc/eig_qr.cu kBand)
# the card pipeline against the plain one on the CPU: eigenvalues in the
# same order within EIG_TOL of the largest (the reduction's sums differ in
# order, so do the Hessenberg matrices, by rounding), V's columns within
# EIG_V_TOL up to a unit factor (a 2x2 block's representation, and so a
# complex column's phase, turns with rounding)
EIG_TOL = 1e-9
EIG_V_TOL = 1e-9
# runmat_eig_francis_chain's modes (csrc/eig_qr.cu): record the
# iterations' branches, replay them with the owners idle, profile, one
# owner warp
CHAIN_RECORD, CHAIN_ALONE, CHAIN_PROFILE = 1, 2, 8
CHAIN_ONE_OWNER_WARP = 16
PROF_SLOTS = 64
# eig_trevc's fixtures (`trevc_case`) and the Schur forms it is held on at
# the card (`eig_kernels_run`'s T), both sides of trevc_route's boundary
TREVC_CASES = ("n1", "n2", "n3", "ends", "repeated", "graded")
TREVC_SCHUR = (5, 24, 64, 128, 512, 513)
PRODUCER_PHASES = ("P @ R", "C @ P and shuffles", "house3", "publish",
                   "delivery wait", "slide")


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    """(bound_ms, bound_by): bytes over 3.35 TB/s against flops over the
    type's peak, whichever is larger."""
    by_bytes = nbytes / BYTES_PER_S * 1e3
    by_ops = flops / FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def iir_inputs(dtype, n: int = N_SIGNAL, seed: int = 0):
    """spectral.m's IIR call on the card: its two tones and noise at 48
    kHz over n samples (the noise from torch's generator, seeded), the
    Butterworth coefficients and a zero state."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=dev) / 48000
    x = torch.sin(2 * math.pi * 1000 * t) + 0.5 * torch.sin(
        2 * math.pi * 5000 * t) + 0.1 * torch.randn(
        n, dtype=torch.float64, device=dev, generator=gen)
    b = torch.tensor(BUTTER_B, dtype=dtype, device=dev)
    a = torch.tensor(BUTTER_A, dtype=dtype, device=dev)
    return x.to(dtype), b, a, torch.zeros(len(BUTTER_B) - 1, dtype=dtype,
                                          device=dev)


def held(got, want, chunk: int, tol: float) -> dict:
    """`got` (the kernel's y) against `want` (the plain version's):
    bit-equal on the first `chunk` outputs (the first stretch, all of them
    where n <= chunk; NaN equal to NaN); non-finite exactly where `want`
    is; elsewhere within `tol` of want's largest finite magnitude.
    `max_abs_err` over the outputs finite in both, `rel_err` over that
    magnitude, `ok` all three."""
    import torch
    g, w = got.reshape(-1), want.reshape(-1)
    first = min(chunk, w.numel())
    same = (g[:first] == w[:first]) | (torch.isnan(g[:first]) &
                                       torch.isnan(w[:first]))
    fin = torch.isfinite(w)
    finite = torch.equal(torch.isfinite(g), fin)
    both = fin & torch.isfinite(g)
    err = float((g[both] - w[both]).abs().max()) if bool(both.any()) \
        else 0.0
    scale = float(w[fin].abs().max()) if bool(fin.any()) else 0.0
    rel = err / scale if scale else 0.0
    equal = bool(same.all())
    return {"n": w.numel(), "chunk": chunk, "equal_first": equal,
            "finite_same": finite, "max_abs_err": err, "rel_err": rel,
            "ok": equal and finite and rel <= tol}


def iir_row(iir, x, b, a, z0, reps: int, path_y=None) -> dict:
    """The kernel on (x, b, a, z0) against its plain version over the whole
    signal (`held`, at iir.CHUNK and iir.TOL), and `path_y`, where given
    (what the main path computed from these inputs), held to it too; the
    kernel's time, each phase's (the time of phases 1..k less that of
    1..k-1), the plain version's, the bound."""
    import torch

    from runmat_tpu_torch.histbench import time_ms
    y = iir.iir(x, b, a, z0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tol = iir.TOL[x.dtype]
    checks = [held(o, want, iir.CHUNK, tol)
              for o in [y] + ([] if path_y is None else [path_y])]
    ms = time_ms(lambda: iir.iir(x, b, a, z0), reps)
    upto = [time_ms(lambda: iir.launch(x, b, a, z0, upto=k), reps)
            for k in range(1, len(iir.PHASES))] + [ms]
    phase_ms = dict(zip(iir.PHASES, [upto[0]] + [
        upto[k] - upto[k - 1] for k in range(1, len(upto))]))
    n, nb = x.numel(), b.numel()
    bnd = _iir_bound(x, b)
    return {"n": n, "order": nb - 1, "chunk": iir.CHUNK,
            "ok": all(c["ok"] for c in checks),
            "equal_first": all(c["equal_first"] for c in checks),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "rel_err": max(c["rel_err"] for c in checks), "tol": tol,
            "ms": ms, "phase_ms": phase_ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def seq_inputs(dtype, n: int, ncoef: int = 40, seed: int = 0,
               device: str = "cuda"):
    """resample_pages.m's filter, a moving average of `ncoef` samples over
    a recursive part of sum |a_k| = 0.01 (ncoef - 1), on a signal of n
    samples made on the card (torch's generator, seeded); a zero state."""
    import torch
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(n, dtype=torch.float64, device=dev, generator=gen)
    b = torch.full((ncoef,), 1.0 / ncoef, dtype=torch.float64, device=dev)
    a = torch.full((ncoef,), 0.01, dtype=torch.float64, device=dev)
    a[0] = 1.0
    return x.to(dtype), b.to(dtype), a.to(dtype), torch.zeros(
        ncoef - 1, dtype=dtype, device=dev)


def seq_row(iir, x, b, a, z0, reps: int, path_y=None) -> dict:
    """The sequential kernel (`iir.seq_launch`, csrc/iir_seq.cu, which `iir`
    takes above iir.MAX_WARP_COEFS coefficients and which takes any order)
    on (x, b, a, z0) against its plain version, bit for bit over every
    output (NaN equal to NaN), and `path_y` where given; its time, the
    plain version's (the host loop, on the host's clock) and the bound (x
    read and y written once at 3.35 TB/s, or 4 (N - 1) + 2 operations a
    sample at the type's rate)."""
    import torch

    from runmat_tpu_torch.histbench import time_ms
    y = iir.seq_launch(x, b, a, z0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = iir.plain_iir(x, b, a, z0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    checks = [held(o, want, x.numel(), 0.0)
              for o in [y] + ([] if path_y is None else [path_y.reshape(-1)])]
    ms = time_ms(lambda: iir.seq_launch(x, b, a, z0), reps)
    bnd = _iir_bound(x, b)
    return {"n": x.numel(), "order": b.numel() - 1,
            "ok": all(c["ok"] for c in checks),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


def _iir_bound(x, b) -> tuple:
    """The least time of a filter call: x read and y written once at
    3.35 TB/s, or 4 (N - 1) + 2 operations a sample at the type's rate."""
    import torch
    n, nb = x.numel(), b.numel()
    name = "float64" if x.dtype == torch.float64 else "float32"
    return bound(2 * n * x.element_size(), (4 * (nb - 1) + 2) * n, name)


def warp_row(iir, x, b, a, z0, reps: int, path_y=None, want=None,
             seq_reps: int = 0) -> dict:
    """The warp kernel (`iir.iir` with MAX_COEFS < N <= MAX_WARP_COEFS
    coefficients, csrc/iir_warp.cu) on (x, b, a, z0) against `want` (the
    plain version's y, made here, timed on the host's clock, where not
    given): bit for bit on the first stretch of L samples, elsewhere
    within iir.TOL of the largest output magnitude, non-finite values in
    the same places (`held`), and `path_y` where given held the same way;
    the kernel's time and each phase's (WARP_PHASES: the time of phases
    1..k less that of 1..k-1), the bound and, with `seq_reps`, the
    sequential kernel's time on the same input."""
    import torch

    from runmat_tpu_torch.histbench import time_ms
    y = iir.iir(x, b, a, z0)
    torch.cuda.synchronize()
    plain_ms = None
    if want is None:
        t0 = time.perf_counter()
        want = iir.plain_iir(x, b, a, z0)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    n = x.numel()
    chunk, group = iir.warp_shape(n)
    tol = iir.TOL[x.dtype]
    checks = [held(o, want, chunk, tol)
              for o in [y] + ([] if path_y is None else [path_y.reshape(-1)])]
    ms = time_ms(lambda: iir.iir(x, b, a, z0), reps)
    upto = [time_ms(lambda: iir.warp_launch(x, b, a, z0, upto=k), reps)
            for k in range(1, len(iir.WARP_PHASES))] + [ms]
    phase_ms = dict(zip(iir.WARP_PHASES, [upto[0]] + [
        upto[k] - upto[k - 1] for k in range(1, len(upto))]))
    bnd = _iir_bound(x, b)
    return {"n": n, "order": b.numel() - 1, "chunk": chunk, "group": group,
            "ok": all(c["ok"] for c in checks),
            "equal_first": all(c["equal_first"] for c in checks),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "rel_err": max(c["rel_err"] for c in checks), "tol": tol,
            "ms": ms, "phase_ms": phase_ms, "plain_ms": plain_ms,
            "seq_ms": time_ms(lambda: iir.seq_launch(x, b, a, z0), seq_reps)
            if seq_reps else None,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def warp_sweep(iir, x, b, a, z0, shapes, reps: int) -> list:
    """The warp kernel on one call at each (L, g) of `shapes` (g = 0: the
    carries in one level; L >= n: one warp walks the whole signal, phase 3
    alone): its time, and one warp's cycles a sample at the 1.98 GHz
    boost clock where a single stretch covers the call."""
    from runmat_tpu_torch.histbench import time_ms
    rows = []
    for chunk, group in shapes:
        ms = time_ms(lambda: iir.warp_launch(x, b, a, z0, chunk, group),
                     reps)
        row = {"chunk": chunk, "group": group, "ms": ms}
        if chunk >= x.numel():
            row["cycles_a_sample"] = ms * 1e-3 * 1.98e9 / x.numel()
        rows.append(row)
    return rows


def builder_calls(n: int = N_SIGNAL, pages: int = 8192,
                  device: str = "cuda") -> list:
    """resample_pages.m's device builders (`accel/dense.py`) on inputs of
    its default shapes made on `device`: (name, the script's call, fn, one
    PyTorch call computing the same function or None, bytes the call must
    move, its flops) each."""
    import torch

    from runmat_tpu_torch.accel import dense
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    f64, w8 = torch.float64, 8
    t = torch.linspace(0, 1, n, dtype=f64, device=dev)
    x = torch.sin(2 * math.pi * 50 * t) + 0.1 * torch.randn(
        n, dtype=f64, device=dev, generator=gen)
    q = t ** 1.5
    y = dense._b_interp1lin(None, ())(t, x, q)
    ay = y.abs()
    A = torch.randn(32, 32, pages, dtype=f64, device=dev, generator=gen) + \
        32 * torch.eye(32, dtype=f64, device=dev)[:, :, None]
    B = torch.randn(32, 32, pages, dtype=f64, device=dev, generator=gen)
    pa, pb = A.permute(2, 0, 1), B.permute(2, 0, 1)

    class Eng:              # what the page and norm builders read
        matmul_precision = "highest"

        @staticmethod
        def count_sync(nbytes, reason):
            pass
    eng = Eng()
    page = pages * 32 * 32 * w8
    mm = 2 * 32 ** 3 * pages
    return [
        ("interp1lin", "interp1(t, x, tq) (2^22 knots and queries, f64)",
         lambda: dense._b_interp1lin(eng, ())(t, x, q), None,
         4 * n * w8, 0),
        ("topk", "maxk(abs(y), 1024) (2^22, f64)",
         lambda: dense._b_topk(eng, (1024, True))(ay),
         lambda: torch.topk(ay, 1024), n * w8 + 1024 * w8, 0),
        ("topk", "mink(y, 16) (2^22, f64)",
         lambda: dense._b_topk(eng, (16, False))(y),
         lambda: torch.topk(y, 16, largest=False), n * w8 + 16 * w8, 0),
        ("pagemtimes", "pagemtimes(A, B) (8192 x 32^2, f64)",
         lambda: dense._b_pagemtimes(eng, ("none", "none"))(A, B),
         lambda: torch.bmm(pa, pb), 3 * page, mm),
        ("pagemtimes", "pagemtimes(A, 'transpose', B, 'none')",
         lambda: dense._b_pagemtimes(eng, ("transpose", "none"))(A, B),
         lambda: torch.bmm(pa.transpose(1, 2), pb), 3 * page, mm),
        ("pagesolve", "pagemldivide(A, B) (8192 x 32^2, f64)",
         lambda: dense._b_pagesolve(eng, ())(A, B), None, 3 * page,
         pages * (2 * 32 ** 3 / 3 + 2 * 32 ** 3)),
        ("pageinv", "pageinv(A) (8192 x 32^2, f64)",
         lambda: dense._b_pageinv(eng, ())(A), None, 2 * page,
         pages * 2 * 32 ** 3),
        ("pagenorm", "pagenorm(C, 'fro') (8192 x 32^2, f64)",
         lambda: dense._b_pagenorm(eng, ("fro",))(A), None,
         page + pages * w8, 2 * 32 * 32 * pages),
    ]


def builder_rows(reps: int, calls: list) -> list:
    """Each of `builder_calls` timed beside its bound (inputs read and
    outputs written once at 3.35 TB/s; the page products' and solves'
    flops over the float64 rate where larger) and its PyTorch call
    (`torch.topk`, `torch.bmm`) where there is one."""
    from runmat_tpu_torch.histbench import time_ms
    rows = []
    for name, call, fn, lib, nbytes, flops in calls:
        ms = time_ms(fn, reps)
        bnd = bound(nbytes, flops, "float64")
        rows.append({"op": name, "call": call, "ms": ms,
                     "library_ms": None if lib is None else time_ms(lib, reps),
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "share": bnd[0] / ms})
    return rows


def host_waits(calls, spin_cycles: int = 10 ** 8) -> list:
    """Which calls wait for the card inside torch, where torch's sync debug
    mode may not see it (a library's own device synchronise): each call of
    `calls` ((name, fn) pairs, warmed up first) is made while the card
    spins `spin_cycles` (about 50 ms on an H100) and timed on the host's
    clock. A call that returns in well under the spin enqueued its work;
    one that takes about the spin waited for the card."""
    import torch
    rows = []
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        rows.append({"call": name, "host_ms": host_ms,
                     "card_ms": host_ms + (time.perf_counter() - t1) * 1e3})
    return rows


def iir_sweep(iir, x, b, a, z0, chunks, reps: int) -> list:
    """The kernel at each stretch length of `chunks` on one call: its time
    and its error against the plain version `want`'s largest magnitude."""
    from runmat_tpu_torch.histbench import time_ms
    want = iir.plain_iir(x, b, a, z0)
    rows = []
    for chunk in chunks:
        r = held(iir.launch(x, b, a, z0, chunk), want, chunk,
                 iir.TOL[x.dtype])
        r["ms"] = time_ms(lambda: iir.launch(x, b, a, z0, chunk), reps)
        rows.append(r)
    return rows


def library_rows(reps: int) -> list:
    """The scripts' cuSOLVER, cuFFT and cuDNN calls through torch at their
    default shapes, each timed beside its bound."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    f64 = torch.float64
    n = N_LINALG
    A = torch.randn(n, n, dtype=f64, device=dev, generator=gen)
    S = A.mT @ A / n + torch.eye(n, dtype=f64, device=dev)
    b = torch.randn(n, 1, dtype=f64, device=dev, generator=gen)
    x = torch.randn(N_SIGNAL, dtype=f64, device=dev, generator=gen)
    X = torch.fft.fft(x)
    k31 = torch.randn(31, dtype=f64, device=dev, generator=gen)
    img = torch.randn(1, 1, 1024, 1024, dtype=torch.float32, device=dev,
                      generator=gen)
    box = torch.ones(1, 1, 5, 5, dtype=torch.float32, device=dev) / 25
    h, q, e = n // 2, n // 4, n // 8
    w8, w16 = 8, 16
    # (name, script's call, fn, bytes, flops, dtype)
    calls = [
        ("gemm", "A' * A (4096, f64)", lambda: A.mT @ A,
         3 * n * n * w8, 2 * n ** 3, "float64"),
        ("potrf", "chol(S) (4096, f64)", lambda: torch.linalg.cholesky_ex(S),
         2 * n * n * w8, n ** 3 / 3, "float64"),
        ("getrf+getrs", "S \\ b (4096, f64)",
         lambda: torch.linalg.solve_ex(S, b), n * n * w8 + 2 * n * w8,
         2 * n ** 3 / 3 + 2 * n * n, "float64"),
        ("geqrf+orgqr", "qr(A(:, 1:N/4), 0) (4096 x 1024, f64)",
         lambda: torch.linalg.qr(A[:, :q]),
         (2 * n * q + q * q) * w8, 4 * n * q * q - 4 * q ** 3 / 3,
         "float64"),
        ("gesvd values", "svd(A(1:N/2, 1:N/2)) (2048, f64)",
         lambda: torch.linalg.svdvals(A[:h, :h]), h * h * w8 + h * w8,
         8 * h ** 3 / 3, "float64"),
        ("syevd values", "eig(S) (4096, f64)",
         lambda: torch.linalg.eigvalsh(S), n * n * w8 + n * w8,
         4 * n ** 3 / 3, "float64"),
        ("geev values", "eig(A(1:N/8, 1:N/8)) (512, f64)",
         lambda: torch.linalg.eigvals(A[:e, :e]), e * e * w8 + e * w16,
         10 * e ** 3, "float64"),
        ("getrf", "lu(A(1:N/2, 1:N/2)) (2048, f64)",
         lambda: torch.linalg.lu_factor_ex(A[:h, :h]), 2 * h * h * w8,
         2 * h ** 3 / 3, "float64"),
        ("getrf+getri", "inv(S(1:N/4, 1:N/4)) (1024, f64)",
         lambda: torch.linalg.inv_ex(S[:q, :q]), 2 * q * q * w8,
         2 * q ** 3, "float64"),
        ("fft r2c", "fft(y) (2^22, f64)", lambda: torch.fft.fft(x),
         N_SIGNAL * (w8 + w16), 2.5 * N_SIGNAL * 22, "float64"),
        ("fft c2c inverse", "ifft(X .* H) (2^22, c128)",
         lambda: torch.fft.ifft(X), 2 * N_SIGNAL * w16,
         5 * N_SIGNAL * 22, "float64"),
        ("conv1d", "filter(b, 1, x) (2^22 x 31 taps, f64)",
         lambda: torch.nn.functional.conv1d(
             x.reshape(1, 1, -1), k31.reshape(1, 1, -1), padding=30),
         2 * N_SIGNAL * w8, 2 * 31 * N_SIGNAL, "float64"),
        ("conv2d", "conv2(single(...), single(ones(5)/25), 'same') "
         "(1024^2 x 5x5, f32)",
         lambda: _fp32_conv2d(img, box), 2 * img.numel() * 4,
         2 * 25 * img.numel(), "float32"),
    ]
    from runmat_tpu_torch.histbench import time_ms
    rows = []
    for name, call, fn, nbytes, flops, dt in calls:
        ms = time_ms(fn, reps)
        bnd = bound(nbytes, flops, dt)
        rows.append({"op": name, "call": call, "ms": ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "share": bnd[0] / ms})
    return rows


def _fp32_conv2d(img, box):
    """The port's conv2 call: cuDNN in true FP32 (`accel/dense.py`)."""
    import torch

    from runmat_tpu_torch.accel.dense import tf32
    with tf32(False, "conv"):
        return torch.nn.functional.conv2d(img, box, padding=2)


def eig_matrix(n: int, dev, seed: int = 0):
    """A random n x n float64 matrix (numpy's generator from `seed`) on
    `dev`: the general eigenproblem's input."""
    import numpy as np
    import torch
    a = np.random.default_rng(seed + n).standard_normal((n, n))
    return torch.tensor(a, dtype=torch.float64, device=dev)


def _phase_err(V, W) -> float:
    """The largest column difference of V from W after turning each column
    of W by the unit factor that best aligns it (a complex eigenvector's
    phase is free)."""
    import torch
    c = torch.sum(W.conj() * V, dim=0)
    mag = torch.abs(c)
    u = torch.where(mag > 0, c / torch.where(mag > 0, mag, 1), 1)
    return float(torch.max(torch.abs(V - W * u[None, :])))


def _host_ms(fn, dev):
    """(result, ms) of one call of `fn` on the host's clock, the card
    synchronized before and after where `dev` is the card."""
    import torch
    card = torch.device(dev).type == "cuda"
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if card:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# eig_trevc's arguments after T, read off T (accel/eig_qr.py _quasi_eigs)
TREVC_ARGS = ("wr", "wi", "is2", "prev2")


def eig_kernels_run(n: int, dev) -> dict:
    """The three eigenvalue kernels (`ops/eig_qr.py`) on `eig_matrix(n)`
    balanced as eig balances it, on `dev`: each kernel's inputs and
    outputs, eig_hess and eig_francis with and without Q and Z, eig_trevc
    on eig_francis' T."""
    import torch

    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.ops import eig_qr as K
    A = eig_matrix(n, dev)
    Ab = EQ.balance(A)
    H, Q = K.hessenberg(Ab, True)
    H1, _ = K.hessenberg(Ab, False)
    Hp = torch.zeros((n + 3, n + 3), dtype=torch.float64, device=dev)
    Hp[:n, :n] = H
    maxit = 40 * n + 100
    T, Z, info = K.francis(Hp, n, maxit, True)
    T1, _, info1 = K.francis(Hp, n, maxit, False)
    Tn = T[:n, :n].contiguous()
    q = dict(zip(TREVC_ARGS, EQ._quasi_eigs(Tn, n)))
    Yr, Yi = K.trevc(Tn, *q.values())
    return {"n": n, "A": A, "Ab": Ab, "H": H, "Q": Q, "H1": H1, "Hp": Hp,
            "T": T, "Z": Z, "info": info, "T1": T1, "info1": info1,
            "Tn": Tn, **q, "Yr": Yr, "Yi": Yi, "smin": float(K._smin(Tn))}


def eig_plain_held(run: dict, plain_dev) -> dict:
    """`eig_kernels_run`'s kernels against their plain versions on
    `plain_dev`, on copies of the kernels' inputs: eig_hess with and
    without Q within HESS_TOL (of the largest |A|; of 1 for Q) of
    plain_hessenberg; eig_francis with and without Z equal to
    plain_francis on the kernel's own Hessenberg matrix, value for value,
    with the same [ok, iterations, chain]; eig_trevc within TREVC_TOL of the
    largest |Y| on the same T and, on the ring route, equal to
    `ordered_trevc` (on the CPU, with the card's smin) bit for bit. On the
    CPU each plain version runs once,
    with Q and with Z (H and T do not depend on them). Raises
    AssertionError; returns each kernel's largest absolute difference, the
    info and each plain version's time (the host's clock, once)."""
    import torch

    from runmat_tpu_torch.ops import eig_qr as K
    n, dev = run["n"], run["H"].device
    pdev = torch.device(plain_dev)
    both = pdev.type != "cpu"       # each plain version without Q/Z as well
    s = float(torch.max(torch.abs(run["Ab"])))
    out = {"n": n, "plain_dev": pdev.type, "plain_ms": {}}
    plain = out["plain_ms"]
    pAb = run["Ab"].to(pdev)
    (pH, pQ), plain["eig_hess with Q"] = _host_ms(
        lambda: K.plain_hessenberg(pAb, True), pdev)
    pH1 = pH
    if both:
        (pH1, _), plain["eig_hess"] = _host_ms(
            lambda: K.plain_hessenberg(pAb, False), pdev)
    err = max(float(torch.max(torch.abs(run["H"] - pH.to(dev)))),
              float(torch.max(torch.abs(run["H1"] - pH1.to(dev)))))
    qerr = float(torch.max(torch.abs(run["Q"] - pQ.to(dev))))
    assert err <= K.HESS_TOL * s and qerr <= K.HESS_TOL, \
        ("eig_hess", n, err, qerr)
    out["eig_hess"] = max(err, qerr)
    T, Z, T1 = run["T"], run["Z"], run["T1"]
    info, info1 = run["info"], run["info1"]
    maxit = 40 * n + 100
    pHp = run["Hp"].to(pdev)
    (pT, pZ, pinfo), plain["eig_francis with Z"] = _host_ms(
        lambda: K.plain_francis(pHp, n, maxit, True), pdev)
    pT1, pinfo1 = pT, pinfo
    if both:
        (pT1, _, pinfo1), plain["eig_francis"] = _host_ms(
            lambda: K.plain_francis(pHp, n, maxit, False), pdev)
    pT, pZ, pT1 = pT.to(dev), pZ.to(dev), pT1.to(dev)
    assert torch.equal(T, pT) and torch.equal(Z, pZ) and \
        torch.equal(T1, pT1), ("eig_francis", n, float(torch.max(torch.abs(
            T - pT))), float(torch.max(torch.abs(Z - pZ))),
            float(torch.max(torch.abs(T1 - pT1))))
    assert info.tolist() == pinfo.tolist() == info1.tolist() == \
        pinfo1.tolist(), ("eig_francis info", n, info.tolist(),
                          pinfo.tolist())
    out["eig_francis"] = 0.0
    out["info"] = info.tolist()
    pTn, *pq = (run[k].to(pdev) for k in ("Tn",) + TREVC_ARGS)
    (pYr, pYi), plain["eig_trevc"] = _host_ms(
        lambda: K.plain_trevc(pTn, *pq), pdev)
    pYr, pYi = pYr.to(dev), pYi.to(dev)
    yerr = max(float(torch.max(torch.abs(run["Yr"] - pYr))),
               float(torch.max(torch.abs(run["Yi"] - pYi))))
    ys = max(1.0, float(torch.max(torch.abs(pYr))),
             float(torch.max(torch.abs(pYi))))
    assert yerr <= K.TREVC_TOL * ys, ("eig_trevc", n, yerr)
    out["eig_trevc"] = yerr
    if K.trevc_route(n) == "ring":
        oYr, oYi = K.ordered_trevc(*(run[k].cpu() for k in ("Tn",) +
                                     TREVC_ARGS), smin=run["smin"])
        assert torch.equal(run["Yr"].cpu(), oYr) and \
            torch.equal(run["Yi"].cpu(), oYi), ("eig_trevc ordered", n)
        out["trevc_ordered"] = True
    return out


def eig_held(n: int, dev, plain_dev=None) -> dict:
    """The three eigenvalue kernels against their plain versions at n
    (`eig_kernels_run`, `eig_plain_held`), the plain versions on
    `plain_dev` (the card by default). On the card, the whole pipeline
    (`accel/eig_qr.py` eig_values and eig_full) is also held to the plain
    versions on the CPU: the same ok, the eigenvalues in the same order
    within EIG_TOL of the largest, V column by column within EIG_V_TOL up
    to a unit factor. Raises AssertionError; returns `eig_plain_held`'s
    dict, with the V error where the pipeline ran."""
    import torch

    from runmat_tpu_torch.accel import eig_qr as EQ
    run = eig_kernels_run(n, dev)
    out = eig_plain_held(run, dev if plain_dev is None else plain_dev)
    if out["plain_dev"] == "cpu":
        return out
    A = run["A"]
    wr, wi, ok = EQ.eig_values(A)
    cr, ci, cok = EQ.eig_values(A.cpu())
    Vr, Vi, fr, fi, fok = EQ.eig_full(A)
    pVr, pVi, gr, gi, gok = EQ.eig_full(A.cpu())
    assert bool(ok) == bool(cok) == bool(fok) == bool(gok), ("ok", n)
    w = torch.complex(wr, wi).cpu()
    ws = max(1.0, float(torch.max(torch.abs(w))))
    for got, want, what in ((w, torch.complex(cr, ci), "eig_values"),
                            (torch.complex(fr, fi).cpu(),
                             torch.complex(gr, gi), "eig_full")):
        werr = float(torch.max(torch.abs(got - want)))
        assert werr <= EIG_TOL * ws, (what, "order or values", n, werr)
    verr = _phase_err(torch.complex(Vr, Vi).cpu(), torch.complex(pVr, pVi))
    assert verr <= EIG_V_TOL, ("eig_full V", n, verr)
    out["v_err"] = verr
    return out


def _plain_child(conn, arrays: dict) -> None:
    """`eig_plain_held` on the CPU in a process of its own: the kernels'
    run as numpy arrays in, its dict (or the AssertionError's arguments)
    out through `conn`."""
    import numpy as np
    import torch
    run = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in arrays.items()}
    try:
        conn.send(("ok", eig_plain_held(run, "cpu")))
    except AssertionError as e:
        conn.send(("assert", e.args))
    conn.close()


class PlainBeside:
    """`eig_held(n, dev, "cpu")` with its plain versions in a process of
    their own, so that the host's other work goes on beside them: the
    kernels run on `dev` at construction, `result()` waits for the check
    (raising its AssertionError) and `stop()` ends the process."""

    def __init__(self, n: int, dev):
        import multiprocessing

        import torch
        run = eig_kernels_run(n, dev)
        arrays = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in run.items()}
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_plain_child, args=(child, arrays),
                                daemon=True)
        self.proc.start()
        child.close()

    def result(self, timeout: float = 600.0) -> dict:
        try:
            if not self.conn.poll(timeout):
                raise RuntimeError(f"the plain versions outlasted {timeout} s")
            kind, value = self.conn.recv()
        except EOFError as e:
            raise RuntimeError(f"the plain versions' process ended "
                               f"(exit code {self.proc.exitcode})") from e
        finally:
            self.stop(wait=10.0)
        if kind == "assert":
            raise AssertionError(*value)
        return value

    def stop(self, wait: float = 0.0) -> None:
        """Ends the process, after `wait` seconds for it to end itself."""
        self.proc.join(wait)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


def trevc_case(name: str):
    """A quasi-triangular T (numpy float64) for eig_trevc's checks: "n1",
    "n2" (one 2x2 block), "n3" (a 1x1 row above a 2x2 block); "ends" (n =
    12, 2x2 blocks at the top and the bottom); "repeated" (n = 10: a 1x1
    eigenvalue twice and one 2x2 block twice, so that dtrevc's smin
    replacement fires in the 1x1 and the 2x2 form: their denominators
    come out exactly 0); "graded" (n = 16, entries falling from 1 to
    1e-12 along the diagonal, two 2x2 blocks)."""
    import numpy as np
    rng = np.random.default_rng(26)

    def block(T, i, a, b, c):      # [a b; c a] at (i, i + 1), b c < 0
        T[i, i] = T[i + 1, i + 1] = a
        T[i, i + 1], T[i + 1, i] = b, c

    if name == "n1":
        return np.array([[rng.standard_normal()]])
    sizes = {"n2": 2, "n3": 3, "ends": 12, "repeated": 10, "graded": 16}
    n = sizes[name]
    T = np.triu(rng.standard_normal((n, n)))
    if name == "n2":
        block(T, 0, 0.3, 1.7, -0.4)
    elif name == "n3":
        block(T, 1, -0.2, 0.9, -1.3)
    elif name == "ends":
        block(T, 0, 0.4, 1.1, -0.8)
        block(T, n - 2, -0.6, 0.7, -1.9)
    elif name == "repeated":
        T[0, 0] = T[3, 3] = 2.0
        block(T, 4, 0.5, 1.0, -1.0)
        block(T, 7, 0.5, 1.0, -1.0)
    elif name == "graded":
        block(T, 3, 0.8, 1.2, -0.5)
        block(T, 11, -0.3, 0.6, -1.4)
        i = np.arange(n)
        T = T * 10.0 ** (-6.0 * (i[:, None] + i[None, :]) / n)
    return T


def trevc_bench(T, q, design: str):
    """(Yr, Yi) of one launch of a bench-only eig_trevc entry on the card
    on the quasi-triangular T and `q` = (wr, wi, is2, prev2): "warp" (the
    earlier design, a warp a column, at any n) or "chain" (the ring
    kernel's last block with only the next row's slots updated: its chain
    alone, n <= TREVC_RING_N; the result is wrong, only its time means
    anything). Counts no launch."""
    from runmat_tpu_torch.ops import eig_qr as K
    args = list(K._trevc_args(T, *q))
    if design == "warp":
        args[0], args[1] = T.contiguous(), T.shape[0]
        rc = K._trevc_call("runmat_eig_trevc_warp", tuple(args), False)
    else:
        rc = K._trevc_call("runmat_eig_trevc_chain", tuple(args))
    if rc != 0:
        raise RuntimeError(f"eig_trevc {design}: CUDA error {rc}")
    yt = args[-1]
    return yt[0].mT, yt[1].mT


def trevc_held(T, repeats: int = 0, plain_dev=None) -> dict:
    """eig_trevc on the quasi-triangular T (float64 on the card): one
    launch, counted under its route's key; on the ring route its Y equal
    to `ordered_trevc`'s (on the CPU, with the card's smin) bit for bit;
    within TREVC_TOL of plain_trevc's largest |Y| (plain on `plain_dev`,
    the card by default); the earlier design (`trevc_bench` "warp")
    within TREVC_TOL of plain too; `repeats` more launches identical to
    the first. Raises AssertionError."""
    import torch

    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.ops import eig_qr as K
    n = T.shape[0]
    q = EQ._quasi_eigs(T, n)
    route = K.trevc_route(n)
    key = K.TREVC_KEYS[route]
    before = K.launches_by[key]
    Yr, Yi = K.trevc(T, *q)
    assert K.launches_by[key] == before + 1, ("eig_trevc launches", n)
    out = {"n": n, "route": route, "repeats": repeats}
    if route == "ring":
        oYr, oYi = K.ordered_trevc(T.cpu(), *(v.cpu() for v in q),
                                   smin=float(K._smin(T)))
        assert torch.equal(Yr.cpu(), oYr) and torch.equal(Yi.cpu(), oYi), \
            ("eig_trevc against ordered_trevc", n, float(torch.max(torch.abs(
                Yr.cpu() - oYr))), float(torch.max(torch.abs(Yi.cpu() - oYi))))
    pdev = T.device if plain_dev is None else torch.device(plain_dev)
    pYr, pYi = K.plain_trevc(T.to(pdev), *(v.to(pdev) for v in q))
    pYr, pYi = pYr.cpu(), pYi.cpu()
    ys = max(1.0, float(torch.max(torch.abs(pYr))),
             float(torch.max(torch.abs(pYi))))
    for what, (gr, gi) in (("kernel", (Yr, Yi)),
                           ("warp", trevc_bench(T, q, "warp"))):
        err = max(float(torch.max(torch.abs(gr.cpu() - pYr))),
                  float(torch.max(torch.abs(gi.cpu() - pYi))))
        assert err <= K.TREVC_TOL * ys, ("eig_trevc", what, n, err, ys)
        out[f"{what}_err"] = err / ys
    for k in range(repeats):
        Yr2, Yi2 = K.trevc(T, *q)
        assert torch.equal(Yr2, Yr) and torch.equal(Yi2, Yi), \
            ("eig_trevc repeat", n, k)
    return out


def francis_bench(Hp, n: int, max_iters: int, with_z: bool, design: str,
                  mode: int = 0, rec=None, prof=None):
    """(H, Z, info) of one launch of a bench-only eig_francis entry on the
    card, as `ops/eig_qr.francis` launches the main one: `design`
    "barrier" (the earlier kernel, one block barrier a bulge position) or
    "chain" (the
    chase with `mode`: CHAIN_RECORD writes each iteration's branch, lo and
    new hi into `rec`, int32 of 3 max_iters; CHAIN_ALONE replays `rec`'s
    first max_iters iterations with the owners idle, so H and Z come back
    wrong and only the time means anything; CHAIN_PROFILE sums clock64
    cycles into
    `prof`, uint64 of PROF_SLOTS zeroed: `francis_profile`;
    CHAIN_ONE_OWNER_WARP gives the owners one warp, so a thread takes
    several indices, as at n > 573). Counts no launch."""
    import ctypes

    import torch

    from runmat_tpu_torch.ops import eig_qr as K
    N = n + 3
    H = Hp.contiguous().clone()
    Zt = torch.eye(N, dtype=H.dtype, device=H.device) if with_z else None
    hfro = K._hfro(H)
    info = torch.empty(3, dtype=torch.int64, device=H.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream, dev = K._stream(H)
    z = Zt.data_ptr() if with_z else None
    if design == "barrier":
        rc = K._entry("runmat_eig_francis_barrier", [P, P, I, I, P, P, P, I])(
            H.data_ptr(), z, n, int(max_iters), hfro.data_ptr(),
            info.data_ptr(), stream, dev)
    else:
        rc = K._entry("runmat_eig_francis_chain",
                      [P, P, I, I, P, P, I, P, P, P, I])(
            H.data_ptr(), z, n, int(max_iters), hfro.data_ptr(),
            info.data_ptr(), mode, None if rec is None else rec.data_ptr(),
            None if prof is None else prof.data_ptr(), stream, dev)
    if rc != 0:
        raise RuntimeError(f"eig_francis {design} mode {mode}: CUDA error "
                           f"{rc}")
    return H, Zt.mT if with_z else None, info


def francis_profile(Hp, n: int, max_iters: int, with_z: bool,
                    mode: int = 0, rec=None) -> dict:
    """Where one launch of eig_francis spends its cycles (clock64 on the
    card, CHAIN_PROFILE): the chaser's phases summed over the bulge
    positions (cycles a position), the band helper's share of time
    waiting for a reflector and its work a position, thread 0's time in
    the lo scan and branch, in the sweeps and after them, the hand-off
    polls, and each owner warp's cycles waiting against working."""
    import torch
    prof = torch.zeros(PROF_SLOTS, dtype=torch.int64, device=Hp.device)
    francis_bench(Hp, n, max_iters, with_z, "chain", mode | CHAIN_PROFILE,
                  rec, prof)
    v = prof.tolist()
    pos = max(v[11], 1)
    owners = [(v[16 + 2 * r], v[17 + 2 * r]) for r in range(23)
              if v[16 + 2 * r] or v[17 + 2 * r]]
    return {"positions": v[11],
            "chaser_cycles_a_position": {
                k: v[i] / pos for i, k in enumerate(PRODUCER_PHASES)},
            "helper_wait_share": v[6] / max(v[6] + v[7], 1),
            "helper_work_cycles_a_position": v[7] / pos,
            "scan_cycles": v[8], "sweep_cycles": v[9], "after_cycles": v[10],
            "hand_off_polls": v[12],
            "owner_wait_share": [w / max(w + k, 1) for w, k in owners],
            "owner_work_cycles_a_position": [k / pos for _, k in owners]}


def francis_held(Hp, n: int, max_iters: int, mode=None) -> list:
    """eig_francis against plain_francis on the card on the padded
    Hessenberg Hp, with and without Z: T and Z value for value and the
    same [ok, iterations, chain]; `mode` runs the bench entry in that mode
    (CHAIN_ONE_OWNER_WARP) in place of the main one. Raises
    AssertionError; returns the info."""
    import torch

    from runmat_tpu_torch.ops import eig_qr as K
    infos = []
    for with_z in (True, False):
        T, Z, info = K.francis(Hp, n, max_iters, with_z) if mode is None \
            else francis_bench(Hp, n, max_iters, with_z, "chain", mode)
        pT, pZ, pinfo = K.plain_francis(Hp, n, max_iters, with_z)
        assert torch.equal(T, pT) and (not with_z or torch.equal(Z, pZ)), \
            ("eig_francis", n, with_z, float(torch.max(torch.abs(T - pT))))
        assert info.tolist() == pinfo.tolist(), ("eig_francis info", n,
                                                 info.tolist(),
                                                 pinfo.tolist())
        infos.append(info.tolist())
    assert infos[0] == infos[1], infos
    return infos[0]


def hess_grid(A, with_q: bool):
    """(H, Q) of one launch of the cooperative eig_hess (the earlier design,
    the route above HESS_RESIDENT_N) at any n >= 3 through the bench-only
    entry `runmat_eig_hess_grid`, as `ops/eig_qr.hessenberg` launches the
    main one. Counts no launch."""
    import ctypes

    import torch

    from runmat_tpu_torch.ops import eig_qr as K
    n = A.shape[0]
    H = A.contiguous().clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device) if with_q else None
    barrier = torch.empty(1, dtype=torch.int64, device=A.device)
    P = ctypes.c_void_p
    stream, dev = K._stream(A)
    rc = K._entry("runmat_eig_hess_grid",
                  [P, P, ctypes.c_int, P, P, ctypes.c_int])(
        H.data_ptr(), Q.data_ptr() if with_q else None, n,
        barrier.data_ptr(), stream, dev)
    if rc != 0:
        raise RuntimeError(f"eig_hess grid: CUDA error {rc}")
    return H, Q


HESS_PHASES = ("exchange 1: wait", "scalars, w and v, their sends",
               "exchange 2: wait", "row pass", "publication, its sends")


def hess_profile(A, with_q: bool) -> dict:
    """Where one launch of the resident eig_hess spends its cycles (clock64
    on the card, each block's thread 0, the bench-only
    `runmat_eig_hess_profile`; n <= 513): cycles a step of each
    phase (HESS_PHASES), the mean over the blocks that own rows and the
    largest, and the total a step. The clock reads add some."""
    import ctypes

    import torch

    from runmat_tpu_torch.ops import eig_qr as K
    n = A.shape[0]
    H = A.contiguous().clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device) if with_q else None
    prof = torch.zeros(8 * K.HESS_BLOCKS, dtype=torch.int64, device=A.device)
    flag = torch.empty(1, dtype=torch.int64, device=A.device)
    P = ctypes.c_void_p
    stream, dev = K._stream(A)
    rc = K._entry("runmat_eig_hess_profile",
                  [P, P, ctypes.c_int, P, P, P, ctypes.c_int])(
        H.data_ptr(), Q.data_ptr() if with_q else None, n, flag.data_ptr(),
        prof.data_ptr(), stream, dev)
    if rc != 0:
        raise RuntimeError(f"eig_hess profile: CUDA error {rc}")
    v = prof.view(K.HESS_BLOCKS, 8)[:, :len(HESS_PHASES)].tolist()
    owning = v[:min(n, K.HESS_BLOCKS)]          # blocks b < n own rows
    steps = n - 2
    mean = [sum(b[q] for b in owning) / len(owning) / steps
            for q in range(len(HESS_PHASES))]
    return {"cycles_a_step": dict(zip(HESS_PHASES, mean)),
            "largest_a_step": dict(zip(HESS_PHASES, [
                max(b[q] for b in owning) / steps
                for q in range(len(HESS_PHASES))])),
            "total_a_step": sum(mean)}


def hess_held(n: int, dev, plain_dev=None, repeats: int = 0) -> dict:
    """eig_hess (the route `hess_route(n)` names) with and without Q
    against plain_hessenberg on `plain_dev` (the card by default) within
    HESS_TOL (of the largest |A|; of 1 for Q), on `eig_matrix(n)`
    balanced, and `repeats` more launches with Q identical to the first.
    Also reports, without asserting, whether H and Q equal
    `ordered_hessenberg`'s (the kernel's order on the CPU) where the
    resident design ran and n <= 128. Raises AssertionError."""
    import torch

    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.ops import eig_qr as K
    pdev = torch.device(dev if plain_dev is None else plain_dev)
    Ab = EQ.balance(eig_matrix(n, dev))
    s = float(torch.max(torch.abs(Ab)))
    H, Q = K.hessenberg(Ab, True)
    H1, _ = K.hessenberg(Ab, False)
    pH, pQ = K.plain_hessenberg(Ab.to(pdev), True)
    err = max(float(torch.max(torch.abs(H - pH.to(dev)))),
              float(torch.max(torch.abs(H1 - pH.to(dev)))))
    qerr = float(torch.max(torch.abs(Q - pQ.to(dev))))
    assert err <= K.HESS_TOL * s and qerr <= K.HESS_TOL, \
        ("eig_hess", n, err, qerr)
    for k in range(repeats):
        H2, Q2 = K.hessenberg(Ab, True)
        assert torch.equal(H2, H) and torch.equal(Q2, Q), \
            ("eig_hess repeat", n, k)
    out = {"n": n, "route": K.hess_route(n), "err": err / s, "qerr": qerr,
           "repeats": repeats}
    if out["route"] == "cluster" and n <= 128:
        oH, oQ = K.ordered_hessenberg(Ab.cpu(), True)
        out["ordered_equal"] = bool(torch.equal(H.cpu(), oH) and
                                    torch.equal(Q.cpu(), oQ))
    return out


def hess_floor(design: str, blocks: int, count: int, smem: int,
               reps: int) -> dict:
    """`count` barriers with nothing between them on the card, CUDA
    events, mean of `reps` launches (the bench-only entry
    `runmat_eig_hess_floor`): "cluster", hardware cluster barriers across
    one cluster of `blocks` blocks of 256 threads holding `smem` bytes of
    dynamic shared memory each (as the resident eig_hess' blocks do), or
    "grid", the cooperative eig_hess' grid_sync across `blocks` blocks of
    256.
    Returns the ms, the µs a barrier and, for a cluster, how many such
    clusters the card holds at once."""
    import ctypes

    import torch

    from runmat_tpu_torch.histbench import time_ms
    from runmat_tpu_torch.ops import eig_qr as K
    P, I = ctypes.c_void_p, ctypes.c_int
    bar = torch.empty(1, dtype=torch.int64, device="cuda")
    clusters = ctypes.c_int(0)
    stream, dev = K._stream(bar)
    fn = K._entry("runmat_eig_hess_floor",
                  [I, I, I, I, P, ctypes.POINTER(ctypes.c_int), P, I])
    code = {"cluster": 0, "grid": 1}[design]

    def launch():
        rc = fn(code, blocks, count, smem, bar.data_ptr(),
                ctypes.byref(clusters), stream, dev)
        if rc != 0:
            raise RuntimeError(f"eig_hess floor {design} x {blocks}: CUDA "
                               f"error {rc} (clusters {clusters.value})")

    ms = time_ms(launch, reps)
    out = {"design": design, "blocks": blocks, "count": count, "smem": smem,
           "ms": ms, "us_per_barrier": ms * 1e3 / max(count, 1)}
    if design == "cluster":
        out["clusters"] = clusters.value
    return out


def eig_hessenberg(n: int, dev):
    """The Hessenberg form (eig_hess) of `eig_matrix(n)` balanced, on the
    card: eig_francis' input at n."""
    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.ops import eig_qr as K
    return K.hessenberg(EQ.balance(eig_matrix(n, dev)), False)[0]


def francis_cases(dev) -> dict:
    """Padded Hessenberg matrices on `dev` for the hand-offs of
    eig_francis (csrc/eig_qr.cu: the band is EIG_BAND columns): label ->
    (Hp, n). "band n": the Hessenberg form of `eig_matrix(n)` at n =
    EIG_BAND - 1, EIG_BAND, EIG_BAND + 1 and 2 EIG_BAND + 3; "splits": a
    random upper Hessenberg of 70 with exact zeros below the first and the
    last diagonal entries and negligible subdiagonals near both ends and in
    the middle, so sweeps start at lo > 0, end next to a deflated block
    and leave columns right of the window; "graded": a random upper
    Hessenberg of 48 whose entries fall from 1 to 1e-12 along the
    diagonal."""
    import numpy as np
    import torch
    out = {}

    def padded(h, n):
        Hp = torch.zeros((n + 3, n + 3), dtype=torch.float64, device=dev)
        Hp[:n, :n] = torch.as_tensor(h, dtype=torch.float64, device=dev)
        return Hp

    for n in (EIG_BAND - 1, EIG_BAND, EIG_BAND + 1, 2 * EIG_BAND + 3):
        out[f"band {n}"] = (padded(eig_hessenberg(n, dev), n), n)
    rng = np.random.default_rng(24)
    n = 70
    h = np.triu(rng.standard_normal((n, n)), -1)
    h[1, 0] = 0.0
    h[n - 1, n - 2] = 0.0
    h[3, 2] = 1e-19
    h[35, 34] = 1e-18
    h[n - 3, n - 4] = 1e-17
    out["splits"] = (padded(h, n), n)
    n = 48
    i = np.arange(n)
    h = np.triu(rng.standard_normal((n, n)), -1) * 10.0 ** (
        -6.0 * (i[:, None] + i[None, :]) / n)
    out["graded"] = (padded(h, n), n)
    return out


def francis_repeat(Hp, n: int, times: int = 20) -> list:
    """eig_francis with Z `times` times on one Hp: every T, Z and info
    identical to the first. Raises AssertionError; returns the info."""
    import torch

    from runmat_tpu_torch.ops import eig_qr as K
    maxit = 40 * n + 100
    T0, Z0, i0 = K.francis(Hp, n, maxit, True)
    for k in range(1, times):
        T, Z, info = K.francis(Hp, n, maxit, True)
        assert torch.equal(T, T0) and torch.equal(Z, Z0) and torch.equal(
            info, i0), ("eig_francis repeat", n, k)
    return i0.tolist()


def eig_rows(reps: int, plain: dict, n: int = EIG_N) -> dict:
    """dense_linalg.m's general eigenproblem at n (512, f64) on the card:
    each kernel timed with CUDA events (the wrapper's call, its few torch
    ops included) as the values path calls it (eig_hess without Q,
    eig_francis without Z) and as [V, D] calls it, beside its operations
    bound (about 10/3 n^3 for the reduction, 10 n^3 for the QR, n^3 for
    trevc at the float64 rate; the bytes of its input and output over
    3.35 TB/s are less) and `plain` (`eig_held`'s times at EIG_PLAIN_N).
    eig_francis also beside the earlier design (`francis_bench`
    "barrier"), the two timed in turns (new, earlier, new, earlier: each
    the mean of its two turns), and the chaser's and helper's chain alone
    over the same iterations (CHAIN_ALONE after CHAIN_RECORD: the measured
    floor; µs a position = its time over the chain);
    the cycles of one profiled launch with Z (`francis_profile`);
    eig_trevc beside the earlier design (`trevc_bench` "warp") in turns
    the same way, its chain alone (`trevc_bench` "chain": the floor) and
    geev on T (torch.linalg.eig of the quasi-triangular T, the whole geev);
    eig_hess beside the earlier design (`hess_grid`, the cooperative
    kernel) in turns the same way, the resident design's n - 2 cluster
    barriers alone (`hess_floor`, its floor), µs a step and one profiled
    launch's cycles a phase with and without Q (`hess_profile`);
    cuSOLVER's geev (torch.linalg.eigvals and eig of A, the earlier
    design; eigvals of the Hessenberg matrix, eig_francis' own input); the
    eigenvalues against numpy's eigvals of the gathered matrix (matched
    greedily, relative to the largest) and [V, D]'s residual and column
    norms."""
    import numpy as np
    import torch

    from runmat_tpu_torch.accel import eig_qr as EQ
    from runmat_tpu_torch.histbench import time_ms
    from runmat_tpu_torch.ops import eig_qr as K
    dev = torch.device("cuda")
    A = eig_matrix(n, dev)
    Ab = EQ.balance(A)
    H, _ = K.hessenberg(Ab, False)
    Hp = torch.zeros((n + 3, n + 3), dtype=torch.float64, device=dev)
    Hp[:n, :n] = H
    maxit = 40 * n + 100
    T, _, info = K.francis(Hp, n, maxit, True)
    ok, iters, chain = info.tolist()
    Tn = T[:n, :n].contiguous()
    q = EQ._quasi_eigs(Tn, n)
    calls = {"eig_hess": lambda: K.hessenberg(Ab, False),
             "eig_hess with Q": lambda: K.hessenberg(Ab, True),
             "eig_francis": lambda: K.francis(Hp, n, maxit, False),
             "eig_francis with Z": lambda: K.francis(Hp, n, maxit, True),
             "eig_trevc": lambda: K.trevc(Tn, *q)}
    ops = {"eig_hess": 10 * n ** 3 / 3, "eig_francis": 10 * n ** 3,
           "eig_trevc": n ** 3}
    nbytes = {"eig_hess": 2 * n * n * 8, "eig_francis": 2 * n * n * 8,
              "eig_trevc": 3 * n * n * 8}
    out = {"n": n, "ok": ok, "iterations": iters, "chain": chain,
           "rows": {}, "plain_n": EIG_PLAIN_N}
    for name, fn in calls.items():
        kernel = name.split()[0]
        b = bound(nbytes[kernel], ops[kernel], "float64")
        out["rows"][name] = {"ms": time_ms(fn, reps), "bound_ms": b[0],
                             "bound_by": b[1], "plain_ms": plain[name]}
    # eig_francis in turns with the earlier design
    for wz, name in ((False, "eig_francis"), (True, "eig_francis with Z")):
        row = out["rows"][name]
        new = [row["ms"]]
        old = []
        for _ in range(2):
            old.append(time_ms(lambda: francis_bench(
                Hp, n, maxit, wz, "barrier"), reps))
            new.append(time_ms(lambda: K.francis(Hp, n, maxit, wz), reps))
        row["ms"] = sum(new[1:]) / 2
        row["barrier_ms"] = sum(old) / 2
        row["turns_ms"] = {"new": new[1:], "barrier": old}
    # eig_hess in turns with the earlier design (the cooperative kernel);
    # the barriers alone: the earlier design's 2 (n - 2) grid barriers
    # across its blocks, and n - 2 cluster barriers across 16 blocks holding
    # the resident design's shared memory (a one-barrier-a-step floor; the
    # resident kernel's exchanges go through mbarriers, `hess_profile`
    # times their waits)
    grid_blocks = max(-(-n // 32), -(-n // 8))
    floors = {"grid": hess_floor("grid", grid_blocks, 2 * (n - 2), 0, reps),
              "cluster": hess_floor("cluster", K.HESS_BLOCKS, n - 2,
                                    K.hess_smem(n), reps)}
    out["hess_floors"] = floors
    for wq, name in ((False, "eig_hess"), (True, "eig_hess with Q")):
        row = out["rows"][name]
        new = [row["ms"]]
        old = []
        for _ in range(2):
            old.append(time_ms(lambda: hess_grid(Ab, wq), reps))
            new.append(time_ms(lambda: K.hessenberg(Ab, wq), reps))
        row["ms"] = sum(new[1:]) / 2
        row["grid_ms"] = sum(old) / 2
        row["turns_ms"] = {"new": new[1:], "grid": old}
        row["us_per_step"] = row["ms"] * 1e3 / (n - 2)
        row["grid_floor_ms"] = floors["grid"]["ms"]
        row["cluster_floor_ms"] = floors["cluster"]["ms"]
    # eig_trevc in turns with the earlier design (a warp a column); its
    # chain alone (the ring kernel's last block with only the next row's
    # slots updated: the floor); cuSOLVER's geev on T itself
    row = out["rows"]["eig_trevc"]
    new = [row["ms"]]
    old = []
    for _ in range(2):
        old.append(time_ms(lambda: trevc_bench(Tn, q, "warp"), reps))
        new.append(time_ms(lambda: K.trevc(Tn, *q), reps))
    row["ms"] = sum(new[1:]) / 2
    row["warp_ms"] = sum(old) / 2
    row["turns_ms"] = {"new": new[1:], "warp": old}
    row["chain_floor_ms"] = time_ms(lambda: trevc_bench(Tn, q, "chain"),
                                    reps)
    row["us_per_row"] = row["ms"] * 1e3 / (n - 1)
    row["geev_T_ms"] = time_ms(lambda: torch.linalg.eig(Tn), reps)
    rec = torch.empty(3 * maxit, dtype=torch.int32, device=dev)
    _, _, rinfo = francis_bench(Hp, n, maxit, False, "chain", CHAIN_RECORD,
                                rec)
    assert rinfo.tolist() == info.tolist(), (rinfo.tolist(), info.tolist())
    out["chain_floor_ms"] = time_ms(lambda: francis_bench(
        Hp, n, iters, False, "chain", CHAIN_ALONE, rec), reps)
    _, _, ainfo = francis_bench(Hp, n, iters, False, "chain", CHAIN_ALONE,
                                rec)
    assert ainfo.tolist()[1:] == info.tolist()[1:], ("replay", ainfo.tolist())
    for name in ("eig_francis", "eig_francis with Z"):
        row = out["rows"][name]
        row["chain_floor_ms"] = out["chain_floor_ms"]
        row["us_per_position"] = row["ms"] * 1e3 / chain
    out["floor_us_per_position"] = out["chain_floor_ms"] * 1e3 / chain
    out["profile"] = francis_profile(Hp, n, maxit, True)
    out["hess_profile"] = {name: hess_profile(Ab, wq) for wq, name in (
        (False, "eig_hess"), (True, "eig_hess with Q"))}
    out["eigvals_ms"] = time_ms(lambda: torch.linalg.eigvals(A), reps)
    out["eig_ms"] = time_ms(lambda: torch.linalg.eig(A), reps)
    out["eigvals_H_ms"] = time_ms(lambda: torch.linalg.eigvals(H), reps)
    wr, wi, vok = EQ.eig_values(A)
    got = list(wr.cpu().numpy() + 1j * wi.cpu().numpy())
    ref = np.linalg.eigvals(A.cpu().numpy())
    err = 0.0
    for r in ref:
        d = [abs(g - r) for g in got]
        j = int(np.argmin(d))
        err = max(err, d[j])
        got.pop(j)
    out["numpy_err"] = err / max(1.0, float(np.max(np.abs(ref))))
    Vr, Vi, fr, fi, fok = EQ.eig_full(A)
    V = torch.complex(Vr, Vi)
    lam = torch.complex(fr, fi)
    res = torch.linalg.norm(A.to(torch.complex128) @ V - V * lam[None, :])
    out["residual"] = float(res / torch.linalg.norm(A))
    out["unit_err"] = float(torch.max(torch.abs(
        torch.linalg.norm(V, dim=0) - 1)))
    out["values_ok"] = bool(vok) and bool(fok)
    out["same_order"] = bool(torch.equal(wr, fr) and torch.equal(wi, fi))
    return out


def print_eig(r: dict) -> None:
    """`eig_rows`' lines."""
    print(f"eig {r['n']} f64: ok {r['ok']}, {r['iterations']} iterations, "
          f"a chain of {r['chain']} bulge positions (chaser and helper alone "
          f"{r['chain_floor_ms']:.2f} ms, {r['floor_us_per_position']:.3f} "
          f"us a position); eigenvalues within {r['numpy_err']:.3g} of "
          f"numpy's (greedy, of the largest), [V, D] residual "
          f"{r['residual']:.3g}, column norms within {r['unit_err']:.3g} of "
          f"1, values and [V, D] in the same order {r['same_order']}")
    for name, row in r["rows"].items():
        extra = ""
        if "barrier_ms" in row:
            extra = (f"; {row['us_per_position']:.3f} us a position, the "
                     f"barrier design {row['barrier_ms']:.2f} ms (turns, ms: "
                     f"new {row['turns_ms']['new']}, barrier "
                     f"{row['turns_ms']['barrier']})")
        if "grid_ms" in row:
            extra = (f"; {row['us_per_step']:.3f} us a step; the cooperative "
                     f"design {row['grid_ms']:.4f} ms (turns, ms: new "
                     f"{row['turns_ms']['new']}, cooperative "
                     f"{row['turns_ms']['grid']}), its {2 * (r['n'] - 2)} "
                     f"grid barriers alone {row['grid_floor_ms']:.4f} ms; "
                     f"{r['n'] - 2} cluster barriers alone "
                     f"{row['cluster_floor_ms']:.4f} ms")
        if "warp_ms" in row:
            extra = (f"; {row['us_per_row']:.3f} us a row of the longest "
                     f"column; the earlier design (a warp a column) "
                     f"{row['warp_ms']:.4f} ms (turns, ms: new "
                     f"{row['turns_ms']['new']}, warp "
                     f"{row['turns_ms']['warp']}); its chain alone "
                     f"{row['chain_floor_ms']:.4f} ms; geev of T (the "
                     f"whole geev, which does more) {row['geev_T_ms']:.3f} "
                     f"ms")
        print(f"  {name:18s} {row['ms']:.4f} ms, bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']}), share {row['bound_ms'] / row['ms']:.2g}"
              f", plain at {r['plain_n']} {row['plain_ms']:.1f} ms{extra}")
    p = r["profile"]
    waits = p["owner_wait_share"]
    print("  eig_francis with Z, clock64 cycles a position of the chaser "
          "(profiled; the clock reads add some): " + ", ".join(
              f"{k} {v:.0f}" for k, v in
              p["chaser_cycles_a_position"].items())
          + f"; the band helper waits {p['helper_wait_share']:.2f} of its "
          f"time, the owner warps {min(waits):.2f}-{max(waits):.2f}")
    for name, hp in r["hess_profile"].items():
        print(f"  {name}, clock64 cycles a step (profiled, blocks' mean; "
              f"the largest in brackets): " + ", ".join(
                  f"{k} {v:.0f} ({hp['largest_a_step'][k]:.0f})"
                  for k, v in hp["cycles_a_step"].items())
              + f"; {hp['total_a_step']:.0f} in all")
    print(f"  geev: torch.linalg.eigvals {r['eigvals_ms']:.3f} ms, "
          f"torch.linalg.eig {r['eig_ms']:.3f} ms, eigvals of the Hessenberg "
          f"matrix {r['eigvals_H_ms']:.3f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    # the tree replaces this file's directory, whose module names
    # (profile.py, ...) would shadow the standard library's
    sys.path[0] = os.path.abspath(args.tree)
    import torch
    if not torch.cuda.is_available():
        print("linalgbench: no CUDA card", file=sys.stderr)
        return 1
    from runmat_tpu_torch.ops import iir
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"tree": os.path.abspath(args.tree), "card": card, "iir": {},
           "library": []}
    for dt in (torch.float64, torch.float32):
        r = iir_row(iir, *iir_inputs(dt), args.reps)
        out["iir"][str(dt).split(".")[1]] = r
        print(f"iir {dt} n=2^22 order {r['order']} L={r['chunk']}: kernel "
              f"{r['ms']:.4f} ms (phases {r['phase_ms']}), plain "
              f"{r['plain_ms']:.1f} ms (host loop), bound {r['bound_ms']:.4f}"
              f" ms ({r['bound_by']}), first stretch bit-equal "
              f"{r['equal_first']}, rel err {r['rel_err']:.3g} (limit "
              f"{r['tol']:g})")
    r = seq_row(iir, *seq_inputs(torch.float64, N_SIGNAL), 3)
    out["iir_seq"] = r
    print(f"iir_seq f64 n=2^22 order {r['order']}: kernel {r['ms']:.3f} ms,"
          f" plain {r['plain_ms']:.1f} ms (host loop), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), bit-equal {r['ok']}")
    for lg in (18, 22):
        x, b, a, z0 = seq_inputs(torch.float64, 1 << lg)
        want = iir.seq_launch(x, b, a, z0) if lg == 22 else None
        r = warp_row(iir, x, b, a, z0, args.reps, want=want, seq_reps=2)
        out[f"iir_warp_2^{lg}"] = r
        print(f"iir_warp f64 n=2^{lg} order {r['order']} L={r['chunk']} "
              f"g={r['group']}: kernel {r['ms']:.4f} ms (phases "
              f"{r['phase_ms']}), iir_seq {r['seq_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), first stretch "
              f"bit-equal {r['equal_first']}, rel err {r['rel_err']:.3g}")
    calls = builder_calls()
    out["builders"] = builder_rows(args.reps, calls)
    out["waits"] = host_waits([(c[1], c[2]) for c in calls])
    for r in out["waits"]:
        print(f"host time with the card busy for 50 ms: {r['call']}: "
              f"{r['host_ms']:.3f} ms (the card's {r['card_ms']:.1f} ms)")
    del calls
    for r in out["builders"]:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"{r['op']:16s} {r['call']}: {r['ms']:.4f} ms, library {lib},"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['share']:.3f}")
    held = eig_held(EIG_PLAIN_N, torch.device("cuda"))
    out["eig"] = r = eig_rows(args.reps, held["plain_ms"])
    print_eig(r)
    for r in library_rows(args.reps):
        out["library"].append(r)
        print(f"{r['op']:16s} {r['call']}: {r['ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['share']:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
