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
larger. `eig_where` profiles one general eigenvalue call (dense_linalg.m's
`eig(A(1:N/8, 1:N/8))`, 512 f64) with torch.profiler: the call's time on
the host, its card kernels' time and count, and its copies each way, which
show where cuSOLVER's geev runs. Each time is the mean of `--reps` after a warm-up, CUDA events
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


def eig_where(n: int = N_LINALG // 8) -> dict:
    """One torch.linalg.eigvals call on an n x n float64 card matrix under
    torch.profiler (after a warm-up call): its host time, the time and
    number of its card kernels, and its copies to and from the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    a = torch.randn(n, n, dtype=torch.float64, device="cuda", generator=gen)
    torch.linalg.eigvals(a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.linalg.eigvals(a)
        torch.cuda.synchronize()
    out = {"n": n, "call_ms": 0.0, "kernel_ms": 0.0, "kernels": 0,
           "copies_to_host": 0, "copies_to_card": 0}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if e.key == "aten::linalg_eigvals":
            out["call_ms"] = e.cpu_time_total / 1e3
        elif e.key.startswith("Memcpy DtoH"):
            out["copies_to_host"] += e.count
        elif e.key.startswith("Memcpy HtoD"):
            out["copies_to_card"] += e.count
        elif e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.key.startswith("Memcpy") and dev_us > 0:
            out["kernel_ms"] += dev_us / 1e3
            out["kernels"] += e.count
    return out


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
    out["eig_where"] = w = eig_where()
    print(f"eigvals {w['n']} f64: the call {w['call_ms']:.1f} ms on the "
          f"host, {w['kernels']} card kernels {w['kernel_ms']:.1f} ms, "
          f"{w['copies_to_host']} copies to the host and "
          f"{w['copies_to_card']} to the card")
    for r in library_rows(args.reps):
        out["library"].append(r)
        print(f"{r['op']:16s} {r['call']}: {r['ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['share']:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
