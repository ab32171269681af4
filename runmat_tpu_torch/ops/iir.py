"""IIR filtering, direct form II transposed: the wrappers around
`csrc/iir.cu`, `csrc/iir_warp.cu` and `csrc/iir_seq.cu`.

`iir(x, b, a, z0)` filters the vector x with N coefficients b and a (a[0]
is 1 and not read) from the state z0 (N-1 values), as the JAX package's
`_b_iir` scan does (runmat_tpu/accel/dense.py:706-728), for any N >= 2. A
CPU tensor takes the plain version below; a CUDA tensor launches a kernel
or raises, by the number of coefficients: the chunked scan (`launch`,
csrc/iir.cuh) for N <= MAX_COEFS (orders 1-32), the chunked scan with a
warp a stretch (`warp_launch`, csrc/iir_warp.cu) for N <= MAX_WARP_COEFS
(orders 33-64), the sample recurrence in one block (`seq_launch`,
csrc/iir_seq.cu) above that. `launches` counts filter calls that launched
a kernel (one each, whatever the number of its phases) and nothing else;
`launches_by` splits the count by route and dtype ("iir f32", "iir f64",
"iir_warp f32", "iir_warp f64", "iir_seq f32", "iir_seq f64"). The
sequential kernel rounds every operation as the plain version does, in
the same order, so all its outputs are bit-equal to it.

The two chunked kernels share one design (see their sources): stretches
of L samples filtered from a zero state, the states carried into each
stretch through powers of the state matrix in float64, and each stretch
filtered again from its carried state. They differ in the carries: the
scan of iir.cuh takes them in log steps over G^(2^k), the warp kernel in
order, one block-wide matvec a carry, in groups of `group` carries whose
totals are scanned first. `chunked_iir` is a model of those phases in
plain PyTorch, vectorised over stretches, with either carry order
(`group`), for the CPU tests; nothing on the main path calls it.

`plain_iir` is the scan's step, one sample at a time on the host, in the
scan's order of operations: y = b0 * x_i + z[0], then z = (b[1:] * x_i +
[z[1:], 0]) - a[1:] * y, over Python floats for float64 and numpy float32
scalars for float32, so that each product, sum and difference is rounded
on its own in x's type. A chunked kernel's first stretch (its first L
outputs, and the whole call when n <= L) rounds each one the same way in
the same order, from z0 itself, so those are bit-equal to it; after that
the carried states are rounded in another order, and the kernel is held
to the plain version within TOL of the largest output magnitude (float64
1e-10, float32 1e-4), with the non-finite outputs in the same places.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ._build import library

launches = 0
launches_by: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.float64: 1}
_NAMES = {torch.float32: "iir f32", torch.float64: "iir f64"}
_WARP_NAMES = {torch.float32: "iir_warp f32", torch.float64: "iir_warp f64"}
_SEQ_NAMES = {torch.float32: "iir_seq f32", torch.float64: "iir_seq f64"}
MAX_COEFS = 33          # kMaxN of csrc/iir.cu: orders 1..32 (it refuses more)
MAX_WARP_COEFS = 65     # csrc/iir_warp.cu: two states a lane of a warp, so
                        # orders up to 64 (it refuses more)
CHUNK = 64              # samples a stretch (a power of two, at most 2^20):
                        # the fastest of 32..4096 on an H100 (PERF.md)
PHASES = ("powers", "chunk states", "carries", "output")
WARP_PHASES = ("chunk states and G", "carries and G's powers", "output")
# csrc/iir.cu's block shapes, printed beside the times: phases 2 and 4 walk
# a stretch a thread in blocks of 128 stretches, staging tiles of 32
# samples of each; phase 3 scans blocks of 128 threads of 16 carries each
SHAPE = {"walk_threads": 128, "tile": 32, "scan_threads": 128, "run": 16}
# csrc/iir_warp.cu's stretch length L and carry group g by signal length:
# (largest n, L, g), the first row whose n is not exceeded; g = 0 would
# scan the carries in one level. The fastest shapes on an H100 at
# resample_pages.m's call (2^18 samples) and at 2^22 (chip_smoke.py's
# IIR_WARP_SWEEP; PERF.md)
WARP_SHAPES = ((1 << 20, 128, 16), (1 << 62, 1024, 16))
# its block shapes, printed beside the times: the walks take a stretch a
# warp, two warps a block, staging tiles of 128 samples; the carries take
# blocks of 128 threads, two a row of G, tiles of 32 carries
WARP_SHAPE = {"walk_warps": 2, "tile": 128, "carry_threads": 128,
              "carry_tile": 32}
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
_entry = None
_warp_entry = None
_seq_entry = None


def warp_shape(n: int) -> tuple:
    """(L, g) of csrc/iir_warp.cu for a signal of n samples."""
    for most, chunk, group in WARP_SHAPES:
        if n <= most:
            return chunk, group
    raise ValueError(f"iir: no stretch length for n={n}")


def _warp_kernel():
    global _warp_entry
    if _warp_entry is None:
        lib = library()
        size = lib.runmat_iir_warp_scratch
        size.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_int64
        fn = lib.runmat_iir_warp
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _warp_entry = (size, fn)
    return _warp_entry


def _seq_kernel():
    global _seq_entry
    if _seq_entry is None:
        lib = library()
        size = lib.runmat_iir_seq_scratch
        size.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
        size.restype = ctypes.c_int64
        fn = lib.runmat_iir_seq
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _seq_entry = (size, fn)
    return _seq_entry


def _kernel():
    global _entry
    if _entry is None:
        lib = library()
        size = lib.runmat_iir_scratch
        size.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int]
        size.restype = ctypes.c_int64
        fn = lib.runmat_iir
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry = (size, fn)
    return _entry


def _steps(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
           z: torch.Tensor) -> tuple:
    """The scan's step along the last axis of x (S stretches of L samples)
    from the states z (S x M), every operation a torch op in x's dtype:
    (y, the end states)."""
    b0, bk, ak = b[0], b[1:], a[1:]
    zero = torch.zeros(x.shape[0], 1, dtype=x.dtype)
    y = torch.empty_like(x)
    for i in range(x.shape[1]):
        xi = x[:, i]
        yi = b0 * xi + z[:, 0]
        z = (bk * xi[:, None] + torch.cat([z[:, 1:], zero], 1)) - \
            ak * yi[:, None]
        y[:, i] = yi
    return y, z


def _seq_carries(v: torch.Tensor, g: torch.Tensor, group: int) -> torch.Tensor:
    """csrc/iir_warp.cu's phase 2 on the rows of v (float64): c_0 = v_0,
    c_j = G c_{j-1} + v_j in order. With groups of `group` rows (0: one
    group), each group is scanned from zero for its total, the totals are
    scanned the same way with G^group (a level up, again in groups while
    they are more than `group`), and each group is scanned again from the
    total before it."""
    def scan(rows, mat, cin=None):
        out = rows.clone()
        prev = cin
        for j in range(rows.shape[0]):
            if prev is not None:
                out[j] = mat @ prev + rows[j]
            prev = out[j]
        return out
    if not group or v.shape[0] <= group:
        return scan(v, g)
    parts = list(torch.split(v, group))
    totals = _seq_carries(torch.stack([scan(part, g)[-1] for part in parts]),
                          torch.linalg.matrix_power(g, group), group)
    return torch.cat([scan(part, g, totals[i - 1] if i else None)
                      for i, part in enumerate(parts)])


def chunked_iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
                z0: torch.Tensor, chunk: int,
                group: int | None = None) -> torch.Tensor:
    """The chunked kernels' phases in plain PyTorch on the CPU, for any
    chunk >= 1: the stretches filtered from zero, the carries c_0 = z0,
    c_j = G c_{j-1} + s_{j-1} (G = A^chunk) in float64 whatever x's type,
    and the stretches filtered again from their carries, rounded to x's
    type. `group` None scans the carries in log steps over G^(2^k)
    (csrc/iir.cuh); an int scans them in order as csrc/iir_warp.cu does,
    in groups of `group` carries (0: one level)."""
    xv = x.reshape(-1)
    n, m = xv.numel(), b.numel() - 1
    b, a = b.reshape(-1), a.reshape(-1)
    p = max(1, -(-n // chunk))
    xs = torch.zeros(p * chunk, dtype=xv.dtype)
    xs[:n] = xv
    xs = xs.reshape(p, chunk)
    f64 = torch.float64
    c = torch.empty(p, m, dtype=f64)
    c[0] = z0.reshape(-1)
    if p > 1:
        _, ends = _steps(xs[:-1], b, a, torch.zeros(p - 1, m,
                                                    dtype=xv.dtype))
        c[1:] = ends
        am = torch.diag(torch.ones(m - 1, dtype=f64), 1)
        am[:, 0] -= a[1:].to(f64)
        g = torch.linalg.matrix_power(am, chunk)
        if group is not None:
            c = _seq_carries(c, g, group)
        d = 1
        while group is None and d < p:
            nxt = c.clone()
            nxt[d:] = c[:-d] @ g.T + c[d:]
            c, g, d = nxt, g @ g, 2 * d
    y, _ = _steps(xs, b, a, c.to(xv.dtype))
    return y.reshape(-1)[:n]


def plain_iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
              z0: torch.Tensor) -> torch.Tensor:
    """The scan, one sample at a time on the host (flat x; b, a of N
    values; z0 of N-1); y comes back on x's device in x's dtype."""
    f64 = x.dtype == torch.float64
    scalar = float if f64 else np.float32

    def values(t):
        v = t.reshape(-1).cpu().tolist()
        return v if f64 else [scalar(e) for e in v]
    xs, bv, av = values(x), values(b), values(a)
    zero = scalar(0.0)
    z = values(z0) + [zero]
    b0 = bv[0]
    coefs = list(zip(bv[1:], av[1:], range(1, len(bv))))
    y = []
    for xi in xs:
        yi = b0 * xi + z[0]
        z = [bk * xi + z[k] - ak * yi for bk, ak, k in coefs]
        z.append(zero)
        y.append(yi)
    out = np.asarray(y, dtype=np.float64 if f64 else np.float32)
    return torch.from_numpy(out).to(x.device)


def _check(x, b, a, z0) -> None:
    n_coef = b.numel()
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (b, a, z0)):
        raise ValueError(f"iir: x {x.dtype}, b {b.dtype}, a {a.dtype} and "
                         f"z0 {z0.dtype} must share float32 or float64")
    if a.numel() != n_coef or z0.numel() != n_coef - 1 or n_coef < 2:
        raise ValueError(f"iir: b and a need the same N >= 2 values and z0 "
                         f"N - 1 (b {b.numel()}, a {a.numel()}, z0 "
                         f"{z0.numel()})")
    if any(t.device != x.device for t in (b, a, z0)):
        raise ValueError("iir: x, b, a and z0 must share one device")


def _operands(x, b, a, z0) -> tuple:
    """x, b, a and z0 checked and on a card: flat and contiguous, with y
    allocated and the card's index."""
    _check(x, b, a, z0)
    if x.device.type != "cuda":
        raise ValueError(f"iir: no kernel for device {x.device}")
    flat = [t.reshape(-1).contiguous() for t in (x, b, a, z0)]
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return flat, torch.empty_like(flat[0]), index


def _lg2(value: int, what: str) -> int:
    lg = value.bit_length() - 1
    if value < 1 or value != 1 << lg:
        raise ValueError(f"iir: the {what} must be a power of two, not "
                         f"{value}")
    return lg


def launch(x, b, a, z0, chunk: int = CHUNK, upto: int = 4) -> torch.Tensor:
    """The kernel's phases 1..upto (4: all) on CUDA tensors, stretches of
    `chunk` samples; y (flat), written by phase 4. Counts nothing: `iir`
    counts its calls, and the phases and other chunks are for timing."""
    (xv, bv, av, zv), y, index = _operands(x, b, a, z0)
    n_coef = b.numel()
    if n_coef > MAX_COEFS:
        raise ValueError(f"iir: the kernel takes at most {MAX_COEFS} "
                         f"coefficients, not {n_coef}")
    lg = _lg2(chunk, "chunk")
    if xv.numel() == 0:
        return y
    size, fn = _kernel()
    code = _DTYPES[x.dtype]
    nbytes = size(code, xv.numel(), n_coef, lg)
    if nbytes < 0:
        raise ValueError(f"iir: the kernel refuses n={xv.numel()}, "
                         f"N={n_coef}, chunk={chunk}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    rc = fn(code, xv.data_ptr(), y.data_ptr(), xv.numel(), n_coef,
            bv.data_ptr(), av.data_ptr(), zv.data_ptr(), lg,
            scratch.data_ptr(), nbytes, upto,
            torch.cuda.current_stream(index).cuda_stream, index)
    if rc != 0:
        raise RuntimeError(f"iir kernel launch failed: CUDA error {rc}")
    return y


def warp_launch(x, b, a, z0, chunk: int | None = None,
                group: int | None = None, upto: int = 3) -> torch.Tensor:
    """csrc/iir_warp.cu's phases 1..upto (3: all, WARP_PHASES) on CUDA
    tensors, N <= MAX_WARP_COEFS coefficients, stretches of `chunk`
    samples and carry groups of `group` (0: one level; both
    `warp_shape(n)` where chunk is None); y (flat), written by phase 3.
    Counts nothing: `iir` counts its calls, and the phases and other
    shapes are for timing."""
    (xv, bv, av, zv), y, index = _operands(x, b, a, z0)
    n_coef, n = b.numel(), xv.numel()
    if n_coef > MAX_WARP_COEFS:
        raise ValueError(f"iir: the warp kernel takes at most "
                         f"{MAX_WARP_COEFS} coefficients, not {n_coef}")
    if chunk is None:
        chunk, group = warp_shape(n)
    lg = _lg2(chunk, "chunk")
    lg_group = _lg2(group, "group") if group else 0
    if n == 0:
        return y
    size, fn = _warp_kernel()
    code = _DTYPES[x.dtype]
    nbytes = size(code, n, n_coef, lg, lg_group)
    if nbytes < 0:
        raise ValueError(f"iir: the warp kernel refuses n={n}, N={n_coef}, "
                         f"chunk={chunk}, group={group}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) \
        if nbytes else None
    rc = fn(code, xv.data_ptr(), y.data_ptr(), n, n_coef, bv.data_ptr(),
            av.data_ptr(), zv.data_ptr(), lg, lg_group,
            scratch.data_ptr() if scratch is not None else None, nbytes,
            upto, torch.cuda.current_stream(index).cuda_stream, index)
    if rc != 0:
        raise RuntimeError(f"iir_warp kernel launch failed: CUDA error {rc}")
    return y


def seq_launch(x, b, a, z0) -> torch.Tensor:
    """csrc/iir_seq.cu on CUDA tensors, any N >= 2 coefficients: y (flat).
    Counts nothing (`iir` counts its calls)."""
    (xv, bv, av, zv), y, index = _operands(x, b, a, z0)
    if xv.numel() == 0:
        return y
    size, fn = _seq_kernel()
    code = _DTYPES[x.dtype]
    nbytes = size(code, xv.numel(), b.numel())
    if nbytes < 0:
        raise ValueError(f"iir: the sequential kernel refuses "
                         f"n={xv.numel()}, N={b.numel()}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) \
        if nbytes else None
    rc = fn(code, xv.data_ptr(), y.data_ptr(), xv.numel(), b.numel(),
            bv.data_ptr(), av.data_ptr(), zv.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, nbytes,
            torch.cuda.current_stream(index).cuda_stream, index)
    if rc != 0:
        raise RuntimeError(f"iir_seq kernel launch failed: CUDA error {rc}")
    return y


def iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
        z0: torch.Tensor) -> torch.Tensor:
    """y (flat, x's dtype) of the filter over flat x. x, b, a and z0 share
    one dtype (float32 or float64) and one device; b and a hold N >= 2
    values, z0 N - 1. On a card, N <= MAX_COEFS takes the chunked scan, N
    <= MAX_WARP_COEFS the warp kernel and more the sequential kernel."""
    global launches
    if x.device.type == "cpu":
        _check(x, b, a, z0)
        return plain_iir(x, b, a, z0)
    n_coef = b.numel()
    if n_coef <= MAX_COEFS:
        y, names = launch(x, b, a, z0), _NAMES
    elif n_coef <= MAX_WARP_COEFS:
        y, names = warp_launch(x, b, a, z0), _WARP_NAMES
    else:
        y, names = seq_launch(x, b, a, z0), _SEQ_NAMES
    if y.numel():
        launches += 1
        launches_by[names[x.dtype]] += 1
    return y
