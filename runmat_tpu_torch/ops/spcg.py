"""Sparse conjugate gradient: the wrappers around `csrc/spcg.cu`.

`cg` is the port's device solve of a symmetric sparse A x = b, the
Jacobi-preconditioned conjugate gradient of `runmat_tpu/sparse.py:_cg_device`
(234-288), which the JAX package runs as one `jax.jit` of a `lax.while_loop`
over a BCOO product (no Pallas twin). A is given as a CSR (`rowptr` int64,
`col` int32, `val` float64), b and the inverse diagonal `invd` as float64
vectors, all on one device. A CPU tensor takes the plain PyTorch versions
below (`plain_cg`, `plain_spmv`); a CUDA tensor launches the kernels or
raises: nothing falls back.

On a card one iteration is three launches of three kernels, in this order:

    spmv_f64      Ap = A p, the tile partials of p.Ap, and the tail of its
                  last block: alpha = (r.z) / (p.Ap)
    cg_update     x += alpha p, r -= alpha Ap, z = invd r, the tile
                  partials of r.z and r.r, and the tail of its last block:
                  beta = (rn.zn) / (r.z), k += 1, the done flag
                  !(sqrt(r.r) > tol sqrt(b.b) && k < maxit)
    cg_direction  p = z + beta p

Every kernel reads the done flag first and writes nothing once it is set,
so CHUNK iterations run as one captured CUDA graph, replayed until the
host, reading the flag once a chunk (`count_read` is told of each read),
finds it set; iterations past the last change nothing, and x is what the
JAX while-loop returns after the same iteration. Every sum runs in a fixed
order (a row's products in ascending column order; each tile of THREADS
rows by a tree; in the block that arrives last, lane t of THREADS adds
the partials of tiles t, t + THREADS, ... in order, and the lanes by the
tree), with no floating-point atomics, so two solves give the same x bit
for bit and the same count. `ordered_sum` is that order in torch ops, and
`plain_cg(..., ordered=True)` the kernels' solve, which they equal bit
for bit. The elementwise steps round each product and sum apart (no FMA),
as the plain version's separate torch ops do.

`launches` counts the kernel launches the card executes and nothing else;
`launches_by` splits them by kernel. A launch made while the stream is
being captured runs only when its graph replays: it is counted in
`captured`, and each replay adds the graph's launches.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ._build import library

launches = 0
launches_by: collections.Counter = collections.Counter()
captured: collections.Counter = collections.Counter()

CHUNK = 128              # iterations a captured graph holds
THREADS = 256            # rows a tile, and lanes (csrc/spcg.cu: kThreads)
# the slots of the scalar state (csrc/spcg.cu: Slot)
SLOTS = {"rz": 0, "bb": 1, "alpha": 2, "beta": 3, "rr": 4, "pap": 5}
_SCALARS = 8                         # float64 slots of the scalar state
_entries: dict = {}


def _entry(name: str, argtypes: list):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


_P, _I64, _INT, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
    ctypes.c_double


def blocks(n: int) -> int:
    """Tiles of THREADS rows a vector of n takes: the count of tile
    partials."""
    return max(1, -(-n // THREADS))


def _launched(label: str, rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"{label} kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured[label] += 1
    else:
        launches += 1
        launches_by[label] += 1


def replayed(graph_launches: collections.Counter, times: int) -> None:
    """A captured graph holding `graph_launches` ran `times` times."""
    global launches
    for label, k in graph_launches.items():
        launches += k * times
        launches_by[label] += k * times


def _stream(t: torch.Tensor) -> tuple:
    index = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.current_stream(index).cuda_stream, index


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_csr(rowptr, col, val, p) -> int:
    n = rowptr.numel() - 1
    if rowptr.dtype != torch.int64 or col.dtype != torch.int32 or \
            val.dtype != torch.float64 or p.dtype != torch.float64:
        raise ValueError(f"spcg: rowptr int64, col int32, val and vectors "
                         f"float64; got {rowptr.dtype}, {col.dtype}, "
                         f"{val.dtype}, {p.dtype}")
    if n < 0 or col.numel() != val.numel() or p.numel() != n:
        raise ValueError(f"spcg: {rowptr.numel()} row pointers, "
                         f"{col.numel()} columns, {val.numel()} values, a "
                         f"vector of {p.numel()}")
    devs = {t.device for t in (rowptr, col, val, p)}
    if len(devs) != 1:
        raise ValueError(f"spcg: operands on {sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in (rowptr, col, val, p)):
        raise ValueError("spcg: operands must be contiguous")
    return n


# ---------------------------------------------------------- plain versions


def plain_spmv(rowptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               p: torch.Tensor) -> torch.Tensor:
    """y = A p over the CSR: a gather, a multiply and each row's sum in
    ascending column order, from 0 (the order of the JAX package's BCOO
    scatter-add), one position of the rows that reach it a step."""
    n = rowptr.numel() - 1
    y = torch.zeros(n, dtype=torch.float64, device=p.device)
    start = rowptr[:-1]
    lens = rowptr[1:] - start
    live = torch.nonzero(lens > 0).reshape(-1)
    k = 0
    while live.numel():
        at = torch.index_select(start, 0, live) + k
        term = torch.index_select(val, 0, at) * torch.index_select(
            p, 0, torch.index_select(col, 0, at).long())
        y = y.index_copy(0, live, torch.index_select(y, 0, live) + term)
        k += 1
        live = torch.masked_select(live, torch.index_select(lens, 0, live) > k)
    return y


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The kernels' tree over the last dimension (THREADS wide): at
    s = 128, 64, ..., 1, v[t] += v[t + s] for t < s; v[0] is the sum."""
    s = THREADS // 2
    while s:
        v = v[..., :s] + v[..., s:2 * s]
        s //= 2
    return v[..., 0]


def _rows(v: torch.Tensor) -> torch.Tensor:
    """v padded with 0.0 to whole rows of THREADS, as rows."""
    pad = -v.numel() % THREADS
    return torch.cat([v, v.new_zeros(pad)]).reshape(-1, THREADS)


def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of v (float64, n values) in the kernels' order, as a 0-d
    tensor: each tile of THREADS values (the last padded with 0.0) by the
    kernels' tree into blocks(n) partials, then lane t adds the partials
    of tiles t, t + THREADS, ... from 0.0 in that order, and the tree over
    the lanes."""
    part = _tree(_rows(v.reshape(-1)))
    lanes = torch.zeros(THREADS, dtype=v.dtype, device=v.device)
    for row in _rows(part):
        lanes = lanes + row
    return _tree(lanes)


def ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.b in the kernels' order: each product rounded, then
    `ordered_sum`."""
    return ordered_sum(a * b)


def plain_cg(rowptr, col, val, b, invd, tol: float = 1e-10,
             maxit: int | None = None, ordered: bool = False) -> tuple:
    """The JAX package's loop (`runmat_tpu/sparse.py:254-280`) in torch
    ops, its condition read on the host each iteration. Returns (x, k).
    ordered: each dot product by `ordered_dot`, and each norm the square
    root of one: the kernels' solve, whose x and k they equal bit for
    bit."""
    n = b.numel()
    maxit = maxit or 10 * n
    if ordered:
        dot = ordered_dot

        def norm(v):
            return torch.sqrt(ordered_dot(v, v))
    else:
        dot, norm = torch.dot, torch.linalg.norm
    x = torch.zeros_like(b)
    r = b
    z = invd * r
    p = z
    k = 0
    bn = norm(b)
    while bool(norm(r) > tol * bn) and k < maxit:
        ap = plain_spmv(rowptr, col, val, p)
        alpha = dot(r, z) / dot(p, ap)
        xn = x + alpha * p
        rn = r - alpha * ap
        zn = invd * rn
        beta = dot(rn, zn) / dot(r, z)
        p = zn + beta * p
        x, r, z, k = xn, rn, zn, k + 1
    return x, k


# ---------------------------------------------------------------- kernels


def spmv(rowptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
         p: torch.Tensor) -> torch.Tensor:
    """y = A p (float64). On a card the `spmv_f64` kernel; on the CPU
    `plain_spmv`."""
    n = _check_csr(rowptr, col, val, p)
    if p.device.type == "cpu":
        return plain_spmv(rowptr, col, val, p)
    if p.device.type != "cuda":
        raise ValueError(f"spmv: no kernel for device {p.device}")
    y = torch.empty(n, dtype=torch.float64, device=p.device)
    _spmv(n, rowptr, col, val, p, y)
    return y


def _spmv(n, rowptr, col, val, p, y, part=None, sc=None, count=None,
          ctl=None) -> None:
    """The `spmv_f64` launch: y = A p; where given, `part` (blocks(n)
    values) the tile partials of p.y, `count` (one int32, 0 between
    launches) the arrival counter of the alpha tail, which writes `sc`'s
    p.Ap and alpha = r.z / p.Ap, and `ctl` the done flag, which stops the
    kernel before it writes."""
    if n == 0:
        return
    fn = _entry("runmat_spmv_f64", [_I64, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _INT])
    _launched("spmv_f64", fn(n, rowptr.data_ptr(), col.data_ptr(),
                             val.data_ptr(), p.data_ptr(), y.data_ptr(),
                             _ptr(part), _ptr(sc), _ptr(count), _ptr(ctl),
                             *_stream(p)))


class _Solver:
    """A solve's state on the card at fixed addresses: the CSR, the
    vectors, the tile partials, the scalars (`SLOTS`: r.z, b.b, alpha,
    beta, r.r, p.Ap), `ctl` = [done, k] (int64) and the arrival counters
    of spmv_f64's and cg_update's tails (int32, zeroed here and at each
    start, reset by each tail); the graph of CHUNK iterations, captured at
    its first solve."""

    def __init__(self, rowptr, col, val, tol: float, maxit: int):
        self.n = n = rowptr.numel() - 1
        dev = val.device
        self.shape = (str(dev), n, val.numel(), float(tol), int(maxit))
        self.rowptr, self.col, self.val = (torch.empty_like(t) for t in
                                           (rowptr, col, val))
        self.invd, self.x, self.r, self.z, self.p, self.ap = (
            torch.empty(n, dtype=torch.float64, device=dev)
            for _ in range(6))
        self.part = torch.empty(2 * blocks(n), dtype=torch.float64,
                                device=dev)
        self.sc = torch.zeros(_SCALARS, dtype=torch.float64, device=dev)
        self.ctl = torch.zeros(2, dtype=torch.int64, device=dev)
        self.count = torch.zeros(2, dtype=torch.int32, device=dev)
        self.tol, self.maxit = float(tol), int(maxit)
        self.graph, self.graph_launches = None, collections.Counter()

    def load(self, rowptr, col, val, invd) -> None:
        for dst, src in ((self.rowptr, rowptr), (self.col, col),
                         (self.val, val), (self.invd, invd)):
            dst.copy_(src)

    def _product(self) -> None:
        """spmv_f64 with its tile partials and its alpha tail."""
        _spmv(self.n, self.rowptr, self.col, self.val, self.p, self.ap,
              self.part, self.sc, self.count[0:1], self.ctl)

    def _update(self, init: bool, tail: bool = True) -> None:
        """cg_update and, unless `tail` is False (for timing), its tail."""
        fn = _entry("runmat_cg_update", [_I64, _INT, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _P, _P, _F64, _I64, _P,
                                          _INT])
        _launched("cg_update", fn(
            self.n, int(init), self.sc.data_ptr(), self.x.data_ptr(),
            self.r.data_ptr(), self.z.data_ptr(), self.p.data_ptr(),
            self.ap.data_ptr(), self.invd.data_ptr(), self.part.data_ptr(),
            _ptr(self.count[1:2] if tail else None), self.ctl.data_ptr(),
            self.tol, self.maxit, *_stream(self.x)))

    def _direction(self) -> None:
        fn = _entry("runmat_cg_direction", [_I64, _P, _P, _P, _P, _P, _INT])
        _launched("cg_direction", fn(
            self.n, self.sc.data_ptr(), self.z.data_ptr(), self.p.data_ptr(),
            self.ctl.data_ptr(), *_stream(self.x)))

    def start(self, b: torch.Tensor) -> None:
        """x = 0, r = b, z = invd r, p = z, k = 0, b.b, r.z, r.r and the
        condition before the first iteration (a zero b is done at once)."""
        self.x.zero_()
        self.r.copy_(b)
        self.ctl.zero_()
        self.count.zero_()
        self._update(init=True)
        self.p.copy_(self.z)

    def step(self) -> None:
        """One iteration: three launches."""
        self._product()
        self._update(init=False)
        self._direction()

    def _capture(self) -> None:
        before = collections.Counter(captured)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.x.device)
        side = torch.cuda.Stream(device=self.x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                for _ in range(CHUNK):
                    self.step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass            # the capture's first error is raised
                raise
            graph.capture_end()
        current.wait_stream(side)
        self.graph = graph
        self.graph_launches = collections.Counter(captured) - before

    def solve(self, b: torch.Tensor, count_read) -> tuple:
        """x (a new tensor) and the iteration count."""
        self.start(b)
        if self.graph is None:
            self._capture()
        while True:
            self.graph.replay()
            replayed(self.graph_launches, 1)
            count_read(int(self.ctl.nbytes))
            done, k = self.ctl.cpu().tolist()
            if done:
                return self.x.clone(), k


def cg(rowptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
       b: torch.Tensor, invd: torch.Tensor, tol: float = 1e-10,
       maxit: int | None = None, cache: dict | None = None,
       count_read=None) -> tuple:
    """Solve A x = b by Jacobi-preconditioned CG. Returns (x, iterations).
    On a card the kernels, CHUNK iterations a graph replay; `cache` (the
    engine's `spcg_cache`) keeps the last solver, its buffers and graph,
    for the next solve of the same shape; `count_read(nbytes)` is called
    once for each read of the done flag. On the CPU `plain_cg`."""
    rowptr, col, val, b, invd = (t.reshape(-1) for t in
                                 (rowptr, col, val, b, invd))
    n = _check_csr(rowptr, col, val, b)
    if invd.dtype != torch.float64 or invd.numel() != n or \
            invd.device != b.device:
        raise ValueError(f"cg: invd {invd.dtype} of {invd.numel()} on "
                         f"{invd.device}, for n = {n} on {b.device}")
    maxit = maxit or 10 * n
    if b.device.type == "cpu":
        return plain_cg(rowptr, col, val, b, invd, tol, maxit)
    if b.device.type != "cuda":
        raise ValueError(f"cg: no kernel for device {b.device}")
    if n >= 1 << 31:
        raise ValueError(f"cg: {n} rows; the kernels index rows with int32 "
                         f"columns")
    solver = None if cache is None else cache.get("solver")
    if solver is None or solver.shape != (str(b.device), n, val.numel(),
                                          float(tol), maxit):
        solver = _Solver(rowptr, col, val, tol, maxit)
        if cache is not None:
            cache["solver"] = solver
    solver.load(rowptr, col, val, invd)
    return solver.solve(b.contiguous(),
                        count_read or (lambda nbytes: None))
