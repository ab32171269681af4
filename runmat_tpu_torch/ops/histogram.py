"""Histogram counts: the wrapper around `csrc/histogram.cu`.

`histcounts` is the port's device histogram for any n_bins >= 1 and any
number of values, the two Pallas kernels of `runmat_tpu/ops/pallas/histogram.py` in one:
search mode over explicit edges (f32 or f64) and, when the edges are exact
power-of-two affine ones (`affine_edge_params`), a direct index (f32). A CPU
tensor takes the plain PyTorch versions below; a CUDA tensor launches the
kernel or raises. `launches` counts kernel launches and nothing else;
`launches_by` splits the count by mode ("search f32", "search f64",
"direct f32").

Semantics (MATLAB `histcounts`, as the Pallas kernels define them): bin k is
[e_k, e_{k+1}), the last bin is closed on the right, NaN and out-of-range
values count nowhere. Edges must be non-decreasing, as there. The kernel's
search mode finds a value's bin through a guide table over [e_0, e_B] and
exact compares with the edges of the table's bracket (`csrc/histogram.cu`
says why that is exact); the plain search version below is the Pallas
definition itself.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ._build import library

launches = 0
launches_by: collections.Counter = collections.Counter()   # by mode name

_MODES = {torch.float32: 0, torch.float64: 1}
_DIRECT = 2
_MODE_NAMES = {0: "search f32", 1: "search f64", _DIRECT: "direct f32"}
_CHUNK_CELLS = 1 << 26            # (chunk, B+1) compares per pass of the plain form
_entry = None


def _kernel():
    global _entry
    if _entry is None:
        fn = library().runmat_histcounts
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def affine_edge_params(edges: np.ndarray):
    """If `edges` (ascending, B+1 of them) is EXACTLY (m + k) * w in f32
    for integer m and power-of-two w, return (log2(1/w), m) else None.
    Copied from runmat_tpu/ops/pallas/histogram.py:40; the port's direct
    index `floor(x*2^k) - m` is exact for every such m."""
    e = np.asarray(edges, np.float32).reshape(-1)
    if e.size < 2:
        return None
    w = float(e[1]) - float(e[0])
    if not (w > 0 and np.isfinite(w)):
        return None
    j = np.log2(w)
    if j != np.round(j) or abs(j) > 40:
        return None
    m = float(e[0]) / w
    if m != np.round(m) or abs(m) > (1 << 18):
        return None
    k = int(-j)
    mi = int(np.round(m))
    recon = ((mi + np.arange(e.size)) * w).astype(np.float32)
    if not np.array_equal(recon, e):
        return None
    return k, mi


def plain_histcounts(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """The Pallas definition, literally: ge_k = #(x >= e_k) for k = 0..B,
    gt = #(x > e_B), counts = ge[:-1] - ge[1:] with the last bin
    ge[B-1] - gt. Computed in chunks of x; returns (B,) int64."""
    x = x.reshape(-1)
    e = edges.reshape(-1)
    nb = e.numel() - 1
    ge = torch.zeros(nb + 1, dtype=torch.int64, device=x.device)
    gt = torch.zeros((), dtype=torch.int64, device=x.device)
    step = max(1, _CHUNK_CELLS // (nb + 1))
    for s in range(0, x.numel(), step):
        xc = x[s:s + step, None]
        ge += (xc >= e).sum(0)
        gt += (xc[:, 0] > e[-1]).sum()
    counts = ge[:-1] - ge[1:]
    counts[-1] = ge[-2] - gt
    return counts


def plain_histcounts_affine(x: torch.Tensor, n_bins: int, k_exp: int,
                            m: int) -> torch.Tensor:
    """The direct index over edges e_k = (m + k) * 2^-k_exp, on f32 x:
    a = x*2^k_exp (exact; where it underflows to 0, x itself, which lies on
    the same side of every edge), bin = min(floor(a) - m, B-1) in integers,
    valid iff m <= a <= m + B. Returns (B,) int64.

    `histcounts_pallas_affine` computes y = x*2^k_exp - m in f32 instead,
    which rounds when m < 0: a value within an ulp of a zero edge lands on
    it. This form gives the search's counts for every m."""
    xv = x.reshape(-1)
    a = xv * (2.0 ** k_exp)
    a = torch.where(a == 0, xv, a)
    keep = (a >= m) & (a <= m + n_bins)
    idx = torch.floor(a[keep]).to(torch.int64) - m
    return torch.bincount(torch.clamp(idx, max=n_bins - 1),
                          minlength=n_bins)


def histcounts(x: torch.Tensor, edges: torch.Tensor,
               affine: tuple | None = None) -> torch.Tensor:
    """Counts (B,) int64 of the flat contiguous `x` over the B+1 `edges`
    (same dtype, f32 or f64, same device). `affine = (k_exp, m)` states that
    edges == (m + k) * 2^-k_exp exactly in f32 and selects the direct index
    (f32 only)."""
    global launches
    nb = edges.numel() - 1
    n = x.numel()
    if x.dtype not in _MODES or edges.dtype != x.dtype:
        raise ValueError(f"histcounts: x {x.dtype} and edges {edges.dtype} "
                         f"must both be float32 or both float64")
    if nb < 1:
        raise ValueError("histcounts: needs at least two edges")
    if affine is not None and (x.dtype != torch.float32 or
                               not -126 <= affine[0] <= 127 or
                               abs(affine[1]) >= 1 << 24):
        raise ValueError(f"histcounts: affine {affine} needs float32 x, "
                         f"an f32 power of two and an f32-exact offset")
    if x.device != edges.device:
        raise ValueError(f"histcounts: x on {x.device}, edges on "
                         f"{edges.device}")
    if x.device.type == "cpu":
        if affine is not None:
            return plain_histcounts_affine(x, nb, *affine)
        return plain_histcounts(x, edges)
    if x.device.type != "cuda":
        raise ValueError(f"histcounts: no kernel for device {x.device}")
    x = x.reshape(-1).contiguous()
    edges = edges.reshape(-1).contiguous()
    counts = torch.zeros(nb, dtype=torch.int64, device=x.device)
    if n == 0:
        return counts
    k_exp, m = affine if affine is not None else (0, 0)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    mode = _DIRECT if affine is not None else _MODES[x.dtype]
    rc = _kernel()(mode, x.data_ptr(), n, edges.data_ptr(), nb, int(k_exp),
                   int(m), counts.data_ptr(),
                   torch.cuda.current_stream(index).cuda_stream, index)
    if rc != 0:
        raise RuntimeError(f"histcounts kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_by[_MODE_NAMES[mode]] += 1
    return counts
