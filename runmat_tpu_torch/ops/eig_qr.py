"""The general eigenproblem's three kernels: the wrappers around
`csrc/eig_qr.cu` and their plain PyTorch versions.

The JAX package computes a real nonsymmetric `eig` as one XLA program
(`runmat_tpu/accel/eig_qr.py`, no Pallas twin); `accel/eig_qr.py` is its
copy, and its three loops run here:

    eig_hess     the Householder reduction to upper Hessenberg form, with
                 or without the accumulated Q (`hessenberg`, 48-80;
                 `hessenberg_q`, 108-141): n - 2 steps, each of four
                 dependent passes over the matrix. Routed by n alone
                 (`hess_route`): up to HESS_RESIDENT_N (627) one cluster of
                 16 blocks keeps H in its shared memory (`hess_smem(n)`
                 bytes a block, within HESS_BUDGET), above it the
                 cooperative grid design
    eig_francis  the implicit double-shift QR iteration with deflation,
                 with or without the Schur vectors Z (`francis_qr_z`,
                 151-284): the whole `lax.while_loop` in one launch
    eig_trevc    the quasi-triangular back-substitution for the right
                 eigenvectors (`trevc`, 362-482) in dtrevc's column
                 (axpy) order. Routed by n alone (`trevc_route`): up to
                 TREVC_RING_N (512) a block of TREVC_COLS adjacent columns,
                 a warp each, the right-hand sides in registers and T's
                 columns streamed through a ring in shared memory
                 (`trevc_smem(n)` bytes); above it the earlier design, one
                 column a warp in the JAX row-dot form

A CPU tensor takes the plain version (`plain_hessenberg`, `plain_francis`,
`plain_trevc`); a CUDA tensor launches the kernel or raises
`MatError("RunMat:eigKernel")`: a failed build or launch, a type other
than float64, a shape the kernel does not take. Nothing falls back.

`plain_francis` is a Python loop over the while-loop's branches: the
scalars that steer it (the deflation tests, the shifts, each 3x3
reflector) are Python floats read off H, whose operations round as the
card's float64 operations do, and each reflector's products are summed
left to right in torch ops, as the kernel sums them (no FMA in either). It
applies each reflector over the whole padded width, as the JAX version
does; the kernel over dlahqr's window (rows k..k+2 from column k-1
rightwards, columns k..k+2 down to row min(k+3, hi)), outside which the
whole-width products only add exact zeros and O(eps) bulge remnants that
never reach the window and are cleared at the sweep's end. So the kernel
equals the plain version on the same H: T and Z value for value (a -0
where the plain version has +0 at most), `ok`, the iteration count and
the chain. The Frobenius norm that sets the deflation floor is computed
by the same torch call for both (`_hfro`).

`plain_hessenberg` and `plain_trevc` sum their long dot products with
`torch.matmul`, the kernels in their own fixed order, so the two agree
within rounding (`HESS_TOL`, `TREVC_TOL`). `ordered_hessenberg` and
`ordered_trevc` write the kernels' orders out on the CPU: the resident
eig_hess and the ring eig_trevc equal them bit for bit.

`launches` counts the kernel launches and nothing else; `launches_by`
splits them by kernel (the ring eig_trevc as "eig_trevc ring"). `francis` returns [ok, iterations, chain] as an
int64 tensor on its device: the chain is the sum of the sweeps' lengths
(bulge positions), the length of the iteration's dependent chain. The
port reads only `ok`, and on the card only through the builtin's flags.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from ..errors import MatError

launches = 0
launches_by: collections.Counter = collections.Counter()

EPS = 2.220446049250313e-16     # float64's machine epsilon
# the kernels against their plain versions on the same input, relative to
# the largest magnitude: the Hessenberg reduction's H and Q (sums of n
# products in another order; H is fixed by Q's first column, but a column
# after a small subdiagonal h(k+1,k) moves by about eps / |h(k+1,k)|: 4.7e-12
# of the largest |A| at n = 128 on the card), the eigenvectors of T
HESS_TOL = 1e-10
TREVC_TOL = 1e-9
# the resident eig_hess (csrc/eig_qr.cu: res_smem, kResBudget): a cluster of
# HESS_BLOCKS blocks, each holding ceil(n / 16) rows of H and, by step
# parity, what its two exchanges deliver into it, in its dynamic shared
# memory, which the H100 lets a block take up to 227 KB of
HESS_BLOCKS = 16
HESS_BUDGET = 232448
# the ring eig_trevc (csrc/eig_qr.cu: kTrevcCols, kTrevcDepth, kTrevcSlots):
# column warps a block, T's columns in flight, 32-row register slots
TREVC_COLS = 4
TREVC_DEPTH = 12
TREVC_RING_N = 32 * 16
_entries: dict = {}


# --------------------------------------------------------------- plain


def plain_hessenberg(A: torch.Tensor, with_q: bool):
    """(H, Q): A = Q H Q' with H upper Hessenberg (Q None unless `with_q`);
    the JAX `hessenberg`/`hessenberg_q` step by step in torch ops."""
    n = A.shape[0]
    H = A.clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device) if with_q else None
    idx = torch.arange(n, device=A.device)
    for k in range(max(n - 2, 0)):
        xt = torch.where(idx > k, H[:, k], 0.0)
        mx = torch.max(torch.abs(xt))
        xt = xt / torch.where(mx == 0, 1.0, mx)
        nrm = torch.sqrt(torch.sum(xt * xt))
        x1 = xt[k + 1]
        alpha = -torch.sign(torch.where(x1 == 0, 1.0, x1)) * nrm
        v = xt - alpha * (idx == k + 1)
        vn2 = torch.sum(v * v)
        safe = vn2 > 0
        v = torch.where(safe, v / torch.sqrt(torch.where(safe, vn2, 1.0)),
                        0.0)
        H = H - 2.0 * torch.outer(v, v @ H)
        H = H - 2.0 * torch.outer(H @ v, v)
        H[k + 2:, k] = 0.0          # exact zeros below the subdiagonal
        if with_q:
            Q = Q - 2.0 * torch.outer(Q @ v, v)
    return H, Q


def _lanes(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's sum of x[:, j] y[j] over j > k as a warp of the kernel
    sums it: lane l adds the products of columns k + 1 + l + 32 q in
    ascending q, then the lanes' tree (`warp_sum`: lane l takes lane
    l + s for s = 16, 8, 4, 2, 1); one value a row."""
    m = x.shape[1] - k - 1
    nq = -(-m // 32)
    pad = 32 * nq - m
    px = torch.nn.functional.pad(x[:, k + 1:], (0, pad))
    py = torch.nn.functional.pad(y[k + 1:], (0, pad))
    part = torch.zeros((x.shape[0], 32), dtype=x.dtype)
    for q in range(nq):
        part = part + px[:, 32 * q:32 * q + 32] * py[32 * q:32 * q + 32]
    s = 16
    while s:
        part = torch.cat([part[:, :s] + part[:, s:2 * s], part[:, s:]], 1)
        s //= 2
    return part[:, 0]


def _tree(vals: list) -> float:
    """A warp's `__shfl_down_sync` sum of 32 values, lane 0's result."""
    vals = list(vals) + [0.0] * (32 - len(vals))
    s = 16
    while s:
        vals = [vals[i] + vals[i + s] if i < s else vals[i]
                for i in range(32)]
        s //= 2
    return vals[0]


def ordered_hessenberg(A: torch.Tensor, with_q: bool):
    """(H, Q) of the resident eig_hess' order of operations, on the CPU in
    float64: the kernel's model, every product and sum rounded apart in
    the kernel's order. Block b of HESS_BLOCKS owns rows b, b + 16, ...
    and publishes, for the step that reduces column k: X_b[j] = the sum
    over its rows i > k, in ascending order, of (H[i, k] 2^-e_b) H[i, j],
    with 2^e_b above its largest |H[i, k]| m_b (frexp), and s_b, the sum
    of those scaled entries' squares without row k + 1's (`_tree` over 32
    lanes, lane l holding local rows l and l + 32). With mxs = max m_b =
    ms 2^E and c_b = 2^(e_b - E) (0 for a block with m_b = 0, whose
    frexp exponent 0 could be far above E): the sum of squares of x / mxs
    without row k + 1's is (sum_b s_b c_b^2) / ms^2, the blocks in order;
    v'H[j] = (Y[j] / ms - alpha H[k+1, j]) / r with Y = sum_b X_b c_b in
    block order, which is (x'H[j] / mxs - alpha H[k+1, j]) / r, the
    reference's v'H with v = (x / mxs - alpha e_{k+1}) / r. Hv and Qv are
    `_lanes` sums; the two updates subtract (2 v_i) w_j and (2 u_i) v_j."""
    n = A.shape[0]
    H = A.clone().to(torch.float64)
    Q = torch.eye(n, dtype=torch.float64) if with_q else None
    nb = min(n, HESS_BLOCKS)

    def publish(kn):
        pubs = []
        for b in range(nb):
            own = list(range(b, n, HESS_BLOCKS))
            rows = [i for i in own if i > kn]
            m = max((abs(float(H[i, kn])) for i in rows), default=0.0)
            e = math.frexp(m)[1]
            xs = {i: math.ldexp(float(H[i, kn]), -e) for i in rows}
            X = torch.zeros(n, dtype=torch.float64)
            for i in rows:
                X = X + xs[i] * H[i]
            lanes = [0.0] * 32
            for r, i in enumerate(own):
                if i in xs and i != kn + 1:
                    lanes[r % 32] = lanes[r % 32] + xs[i] * xs[i]
            pubs.append((m, e, X, _tree(lanes)))
        return pubs

    pubs = publish(0)
    for k in range(max(n - 2, 0)):
        mx = max(p[0] for p in pubs)
        mxs = 1.0 if mx == 0 else mx
        ms, E = math.frexp(mxs)
        sc = [math.ldexp(1.0, p[1] - E) if p[0] > 0 else 0.0 for p in pubs]
        ss = 0.0
        for p, c in zip(pubs, sc):
            ss = ss + p[3] * (c * c)
        sp = ss / (ms * ms)
        x1 = float(H[k + 1, k]) / mxs
        nrm = math.sqrt(sp + x1 * x1)
        alpha = -_sign(1.0 if x1 == 0 else x1) * nrm
        v1 = x1 - alpha
        vn2 = sp + v1 * v1
        safe = vn2 > 0
        r = math.sqrt(vn2 if safe else 1.0)
        v = torch.zeros(n, dtype=torch.float64)
        w = torch.zeros(n, dtype=torch.float64)
        if safe:
            v[k + 1] = v1 / r
            v[k + 2:] = H[k + 2:, k] / mxs / r
            Y = torch.zeros(n, dtype=torch.float64)
            for p, c in zip(pubs, sc):
                Y = Y + p[2] * c
            w[k:] = (Y[k:] / ms - alpha * H[k + 1, k:]) / r
        below = torch.arange(n) > k
        x = torch.where(below[:, None],
                        H - (2.0 * v)[:, None] * w[None, :], H)
        u2 = 2.0 * _lanes(x, v, k)
        Hn = x.clone()
        Hn[:, k + 1:] = x[:, k + 1:] - u2[:, None] * v[None, k + 1:]
        Hn[:, :k + 1] = H[:, :k + 1]
        Hn[k + 1, k] = H[k + 1, k] - 2.0 * v[k + 1] * w[k]
        Hn[k + 2:, k] = 0.0
        H = Hn
        if with_q and safe:
            uq2 = 2.0 * _lanes(Q, v, k)
            Q[:, k + 1:] = Q[:, k + 1:] - uq2[:, None] * v[None, k + 1:]
        if k + 1 < n - 2:
            pubs = publish(k + 1)
    return H, Q


def _sign(t: float) -> float:
    """jnp.sign of a nonzero float: NaN stays NaN."""
    return 1.0 if t > 0 else -1.0 if t < 0 else t


def _max(a: float, b: float) -> float:
    """jnp.maximum: NaN if either is NaN."""
    return a if a != a or a > b else b


def _house3(x: float, y: float, z: float, use3: bool) -> list:
    """The symmetric 3x3 reflector P = I - 2 v v' with P [x, y, z]' =
    [r, 0, 0]' (JAX `_house3`, 83-105): z forced to 0 unless `use3`, the
    vector scaled by its largest magnitude, v of unit length. P as a 3x3
    list of floats."""
    if not use3:
        z = 0.0
    m = _max(_max(abs(x), abs(y)), abs(z))
    ms = 1.0 if m == 0 else m
    x, y, z = x / ms, y / ms, z / ms
    nrm = math.sqrt(x * x + y * y + z * z)
    alpha = -_sign(1.0 if x == 0 else x) * nrm
    u = (x - alpha, y, z)
    un2 = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    if un2 > 0 and m > 0:
        r = math.sqrt(un2)
        v = (u[0] / r, u[1] / r, u[2] / r)
    else:
        v = (0.0, 0.0, 0.0)
    return [[(1.0 if r == c else 0.0) - 2.0 * (v[r] * v[c])
             for c in range(3)] for r in range(3)]


def _rows(R: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """P @ R for R of 3 rows, each sum left to right."""
    return R[0:1] * P[:, 0:1] + R[1:2] * P[:, 1:2] + R[2:3] * P[:, 2:3]


def _cols(C: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """C @ P for C of 3 columns, each sum left to right."""
    return C[:, 0:1] * P[0:1] + C[:, 1:2] * P[1:2] + C[:, 2:3] * P[2:3]


def _hfro(H: torch.Tensor) -> torch.Tensor:
    """||H||_F, the invariant that sets the deflation floor."""
    return torch.sqrt(torch.sum(H * H))


def plain_francis(Hp: torch.Tensor, n: int, max_iters: int, with_z: bool):
    """(H, Z, info): the JAX `francis_qr_z` on the (n+3) x (n+3) padded
    Hessenberg matrix Hp (Z None unless `with_z`), info the int64 tensor
    [ok, iterations, chain]."""
    H = Hp.clone()
    N = H.shape[0]
    dev = H.device
    Z = torch.eye(N, dtype=H.dtype, device=dev) if with_z else None
    floor = 4.0 * EPS * _hfro(H).item()
    idx = torch.arange(N, device=dev)

    def small(h_prev: float, h_diag: float, s_sub: float) -> bool:
        a = abs(h_prev) + abs(h_diag)
        a = 1.0 if a == 0 else a
        s = abs(s_sub)
        return s <= 8.0 * EPS * a or s <= floor

    hi, stall, it, chain = n - 1, 0, 0, 0
    while hi >= 1 and it < max_iters:
        dabs = torch.abs(torch.diagonal(H))
        a_all = torch.cat([dabs[:1] * 0.0, dabs[:-1]]) + dabs
        a_all = torch.where(a_all == 0, 1.0, a_all)
        sb = torch.abs(H[idx, torch.clamp(idx - 1, min=0)])
        smallv = (sb <= 8.0 * EPS * a_all) | (sb <= floor)
        cand = (idx >= 1) & (idx <= hi) & smallv
        lo = int(torch.max(torch.where(cand, idx, 0)).item())
        if lo > 0:
            H[lo, lo - 1] = 0.0
        w = H[hi - 2 if hi >= 2 else 0:hi + 1, :].tolist()

        def h(r: int, c: int) -> float:     # H[r, c] for r in hi-2..hi
            return w[r - (hi - 2 if hi >= 2 else 0)][c]

        b = 0 if small(h(hi - 1, hi - 1), h(hi, hi), h(hi, hi - 1)) else \
            1 if hi - 2 >= lo and small(h(hi - 2, hi - 2), h(hi - 1, hi - 1),
                                        h(hi - 1, hi - 2)) else \
            2 if hi - lo <= 1 else 3
        if b == 0:
            H[hi, hi - 1] = 0.0
            new_hi = hi - 1
        elif b == 1:
            H[hi - 1, hi - 2] = 0.0
            new_hi = hi - 2
        elif b == 2:
            new_hi = lo - 1
        else:
            new_hi = hi
            t11, t12 = h(hi - 1, hi - 1), h(hi - 1, hi)
            t21, t22 = h(hi, hi - 1), h(hi, hi)
            s = t11 + t22
            p = t11 * t22 - t12 * t21
            if stall > 0 and stall % 10 == 0:      # exceptional shift
                ssum = abs(t21) + abs(h(hi - 1, hi - 2))
                e = t22 + 0.75 * ssum
                s, p = 2.0 * e, e * e
            (h11, h12), (h21, h22), (_, h32) = \
                H[lo:lo + 3, lo:lo + 2].tolist()
            x = h11 * h11 + h12 * h21 - s * h11 + p
            y = h21 * (h11 + h22 - s)
            z = h32 * h21
            for k in range(lo, hi):
                P = torch.tensor(_house3(x, y, z, k + 2 <= hi),
                                 dtype=H.dtype, device=dev)
                H[k:k + 3, :] = _rows(H[k:k + 3, :], P)
                H[:, k:k + 3] = _cols(H[:, k:k + 3], P)
                if with_z:
                    Z[:, k:k + 3] = _cols(Z[:, k:k + 3], P)
                x, y, z = H[k + 1:k + 4, k].tolist()
                if k + 3 > hi:
                    z = 0.0
            # exact Hessenberg zeros below the subdiagonal of the window
            H[lo:hi + 1, lo:hi + 1] = torch.triu(H[lo:hi + 1, lo:hi + 1],
                                                 diagonal=-1)
            chain += hi - lo
        stall = stall + 1 if b == 3 else 0
        it += 1
        hi = new_hi
    info = torch.tensor([int(hi < 1), it, chain], dtype=torch.int64,
                        device=dev)
    return H, Z, info


def plain_trevc(T, wr, wi, is2, prev2):
    """(Yr, Yi): the right eigenvectors of the quasi-triangular T, the JAX
    `trevc` in torch ops (columns unit-normalized at their seeds)."""
    n = T.shape[0]
    dev, dt = T.device, T.dtype
    idx = torch.arange(n, device=dev)
    smin = _smin(T)
    jstart = torch.where(prev2, idx - 1, idx)
    d0 = torch.diagonal(T)
    zero1 = torch.zeros(1, dtype=dt, device=dev)
    sup = torch.cat([torch.diagonal(T, 1), zero1]) if n > 1 else zero1
    sub = torch.cat([torch.diagonal(T, -1), zero1]) if n > 1 else zero1
    a_p = d0[jstart]
    b_p = sup[jstart]
    c_p = sub[jstart]
    d_p = d0[torch.clamp(jstart + 1, max=n - 1)]
    n_b = torch.sqrt(b_p * b_p + (wr - a_p) * (wr - a_p) + wi * wi)
    n_c = torch.sqrt(c_p * c_p + (wr - d_p) * (wr - d_p) + wi * wi)
    use_b = n_b >= n_c
    top_r = torch.where(use_b, b_p, wr - d_p)
    top_i = torch.where(use_b, 0.0, wi)
    bot_r = torch.where(use_b, wr - a_p, c_p)
    bot_i = torch.where(use_b, wi, 0.0)
    snrm = torch.sqrt(top_r * top_r + top_i * top_i
                      + bot_r * bot_r + bot_i * bot_i)
    snrm = torch.maximum(snrm, torch.tensor(1e-300, dtype=dt, device=dev))
    top_r, top_i = top_r / snrm, top_i / snrm
    bot_r, bot_i = bot_r / snrm, bot_i / snrm
    pair = is2 | prev2
    rows = idx[:, None]
    seed_top = (rows == jstart[None, :]) & pair[None, :]
    seed_bot = (rows == jstart[None, :] + 1) & pair[None, :]
    single = (rows == idx[None, :]) & ~pair[None, :]
    Yr = torch.where(single, 1.0, torch.zeros((), dtype=dt, device=dev))
    Yr = torch.where(seed_top, top_r[None, :], Yr)
    Yr = torch.where(seed_bot, bot_r[None, :], Yr)
    Yi = torch.where(seed_top, top_i[None, :], torch.zeros_like(Yr))
    Yi = torch.where(seed_bot, bot_i[None, :], Yi)
    lam_r, lam_i = wr, wi
    for i in range(n - 1, -1, -1):
        ip1 = min(i + 1, n - 1)
        r1r = -(T[i, :] @ Yr)
        r1i = -(T[i, :] @ Yi)
        r2r = -(T[ip1, :] @ Yr)
        r2i = -(T[ip1, :] @ Yi)
        # the 1x1 solve; a vanishing denominator is replaced by smin
        den_r = T[i, i] - lam_r
        den_i = -lam_i
        dsmall = torch.hypot(den_r, den_i) < smin
        den_r = torch.where(dsmall, smin, den_r)
        den_i = torch.where(dsmall, 0.0, den_i)
        dd = den_r * den_r + den_i * den_i
        y1r = (r1r * den_r + r1i * den_i) / dd
        y1i = (r1i * den_r - r1r * den_i) / dd
        # the 2x2 solve of rows i, i+1 by Cramer's rule
        aa, bb = T[i, i], T[i, ip1]
        cc, ddg = T[ip1, i], T[ip1, ip1]
        m11r, m11i = aa - lam_r, -lam_i
        m22r, m22i = ddg - lam_r, -lam_i
        detr = m11r * m22r - m11i * m22i - bb * cc
        deti = m11r * m22i + m11i * m22r
        det_small = torch.hypot(detr, deti) < smin * smin
        detr = torch.where(det_small, smin * smin, detr)
        deti = torch.where(det_small, 0.0, deti)
        dmag = detr * detr + deti * deti
        n1r = r1r * m22r - r1i * m22i - bb * r2r
        n1i = r1r * m22i + r1i * m22r - bb * r2i
        n2r = m11r * r2r - m11i * r2i - cc * r1r
        n2i = m11r * r2i + m11i * r2r - cc * r1i
        y2tr = (n1r * detr + n1i * deti) / dmag
        y2ti = (n1i * detr - n1r * deti) / dmag
        y2br = (n2r * detr + n2i * deti) / dmag
        y2bi = (n2i * detr - n2r * deti) / dmag
        blk = is2[i]
        upd1 = (i < jstart) & ~blk & ~prev2[i]
        upd2 = (i + 1 < jstart) & blk
        Yr[i] = torch.where(upd1, y1r, torch.where(upd2, y2tr, Yr[i]))
        Yi[i] = torch.where(upd1, y1i, torch.where(upd2, y2ti, Yi[i]))
        Yr[ip1] = torch.where(upd2, y2br, Yr[ip1])
        Yi[ip1] = torch.where(upd2, y2bi, Yi[ip1])
    return Yr, Yi


def _smin(T: torch.Tensor) -> torch.Tensor:
    """dtrevc's smallest denominator, max(eps ||T||_F, 1e-300)."""
    tnorm = torch.sqrt(torch.sum(T * T))
    return torch.clamp(EPS * tnorm, min=1e-300)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float64 CPU tensor, as the
    card's `__dsqrt_rn`: numpy's. torch's own CPU sqrt is not always
    correctly rounded (its vectorised path can be one ulp off)."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def ordered_trevc(T, wr, wi, is2, prev2, smin=None):
    """(Yr, Yi) of the ring eig_trevc's order of operations, on the CPU in
    float64: the kernel's model, every product, sum and quotient rounded
    apart in its order (csrc/eig_qr.cu above eig_trevc_ring). Column j is
    seeded as `plain_trevc` seeds it; then the stages c = n-1 .. 0: a
    seed row's y is the seed's entry; a 1x1 row c < js gives y_c = r_c /
    den_c; the top row c of a 2x2 block (c + 1 < js) solves rows c and
    c + 1 with r_{c+1} kept from stage c + 1; a row that is neither keeps
    its r for the next stage. After a row's y, r_m = r_m - T[m, c] y_c for
    every m < c (a 2x2 block: column c + 1's term first), so r_m, from +0,
    collects its terms in descending c (dtrevc's order, not the JAX dot's).
    `smin` (a float) replaces `_smin(T)`, so that the card's own value can
    be used. Vectorised across the columns; each torch product, sum and
    quotient on float64 rounds as the kernel's `__d*_rn` does, and the
    square roots are numpy's (`_sqrt_rn`)."""
    T = T.detach().to("cpu", torch.float64)
    wr, wi = wr.to("cpu", torch.float64), wi.to("cpu", torch.float64)
    is2, prev2 = is2.to("cpu", torch.bool), prev2.to("cpu", torch.bool)
    n = T.shape[0]
    idx = torch.arange(n)
    smin = float(_smin(T)) if smin is None else float(smin)
    smin2 = smin * smin
    pair = is2 | prev2
    js = torch.where(prev2, idx - 1, idx)
    top = torch.where(pair, js + 1, idx)
    # the seed, as the kernel computes it
    a_p = T[js, js]
    inner = js < n - 1
    b_p = torch.where(inner, T[js, torch.clamp(js + 1, max=n - 1)], 0.0)
    c_p = torch.where(inner, T[torch.clamp(js + 1, max=n - 1), js], 0.0)
    jd = torch.clamp(js + 1, max=n - 1)
    d_p = T[jd, jd]
    war, wdr = wr - a_p, wr - d_p
    n_b = _sqrt_rn(b_p * b_p + war * war + wi * wi)
    n_c = _sqrt_rn(c_p * c_p + wdr * wdr + wi * wi)
    use_b = n_b >= n_c
    tr = torch.where(use_b, b_p, wdr)
    ti = torch.where(use_b, 0.0, wi)
    br = torch.where(use_b, war, c_p)
    bi = torch.where(use_b, wi, 0.0)
    snrm = _sqrt_rn(tr * tr + ti * ti + br * br + bi * bi)
    snrm = torch.where(torch.isnan(snrm) | (snrm > 1e-300), snrm, 1e-300)
    tr, ti, br, bi = tr / snrm, ti / snrm, br / snrm, bi / snrm
    mi = -wi
    # the row constants (row m, column j), for every row: 1x1 and 2x2
    dg = torch.diagonal(T)
    up = torch.cat([torch.diagonal(T, 1), torch.zeros(1, dtype=T.dtype)])
    lo = torch.cat([torch.diagonal(T, -1), torch.zeros(1, dtype=T.dtype)])
    dg1 = torch.cat([dg[1:], torch.zeros(1, dtype=T.dtype)])
    m11i = m22i = mi[None, :].expand(n, n)
    den_r = dg[:, None] - wr[None, :]
    small = torch.hypot(den_r, m11i) < smin
    den_r = torch.where(small, smin, den_r)
    den_i = torch.where(small, 0.0, m11i)
    dd = den_r * den_r + den_i * den_i
    m11r = dg[:, None] - wr[None, :]
    m22r = dg1[:, None] - wr[None, :]
    bb, cc = up[:, None], lo[:, None]
    detr = m11r * m22r - m11i * m22i - bb * cc
    deti = m11r * m22i + m11i * m22r
    small = torch.hypot(detr, deti) < smin2
    detr = torch.where(small, smin2, detr)
    deti = torch.where(small, 0.0, deti)
    dmag = detr * detr + deti * deti
    R = torch.zeros((n, n), dtype=T.dtype)      # r, row m of column j
    Ri = torch.zeros((n, n), dtype=T.dtype)
    Yr = torch.zeros((n, n), dtype=T.dtype)
    Yi = torch.zeros((n, n), dtype=T.dtype)
    pr = torch.zeros(n, dtype=T.dtype)
    pi = torch.zeros(n, dtype=T.dtype)

    def axpy(c, col, yr, yi, on):
        if c == 0:
            return
        t = T[:c, col][:, None]
        R[:c] = torch.where(on[None, :], R[:c] - t * yr[None, :], R[:c])
        Ri[:c] = torch.where(on[None, :], Ri[:c] - t * yi[None, :], Ri[:c])

    for c in range(n - 1, -1, -1):
        live = c <= top
        seed = live & (c >= js)
        reg = live & (c < js)
        one = reg & ~is2[c] & ~prev2[c]
        two = reg & is2[c] & (c + 1 < js)
        neither = reg & ~one & ~two
        r1r, r1i = R[c], Ri[c]
        sy_r = torch.where(pair, torch.where(c == js, tr, br), 1.0)
        sy_i = torch.where(pair, torch.where(c == js, ti, bi), 0.0)
        y1r = (r1r * den_r[c] + r1i * den_i[c]) / dd[c]
        y1i = (r1i * den_r[c] - r1r * den_i[c]) / dd[c]
        r2r, r2i = pr, pi
        n1r = r1r * m22r[c] - r1i * mi - bb[c] * r2r
        n1i = r1r * mi + r1i * m22r[c] - bb[c] * r2i
        n2r = m11r[c] * r2r - mi * r2i - cc[c] * r1r
        n2i = m11r[c] * r2i + mi * r2r - cc[c] * r1i
        ytr = (n1r * detr[c] + n1i * deti[c]) / dmag[c]
        yti = (n1i * detr[c] - n1r * deti[c]) / dmag[c]
        ybr = (n2r * detr[c] + n2i * deti[c]) / dmag[c]
        ybi = (n2i * detr[c] - n2r * deti[c]) / dmag[c]
        pr = torch.where(neither, r1r, pr)
        pi = torch.where(neither, r1i, pi)
        if bool(two.any()):
            Yr[c + 1] = torch.where(two, ybr, Yr[c + 1])
            Yi[c + 1] = torch.where(two, ybi, Yi[c + 1])
            axpy(c, c + 1, ybr, ybi, two)
        yr = torch.where(seed, sy_r, torch.where(one, y1r, ytr))
        yi = torch.where(seed, sy_i, torch.where(one, y1i, yti))
        upd = seed | one | two
        Yr[c] = torch.where(upd, yr, Yr[c])
        Yi[c] = torch.where(upd, yi, Yi[c])
        axpy(c, c, yr, yi, upd)
    return Yr, Yi


# --------------------------------------------------------------- kernels


def _entry(name: str, argtypes: list):
    fn = _entries.get(name)
    if fn is None:
        from ._build import library
        try:
            fn = getattr(library(), name)
        except (RuntimeError, OSError, AttributeError) as e:
            raise MatError("RunMat:eigKernel",
                           f"the eigenvalue kernels could not be built or "
                           f"loaded: {str(e)[-1500:]}") from e
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float64:
        raise MatError("RunMat:eigKernel",
                       f"{what} takes float64 on a card, not {t.dtype} on "
                       f"{t.device}")


def _launched(name: str, rc: int) -> None:
    global launches
    if rc != 0:
        raise MatError("RunMat:eigKernel",
                       f"{name} launch failed: CUDA error {rc}")
    launches += 1
    launches_by[name] += 1


def _stream(t: torch.Tensor) -> tuple:
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.current_stream(dev).cuda_stream, dev


def hess_smem(n: int) -> int:
    """The resident eig_hess' dynamic shared memory a block at n, bytes."""
    rows = -(-n // HESS_BLOCKS)
    # H's rows; by step parity, each block's [m, s] (32), H[k+1, k] and a
    # pad, each block's X and row k + 1 over the slice (17 rows), v and w;
    # four mbarriers
    return 8 * (rows * n + 2 * (2 * HESS_BLOCKS + 2 + 17 * rows + 2 * n) + 4)


def hess_route(n: int) -> str:
    """eig_hess' design at n, from n alone: "cluster" (H resident in one
    cluster's shared memory) where `hess_smem(n)` fits HESS_BUDGET, else
    "grid" (the cooperative design, H in device memory)."""
    return "cluster" if hess_smem(n) <= HESS_BUDGET else "grid"


# the largest n the resident design takes (627)
HESS_RESIDENT_N = max(n for n in range(3, 1024) if hess_route(n) == "cluster")


def hessenberg(A: torch.Tensor, with_q: bool):
    """(H, Q): A's Hessenberg form and, if `with_q`, Q with A = Q H Q'
    (else None). A CPU tensor takes `plain_hessenberg`; a card tensor
    launches eig_hess once (no launch for n < 3, which has no step), in
    the design `hess_route(n)` names."""
    if A.device.type == "cpu":
        return plain_hessenberg(A, with_q)
    _card(A, "eig_hess")
    n = A.shape[0]
    if A.dim() != 2 or A.shape[1] != n:
        raise MatError("RunMat:eigKernel", f"eig_hess of a {tuple(A.shape)}"
                       f" matrix")
    H = A.contiguous().clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device) if with_q else None
    if n < 3:
        return H, Q
    barrier = torch.empty(1, dtype=torch.int64, device=A.device)
    P = ctypes.c_void_p
    stream, dev = _stream(A)
    rc = _entry("runmat_eig_hess", [P, P, ctypes.c_int, P, P, ctypes.c_int])(
        H.data_ptr(), Q.data_ptr() if with_q else None, n,
        barrier.data_ptr(), stream, dev)
    _launched("eig_hess", rc)
    return H, Q


def francis(Hp: torch.Tensor, n: int, max_iters: int, with_z: bool):
    """(H, Z, info): the Francis QR iteration on the padded Hessenberg Hp
    (Z None unless `with_z`), info [ok, iterations, chain] as int64 on
    Hp's device. A CPU tensor takes `plain_francis`; a card tensor
    launches eig_francis once, one block over the whole iteration: a
    chaser warp on the bulge, a helper warp on the band beside it and
    owner threads on the rest, no block barrier between bulge positions
    (its Z comes back as the transpose of the kernel's, a view)."""
    if Hp.device.type == "cpu":
        return plain_francis(Hp, n, max_iters, with_z)
    _card(Hp, "eig_francis")
    N = n + 3
    if tuple(Hp.shape) != (N, N) or n < 2:
        raise MatError("RunMat:eigKernel", f"eig_francis of a "
                       f"{tuple(Hp.shape)} matrix for n = {n}")
    H = Hp.contiguous().clone()
    # the kernel keeps Z transposed (the identity is its own transpose)
    Zt = torch.eye(N, dtype=H.dtype, device=H.device) if with_z else None
    hfro = _hfro(H)
    info = torch.empty(3, dtype=torch.int64, device=H.device)
    P = ctypes.c_void_p
    stream, dev = _stream(H)
    rc = _entry("runmat_eig_francis",
                [P, P, ctypes.c_int, ctypes.c_int, P, P, P, ctypes.c_int])(
        H.data_ptr(), Zt.data_ptr() if with_z else None, n, int(max_iters),
        hfro.data_ptr(), info.data_ptr(), stream, dev)
    _launched("eig_francis", rc)
    return H, Zt.mT if with_z else None, info


def trevc_smem(n: int) -> int:
    """The ring eig_trevc's dynamic shared memory at n, bytes: the ring of
    TREVC_DEPTH slots of T's columns (32 ceil(n / 32) doubles each), 8
    doubles of row constants a row a column, the full and empty mbarriers,
    a byte of row kind a row a column."""
    return 8 * (TREVC_DEPTH * 32 * -(-n // 32) + TREVC_COLS * 8 * n) + \
        16 * TREVC_DEPTH + TREVC_COLS * n


# each design's launch key: the warp design keeps the key it has had
# since it was the only one
TREVC_KEYS = {"ring": "eig_trevc ring", "warp": "eig_trevc"}


def trevc_route(n: int) -> str:
    """eig_trevc's design at n, from n alone: "ring" (dtrevc's order, the
    right-hand sides in 16 register slots of 32 rows, T streamed through
    shared memory) up to TREVC_RING_N, else "warp" (the first design, a
    warp a column)."""
    return "ring" if n <= TREVC_RING_N else "warp"


def _trevc_args(T, wr, wi, is2, prev2):
    """The kernels' inputs on the card: T as the route takes it (the ring:
    T.mT in a fresh (n, ld) tensor, ld = n rounded up to even, so that
    every column of T starts and ends on 16 bytes; the warp design: T
    row-major), its leading dimension, the rest contiguous, dtrevc's smin
    and the output yt (2, n, n)."""
    _card(T, "eig_trevc")
    n = T.shape[0]
    if T.dim() != 2 or T.shape[1] != n or n < 1:
        raise MatError("RunMat:eigKernel", f"eig_trevc of a "
                       f"{tuple(T.shape)} matrix")
    if trevc_route(n) == "ring":
        ld = n + (n & 1)
        if ld == n:
            Tk = torch.empty_like(T, memory_format=torch.contiguous_format)
            Tk.copy_(T.mT)
        else:
            Tk = T.new_zeros((n, ld))
            Tk[:, :n].copy_(T.mT)
    else:
        ld = n
        Tk = T.contiguous()
    yt = torch.empty((2, n, n), dtype=T.dtype, device=T.device)
    return (Tk, ld, wr.contiguous(), wi.contiguous(), is2.contiguous(),
            prev2.contiguous(), _smin(T), yt)


def _trevc_call(name: str, args: tuple, with_ld: bool = True) -> int:
    """rc of one launch of the C entry `name` on `_trevc_args`' tuple."""
    Tk, ld, wr, wi, is2, prev2, smin, yt = args
    P, I = ctypes.c_void_p, ctypes.c_int
    stream, dev = _stream(Tk)
    n = Tk.shape[0]
    ptrs = [wr.data_ptr(), wi.data_ptr(), is2.data_ptr(), prev2.data_ptr()]
    if with_ld:
        return _entry(name, [P, I, P, P, P, P, I, P, P, P, I])(
            Tk.data_ptr(), ld, *ptrs, n, smin.data_ptr(), yt.data_ptr(),
            stream, dev)
    return _entry(name, [P, P, P, P, P, I, P, P, P, I])(
        Tk.data_ptr(), *ptrs, n, smin.data_ptr(), yt.data_ptr(), stream,
        dev)


def trevc(T, wr, wi, is2, prev2):
    """(Yr, Yi): the right eigenvectors of the quasi-triangular T (its
    eigenvalues wr + i wi, is2/prev2 its 2x2 blocks as `_quasi_eigs`
    reads them). A CPU tensor takes `plain_trevc`; a card tensor
    launches eig_trevc once in the design `trevc_route(n)` names
    (`launches_by` under `TREVC_KEYS[route]`), which writes the columns
    as rows (returned transposed)."""
    if T.device.type == "cpu":
        return plain_trevc(T, wr, wi, is2, prev2)
    args = _trevc_args(T, wr, wi, is2, prev2)
    rc = _trevc_call("runmat_eig_trevc", args)
    n = T.shape[0]
    _launched(TREVC_KEYS[trevc_route(n)], rc)
    yt = args[-1]
    return yt[0].mT, yt[1].mT
