"""A model of eig_trevc_ring (`runmat_tpu_torch/csrc/eig_qr.cu`) in Python
floats: one block's producer warp and column warps as coroutines, run
under a chosen schedule, with the ring of T's columns, its full and empty
mbarriers and each warp's lanes and register slots as the kernel has them.

`block_model` mirrors the kernel operation for operation on the values
(the seed, the row constants, each stage's quotients and the unmasked
updates of slots 0..S, rows at or below the stage included) and access
for access on the ring: a slot holds the rows 0..c + 1 of column c copied
by the producer (rounded up to an even count, at most ld) over whatever
an earlier column left there, and every read of a slot checks that the
slot holds the column of the stage the reader expects (stage k's for the
stage's own update, stage k - 1's for a 2x2 block's column c + 1). A slot
the producer refills before every column warp released it raises `Race`;
a schedule that leaves everyone waiting raises `Deadlock`. The result
(`model_trevc`, all blocks) is held to `ordered_trevc` bit for bit.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from runmat_tpu_torch.ops import eig_qr as K

COLS, DEPTH, SLOTS = K.TREVC_COLS, K.TREVC_DEPTH, 16


WAIT, STEP = "wait", "step"      # what a coroutine yields


class Race(AssertionError):
    pass


class Deadlock(RuntimeError):
    pass


def _producer(st):
    """The producer's lane 0: stage k's column into slot k % DEPTH once
    every column warp released the slot's previous stage."""
    for k in range(st["cmax"] + 1):
        slot = k % DEPTH
        if k >= DEPTH:
            while st["released"][slot][k // DEPTH - 1] < st["cols"]:
                yield WAIT
        c = st["cmax"] - k
        ln = min((c + 3) & ~1, st["ld"])
        st["ring"][slot][:ln] = st["Tt"][c, :ln]
        st["held"][slot] = k
        st["full"][slot] += 1
        yield STEP


def _column(st, wid):
    """Column warp `wid` of the block, lane by lane."""
    Tt, n, ld = st["Tt"], st["n"], st["ld"]
    wr, wi, is2, prev2 = st["q"]
    j = st["j0"] + wid
    smin = st["smin"]
    smin2 = smin * smin
    pair = bool(is2[j] or prev2[j])
    js = j - 1 if prev2[j] else j
    top = js + 1 if pair else j

    def T(r, c):
        return float(Tt[c, r])

    a_p = T(js, js)
    b_p = T(js, js + 1) if js < n - 1 else 0.0
    c_p = T(js + 1, js) if js < n - 1 else 0.0
    jd = min(js + 1, n - 1)
    d_p = T(jd, jd)
    lr, li = float(wr[j]), float(wi[j])
    war, wdr = lr - a_p, lr - d_p
    n_b = math.sqrt(b_p * b_p + war * war + li * li)
    n_c = math.sqrt(c_p * c_p + wdr * wdr + li * li)
    use_b = n_b >= n_c
    tr, ti = (b_p, 0.0) if use_b else (wdr, li)
    br, bi = (war, li) if use_b else (c_p, 0.0)
    snrm = math.sqrt(tr * tr + ti * ti + br * br + bi * bi)
    snrm = snrm if (snrm != snrm or snrm > 1e-300) else 1e-300
    tr, ti, br, bi = tr / snrm, ti / snrm, br / snrm, bi / snrm
    mi = -li
    yr, yi = st["Y"][0][:, j], st["Y"][1][:, j]
    yr[:] = 0.0
    yi[:] = 0.0
    pre = [None] * n
    kinds = [0] * n
    for m in range(js):
        blk = bool(is2[m])
        one = not blk and not bool(prev2[m])
        two = blk and m + 1 < js
        kinds[m] = 1 if one else 2 if two else 0
        if one:
            den_r, den_i = T(m, m) - lr, -li
            if math.hypot(den_r, den_i) < smin:
                den_r, den_i = smin, 0.0
            pre[m] = (den_r, den_i, den_r * den_r + den_i * den_i)
        elif two:
            aa, bb, cc, ddg = T(m, m), T(m, m + 1), T(m + 1, m), \
                T(m + 1, m + 1)
            m11r, m11i, m22r, m22i = aa - lr, -li, ddg - lr, -li
            detr = m11r * m22r - m11i * m22i - bb * cc
            deti = m11r * m22i + m11i * m22r
            if math.hypot(detr, deti) < smin2:
                detr, deti = smin2, 0.0
            pre[m] = (m11r, m22r, bb, cc, detr, deti,
                      detr * detr + deti * deti)
    rr = [[0.0] * 32 for _ in range(SLOTS)]
    ri = [[0.0] * 32 for _ in range(SLOTS)]

    def read(slot, stage):
        if st["held"][slot] != stage:
            raise Race(f"warp {wid} reads slot {slot} for stage {stage}, "
                       f"which holds stage {st['held'][slot]}")
        return st["ring"][slot]

    def axpy(S, col, y_r, y_i):
        for q in range(S, -1, -1):
            for lane in range(32):
                t = float(col[32 * q + lane])
                rr[q][lane] = rr[q][lane] - t * y_r
                ri[q][lane] = ri[q][lane] - t * y_i

    pr = pi = 0.0
    k = 0
    cmax = st["cmax"]
    for S in range(SLOTS - 1, -1, -1):
        if 32 * S > cmax:
            continue
        for l in range(min(31, cmax - 32 * S), -1, -1):
            c = 32 * S + l
            if c <= top:
                slot = k % DEPTH
                while st["full"][slot] < k // DEPTH + 1:
                    yield WAIT
                y_r, y_i, upd = 1.0, 0.0, True
                if c >= js:
                    if pair:
                        y_r, y_i = (tr, ti) if c == js else (br, bi)
                else:
                    r1r, r1i = rr[S][l], ri[S][l]
                    if kinds[c] == 1:
                        den_r, den_i, dd = pre[c]
                        y_r = (r1r * den_r + r1i * den_i) / dd
                        y_i = (r1i * den_r - r1r * den_i) / dd
                    elif kinds[c] == 2:
                        m11r, m22r, bb, cc, detr, deti, dmag = pre[c]
                        r2r, r2i = pr, pi
                        n1r = r1r * m22r - r1i * mi - bb * r2r
                        n1i = r1r * mi + r1i * m22r - bb * r2i
                        n2r = m11r * r2r - mi * r2i - cc * r1r
                        n2i = m11r * r2i + mi * r2r - cc * r1i
                        y_r = (n1r * detr + n1i * deti) / dmag
                        y_i = (n1i * detr - n1r * deti) / dmag
                        ybr = (n2r * detr + n2i * deti) / dmag
                        ybi = (n2i * detr - n2r * deti) / dmag
                        yr[c + 1], yi[c + 1] = ybr, ybi
                        axpy(S, read((k + DEPTH - 1) % DEPTH, k - 1), ybr,
                             ybi)
                    else:
                        pr, pi, upd = r1r, r1i, False
                if upd:
                    yr[c], yi[c] = y_r, y_i
                    axpy(S, read(slot, k), y_r, y_i)
            if k > 0:
                st["released"][(k - 1) % DEPTH][(k - 1) // DEPTH] += 1
            k += 1
            yield STEP
    st["released"][cmax % DEPTH][cmax // DEPTH] += 1


def block_model(st, schedule: str, rng) -> None:
    """Runs one block's coroutines to their end under `schedule`, one step
    at a time: "random" (a runnable coroutine at random), "producer" (the
    producer whenever it can go on: as far ahead as the ring lets it) or
    "columns" (the column warps first: the producer only when all of them
    wait)."""
    runs = {"producer": _producer(st)}
    for w in range(st["cols"]):
        runs[w] = _column(st, w)
    while runs:
        names = list(runs)
        if schedule == "producer":
            order = sorted(names, key=lambda x: x != "producer")
        elif schedule == "columns":
            order = sorted(names, key=lambda x: x == "producer")
        else:
            order = rng.sample(names, len(names))
        for name in order:
            try:
                if next(runs[name]) == STEP:
                    break
            except StopIteration:
                del runs[name]
                break
        else:
            raise Deadlock(f"block {st['j0'] // COLS}: {names} all wait")


def model_trevc(T, wr, wi, is2, prev2, smin=None, schedule="random",
                seed=0):
    """(Yr, Yi) of the modelled kernel on the n x n quasi-triangular T
    (n <= 512), every block under `schedule`; the ring starts full of
    values no column holds."""
    T = T.detach().to("cpu", torch.float64)
    n = T.shape[0]
    ld = n + (n & 1)
    Tt = np.zeros((n, ld))
    Tt[:, :n] = T.numpy().T
    rs = 32 * -(-n // 32)
    q = tuple(v.cpu().numpy() for v in (wr, wi, is2, prev2))
    smin = float(K._smin(T)) if smin is None else float(smin)
    Y = (np.full((n, n), np.nan), np.full((n, n), np.nan))
    rng = random.Random(seed)
    for j0 in range(0, n, COLS):
        cols = min(COLS, n - j0)
        cmax = 0
        for j in range(j0, j0 + cols):
            top = j if q[3][j] else (j + 1 if q[2][j] else j)
            cmax = max(cmax, top)
        cmax = min(cmax, n - 1)
        stale = np.random.default_rng(j0).standard_normal((DEPTH, rs)) * 1e3
        st = {"Tt": Tt, "n": n, "ld": ld, "q": q, "smin": smin, "Y": Y,
              "j0": j0, "cols": cols, "cmax": cmax, "ring": stale,
              "held": [-1] * DEPTH, "full": [0] * DEPTH,
              "released": [[0] * (cmax // DEPTH + 2) for _ in range(DEPTH)]}
        block_model(st, schedule, rng)
    return torch.from_numpy(Y[0].copy()), torch.from_numpy(Y[1].copy())
