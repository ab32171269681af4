"""A model of eig_francis (`runmat_tpu_torch/csrc/eig_qr.cu`) in Python
floats: the chaser warp, the band helper warp and the owner warps as
coroutines, run under a chosen schedule, each read and write of shared and
global memory checked against a happens-before order built from the
kernel's own synchronisation.

Each function below mirrors its namesake in the kernel (`chase_chaser`,
`chase_helper`, `chase_owner` with `chase_item` and `item_start`,
`ring_room`), operation for operation on the values and access for access
on memory. The model is parametrised by the kernel's sizes (the band's
width `band`, the ring's `ring` entries, the `hand` hand-off slots, `slots`
owner threads in warps of `warp` lanes), so that a small matrix reaches
every hand-off that the kernel's sizes reach only at large n.

Happens-before is tracked with vector clocks, one agent for the chaser, one
for the helper (each a warp whose lanes only talk through shuffles) and one
for every owner lane. A count written after a block fence is a release; a
count read with `ld.acquire` is an acquire; `__syncwarp` joins the lanes of
an owner warp; `__syncthreads` joins everyone. A read whose last write is
not ordered before it, or a write whose last write or reads since are not
ordered before it, raises `Race`. A schedule that leaves every coroutine
waiting raises `Deadlock`.
"""

from __future__ import annotations

import random

from runmat_tpu_torch.ops import eig_qr as K

BLOCK = object()        # a coroutine waits on a count


class Race(AssertionError):
    pass


class Deadlock(RuntimeError):
    pass


def dot3(a0, a1, a2, b0, b1, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def by_rows(a, b, c, P):
    return (dot3(a, b, c, P[0], P[1], P[2]), dot3(a, b, c, P[3], P[4], P[5]),
            dot3(a, b, c, P[6], P[7], P[8]))


def by_cols(a, b, c, P):
    return (dot3(a, b, c, P[0], P[3], P[6]), dot3(a, b, c, P[1], P[4], P[7]),
            dot3(a, b, c, P[2], P[5], P[8]))


def house3(x, y, z, use3):
    return [v for row in K._house3(x, y, z, use3) for v in row]


CHASER, HELPER = 0, 1


class Launch:
    """The memory of one launch with its vector clocks."""

    def __init__(self, H, Z, N, band, ring, hand, slots, warp, release):
        self.H, self.Z, self.N = H, Z, N
        self.band, self.ring, self.hand = band, ring, hand
        self.slots, self.warp = slots, warp
        self.release_progress = release
        self.lead = band + 3
        self.owners = (min(N, slots) + warp - 1) // warp
        self.per = (N + slots - 1) // slots
        self.agents = 2 + self.owners * warp
        self.vc = [[1 if a == b else 0 for b in range(self.agents)]
                   for a in range(self.agents)]
        self.cell = {}          # shared memory: key -> value
        self.count = {}         # counts: key -> (value, release clock)
        self.last = {}          # key -> (writer, its clock)
        self.reads = {}         # key -> {reader: its clock}
        self.races = 0

    # ---------------------------------------------------------- accesses
    def _check(self, a, key, what):
        v = self.vc[a]
        w = self.last.get(key)
        if w is not None and w[1] > v[w[0]]:
            raise Race(f"{what} of {key} by agent {a} unordered after the "
                       f"write by agent {w[0]}")
        return v

    def rd(self, a, key):
        v = self._check(a, key, "read")
        self.reads.setdefault(key, {})[a] = v[a]
        if key[0] == "H":
            return self.H[key[1]][key[2]]
        if key[0] == "Z":
            return self.Z[key[1]][key[2]]
        return self.cell[key]

    def wr(self, a, key, val):
        v = self._check(a, key, "write")
        for r, c in self.reads.get(key, {}).items():
            if c > v[r]:
                raise Race(f"write of {key} by agent {a} unordered after the "
                           f"read by agent {r}")
        self.reads.pop(key, None)
        self.last[key] = (a, v[a])
        if key[0] == "H":
            self.H[key[1]][key[2]] = val
        elif key[0] == "Z":
            self.Z[key[1]][key[2]] = val
        else:
            self.cell[key] = val

    # ------------------------------------------------------------ counts
    def release(self, a, key, val):
        """A block fence, then the count (or a plain store of it)."""
        self.count[key] = (val, list(self.vc[a]))
        self.vc[a][a] += 1

    def store(self, key, val):
        self.count[key] = (val, None)

    def acquire(self, a, key):
        val, clock = self.count[key]
        if clock is not None:
            v = self.vc[a]
            self.vc[a] = [x if x >= y else y for x, y in zip(v, clock)]
        return val

    def relaxed(self, key):
        return self.count[key][0]

    def join(self, agents):
        """__syncwarp of these lanes, __syncthreads of all."""
        m = [max(col) for col in zip(*(self.vc[a] for a in agents))]
        for a in agents:
            self.vc[a] = list(m)
            self.vc[a][a] += 1

    def barrier(self):
        self.join(range(self.agents))
        self.last.clear()
        self.reads.clear()


def ring_room(m, a, g, safe):
    """Wait until no owner warp still reads ring entry g - ring; `safe`
    (a one-element list) the lowest count read so far."""
    while g - m.ring >= safe[0]:
        safe[0] = min(m.acquire(a, ("progress", w)) if m.release_progress
                      else m.relaxed(("progress", w))
                      for w in range(m.owners))
        if g - m.ring >= safe[0]:
            yield BLOCK


def chaser(m, lo, hi, g0, P0):
    """chase_chaser: lane e of 0-3 holds column j-1+e, rows j..j+3."""
    a, R = CHASER, m.ring
    safe = [0]
    P = list(P0)
    h = [[0.0] * 4 for _ in range(4)]
    for e in range(4):
        if lo - 1 + e >= 0:
            h[e] = [m.rd(a, ("H", lo + i, lo - 1 + e)) for i in range(4)]
    yield from ring_room(m, a, g0, safe)
    for q in range(9):
        m.wr(a, ("ring", g0 % R, q), P[q])
    m.release(a, "published", g0 + 1)
    for j in range(lo, hi):
        g = g0 + (j - lo)
        for e in range(4):
            if j - 1 + e >= 0:
                h[e][0], h[e][1], h[e][2] = by_rows(*h[e][:3], P)
        cs = [[dot3(h[1][i], h[2][i], h[3][i], P[e], P[3 + e], P[6 + e])
               for i in range(4)] for e in range(3)]
        for e in range(3):
            h[1 + e][0], h[1 + e][1] = cs[e][0], cs[e][1]
            if j + 2 <= hi:
                h[1 + e][2] = cs[e][2]
            if j + 3 <= hi:
                h[1 + e][3] = cs[e][3]
        x, y, z = h[1][1], h[1][2], h[1][3]
        if j + 1 == hi:
            for e in range(4):
                if j - 1 + e >= 0:
                    for i in range(3):
                        m.wr(a, ("H", j + i, j - 1 + e), h[e][i])
            return
        P = house3(x, y, z, j + 3 <= hi)
        yield
        yield from ring_room(m, a, g + 1, safe)
        s = (g + 1) % R
        for q in range(9):
            m.wr(a, ("ring", s, q), P[q])
        for i in range(3):
            m.wr(a, ("outs", s, i), h[0][i])
        m.wr(a, ("outs", s, 3), h[1][0])
        m.wr(a, ("rows", s, 0), h[2][0])
        m.wr(a, ("rows", s, 1), h[3][0])
        m.release(a, "published", g + 2)
        yield
        while m.acquire(a, "delivered") < g + 1:
            yield BLOCK
        d = [m.rd(a, ("deliver", (j + 1) % 4, q)) for q in range(6)]
        h = [[h[1][1], h[1][2], h[1][3], 0.0],
             [h[2][1], h[2][2], h[2][3], d[4]],
             [h[3][1], h[3][2], h[3][3], d[5]],
             d[:4]]


def help_col(m, p, lane):
    return p + 3 + ((lane - p - 3) & (m.band - 1))


def helper(m, lo, hi, g0):
    """chase_helper: lane l holds column help_col, rows j..j+2 and the
    fetched rows j+3, j+4."""
    a, R, N, B = HELPER, m.ring, m.N, m.band
    safe = [0]
    c = [help_col(m, lo, lane) for lane in range(B)]
    regs = [[m.rd(a, ("H", lo + i, c[lane])) for i in range(5)]
            if c[lane] < N else [0.0] * 5 for lane in range(B)]
    for j in range(lo, hi):
        g = g0 + (j - lo)
        end = j + 1 == hi
        r4 = [0.0 if end else m.rd(a, ("H", j + 4, j + 1 + lane))
              for lane in range(2)]
        while m.acquire(a, "published") <= g:
            yield BLOCK
        s = g % R
        P = [m.rd(a, ("ring", s, q)) for q in range(9)]
        out = [m.rd(a, ("outs", s, lane)) for lane in range(4)] \
            if j > lo else None
        for lane in range(B):
            if c[lane] < N:
                regs[lane][:3] = by_rows(*regs[lane][:3], P)
        if not end:
            l3 = (j + 3) & (B - 1)
            d = regs[l3][1:5] + r4
            yield from ring_room(m, a, g + 1, safe)
            for q in range(6):
                m.wr(a, ("deliver", (j + 1) % 4, q), d[q])
            for lane in range(B):
                e = c[lane] - j
                if 3 <= e <= 5:
                    m.wr(a, ("rows", (g + 1) % R, e - 1), regs[lane][0])
            m.release(a, "delivered", g + 1)
            yield
        for lane in range(B):
            e = c[lane] - j
            if c[lane] < N and (end or e > min(5, hi + 1 - j)):
                m.wr(a, ("H", j, c[lane]), regs[lane][0])
            if c[lane] < N and end:
                m.wr(a, ("H", j + 1, c[lane]), regs[lane][1])
                m.wr(a, ("H", j + 2, c[lane]), regs[lane][2])
        if j > lo:
            for lane in range(4):
                r = j - 1 if lane == 3 else j - 1 + lane
                k = j - 1 if lane == 3 else j - 2
                if k >= 0:
                    m.wr(a, ("H", r, k), out[lane])
        if end:
            return
        tn = j + m.lead
        top = ha = hb = 0.0
        if tn < N:
            hs = tn % m.hand
            while m.acquire(a, ("tag", hs)) != g + 1:
                yield BLOCK
            top, ha, hb = [m.rd(a, ("hand", hs, q)) for q in range(3)]
        for lane in range(B):
            cn = help_col(m, j + 1, lane)
            if cn != c[lane]:
                if cn < N:
                    m.wr(a, ("H", j, cn), top)
                    regs[lane] = [ha, hb] + [m.rd(a, ("H", j + i, cn))
                                             for i in (3, 4, 5)]
            else:
                regs[lane] = regs[lane][1:] + [
                    m.rd(a, ("H", j + 5, cn)) if cn < N else 0.0]
            c[lane] = cn


def item_start(m, a, lo, t, w, v):
    if t - m.lead >= lo:
        w[:] = [m.rd(a, ("H", lo + i, t)) for i in range(4)]
    elif t < lo:
        w[:] = [m.rd(a, ("H", t, lo + i)) for i in range(4)]
    if m.Z is not None:
        v[:] = [m.rd(a, ("Z", lo + i, t)) for i in range(4)]


def chase_item(m, a, lo, hi, j, t, g, s, P, w, v):
    if j <= t - m.lead:                       # column t, right of the band
        w[:3] = by_rows(*w[:3], P)
        if j == t - m.lead and j + 1 < hi:    # the helper's at j+1
            hs = t % m.hand
            for q in range(3):
                m.wr(a, ("hand", hs, q), w[q])
            m.release(a, ("tag", hs), g + 1)
        else:
            m.wr(a, ("H", j, t), w[0])
            if j + 1 == hi:
                m.wr(a, ("H", j + 1, t), w[1])
                m.wr(a, ("H", j + 2, t), w[2])
            else:
                w[:] = w[1:] + [m.rd(a, ("H", j + 4, t))]
    elif j > t:                               # row t, above the bulge
        first = j == t + 1 and t >= lo
        if first:
            w[:] = [m.rd(a, ("rows", s, q)) for q in range(4)]
        w[:3] = by_cols(*w[:3], P)
        m.wr(a, ("H", t, j), w[0])
        if j + 1 == hi:
            m.wr(a, ("H", t, j + 1), w[1])
            m.wr(a, ("H", t, j + 2), w[2])
        else:
            w[:] = w[1:] + [m.rd(a, ("rows", s, 4)) if first
                            else m.rd(a, ("H", t, j + 4))]
    if m.Z is not None:
        v[:3] = by_cols(*v[:3], P)
        m.wr(a, ("Z", j, t), v[0])
        if j + 1 == hi:
            m.wr(a, ("Z", j + 1, t), v[1])
            m.wr(a, ("Z", j + 2, t), v[2])
        else:
            v[:] = v[1:] + [m.rd(a, ("Z", j + 4, t))]


def owner_warp(m, lo, hi, g0, rank):
    """chase_owner for the lanes of owner warp `rank`: lane l is thread
    s = rank * warp + l and owns t = s, s + slots, ... below N."""
    lanes = [2 + rank * m.warp + lane for lane in range(m.warp)]
    items = {}
    for a in lanes:
        s = a - 2
        for q in range(m.per):
            t = s + q * m.slots
            if t < m.N:
                items[(a, t)] = ([None] * 4, [None] * 4)
                item_start(m, a, lo, t, *items[(a, t)])
    avail = g0
    for j in range(lo, hi):
        g = g0 + (j - lo)
        while g >= avail:
            # P_g published, and the helper done with position g-1
            got = [(m.acquire(a, "published"), m.acquire(a, "delivered"))
                   for a in lanes]
            avail = min(got[0][0], got[0][1] + 1)
            if g >= avail:
                yield BLOCK
        slot = g % m.ring
        for a in lanes:
            P = [m.rd(a, ("ring", slot, q)) for q in range(9)]
            for q in range(m.per):
                t = a - 2 + q * m.slots
                if t < m.N:
                    chase_item(m, a, lo, hi, j, t, g, slot, P, *items[(a, t)])
            yield
        m.join(lanes)
        if m.release_progress:
            m.release(lanes[0], ("progress", rank), g + 1)
        else:
            m.store(("progress", rank), g + 1)


def run(coroutines, schedule, rng):
    """Step the coroutines until all end: `schedule` "random" picks one at
    random; "chaser" runs the chaser and the helper while they can, so the
    owners lag as far as the ring lets them; "owners" runs the owners
    first, so they wait on every count."""
    live = list(coroutines)
    while live:
        if schedule == "random":
            order = live[:]
            rng.shuffle(order)
        elif schedule == "chaser":
            order = live[:2] + rng.sample(live[2:], len(live[2:])) \
                if len(live) > 2 else live[:]
        else:
            order = live[::-1]
        for k in order:
            try:
                r = next(k[1])
            except StopIteration:
                live.remove(k)
                break
            if r is not BLOCK:
                break
        else:
            raise Deadlock([name for name, _ in live])


def francis(Hp, n, max_iters, with_z, *, band=32, ring=256, hand=64,
            slots=576, warp=32, schedule="random", seed=0, release=True):
    """(H, Zt, info, stats): the kernel's iteration on the padded
    Hessenberg Hp (a float64 tensor) with these sizes, Zt the transposed
    Z as the kernel keeps it. `release` False models an owner warp whose
    count is a plain store, read without acquire."""
    rng = random.Random(seed)
    N = n + 3
    H = Hp.tolist()
    Z = [[1.0 if r == c else 0.0 for c in range(N)] for r in range(N)] \
        if with_z else None
    m = Launch(H, Z, N, band, ring, hand, slots, warp, release)
    for w in range(m.owners):
        m.store(("progress", w), 0)
    for hs in range(hand):
        m.store(("tag", hs), 0)
        for q in range(3):
            m.cell[("hand", hs, q)] = 0.0
    m.store("published", 0)
    m.store("delivered", 0)
    floor = 4.0 * K.EPS * float(K._hfro(Hp))

    def sub_small(i):
        a = abs(H[i - 1][i - 1]) + abs(H[i][i])
        a = 1.0 if a == 0 else a
        s = abs(H[i][i - 1])
        return s <= 8.0 * K.EPS * a or s <= floor

    hi, stall, it, chain = n - 1, 0, 0, 0
    m.barrier()
    while hi >= 1 and it < max_iters:
        lo = max([i for i in range(1, hi + 1) if sub_small(i)], default=0)
        if lo > 0:
            H[lo][lo - 1] = 0.0
        nh = hi
        if sub_small(hi):
            b, nh = 0, hi - 1
            H[hi][hi - 1] = 0.0
        elif hi - 2 >= lo and sub_small(hi - 1):
            b, nh = 1, hi - 2
            H[hi - 1][hi - 2] = 0.0
        elif hi - lo <= 1:
            b, nh = 2, lo - 1
        else:
            b = 3
            t11, t12 = H[hi - 1][hi - 1], H[hi - 1][hi]
            t21, t22 = H[hi][hi - 1], H[hi][hi]
            s = t11 + t22
            p = t11 * t22 - t12 * t21
            if stall > 0 and stall % 10 == 0:       # the exceptional shift
                ssum = abs(t21) + abs(H[hi - 1][hi - 2])
                e = t22 + 0.75 * ssum
                s, p = 2.0 * e, e * e
            h11, h12 = H[lo][lo], H[lo][lo + 1]
            h21, h22, h32 = H[lo + 1][lo], H[lo + 1][lo + 1], H[lo + 2][lo + 1]
            P0 = house3(h11 * h11 + h12 * h21 - s * h11 + p,
                        h21 * (h11 + h22 - s), h32 * h21, True)
            m.barrier()
            run([("chaser", chaser(m, lo, hi, chain, P0)),
                 ("helper", helper(m, lo, hi, chain))]
                + [(f"owner warp {r}", owner_warp(m, lo, hi, chain, r))
                   for r in range(m.owners)], schedule, rng)
            m.barrier()
            for c in range(lo, hi + 1):
                if c + 2 <= hi:
                    H[c + 2][c] = 0.0
                if c + 3 <= hi:
                    H[c + 3][c] = 0.0
            chain += hi - lo
            m.store("delivered", chain)
        stall = stall + 1 if b == 3 else 0
        it += 1
        hi = nh
        m.barrier()
    return H, Z, [int(hi < 1), it, chain], m
