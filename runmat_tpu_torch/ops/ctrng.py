"""Threefry2x32-20 streams: plain PyTorch (the reference the CUDA kernel is
held to) and host numpy (the session's own draws).

Same stream as `runmat_tpu/ops/ctrng.py` (host numpy and device jax): the
same key schedule, the same blocked `[w0 | w1]` word order and the same
contiguous Box-Muller halves. The host numpy part at the end of this file
(`np_uniform`, `np_normal`, `blocks_for`, `PhiloxState`, `host_rand`,
`host_randn`) is copied from that file with `xp` fixed to numpy: it draws
for a session whose values stay on the host, and holds the session's RNG
state.

Words are carried in int64 and masked to 32 bits after every add and shift:
`torch.uint32` supports only `^` on some builds, so unsigned arithmetic is
spelled out. Everything runs on whatever device `device` names; on a card it
is the comparison target for `csrc/threefry.cu`, never the main path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def split_counter(counter):
    """64-bit block index (an int, or a 0-d int64 tensor) or (lo, hi) u32
    pair -> (lo, hi): ints, or int64 tensors on the counter's device (an
    int64 holds the index's 64 bits, so `& _MASK` and `>> 32` give its
    words whatever its sign)."""
    if isinstance(counter, torch.Tensor):
        return counter & _MASK, (counter >> 32) & _MASK
    if isinstance(counter, tuple):
        return int(counter[0]) & _MASK, int(counter[1]) & _MASK
    return int(counter) & _MASK, (int(counter) >> 32) & _MASK


def threefry2x32(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor,
                 rounds: int = 20):
    """The Threefry-2x32 bijection on int64 tensors holding u32 values."""
    ks = (k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK, k0 & _MASK)
    x0 = (c0 + k0) & _MASK
    x1 = (c1 + k1) & _MASK
    for chunk in range(rounds // 4):
        for r in _ROT[(chunk % 2) * 4:(chunk % 2) * 4 + 4]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[chunk % 3]) & _MASK
        x1 = (x1 + ks[(chunk + 1) % 3] + chunk + 1) & _MASK
    return x0, x1


def raw_words(key: tuple, counter, n_blocks: int, device):
    """n_blocks counter blocks from `counter` (64-bit carry from lo into
    hi) -> (w0, w1), int64 tensors of u32 values. A tensor counter stays
    on its device: nothing is read back."""
    lo, hi = split_counter(counter)
    i = torch.arange(n_blocks, dtype=torch.int64, device=device)
    idx = lo + i
    return threefry2x32(int(key[0]), int(key[1]), idx & _MASK,
                        (hi + (idx >> 32)) & _MASK)


def _u53(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """53-bit uniform in [0,1) from one block (exact in int64 -> f64)."""
    v = ((w0 >> 5) << 26) + (w1 >> 6)
    return v.to(torch.float64) * 2.0 ** -53


def uniform(key, counter, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """n uniforms in [0,1). f32: one word each (two per block); f64: one
    block each."""
    if dtype == torch.float32:
        nb = (n + 1) // 2
        w0, w1 = raw_words(key, counter, nb, device)
        bits = torch.cat([w0, w1])[:n]
        return (bits >> 8).to(torch.float32) * 2.0 ** -24
    w0, w1 = raw_words(key, counter, n, device)
    return _u53(w0, w1)


def normal(key, counter, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """n standard normals by Box-Muller over contiguous halves: the first m
    values are r*cos(theta), the next r*sin(theta), m = ceil(n/2)."""
    m = (n + 1) // 2
    if dtype == torch.float32:
        w0, w1 = raw_words(key, counter, m, device)
        u1 = 1.0 - (w0 >> 8).to(torch.float32) * 2.0 ** -24
        u2 = (w1 >> 8).to(torch.float32) * 2.0 ** -24
    else:
        w0, w1 = raw_words(key, counter, 2 * m, device)
        u = _u53(w0, w1)
        u1 = 1.0 - u[:m]
        u2 = u[m:]
    r = torch.sqrt(-2.0 * torch.log(u1))
    # 2*pi rounded to the working type first, as the reference does (a
    # Python float is cast to u2's type before the product)
    two_pi = float(np.float32(2.0 * math.pi)) if dtype == torch.float32 \
        else 2.0 * math.pi
    th = u2 * two_pi
    return torch.cat([r * torch.cos(th), r * torch.sin(th)])[:n]


# --------------------------------------------------------------------------- #
# the host stream (numpy), copied from runmat_tpu/ops/ctrng.py:44-196
# --------------------------------------------------------------------------- #

def _np_rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def np_threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """The Threefry-2x32 bijection (standard 20 rounds). k*: u32 scalars
    (python ints or numpy scalars); c*: u32 arrays. Returns two u32 arrays."""
    k0 = np.uint32(k0) if isinstance(k0, int) else k0
    k1 = np.uint32(k1) if isinstance(k1, int) else k1
    ks2 = k0 ^ k1 ^ np.uint32(_PARITY)
    with np.errstate(over="ignore"):
        x0 = c0 + k0
        x1 = c1 + k1
        ks = (k1, ks2, k0)
        for chunk in range(rounds // 4):
            for r in _ROT[(chunk % 2) * 4:(chunk % 2) * 4 + 4]:
                x0 = x0 + x1
                x1 = _np_rotl(x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[chunk % 3]
            x1 = x1 + ks[(chunk + 1) % 3] + np.uint32(chunk + 1)
    return x0, x1


def np_raw_words(key: tuple, counter, n_blocks: int):
    """n_blocks counter blocks -> two u32 arrays (w0, w1) of length n_blocks.
    counter: python int (64-bit block index) or a (lo, hi) pair of u32
    values."""
    if isinstance(counter, tuple):
        lo0, hi0 = counter
    else:
        lo0 = counter & _MASK
        hi0 = (counter >> 32) & _MASK
    i = np.arange(n_blocks, dtype=np.uint32)
    with np.errstate(over="ignore"):
        c0 = np.uint32(lo0) + i
        carry = (c0 < i).astype(np.uint32)
        c1 = np.uint32(hi0) + carry
        return np_threefry2x32(key[0], key[1], c0, c1)


def blocks_for(kind: str, n: int, mclass) -> int:
    """Counter blocks consumed by a draw of n values (single source of truth
    for host, engine, and loop-idiom accounting)."""
    single = mclass in (np.float32, "float32", "single")
    if kind == "randn":
        m = (n + 1) // 2
        return m if single else 2 * m
    # uniform-based draws
    return (n + 1) // 2 if single else n


def _np_to_f64(w):
    """u32 -> f64 via 16-bit halves, exact (as the JAX package writes it)."""
    hi = (w >> np.uint32(16)).astype(np.float64)
    lo = (w & np.uint32(0xFFFF)).astype(np.float64)
    return hi * np.float64(65536.0) + lo


def np_uniform(key, counter, n: int, dtype):
    """n uniforms in [0,1). f32: one word each (2 per block); f64: one block
    each (53 bits from the block's two words). Returns (values, blocks)."""
    if dtype in (np.float32, "float32", "single"):
        nb = (n + 1) // 2
        w0, w1 = np_raw_words(key, counter, nb)
        bits = np.concatenate([w0, w1])[:n]
        return (bits >> np.uint32(8)).astype(np.float32) * \
            np.float32(2.0 ** -24), nb
    w0, w1 = np_raw_words(key, counter, n)
    v = _np_to_f64(w0 >> np.uint32(5)) * np.float64(2 ** 26) \
        + _np_to_f64(w1 >> np.uint32(6))
    return v * np.float64(2.0 ** -53), n


def np_normal(key, counter, n: int, dtype):
    """n standard normals via Box-Muller over contiguous half-pairs.
    Returns (values, blocks); consumes blocks_for('randn', ...)."""
    single = dtype in (np.float32, "float32", "single")
    m = (n + 1) // 2
    if single:
        w0, w1 = np_raw_words(key, counter, m)
        f = np.float32
        u1 = f(1.0) - (w0 >> np.uint32(8)).astype(f) * f(2.0 ** -24)
        u2 = (w1 >> np.uint32(8)).astype(f) * f(2.0 ** -24)
        nb = m
    else:
        w0, w1 = np_raw_words(key, counter, 2 * m)
        f = np.float64
        v = _np_to_f64(w0 >> np.uint32(5)) * np.float64(2 ** 26) \
            + _np_to_f64(w1 >> np.uint32(6))
        u = v * np.float64(2.0 ** -53)
        u1 = f(1.0) - u[:m]
        u2 = u[m:]
        nb = 2 * m
    r = np.sqrt(f(-2.0) * np.log(u1))
    th = f(2.0 * np.pi) * u2
    z = np.concatenate([r * np.cos(th), r * np.sin(th)])[:n]
    return z, nb


class PhiloxState:
    """Session RNG state: (key, counter). The name is kept from the reference
    contract (host-mirrored counter-based state); the generator underneath is
    Threefry2x32."""

    __slots__ = ("seed", "key", "counter", "generator")

    def __init__(self, seed: int = 0):
        self.reseed(seed)
        self.generator = "threefry2x32"

    def reseed(self, seed: int) -> None:
        self.seed = int(seed) & ((1 << 64) - 1)
        s0 = np.array([self.seed & _MASK], dtype=np.uint32)
        s1 = np.array([(self.seed >> 32) & _MASK], dtype=np.uint32)
        k0, k1 = np_threefry2x32(0x9E3779B9, 0xBB67AE85, s0, s1)
        self.key = (int(k0[0]), int(k1[0]))
        self.counter = 0

    def advance(self, blocks: int) -> int:
        """Reserve `blocks` counter blocks; returns the starting counter."""
        start = self.counter
        self.counter += int(blocks)
        return start

    def state_tuple(self):
        return (self.seed, self.key, self.counter)


def host_rand(state: PhiloxState, n: int, dtype) -> np.ndarray:
    start = state.advance(blocks_for("rand", n, dtype))
    vals, _ = np_uniform(state.key, start, n, dtype)
    return vals


def host_randn(state: PhiloxState, n: int, dtype) -> np.ndarray:
    start = state.advance(blocks_for("randn", n, dtype))
    vals, _ = np_normal(state.key, start, n, dtype)
    return vals
