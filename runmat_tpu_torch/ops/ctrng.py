"""Plain PyTorch Threefry2x32-20: the reference the CUDA kernel is held to.

Same stream as `runmat_tpu.ops.ctrng` (host numpy and device jax): the same
key schedule, the same blocked `[w0 | w1]` word order and the same
contiguous Box-Muller halves. The block budget of a draw (`blocks_for`) and
the session state (`PhiloxState`) are the JAX package's, pure numpy, used
as they are.

Words are carried in int64 and masked to 32 bits after every add and shift:
`torch.uint32` supports only `^` on some builds, so unsigned arithmetic is
spelled out. Everything runs on whatever device `device` names; on a card it
is the comparison target for `csrc/threefry.cu`, never the main path.
"""

from __future__ import annotations

import math

import torch

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def split_counter(counter) -> tuple[int, int]:
    """64-bit block index (int) or (lo, hi) u32 pair -> (lo, hi) ints."""
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
    hi) -> (w0, w1), int64 tensors of u32 values."""
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
    # 2*pi rounded to the working type first, as the reference does
    th = torch.tensor(2.0 * math.pi, dtype=dtype) * u2
    return torch.cat([r * torch.cos(th), r * torch.sin(th)])[:n]
