"""jax.random's keys and float32 uniforms, bit for bit, without jax.

The JAX package draws a network's initial weights with `jax.random`
(`runmat_tpu/runtime/builtins/dl_layers.py:282-366`): `PRNGKey(seed)`, then
`split` and `uniform` for each layer. The card machine has no jax, so this
module gives the port the same weights. jax 0.9 sets
`jax_threefry_partitionable=True`, and under it:

* `PRNGKey(seed)` is the pair of 32-bit words (seed >> 32, seed & 0xFFFFFFFF)
  (`jax/_src/prng.py:_threefry_seed`);
* `split(key, n)`: the Threefry-2x32 hash under `key` of the counter pairs
  (hi, lo) of the 64-bit iota 0..n-1; key i is the pair of words (w0[i],
  w1[i]) (`_threefry_split_foldlike`);
* the 32-bit random bits of a shape are w0 ^ w1 over the C-order iota of
  the shape (`_threefry_random_bits_partitionable`);
* `uniform(key, shape, float32, lo, hi)`: the bits shifted right by 9 and
  or-ed with the bits of 1.0f give a float f in [1, 2); f - 1, then
  (f - 1) * (hi - lo) + lo, then max(lo, .) (`jax/_src/random.py:_uniform`),
  lo and hi cast to float32 first. XLA on the CPU contracts the product
  and the sum into one FMA (rounded once; with them rounded apart, about
  half of the values differ by an ulp). Here they are computed in float64,
  where both are exact (f - 1 is a multiple of 2^-23 and hi - lo = 2|lo|
  for the symmetric limits the initialiser uses, so the exact sum is an
  integer below 2^47 times a power of two), and rounded to float32 once:
  the FMA's value.

Keys are tuples of two Python ints. The hash is `ops/ctrng.threefry2x32`,
whose word order is jax's (key (k0, k1), counters (x0, x1)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ctrng import threefry2x32

_MASK = 0xFFFFFFFF
_ONE_F32 = 0x3F800000


def prng_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) of a 64-bit integer seed."""
    seed = int(seed) & ((1 << 64) - 1)
    return ((seed >> 32) & _MASK, seed & _MASK)


def _words(key: tuple, n: int, device) -> tuple:
    """The hash of the counters (0, i), i < n (n < 2^32: the iota's high
    words are 0)."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(int(key[0]), int(key[1]), torch.zeros_like(lo), lo)


def split(key: tuple, n: int = 2) -> list:
    """jax.random.split(key, n): n new keys."""
    w0, w1 = _words(key, n, "cpu")
    return [(int(a), int(b)) for a, b in zip(w0.tolist(), w1.tolist())]


def bits32(key: tuple, shape: tuple, device="cpu") -> torch.Tensor:
    """The 32-bit random bits of `shape` (int64 tensor of u32 values)."""
    w0, w1 = _words(key, math.prod(shape), device)
    return (w0 ^ w1).reshape(shape)


def uniform(key: tuple, shape: tuple, lo: float, hi: float,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, jnp.float32, lo, hi)."""
    shape = tuple(int(d) for d in shape)
    fb = (bits32(key, shape, device) >> 9) | _ONE_F32
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = np.float32(lo), np.float32(hi)
    fused = floats.to(torch.float64) * float(hi32 - lo32) + float(lo32)
    return torch.clamp_min(fused.to(torch.float32), float(lo32))
