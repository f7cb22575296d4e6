"""JAX's default random numbers in PyTorch integer operations (port of
``jax.random.PRNGKey``, ``bits``, ``uniform`` and ``bernoulli`` for the
threefry2x32 generator), so that the port draws the reference's samples.

uint32 arithmetic is emulated in int64 tensors masked to 32 bits, so the
bits are the same on the CPU and on the card.  The counters follow
``jax_threefry_partitionable=True`` (JAX's default since 0.5): element i of
a draw of n values hashes the 64-bit counter i, split into (hi, lo) words,
and its bits are the two output words xor-ed.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for an int32 seed (64-bit JAX off): the
    pair (0, seed as uint32)."""
    return 0, int(seed) & _M32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds (Random123; jax/_src/prng.py) of the
    counter words ``x0``, ``x1`` (int64 tensors holding uint32 values)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(key: Key, n: int, device=None):
    """``jax.random.bits(key, (n,))``: (n,) int64 holding uint32 values."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _M32)
    return y0 ^ y1


def uniform(key: Key, n: int, device=None):
    """``jax.random.uniform(key, (n,))``: f32 in [0, 1) from the top 23
    bits, as 1.0's mantissa minus 1."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return torch.clamp(bits.to(torch.int32).view(torch.float32) - 1.0,
                       min=0.0)


def bernoulli(key: Key, p: float, n: int, device=None):
    """``jax.random.bernoulli(key, p, (n,))``: uniform < p in f32."""
    return uniform(key, n, device) < torch.tensor(p, dtype=torch.float32,
                                                  device=device)
