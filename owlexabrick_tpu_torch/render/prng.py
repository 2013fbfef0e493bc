"""The JAX package's random numbers on the host, in numpy: the
Threefry-2x32 hash (20 rounds, Salmon et al., SC'11) and the three
``jax.random`` calls the Renderer makes, ``PRNGKey``, ``fold_in`` and a
scalar float32 ``uniform``.

The bits are those of ``jax.random`` with its default implementation
(``jax_default_prng_impl = "threefry2x32"``) under the partitionable
scheme (``jax_threefry_partitionable = True``, the default since JAX
0.5): a key is two uint32 words; ``fold_in(key, d)`` hashes the counter
pair (0, d) under the key and takes both words as the new key; a scalar
draw hashes the counter pair (0, 0) and takes the XOR of the two words;
``uniform`` puts the draw's top 23 bits in the mantissa of a float in
[1, 2) and subtracts 1.  ``tests/test_torch_host.py`` holds these to
``jax.random`` bit for bit.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _rotl(x: int, d: int) -> int:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key, count):
    """Threefry-2x32 of one counter pair under one key: ``key``, ``count``
    and the result are pairs of uint32 (Python ints)."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (int(count[0]) + ks[0]) & _M32
    x1 = (int(count[1]) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^64): its high and
    low 32-bit words."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for data in [0, 2^32)."""
    return threefry2x32(key, (0, int(data) & _M32))


def uniform_f32(key) -> np.float32:
    """``jax.random.uniform(key, ())``: one float32 in [0, 1)."""
    b0, b1 = threefry2x32(key, (0, 0))
    bits = np.uint32(((b0 ^ b1) >> 9) | 0x3F800000)
    return np.float32(bits.view(np.float32) - np.float32(1.0))
