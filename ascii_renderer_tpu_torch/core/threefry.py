"""The part of ``jax.random`` that the path tracer's XLA core draws from,
for a threefry2x32 key (JAX's default generator), in torch.

A key is its key data: two uint32 words ``(k0, k1)`` as Python ints
(``jax.random.key(seed)`` has the data ``(0, seed)`` for a 32-bit seed).
Keys are derived on the host (``fold_in``, ``split``: one hash each);
only ``uniform`` hashes a whole array, on the device it is asked for.

The layout is JAX's partitionable one (``jax_threefry_partitionable``, the
default from JAX 0.5): the counters of an array of draws are the high and
low words of each element's row-major flat index, a 32-bit draw is
``bits1 ^ bits2`` of the hash, ``split`` takes the pair ``(bits1, bits2)``
of counter ``i`` as key ``i``, and ``fold_in(key, d)`` is the hash of the
counter pair ``(0, d)``. A uniform float32 in [0, 1) is the draw's top 23
bits as a mantissa under the exponent of 1.0, minus 1.

Words are int64 tensors holding values below 2**32, every operation masked
to 32 bits: CUDA torch covers few operations on uint32.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) of the counter
    pair (x0, x1) under the key (k0, k1). Works on Python ints and on int64
    tensors of any device (values in [0, 2**32)); returns the output pair
    in the same form."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key_data(seed: int) -> tuple:
    """The key data of ``jax.random.key(seed)`` for a 32-bit seed."""
    seed = int(seed)
    if not 0 <= seed <= M32:
        raise ValueError(f"key_data: seed {seed} outside [0, 2**32)")
    return (0, seed)


def as_key(key) -> tuple:
    """Two uint32 words (a tuple, a numpy array or a tensor) as a key."""
    k0, k1 = (int(w) & M32 for w in (key.tolist() if hasattr(key, "tolist")
                                     else key))
    return (k0, k1)


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data & 0xFFFFFFFF)."""
    k0, k1 = as_key(key)
    return threefry2x32(k0, k1, 0, int(data) & M32)


def split(key, n: int = 2) -> list:
    """``jax.random.split(key, n)``: key i is the hash pair of counter i."""
    k0, k1 = as_key(key)
    return [threefry2x32(k0, k1, 0, i) for i in range(n)]


def uniform(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32: U[0, 1), from the
    32-bit draws ``bits1 ^ bits2`` of each element's flat-index counter."""
    k0, k1 = as_key(key)
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 1 << 32:
        raise ValueError("uniform: more than 2**32 draws")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    mant = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32).reshape(tuple(shape)) - 1.0
