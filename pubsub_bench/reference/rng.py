"""Threefry-2x32 and the ``jax.random`` draws the model's semantics name.

Written from the Threefry specification (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011: 20 rounds, rotations (13, 15, 26,
6) and (17, 29, 16, 24), a key injection every 4 rounds with the parity
constant 0x1BD11BDA) and from ``jax.random``'s documented conventions
with ``jax_threefry_partitionable`` on: a key is two 32-bit words; a seed
s of 32 bits is the key (0, s); element i of a draw of any shape hashes
the counter pair (i >> 32, i & 0xFFFFFFFF) of its flat index i; ``split``
into n keys is a draw of shape (n,) whose two output words are each
key's words; 32 random bits are the two output words XORed; a float32
uniform in [0, 1) puts the top 23 bits into the mantissa of a float in
[1, 2) and subtracts 1, and ``uniform(minval=0, maxval=b)`` multiplies
that by the float32 value of b.

Words are held as int64 in [0, 2**32), so every operation here is plain
integer arithmetic with a mask.  A key is an int64[2] tensor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, c0: torch.Tensor, c1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (c0, c1) under ``key``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def key_of_seed(seed: int, device=None) -> torch.Tensor:
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"a key's seed has 32 bits, not {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _hash_flat(key: torch.Tensor, count: int):
    idx = torch.arange(count, dtype=torch.int64, device=key.device)
    return threefry2x32(key, idx >> 32, idx & MASK)


def split(key: torch.Tensor, num: int) -> list:
    """``num`` new keys."""
    w0, w1 = _hash_flat(key, num)
    return [torch.stack([w0[i], w1[i]]) for i in range(num)]


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits an element, int64 in [0, 2**32)."""
    count = int(np.prod(shape))
    w0, w1 = _hash_flat(key, count)
    return (w0 ^ w1).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int],
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [0, maxval)."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    one_two = mant.to(torch.int32).view(torch.float32)
    return (one_two - 1.0) * float(np.float32(maxval))
