"""Threefry-2x32 counter-based PRNG, bit for bit with ``jax.random``.

The model's randomness is a key carried in the state, as in the JAX
package: every heartbeat splits it and draws uniforms for the mesh, gossip,
IWANT-priority, fanout and PX choices.  This module reproduces the four
functions that path needs -- ``threefry2x32``, ``PRNGKey``, ``split`` and
``uniform`` -- exactly as jax draws them with ``jax_threefry_partitionable``
on (the default since jax 0.5): the counter of element i of a draw is the
64-bit flat index i, split into a (hi, lo) pair of 32-bit words.

Keys are int32[2] tensors holding the uint32 bit patterns of jax's raw
``uint32[2]`` keys.  The arithmetic runs in int64 masked to 32 bits,
because torch's CPU ``uint32`` has no shifts.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .fma import fma

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2).  All four are int64 holding uint32 values; returns the
    two output words, int64 in [0, 2**32)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1_ = (x2 + ks[1]) & _M32
    for r in range(5):
        for rot in _ROT[r % 2]:
            x0 = (x0 + x1_) & _M32
            x1_ = _rotl(x1_, rot) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & _M32
        x1_ = (x1_ + ks[(r + 2) % 3] + (r + 1)) & _M32
    return x0, x1_


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]`` for
    a 32-bit seed, i.e. ``[0, seed]`` -> int32[2]."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed must fit 32 bits, got {seed}")
    lo = seed & _M32
    return _i32(torch.tensor([0, lo], dtype=torch.int64, device=device))


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return idx >> 32, idx & _M32


def _hash(key: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    k = _u32(key)
    hi, lo = _counters(shape, key.device)
    return threefry2x32(k[0], k[1], hi, lo)


def split(key: torch.Tensor, num: Union[int, Sequence[int]] = 2) -> torch.Tensor:
    """``jax.random.split``: int32[2] key -> int32[num, 2] new keys."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    b1, b2 = _hash(key, shape)
    return _i32(torch.stack([b1, b2], dim=-1))


def uniform(
    key: torch.Tensor,
    shape: Sequence[int] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 random bits become the
    mantissa of a float in [1, 2), minus 1, scaled into [minval, maxval)."""
    shape = tuple(int(d) for d in shape)
    b1, b2 = _hash(key, shape)
    bits = _i32(((b1 ^ b2) >> 9) | 0x3F800000)
    floats = bits.view(torch.float32) - 1.0
    # The bounds as float32 values held in Python floats: scalars reach the
    # kernels as arguments, with no host-to-device copy.
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # jax's ``floats * (maxval - minval) + minval`` is contracted into one
    # fused multiply-add by XLA's CPU backend; with minval == 0 (every draw
    # of the model) a plain float32 multiply rounds identically.
    if minval == 0.0:
        return torch.clamp(floats * span, min=lo)
    return torch.clamp(fma(floats, span, lo), min=lo)
