"""Threefry-2x32 counter-based PRNG, bit for bit with ``jax.random``.

The model's randomness is a key carried in the state, as in the JAX
package: every heartbeat splits it and draws uniforms for the mesh, gossip,
IWANT-priority, fanout and PX choices.  This module reproduces the
functions that path needs -- ``threefry2x32``, ``PRNGKey``, ``split``,
``fold_in`` (the multi-topic model's per-topic keys), ``uniform`` and
``randint`` (the coded plane's GF(256) coefficients) -- exactly as jax
draws them with ``jax_threefry_partitionable`` on (the default since jax
0.5): the counter of element i of a draw is the 64-bit flat index i,
split into a (hi, lo) pair of 32-bit words.  So rows ``[r0, r0 + B)`` of
a draw are the whole draw's rows: ``row_offset`` draws them alone, which
bounds the memory of a large draw taken in blocks.  The same holds for
any set of rows: :func:`uniform_rows` and ``randint(rows=)`` compute each
element's counter from its canonical flat index (``row * inner + j``),
so a rank of the sharded rollout draws only the rows it owns, equal bit
for bit to ``uniform(key, shape)[rows]``.

Keys are int32[2] tensors holding the uint32 bit patterns of jax's raw
``uint32[2]`` keys.  torch's CPU ``uint32`` has no shifts, so values
travel as int64 in [0, 2**32) and the hash's rounds run on int32 bit
patterns.

The key's device chooses the path, and nothing else does.  On a CUDA key
each of ``split``, ``fold_in``, ``uniform``, ``uniform_rows``, ``randint``
and the 32-bit draws is one launch of the threefry kernel
(``ops/cuda_rng.py``), which reads the key on the card.  On a CPU key they
run the hash as the PyTorch ops below, which are also the kernel's twin in
the tests.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.trace import span
from . import cuda_rng
from .fma import fma

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _key_schedule(k1: torch.Tensor, k2: torch.Tensor):
    return [_i32(k1), _i32(k2), _i32(k1 ^ k2 ^ 0x1BD11BDA)]


def _rounds(ks, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry's 20 rounds and 5 key injections on int32 bit patterns
    (the first injection already added): int32 adds wrap as uint32 adds
    do, XOR and left shifts keep the low 32 bits, and right shifts are
    masked to logical ones (half the bytes of int64 arithmetic)."""
    for r in range(5):
        for rot in _ROT[r % 2]:
            x0 = x0 + x1
            x1 = ((x1 << rot) | _srl(x1, 32 - rot)) ^ x0
        x0 = x0 + ks[(r + 1) % 3]
        x1 = x1 + (ks[(r + 2) % 3] + (r + 1))
    return x0, x1


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    key (k1, k2).  All four are int64 holding uint32 values; returns the
    two output words, int64 in [0, 2**32)."""
    ks = _key_schedule(k1, k2)
    x0, x1_ = _rounds(ks, x1.to(torch.int32) + ks[0],
                      x2.to(torch.int32) + ks[1])
    return x0.to(torch.int64) & _M32, x1_.to(torch.int64) & _M32


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]`` for
    a 32-bit seed, i.e. ``[0, seed]`` -> int32[2]."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed must fit 32 bits, got {seed}")
    lo = seed & _M32
    return _i32(torch.tensor([0, lo], dtype=torch.int64, device=device))


def _counters(shape: Sequence[int], device, row_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) counter words of a draw of ``shape``, whose leading
    axis starts at row ``row_offset`` of a larger draw with the same
    trailing axes."""
    n = 1
    for d in shape:
        n *= int(d)
    start = int(row_offset) * (n // int(shape[0])) if row_offset else 0
    idx = torch.arange(start, start + n, dtype=torch.int64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & _M32


def _on_card(key: torch.Tensor) -> bool:
    """Whether ``key``'s draws launch the kernel: a CUDA key."""
    return key.device.type == "cuda"


def _hash(key: torch.Tensor, shape, row_offset: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = _u32(key)
    hi, lo = _counters(shape, key.device, row_offset)
    return threefry2x32(k[0], k[1], hi, lo)


def split(key: torch.Tensor, num: Union[int, Sequence[int]] = 2) -> torch.Tensor:
    """``jax.random.split``: int32[2] key -> int32[num, 2] new keys."""
    with span("rng.split"):
        shape = (num,) if isinstance(num, int) else tuple(num)
        if _on_card(key):
            return cuda_rng.threefry(key, cuda_rng.counter_plan(
                cuda_rng.PAIR, shape))
        return _split_chain(key, shape)


def _split_chain(key: torch.Tensor, shape) -> torch.Tensor:
    b1, b2 = _hash(key, shape)
    return _i32(torch.stack([b1, b2], dim=-1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the threefry hash of the counter pair
    ``(0, data)`` under ``key``, ``data`` taken as uint32 (an int, or an
    int tensor of any shape, which folds each element) -> int32[..., 2]."""
    if _on_card(key):
        return cuda_rng.threefry(key, cuda_rng.fold_plan(data), data)
    k = _u32(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return _i32(torch.stack([b1, b2], dim=-1))


def uniform(
    key: torch.Tensor,
    shape: Sequence[int] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 random bits become the
    mantissa of a float in [1, 2), minus 1, scaled into [minval, maxval)."""
    with span("rng.uniform"):
        shape = tuple(int(d) for d in shape)
        if _on_card(key):
            return cuda_rng.threefry(key, cuda_rng.counter_plan(
                cuda_rng.UNIFORM, shape,
                **cuda_rng.uniform_params(minval, maxval)))
        return _uniform_chain(key, shape, minval, maxval)


def _uniform_chain(key: torch.Tensor, shape, minval: float,
                   maxval: float) -> torch.Tensor:
    b1, b2 = _hash(key, shape)
    bits = _i32(((b1 ^ b2) >> 9) | 0x3F800000)
    floats = bits.view(torch.float32) - 1.0
    # The bounds as float32 values held in Python floats: scalars reach the
    # kernels as arguments, with no host-to-device copy.
    lo = float(np.float32(minval))
    width = float(np.float32(maxval) - np.float32(minval))
    # jax's ``floats * (maxval - minval) + minval`` is contracted into
    # one fused multiply-add by XLA's CPU backend; with minval == 0
    # (every draw of the model) a plain float32 multiply rounds
    # identically.
    if minval == 0.0:
        return torch.clamp(floats * width, min=lo)
    return torch.clamp(fma(floats, width, lo), min=lo)


def _bits_rows(key: torch.Tensor, rows: torch.Tensor, inner) -> torch.Tensor:
    """32 random bits (the two threefry output words XORed, int32 bit
    patterns) of rows ``rows`` of a draw whose trailing axes are ``inner``:
    element ``(r, j)`` hashes its flat index ``rows[r] * prod(inner) + j``
    -> int32[len(rows), *inner]."""
    if _on_card(key):
        return cuda_rng.threefry(key, cuda_rng.counter_plan(
            cuda_rng.BITS, (len(rows),) + tuple(inner), by_rows=True), rows)
    k = _u32(key)
    ks = _key_schedule(k[0], k[1])
    inner = tuple(int(d) for d in inner)
    width = 1
    for d in inner:
        width *= d
    rows = rows.to(device=key.device, dtype=torch.int64)
    flat = (rows[:, None] * width + torch.arange(
        width, dtype=torch.int64, device=key.device)[None, :]).reshape(
        (rows.shape[0],) + inner)
    # Both counter words from the int64 index: no bound on the rows is read
    # from the device.
    x0, x1 = _rounds(ks, (flat >> 32).to(torch.int32) + ks[0],
                     _i32(flat & _M32) + ks[1])
    return x0 ^ x1


def uniform_rows(
    key: torch.Tensor,
    rows: torch.Tensor,
    inner: Sequence[int],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """Rows ``rows`` of ``uniform(key, (N,) + inner)`` for any N above
    ``max(rows)``, drawn alone: bit for bit ``uniform(key, shape)[rows]``.
    The float is built from the int32 bits as :func:`uniform` builds it
    from the uint32 words (logical shift, exponent of 1.0)."""
    if _on_card(key):
        return cuda_rng.threefry(key, cuda_rng.counter_plan(
            cuda_rng.UNIFORM, (len(rows),) + tuple(inner), by_rows=True,
            **cuda_rng.uniform_params(minval, maxval)), rows)
    bits = (_srl(_bits_rows(key, rows, inner), 9) | 0x3F800000).to(
        torch.int32)
    floats = bits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    if minval == 0.0:
        return torch.clamp(floats * span, min=lo)
    return torch.clamp(fma(floats, span, lo), min=lo)


def _bits32(key: torch.Tensor, shape, row_offset: int = 0,
            rows=None) -> torch.Tensor:
    """``jax.random.bits`` of 32 bits (the two threefry output words
    XORed) as int32 bit patterns.  Where every flat index of the draw is
    below 2**32 (any draw of under 4G elements) the counters' high word
    is 0, so its lane is the key word alone and never materialised.
    ``rows`` draws those rows alone (:func:`_bits_rows`)."""
    if rows is not None:
        return _bits_rows(key, rows, shape[1:])
    if _on_card(key):
        return cuda_rng.threefry(key, cuda_rng.counter_plan(
            cuda_rng.BITS, shape, row_offset))
    k = _u32(key)
    ks = _key_schedule(k[0], k[1])
    n = 1
    for d in shape:
        n *= int(d)
    start = int(row_offset) * (n // int(shape[0])) if row_offset else 0
    if start + n <= 2**32:
        lo = torch.arange(start, start + n, dtype=torch.int64,
                          device=key.device).to(torch.int32)
        x0, x1 = _rounds(ks, ks[0], lo.reshape(tuple(shape)) + ks[1])
    else:
        hi, lo = _counters(shape, key.device, row_offset)
        x0, x1 = _rounds(ks, hi.to(torch.int32) + ks[0],
                         lo.to(torch.int32) + ks[1])
    return x0 ^ x1


def _mulmod32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` of uint32 values in int64, with no int64
    overflow (``b`` split into 16-bit halves)."""
    hi, lo = b >> 16, b & 0xFFFF
    return ((((a * hi) & 0xFFFF) << 16) + a * lo) & _M32


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    row_offset: int = 0,
    rows=None,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)`` ->
    int32, for int32 scalar bounds (``jax/_src/random.py:_randint``).

    The key splits into (k1, k2); each draws 32 bits per element (higher
    and lower).  With ``span = maxval - minval`` as uint32 (1 when
    ``maxval <= minval``, so ``minval`` comes back) and ``mult = (2**16 %
    span)**2 % span``, the value is ``minval + ((higher % span) * mult +
    lower % span) % span``, every product and sum wrapping in uint32 as
    jax's do (so the square wraps to 0, and with it ``mult``, for any span
    above 2**16).  Where ``mult`` is 0 (any span above 2**16, and a power
    of two) the higher draw cannot change the value and is not computed;
    a power-of-two span (the coefficients' 256) is a mask of the lower
    draw's int32 bits.  ``row_offset`` draws rows ``[row_offset,
    row_offset + shape[0])`` of a larger draw whose trailing axes are
    ``shape[1:]``; ``rows`` (an int tensor of ``shape[0]`` row ids) draws
    those rows of it, in any order."""
    shape = tuple(int(d) for d in shape)
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -(2**31) <= v < 2**31:
            raise OverflowError(f"randint bound {v} outside int32")
    span = 1 if maxval <= minval else maxval - minval
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    if rows is not None and len(rows) != shape[0]:
        raise ValueError(f"randint: {len(rows)} rows for shape {shape}")
    if _on_card(key):
        return cuda_rng.threefry(key, cuda_rng.counter_plan(
            cuda_rng.RANDINT, shape, row_offset, rows is not None,
            **cuda_rng.randint_params(span, mult, minval)), rows)
    k1, k2 = split(key, 2).unbind(0)
    lower = _bits32(k2, shape, row_offset, rows)
    if span & (span - 1) == 0:
        return (lower & (span - 1)) + minval   # int32 adds wrap as uint32
    offset = (lower.to(torch.int64) & _M32) % span
    if mult:
        higher = _bits32(k1, shape, row_offset, rows).to(torch.int64) & _M32
        offset = ((_mulmod32(higher % span, mult) + offset) & _M32) % span
    return _i32((offset + minval) & _M32)
