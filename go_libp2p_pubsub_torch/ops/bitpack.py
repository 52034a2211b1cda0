"""Bit-packed message windows: M bool flags per peer as ceil(M/32) words.

Port of the JAX package's ``ops/bitpack.py``.  Packed words are stored as
``torch.int32`` bit patterns: torch's CPU ``uint32`` has no ``~``, ``>>``
or ``<<``, while int32 has all three.  The bit layout is the reference's
(message m lives in word m // 32, bit m % 32), so a word's int32 pattern
is the reference's uint32 word reinterpreted (``.view``).

Every right shift that must act as an unsigned shift goes through
:func:`srl`, which masks off the sign-extended bits.  torch has no
popcount op, so :func:`popcount_words` is the SWAR bit count.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 32
FULL = -1  # all 32 bits set, as an int32 bit pattern


def n_words(m: int) -> int:
    """Words needed for an M-message window."""
    return (m + WORD - 1) // WORD


def srl(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by ``s`` (int or tensor,
    in [0, 31])."""
    if isinstance(s, int):
        if s == 0:
            return x
        return (x >> s) & ((1 << (WORD - s)) - 1)
    s = s.to(torch.int32)
    keep = (torch.ones_like(s, dtype=torch.int64) << (WORD - s)) - 1
    return (x >> s) & keep.to(torch.int32)


def as_mask(b: torch.Tensor) -> torch.Tensor:
    """bool[...] -> int32[...] word mask (all ones / all zeros)."""
    return torch.where(b, FULL, 0).to(torch.int32)


def as_int32_bits(v: int) -> int:
    """A uint32 value as the Python int of its int32 bit pattern."""
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same low 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack(flags: torch.Tensor) -> torch.Tensor:
    """bool[..., M] -> int32[..., ceil(M/32)]."""
    m = flags.shape[-1]
    w = n_words(m)
    pad = w * WORD - m
    if pad:
        flags = torch.cat(
            [flags, flags.new_zeros(flags.shape[:-1] + (pad,))], dim=-1
        )
    bits = flags.reshape(flags.shape[:-1] + (w, WORD)).to(torch.int32)
    # Bit b weighs 2**b as an int32 pattern (bit 31 is -2**31): the sum of
    # distinct powers never carries, so it is the packed word exactly.
    weights = _wrap_i32(torch.ones(WORD, dtype=torch.int64,
                                   device=flags.device)
                        << torch.arange(WORD, device=flags.device))
    return (bits * weights).sum(dim=-1, dtype=torch.int32)


def unpack(words: torch.Tensor, m: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., m]."""
    w = words.shape[-1]
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (w * WORD,))
    return flat[..., :m].to(torch.bool)


def bit_mask(slot, w: int, device=None) -> torch.Tensor:
    """One-hot word vector for message index ``slot``: int32[w] with the
    slot's bit set.  ``slot`` is an int or a 0-d integer tensor."""
    slot = torch.as_tensor(slot, dtype=torch.int64, device=device)
    word = slot // WORD
    bit = slot % WORD
    sel = torch.arange(w, device=slot.device) == word
    one = _wrap_i32(torch.ones((), dtype=torch.int64, device=slot.device) << bit)
    return torch.where(sel, one, torch.zeros((), dtype=torch.int32,
                                             device=slot.device))


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 bit patterns (SWAR) -> int32."""
    x = x - (srl(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (srl(x, 2) & 0x33333333)
    x = (x + srl(x, 4)) & 0x0F0F0F0F
    return srl(x * 0x01010101, 24)


def popcount(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Total set bits along ``axis`` (summing word popcounts) as int32."""
    return popcount_words(words).sum(dim=axis, dtype=torch.int32)


def get_bit(words: torch.Tensor, slot: int) -> torch.Tensor:
    """Read one message bit: words[..., W] -> bool[...]."""
    return ((words[..., slot // WORD] >> (slot % WORD)) & 1).to(torch.bool)


def pack_np(flags: np.ndarray) -> np.ndarray:
    """NumPy host-side pack -> uint32[..., W] (the reference's word type;
    ``.view(np.int32)`` gives the port's storage)."""
    m = flags.shape[-1]
    w = n_words(m)
    pad = w * WORD - m
    if pad:
        flags = np.concatenate(
            [flags, np.zeros(flags.shape[:-1] + (pad,), bool)], axis=-1
        )
    le_bytes = np.packbits(flags, axis=-1, bitorder="little")
    return le_bytes.reshape(flags.shape[:-1] + (w, 4)).view(np.uint32)[..., 0]
