"""Float32 fused multiply-add, to reproduce the reference's rounding.

XLA's CPU backend lets LLVM contract a float32 ``x * w + acc`` inside one
fusion into a fused multiply-add, which rounds once where the plain
two-op form rounds twice.  The reference's score arithmetic
(``ops/scoring.py``) and its uniform draws go through such fusions, so the
port has to round the same way to stay bit-identical: a one-ulp
difference in a score flips a threshold or a top-k pick and forks the
whole trajectory.  Each call site names the contraction it reproduces.

torch has no fma op, so :func:`fma` computes it exactly: the product of
two float32 values is exact in float64 (24 + 24 bits), the sum is taken
with an exact error term (TwoSum), and rounding the float64 sum to odd
makes the final cast to float32 a single, correct rounding.

The same backend runs its float arithmetic with the x86 MXCSR modes
flush-to-zero and denormals-are-zero: an add, multiply, divide, fused
multiply-add, min/max or comparison reads a subnormal operand as a zero
of its sign and writes a subnormal result as one.  A select, a copy,
``abs``, negation and a sort's data movement pass a subnormal on
unchanged.  :func:`ftz` is that flush, written out so that it runs alike
on the CPU and the card; each call site names the arithmetic it stands
for.
"""

from __future__ import annotations

import numpy as np
import torch


FLT_MIN = float(np.finfo(np.float32).tiny)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal float32 replaced by a zero of its sign;
    zeros, normal values, infinities and NaNs keep their bits."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def _f64(x):
    """A float32 operand in float64: a tensor converts on its device; a
    Python number rounds to float32 on the host and stays a Python float
    (so it reaches the kernel as an argument, not by a host-to-device
    copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).double()
    return float(np.float32(x))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding.  ``b`` and ``c`` may be
    tensors or Python floats (taken as float32 constants)."""
    p = _f64(a) * _f64(b)
    c64 = _f64(c)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def madd(x: torch.Tensor, w: float, acc: torch.Tensor) -> torch.Tensor:
    """``acc + x * w`` for a constant weight ``w``, rounded as XLA's CPU
    backend rounds it: a weight of 1 is simplified away and -1 becomes a
    negation (both exact, so one rounding of the add), any other weight
    contracts with the add into one fused multiply-add."""
    if w == 1.0:
        return acc + x
    if w == -1.0:
        return acc - x
    return fma(x, w, acc)


def madd_square(x: torch.Tensor, w: float, acc: torch.Tensor) -> torch.Tensor:
    """``acc + (x * x) * w``, rounded as XLA's CPU backend rounds it: with
    a weight of +-1 the outer multiply disappears and the square itself
    contracts with the add (``fma(+-x, x, acc)``); otherwise the square is
    rounded and the weight's multiply contracts with the add."""
    if w in (1.0, -1.0):
        return fma(x * w, x, acc)
    return fma(x * x, w, acc)
