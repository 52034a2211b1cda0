"""Online per-edge loss estimation for the adaptive coded-gossip hybrid.

Port of the JAX package's ``ops/loss_estimator.py``.  The hybrid
(``models/hybrid.py``) keeps a per-edge EWMA of expected-vs-observed
receipts, updated only on rounds where ``expected[i, s]`` is True:

    loss'[i, s] = (1 - alpha) * loss[i, s] + alpha * miss[i, s]

and a two-threshold latch: an edge goes coded above ``hi`` and back to
eager only below ``lo < hi``; between them the previous mode sticks.

The reference runs the fold inside its jitted round, where XLA's CPU
backend contracts ``(1 - alpha) * loss + alpha * miss`` into one fused
multiply-add, ``fma(1 - alpha, loss, alpha * miss)`` (``alpha * miss``
is exact: ``miss`` is 0 or 1).  The port rounds the same way through
``ops/fma.py``, so the estimate's float32 bits are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fma import fma


class LossEstimate(NamedTuple):
    loss_ewma: torch.Tensor  # f32[N, K] per-edge loss estimate in [0, 1]
    coded: torch.Tensor      # bool[N, K] edges currently on the coded plane


def ewma_update(
    loss_ewma: torch.Tensor,  # f32[N, K]
    expected: torch.Tensor,   # bool[N, K] sender had deliverable traffic
    observed: torch.Tensor,   # bool[N, K] receiver ingress accepted
    alpha: float,
) -> torch.Tensor:
    """One round's EWMA fold: edges with expected traffic move toward their
    miss indicator; quiet edges hold their estimate."""
    miss = (expected & ~observed).to(torch.float32)
    a = float(np.float32(alpha))
    blended = fma(loss_ewma, float(np.float32(1.0 - alpha)), miss * a)
    return torch.where(expected, blended, loss_ewma)


def hysteresis_switch(
    loss_ewma: torch.Tensor,  # f32[N, K]
    coded: torch.Tensor,      # bool[N, K] current mode
    hi: float,
    lo: float,
) -> torch.Tensor:
    """Two-threshold mode latch: above ``hi`` -> coded, below ``lo`` ->
    eager, in between -> keep the previous mode."""
    hi32, lo32 = float(np.float32(hi)), float(np.float32(lo))
    return torch.where(loss_ewma > hi32, True,
                       torch.where(loss_ewma < lo32, False, coded))


def update(
    est: LossEstimate,
    expected: torch.Tensor,
    observed: torch.Tensor,
    alpha: float,
    hi: float,
    lo: float,
) -> LossEstimate:
    """EWMA fold + hysteresis latch, the hybrid round's one-call form.  On
    an all-clean fabric the estimate stays at 0.0 and ``coded`` all-False
    (the eager twin's bit-identity guard)."""
    loss = ewma_update(est.loss_ewma, expected, observed, alpha)
    return LossEstimate(
        loss_ewma=loss, coded=hysteresis_switch(loss, est.coded, hi, lo))
