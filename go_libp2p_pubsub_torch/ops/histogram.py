"""Histogram reductions of the flight recorder's latency plane.

Port of the JAX package's ``ops/histogram.py`` (the functions the
recorded rollout and its summary use).  Latencies are whole rounds, so a
fixed-bin integer histogram carried through the rollout and advanced by
each round's new receipts gives exact quantiles afterwards with no host
sync inside the rollout.  Scatter-adds are ``index_add_`` with the
masked-out entries routed to an overflow bin that is cut off.
"""

from __future__ import annotations

import torch


def _bin_counts(values: torch.Tensor, seg: torch.Tensor, n_bins: int):
    """``segment_sum(values, seg, n_bins + 1)[:n_bins]`` (int32)."""
    out = torch.zeros(n_bins + 1, dtype=torch.int32, device=seg.device)
    out.index_add_(0, seg.reshape(-1).long(),
                   values.reshape(-1).to(torch.int32))
    return out[:n_bins]


def latency_histogram(first_step, msg_birth, msg_mask, peer_mask, n_bins: int):
    """int32[n_bins] counts of first-receipt latencies (rounds), last bin
    absorbing the tail; counted where ``first_step >= 0`` under the masks."""
    lat = first_step - msg_birth[None, :]
    counted = (first_step >= 0) & peer_mask[:, None] & msg_mask[None, :]
    bins = torch.clamp(lat, 0, n_bins - 1)
    seg = torch.where(counted, bins, n_bins)
    return _bin_counts(torch.ones_like(seg), seg, n_bins)


def latency_histogram_increment(per_msg_new, msg_birth, msg_mask, stamp,
                                n_bins: int):
    """int32[n_bins]: one round's new receipts (``per_msg_new`` int32[M],
    all stamped at round ``stamp``) scattered into latency bins."""
    bins = torch.clamp(stamp - msg_birth, 0, n_bins - 1)
    seg = torch.where(msg_mask, bins, n_bins)
    return _bin_counts(per_msg_new, seg, n_bins)


def latency_histogram_seed(first_step, msg_birth, msg_mask, peer_mask,
                           n_bins: int):
    """:func:`latency_histogram` with the reference's fresh-publish fast
    path: when every counted receipt has latency zero the histogram is one
    count in bin 0.  The reference picks the branch with ``lax.cond``;
    here ``torch.where`` selects between both (they agree whenever the
    cheap one applies), so the seed never syncs with the host."""
    counted = (first_step >= 0) & peer_mask[:, None] & msg_mask[None, :]
    zero_lat = first_step == msg_birth[None, :]
    all_zero = ~torch.any(counted & ~zero_lat)
    cheap = torch.zeros(n_bins, dtype=torch.int32, device=first_step.device)
    cheap[0] = counted.sum(dtype=torch.int32)
    full = latency_histogram(first_step, msg_birth, msg_mask, peer_mask,
                             n_bins)
    return torch.where(all_zero, cheap, full)


def hist_quantile(counts: torch.Tensor, q: float) -> torch.Tensor:
    """f32[]: the q-quantile of the integer values a histogram encodes
    (bin index == value), with numpy's "linear" rank ``(total - 1) * q``;
    NaN on an empty histogram."""
    counts = counts.to(torch.int32)
    total = counts.sum(dtype=torch.int32)
    cum = torch.cumsum(counts, dim=0)

    def value_at(rank):
        return torch.argmax((cum > rank).to(torch.uint8)).to(torch.float32)

    h = (total - 1).to(torch.float32) * q
    lo = torch.floor(h).to(torch.int32)
    hi = torch.ceil(h).to(torch.int32)
    frac = h - lo
    v = (1.0 - frac) * value_at(lo) + frac * value_at(hi)
    return torch.where(total > 0, v, torch.nan)


def binned_quantiles(values: torch.Tensor, mask: torch.Tensor, qs,
                     n_bins: int = 128) -> torch.Tensor:
    """f32[len(qs)] approximate masked quantiles via a fixed-bin histogram
    over the per-call [min, max] range (error at most one bin width); NaN
    where ``mask`` selects nothing."""
    v = values.to(torch.float32)
    lo = torch.where(mask, v, torch.inf).min()
    hi = torch.where(mask, v, -torch.inf).max()
    # A true division: ``scalar / tensor`` in torch is a reciprocal times
    # the scalar, which rounds twice.
    scale = torch.where(hi > lo, torch.full_like(hi, n_bins - 1) / (hi - lo),
                        0.0)
    # NaN (a -inf value makes the range infinite) converts to bin 0, as
    # XLA's float -> int conversion does.
    b = torch.nan_to_num(torch.clamp((v - lo) * scale, 0, n_bins - 1),
                         nan=0.0).to(torch.int32)
    seg = torch.where(mask, b, n_bins)
    counts = _bin_counts(torch.ones_like(seg), seg, n_bins)
    cum = torch.cumsum(counts, dim=0)
    total = cum[-1]
    # One f32 product per quantile (a Python scalar, so no host-to-device
    # copy).
    span = torch.clamp(total - 1, min=0).to(torch.float32)
    ranks = torch.stack([span * q for q in qs])
    idx = torch.argmax((cum[None, :] > ranks[:, None]).to(torch.uint8), dim=1)
    vals = lo + torch.where(scale > 0.0, idx.to(torch.float32) / scale, 0.0)
    return torch.where(total > 0, vals, torch.nan)
