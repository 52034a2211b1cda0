"""Metrics over model state: reductions on the device, digests on the host.

Port of ``gossip_metrics`` and ``flight_summary`` from the JAX package's
``utils/metrics.py``.  ``gossip_metrics`` is a set of reductions over a
``GossipState`` that stays on the device until the caller reads it;
``flight_summary`` brings a rollout's flight record to the host once.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops import bitpack
from ..ops.histogram import hist_quantile


def gossip_metrics(st) -> Dict[str, torch.Tensor]:
    """Reductions over a ``GossipState``: mesh health, delivery, scores."""
    alive = st.alive
    alive_n = torch.clamp(alive.sum(dtype=torch.int32), min=1)
    mesh_deg = (st.mesh & st.nbr_valid).sum(dim=1, dtype=torch.int32)
    in_window = st.msg_used & st.msg_valid
    have = bitpack.unpack(st.have_w, st.msg_valid.shape[0])
    delivered = (have & alive[:, None]).sum(dim=0, dtype=torch.int32)
    frac = torch.where(in_window, delivered / alive_n, torch.nan)
    scores_live = torch.where(st.nbr_valid, st.scores, torch.nan)
    return {
        "peers_alive": alive.sum(dtype=torch.int32),
        "mesh_degree_mean": torch.where(alive, mesh_deg, 0).sum(
            dtype=torch.int32) / alive_n,
        "mesh_degree_max": mesh_deg.max(),
        "msgs_in_window": in_window.sum(dtype=torch.int32),
        "delivery_frac_mean": torch.nanmean(frac),
        "deliveries_total": (
            have & alive[:, None] & in_window[None, :]).sum(dtype=torch.int32),
        "score_mean": torch.nanmean(scores_live),
        "score_min": torch.where(torch.isnan(scores_live), torch.inf,
                                 scores_live).min(),
        "gossip_pending": bitpack.popcount(st.gossip_pend_w).sum(
            dtype=torch.int32),
        "step": torch.tensor(st.step, dtype=torch.int32),
    }


def flight_summary(record: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Host-side digest of a ``rollout(record=True)`` flight record: every
    per-round scalar channel as a list of floats, and the final cumulative
    latency histogram with its p50/p99."""
    host = {name: t.detach().cpu().numpy() for name, t in record.items()}
    out: Dict[str, Any] = {"series": {}}
    for name, arr in sorted(host.items()):
        a = np.asarray(arr)
        if a.ndim == 1:
            out["series"][name] = [round(float(v), 6) for v in a]
    if "lat_hist" in host:
        final = np.asarray(host["lat_hist"])[-1]
        out["lat_hist"] = [int(v) for v in final]
        counts = torch.from_numpy(final.astype(np.int32))
        out["lat_p50"] = float(hist_quantile(counts, 0.5))
        out["lat_p99"] = float(hist_quantile(counts, 0.99))
    return out
