"""Peer-score ops: the GossipSub v1.1 score function on tensors.

Port of the JAX package's ``ops/scoring.py``: per-topic components P1-P4
from per-(peer, neighbor-slot) counters, global components P5-P7, and
the heartbeat decay.  Everything is elementwise over [N, K] or [N].

The sums of weighted terms round as the reference's XLA CPU fusions round
them (``ops/fma.py``): the first weighted term and each later one
contract with the running sum into a fused multiply-add.  ``segment_sum``
is ``index_add_``; every sum it takes on this path is of integer-valued
float32, so the scatter order cannot change a bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ScoreParams
from .fma import fma, madd, madd_square


class TopicCounters(NamedTuple):
    """Per-(local peer, neighbor slot) counters for one topic."""

    time_in_mesh: torch.Tensor               # f32[N, K]
    first_message_deliveries: torch.Tensor   # f32[N, K]
    mesh_message_deliveries: torch.Tensor    # f32[N, K]
    mesh_failure_penalty: torch.Tensor       # f32[N, K]
    invalid_message_deliveries: torch.Tensor  # f32[N, K]
    mesh_time_active: torch.Tensor           # f32[N, K] seconds since graft

    @classmethod
    def zeros(cls, n: int, k: int, device=None) -> "TopicCounters":
        return cls(*(torch.zeros((n, k), dtype=torch.float32, device=device)
                     for _ in range(6)))


class GlobalCounters(NamedTuple):
    """Per-peer global score inputs (indexed by the *remote* peer id)."""

    app_score: torch.Tensor          # f32[N] P5 application-specific score
    ip_group: torch.Tensor           # i32[N] colocation group id
    behaviour_penalty: torch.Tensor  # f32[N] P7 counter

    @classmethod
    def zeros(cls, n: int, device=None) -> "GlobalCounters":
        return cls(
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.arange(n, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
        )


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_sum`` (ids outside [0, num_segments) dropped)."""
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out.index_add_(0, torch.where(ok, ids, num_segments).long(), data)
    return out[:num_segments]


def _deficit(c: TopicCounters, p: ScoreParams) -> torch.Tensor:
    capped = torch.clamp(c.mesh_message_deliveries,
                         max=p.mesh_message_deliveries_cap)
    return torch.clamp(p.mesh_message_deliveries_threshold - capped, min=0.0)


def topic_score(c: TopicCounters, p: ScoreParams) -> torch.Tensor:
    """P1-P4 for one topic -> f32[N, K]: my score of each neighbor slot."""
    a = torch.clamp(c.time_in_mesh / p.time_in_mesh_quantum_s,
                    max=p.time_in_mesh_cap)
    b = torch.clamp(c.first_message_deliveries,
                    max=p.first_message_deliveries_cap)
    active = c.mesh_time_active >= p.mesh_message_deliveries_activation_s
    d = _deficit(c, p)
    p3_raw = torch.where(active, d * d, 0.0)
    # p1 + p2: the P1 multiply contracts with the add (its weight is the
    # one that survives XLA's simplification of x * 1).
    if p.time_in_mesh_weight in (1.0, -1.0):
        acc = madd(b, p.first_message_deliveries_weight,
                   a * p.time_in_mesh_weight)
    else:
        p2 = b if p.first_message_deliveries_weight == 1.0 else (
            b * p.first_message_deliveries_weight)
        acc = fma(a, p.time_in_mesh_weight, p2)
    acc = madd(p3_raw, p.mesh_message_deliveries_weight, acc)
    acc = madd(c.mesh_failure_penalty, p.mesh_failure_penalty_weight, acc)
    acc = madd_square(c.invalid_message_deliveries,
                      p.invalid_message_deliveries_weight, acc)
    if p.topic_weight != 1.0:
        acc = acc * p.topic_weight
    return torch.clamp(acc, max=p.topic_score_cap)


def _colocation_surplus(ip_group: torch.Tensor, p: ScoreParams, pm=None):
    """f32[N]: how far each peer's colocation group exceeds the threshold
    (group ids live in [0, N); ``segment_sum`` counts group sizes).  On a
    rank of the sharded rollout (``pm``) ``ip_group`` is the rank's block:
    each rank counts its peers' groups as integers and the counts add over
    the ranks (an integer all-reduce: a count of ones is exact in f32, so
    this is the reference's float ``segment_sum`` bit for bit)."""
    if pm is None:
        n = ip_group.shape[0]
        group = torch.remainder(ip_group, n).long()
        counts = segment_sum(
            torch.ones(n, dtype=torch.float32, device=ip_group.device),
            group, n)
    else:
        group = torch.remainder(ip_group, pm.n).long()
        counts = pm.sum(torch.bincount(group, minlength=pm.n).to(
            torch.int32)).to(torch.float32)
    return torch.clamp(counts[group] - p.ip_colocation_factor_threshold,
                       min=0.0)


def colocation_penalty(ip_group: torch.Tensor, p: ScoreParams) -> torch.Tensor:
    """P6 -> f32[N]: squared surplus of peers sharing a colocation group
    (the surplus is integer-valued, so its square is exact)."""
    surplus = _colocation_surplus(ip_group, p)
    return surplus * surplus * p.ip_colocation_factor_weight


def global_score(g: GlobalCounters, p: ScoreParams, pm=None
                 ) -> torch.Tensor:
    """P5 + P6 + P7 -> f32[N], indexed by remote peer id.  P6 and P7 each
    contract with the running sum (``madd_square``).  With ``pm`` the
    counters are a rank's block, and so is the result."""
    surplus = _colocation_surplus(g.ip_group, p, pm)
    excess = torch.clamp(g.behaviour_penalty - p.behaviour_penalty_threshold,
                         min=0.0)
    p5 = g.app_score if p.app_specific_weight == 1.0 else (
        g.app_score * p.app_specific_weight)
    acc = madd_square(surplus, p.ip_colocation_factor_weight, p5)
    return madd_square(excess, p.behaviour_penalty_weight, acc)


def neighbor_scores(
    c: TopicCounters,
    g: GlobalCounters,
    nbrs: torch.Tensor,
    nbr_valid: torch.Tensor,
    p: ScoreParams,
    jidx: Optional[torch.Tensor] = None,
    pm=None,
) -> torch.Tensor:
    """Full score of each neighbor slot -> f32[N, K]; invalid slots score
    -inf.  ``jidx`` optionally supplies ``clip(nbrs, 0, N-1)``.  On a rank
    of the sharded rollout (``pm``) the neighbors' global scores are read
    across ranks (``pm.gather``)."""
    gs = global_score(g, p, pm)
    if pm is not None:
        if jidx is None:
            jidx = nbrs.clamp(0, pm.n - 1)
        total = topic_score(c, p) + pm.gather(gs, jidx)
        return torch.where(nbr_valid, total, -torch.inf)
    if jidx is None:
        jidx = nbrs.clamp(0, gs.shape[0] - 1)
    total = topic_score(c, p) + gs[jidx.long()]
    return torch.where(nbr_valid, total, -torch.inf)


def decay_topic_counters(c: TopicCounters, p: ScoreParams) -> TopicCounters:
    """Heartbeat decay with decay-to-zero snapping."""

    def dec(x, rate):
        x = x * rate
        return torch.where(x < p.decay_to_zero, 0.0, x)

    return c._replace(
        first_message_deliveries=dec(
            c.first_message_deliveries, p.first_message_deliveries_decay
        ),
        mesh_message_deliveries=dec(
            c.mesh_message_deliveries, p.mesh_message_deliveries_decay
        ),
        mesh_failure_penalty=dec(c.mesh_failure_penalty,
                                 p.mesh_failure_penalty_decay),
        invalid_message_deliveries=dec(
            c.invalid_message_deliveries, p.invalid_message_deliveries_decay
        ),
    )


def decay_global_counters(g: GlobalCounters, p: ScoreParams) -> GlobalCounters:
    b = g.behaviour_penalty * p.behaviour_penalty_decay
    return g._replace(
        behaviour_penalty=torch.where(b < p.decay_to_zero, 0.0, b)
    )


def on_graft(c: TopicCounters, grafted: torch.Tensor) -> TopicCounters:
    """Reset per-slot mesh clocks for newly grafted slots."""
    return c._replace(
        time_in_mesh=torch.where(grafted, 0.0, c.time_in_mesh),
        mesh_time_active=torch.where(grafted, 0.0, c.mesh_time_active),
    )


def on_prune(
    c: TopicCounters, pruned: torch.Tensor, p: ScoreParams
) -> TopicCounters:
    """Sticky P3b penalty for slots pruned with a delivery deficit, and
    mesh-clock reset."""
    active = c.mesh_time_active >= p.mesh_message_deliveries_activation_s
    d = _deficit(c, p)
    penalty = torch.where(pruned & active, d * d, 0.0)
    return c._replace(
        mesh_failure_penalty=c.mesh_failure_penalty + penalty,
        time_in_mesh=torch.where(pruned, 0.0, c.time_in_mesh),
        mesh_time_active=torch.where(pruned, 0.0, c.mesh_time_active),
    )


def tick_mesh_clocks(
    c: TopicCounters, in_mesh: torch.Tensor, dt_s: float
) -> TopicCounters:
    """Advance P1 time-in-mesh and the P3 activation clock for mesh slots."""
    return c._replace(
        time_in_mesh=torch.where(in_mesh, c.time_in_mesh + dt_s,
                                 c.time_in_mesh),
        mesh_time_active=torch.where(
            in_mesh, c.mesh_time_active + dt_s, c.mesh_time_active
        ),
    )
