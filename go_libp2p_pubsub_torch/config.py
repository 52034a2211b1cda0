"""Typed protocol configuration for the PyTorch port.

A copy of ``GossipSubParams`` and ``ScoreParams`` from the JAX package's
``config.py``, field for field, with the same defaults and the same
validation.  The port keeps its own copy because importing the JAX
package pulls in ``jax`` (its ``__init__`` imports ``api.py``);
``tests/test_torch_scaffold.py`` pins the two copies to each other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


@dataclass(frozen=True)
class GossipSubParams:
    """GossipSub v1.1 protocol parameters (north-star configs b, e).

    These mirror the public GossipSub spec's D/Dlo/Dhi/heartbeat family —
    absent from the v0 reference, required by BASELINE.json ("GossipSub D=6
    mesh, 1k-peer heartbeat sim").
    """

    d: int = 6                 # target mesh degree
    d_lo: int = 4              # graft below
    d_hi: int = 12             # prune above
    d_score: int = 4           # best-scoring peers kept on oversubscription
    d_lazy: int = 6            # gossip emission degree
    d_out: int = 2             # min outbound-mesh degree (v1.1)
    history_length: int = 5    # mcache windows kept
    history_gossip: int = 3    # windows advertised in IHAVE
    heartbeat_interval_s: float = 1.0
    fanout_ttl_s: float = 60.0
    gossip_factor: float = 0.25
    opportunistic_graft_peers: int = 2
    opportunistic_graft_ticks: int = 8  # heartbeats between opportunistic checks
    max_ihave_length: int = 5000
    max_iwant_length: int = 5000  # per-advertiser ask budget per heartbeat
    #                               (go-gossipsub reuses MaxIHaveLength here)
    seen_ttl_s: float = 120.0
    prune_backoff_heartbeats: int = 4  # spec's PruneBackoff, in heartbeats
    flood_publish: bool = True  # own publishes go to ALL topic peers above
    #                             publish_threshold (go-gossipsub default)
    idontwant: bool = False  # gossipsub v1.2 IDONTWANT: on first receipt a
    #                          peer tells its mesh neighbors, who then skip
    #                          relaying it the copy — in the lockstep model
    #                          a sender's knowledge is exactly the
    #                          receiver's previous-round possession, so
    #                          suppression masks the duplicate copies that
    #                          would have crossed the wire (observable as
    #                          lower P3 mesh-delivery counting; deliveries,
    #                          receipts, and all other state are unchanged).
    #                          Inert under per-edge delay (max_edge_delay>0):
    #                          a one-round snapshot cannot represent d-round
    #                          notification paths, so the model
    #                          conservatively counts those duplicates
    idontwant_wire_lag: bool = False  # IDONTWANT possession snapshot age.
    #                          False (default, the historical behavior): a
    #                          sender suppresses against the receiver's full
    #                          start-of-round possession — INCLUDING first
    #                          receipts from the immediately preceding round,
    #                          i.e. notifications that crossed the wire with
    #                          zero latency.  True (wire parity): snapshot
    #                          one round older (have_w minus fresh_w, the
    #                          previous round's first receipts) — a
    #                          notification sent on receipt in round t-1 is
    #                          still in flight during round t, so the
    #                          duplicate it would have suppressed still
    #                          crosses the wire and still counts toward P3
    #                          mesh-delivery credit.  Receipts and scores
    #                          are otherwise identical; only duplicate
    #                          COUNTING moves one round later.

    def __post_init__(self) -> None:
        if not (self.d_lo <= self.d <= self.d_hi):
            raise ValueError("require d_lo <= d <= d_hi")
        if self.history_gossip > self.history_length:
            raise ValueError("history_gossip must be <= history_length")
        if self.d_out > self.d_lo or 2 * self.d_out > self.d:
            # The spec's constraint: the outbound quota must be satisfiable
            # under both the graft floor and the oversubscription keep rule.
            raise ValueError("require d_out <= d_lo and d_out <= d/2")
        if self.prune_backoff_heartbeats < 0:
            # 0 is a documented off switch; negatives would silently disable
            # the window via the `backoff <= 0` re-graft test (ADVICE r1).
            raise ValueError("prune_backoff_heartbeats must be >= 0")
        if self.opportunistic_graft_ticks < 1:
            raise ValueError("opportunistic_graft_ticks must be >= 1")
        if self.max_iwant_length < 1:
            raise ValueError("max_iwant_length must be >= 1")


@dataclass(frozen=True)
class ScoreParams:
    """Peer-score function weights (GossipSub v1.1; north-star config d).

    Topic-level components P1-P4 plus global P5-P7, with decay. Defaults are
    benign placeholders; attack-trace benchmarks override them.
    """

    # P1: time in mesh
    time_in_mesh_weight: float = 0.01
    time_in_mesh_quantum_s: float = 1.0
    time_in_mesh_cap: float = 3600.0
    # P2: first message deliveries
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_decay: float = 0.5
    first_message_deliveries_cap: float = 2000.0
    # P3: mesh message delivery deficit (squared).  The threshold must be
    # tuned to the topic's expected message rate, so P3/P3b default to
    # DISABLED (weight 0) — a quiet topic with a naive threshold would
    # mass-prune its own mesh.  Throughput/attack configs enable them with a
    # rate-appropriate threshold (> 0 is enforced when enabled).
    mesh_message_deliveries_weight: float = 0.0
    mesh_message_deliveries_decay: float = 0.5
    mesh_message_deliveries_threshold: float = 20.0
    mesh_message_deliveries_cap: float = 100.0
    mesh_message_deliveries_activation_s: float = 5.0
    # P3b: mesh failure penalty (sticky)
    mesh_failure_penalty_weight: float = 0.0
    mesh_failure_penalty_decay: float = 0.5
    # P4: invalid messages (squared)
    invalid_message_deliveries_weight: float = -1.0
    invalid_message_deliveries_decay: float = 0.3
    # topic weight applied to P1-P4 sum
    topic_weight: float = 1.0
    topic_score_cap: float = 100.0
    # P5: application-specific (supplied externally)
    app_specific_weight: float = 1.0
    # P6: IP colocation
    ip_colocation_factor_weight: float = -1.0
    ip_colocation_factor_threshold: float = 1.0
    # P7: behavioural penalty (squared)
    behaviour_penalty_weight: float = -1.0
    behaviour_penalty_threshold: float = 0.0
    behaviour_penalty_decay: float = 0.9
    # score thresholds
    gossip_threshold: float = -10.0
    publish_threshold: float = -50.0
    graylist_threshold: float = -80.0
    accept_px_threshold: float = 10.0
    opportunistic_graft_threshold: float = 1.0
    decay_interval_s: float = 1.0
    decay_to_zero: float = 0.01
    retain_score_s: float = 3600.0

    def __post_init__(self) -> None:
        # Mirrors the upstream GossipSub validation: an enabled P3 with a
        # non-positive threshold is a misconfiguration (every mesh link would
        # carry a penalty regardless of behavior).
        if (
            self.mesh_message_deliveries_weight != 0.0
            and self.mesh_message_deliveries_threshold <= 0.0
        ):
            raise ValueError(
                "mesh_message_deliveries_threshold must be > 0 when "
                "mesh_message_deliveries_weight is non-zero"
            )


def to_dict(cfg: Any) -> Dict[str, Any]:
    """Serialize a config dataclass to a plain dict."""
    return dataclasses.asdict(cfg)
