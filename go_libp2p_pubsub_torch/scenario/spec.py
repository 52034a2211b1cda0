"""Declarative scenario specs: an adversity campaign as serializable data.

(The JAX package's ``scenario/spec.py``, copied into the port unchanged.)

BASELINE config (d) and the ROADMAP's "handle as many scenarios as you can
imagine" were served by three disconnected mechanisms — ``utils.faults``
FaultPlans, ``models/attacks.py`` ad-hoc runners, and per-test link
profiles.  A :class:`ScenarioSpec` composes all of them onto ONE timeline:
phased churn (abrupt or graceful, with optional rejoin), attack waves
(sybil colocation, eclipse, invalid spam, gossip-promise spam, backoff
graft spam), link-degradation windows, and traffic workload generators
(constant / burst / hot-publisher), plus the SLO thresholds the run is
graded against.

A spec is pure data: dataclasses with an exact JSON round-trip
(``to_dict``/``from_dict``/``to_json``/``from_json``), so a scenario can be
committed, diffed, and replayed bit-for-bit (``scenario.runner.save_trace``
stores the spec next to the flight record it produced).  All randomness is
derived from ``seed`` through per-component substreams at compile time —
the lowered event tensors are a pure function of the spec.

Lowering to device event tensors lives in ``scenario.compiler``; execution
and verdicts in ``scenario.runner``; the named canon in ``scenario.canon``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FAMILIES = ("gossipsub", "treecast", "multitopic", "rlnc", "hybrid")
WORKLOAD_KINDS = ("constant", "burst", "hot")
ATTACK_KINDS = (
    "sybil", "eclipse", "spam", "promise_spam", "graft_spam",
    # The literature's remaining catalogue (arXiv 2007.02754 / 2212.05197):
    "cold_boot_eclipse", "covert_flash", "score_farm", "self_promo_ihave",
    "partition_flood",
)


@dataclass(frozen=True)
class Workload:
    """A traffic generator on the scenario timeline.

    - ``constant``: ``n_msgs`` publishes every ``every`` steps over
      [start, stop), each from a random honest alive peer (or ``src``).
    - ``burst``: ``n_msgs`` publishes all at ``start`` (flash crowd), each
      from a distinct random honest peer unless ``src`` pins one.
    - ``hot``: like constant but REQUIRES ``src`` — the hot-publisher
      pattern (one peer produces the topic's whole feed).
    """

    kind: str = "constant"
    start: int = 0
    stop: Optional[int] = None     # exclusive; None = scenario end
    every: int = 1
    n_msgs: int = 1                # per event (burst: total, at `start`)
    src: Optional[int] = None
    valid: bool = True
    topic: int = 0                 # multitopic family only

    def __post_init__(self) -> None:
        if self.kind not in WORKLOAD_KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}")
        if self.kind == "hot" and self.src is None:
            raise ValueError("hot workload requires src")
        if self.every < 1:
            raise ValueError("workload every must be >= 1")
        if self.n_msgs < 1:
            raise ValueError("workload n_msgs must be >= 1")


@dataclass(frozen=True)
class ChurnPhase:
    """A window of membership churn.

    Every ``every`` steps in [start, stop), ``kills_per_event`` victims are
    drawn (random honest alive peers, or cycled from ``peers``) and either
    killed abruptly (default) or removed gracefully (``graceful=True``:
    unsubscribe for the mesh families, Part for the tree).  With
    ``rejoin_after`` set, each victim comes back that many steps later
    (revive / resubscribe / join walk) — churn with rejoin, or with a
    single event, partition-and-heal.
    """

    start: int = 0
    stop: int = 1
    every: int = 8
    kills_per_event: int = 1
    graceful: bool = False
    rejoin_after: Optional[int] = None
    peers: Optional[List[int]] = None

    def __post_init__(self) -> None:
        if self.every < 1:
            raise ValueError("churn every must be >= 1")
        if self.stop <= self.start:
            raise ValueError("churn stop must be > start")


@dataclass(frozen=True)
class AttackWave:
    """An adversary campaign window (gossipsub family; ``spam`` and
    ``promise_spam`` also lower for multitopic).

    - ``sybil``: peers [0, n_attackers) share one IP-colocation group for
      the whole run (P6 defense under test).
    - ``eclipse``: the attackers are the ``target``'s CONVERGED mesh at
      scenario start (derived at compile time); during [start, stop) they
      receive but never relay (post-step silence) and never serve IWANTs
      (gossip mute).  ``spam_every``/``graft_spam`` compose spam flavors
      onto the same attacker set.
    - ``spam``: attackers [0, n_attackers) publish one invalid message each
      every ``spam_every`` steps in [start, stop) (P4 defense).
    - ``promise_spam``: attackers advertise but never serve IWANTs during
      the window (P7 promise tracking).
    - ``graft_spam``: attackers re-GRAFT through their prune-backoff every
      heartbeat for the WHOLE run (constructor-bound ``graft_spammers``),
      plus the window's invalid spam when ``spam_every > 0`` (P7 backoff
      violations).
    - ``cold_boot_eclipse``: ``n_attackers`` of the ``target``'s CONNECTED
      neighbors monopolize its mesh from step 0 — the compiler forces the
      target's mesh to attacker edges only and zeroes the score history on
      every touched edge (no banked P1/P2 to prune against); during
      [start, stop) the monopolists receive but never relay nor serve.
    - ``covert_flash``: attackers [0, n_attackers) behave honestly until
      ``defect_step``, then defect simultaneously (silence + gossip mute
      until ``stop``, plus invalid spam every ``spam_every`` steps when
      ``spam_every > 0``) — tests that defense reaction time beats banked
      reputation.
    - ``score_farm``: attackers publish VALID messages every ``spam_every``
      steps for the first ``farm_steps`` of the window (banking P1/P2
      credit), then flip to invalid spam for the remainder — tests that
      P4 penalties overcome farmed credit.
    - ``self_promo_ihave``: attackers publish valid self-originated traffic
      every ``spam_every`` steps and craft their IHAVEs to advertise ONLY
      ids they originated, while never serving the IWANTs those ads
      attract — inflated promise/delivery standing vs P7 promise tracking.
    - ``partition_flood``: a random ``partition_frac`` cohort of honest
      peers is partitioned away during [start, stop); at
      ``stop + flood_offset`` the attackers open an invalid spam flood
      (every ``spam_every`` steps to scenario end) timed to pollute the
      heal's gossip backfill.
    """

    kind: str = "spam"
    start: int = 0
    stop: Optional[int] = None     # exclusive; None = scenario end
    n_attackers: int = 0
    target: Optional[int] = None   # eclipse / cold_boot_eclipse only
    spam_every: int = 0            # 0 = no spam publishes
    graft_spam: bool = False       # also bind attackers as graft spammers
    defect_step: Optional[int] = None  # covert_flash: step the mask drops
    farm_steps: int = 0            # score_farm: valid-publish window length
    flood_offset: int = 0          # partition_flood: heal -> flood delay
    partition_frac: float = 0.0    # partition_flood: cohort fraction

    def __post_init__(self) -> None:
        if self.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown attack kind {self.kind!r}")
        targeted = ("eclipse", "cold_boot_eclipse")
        if self.kind in targeted and self.target is None:
            raise ValueError(f"{self.kind} wave requires target")
        if self.kind != "eclipse" and self.n_attackers < 1:
            raise ValueError(f"{self.kind} wave requires n_attackers >= 1")
        spam_kinds = ("spam", "score_farm", "self_promo_ihave",
                      "partition_flood")
        if self.kind in spam_kinds and self.spam_every < 1:
            raise ValueError(f"{self.kind} wave requires spam_every >= 1")
        # Kind-specific fields are rejected elsewhere rather than silently
        # ignored — a farm window on an eclipse wave is a spec bug.
        if self.defect_step is not None and self.kind != "covert_flash":
            raise ValueError("defect_step is covert_flash-only")
        if self.kind == "covert_flash":
            if self.defect_step is None or self.defect_step < 0:
                raise ValueError(
                    "covert_flash wave requires defect_step >= 0"
                )
        if self.farm_steps and self.kind != "score_farm":
            raise ValueError("farm_steps is score_farm-only")
        if self.kind == "score_farm" and self.farm_steps < 1:
            raise ValueError("score_farm wave requires farm_steps >= 1")
        if self.flood_offset and self.kind != "partition_flood":
            raise ValueError("flood_offset is partition_flood-only")
        if self.partition_frac and self.kind != "partition_flood":
            raise ValueError("partition_frac is partition_flood-only")
        if self.kind == "partition_flood":
            if self.flood_offset < 0:
                raise ValueError("flood_offset must be >= 0")
            if not (0.0 < self.partition_frac < 1.0):
                raise ValueError(
                    "partition_flood wave requires partition_frac in (0, 1)"
                )
            if self.stop is None:
                raise ValueError(
                    "partition_flood wave requires an explicit stop (the "
                    "heal the flood is timed against)"
                )


@dataclass(frozen=True)
class LinkWindow:
    """A link-degradation window: ingress gossip delay ``delay`` (rounds)
    installed on ``peers`` (or a random ``frac`` of peers) during
    [start, stop), restored to the ideal fabric at ``stop``."""

    start: int = 0
    stop: int = 1
    delay: int = 1
    peers: Optional[List[int]] = None
    frac: float = 0.0

    def __post_init__(self) -> None:
        if self.stop <= self.start:
            raise ValueError("link window stop must be > start")
        if self.delay < 0:
            raise ValueError("link delay must be >= 0")
        if self.peers is None and not (0.0 < self.frac <= 1.0):
            raise ValueError("link window needs peers or frac in (0, 1]")


@dataclass(frozen=True)
class SLO:
    """Pass/fail thresholds graded from the run's flight record.  ``None``
    disables a criterion.  Latency criteria read the recorder's histogram
    (``hist_quantile`` over the final cumulative ``lat_hist`` row);
    delivery reads the final state's delivery stats; capture reads the
    attacker channels; the ``*_total``/``orphans`` criteria are the tree
    family's delivery surface (the tree record has no latency histogram,
    so latency SLOs are rejected there at compile time)."""

    min_delivery_frac: Optional[float] = None
    max_p50: Optional[float] = None                  # rounds
    max_p99: Optional[float] = None                  # rounds
    max_capture_frac: Optional[float] = None         # max over the series
    max_final_attacker_mesh_edges: Optional[int] = None
    min_final_target_honest_edges: Optional[int] = None
    # Score-standing criteria (attack waves only — graded from the
    # ``attacker_score_mean`` / ``honest_score_min`` campaign channels):
    # the ceiling asserts the defense buried the attackers' standing; the
    # floor asserts no honest peer was collaterally penalized below it.
    max_final_attacker_score: Optional[float] = None
    min_final_honest_score: Optional[float] = None
    min_delivered_total: Optional[int] = None        # tree
    max_final_orphans: Optional[int] = None          # tree
    # Failover criteria (live plane, scenario.live_runner): graded from the
    # ``final_epoch`` / ``epoch_spread`` / ``duplicate_deliveries`` record
    # channels.  ``min_final_epoch`` asserts a promotion actually happened
    # (every survivor at epoch >= N); ``max_epoch_spread`` asserts the
    # survivors CONVERGED (spread 0 = no forked regime); the duplicates cap
    # is the exactly-once delivery bound across replay/heal overlap.
    min_final_epoch: Optional[int] = None
    max_epoch_spread: Optional[int] = None
    max_duplicate_deliveries: Optional[int] = None
    # Streaming criteria (serving plane, scenario.streaming_runner): graded
    # from the ``queue_depth_peak`` / ``ingest_lat_max_s`` / ``silent_drops``
    # record channels.  ``max_queue_depth`` bounds ingest backlog under the
    # offered load; ``max_ingest_latency_s`` bounds worst-case exact
    # ingest→delivery (host seconds, quantized to chunk boundaries);
    # ``max_silent_drops`` is the conservation bound — every message must be
    # delivered, queued, or attributed to a named backpressure counter
    # (0 under ``block`` means the ring NEVER loses a message it accepted).
    max_queue_depth: Optional[int] = None
    max_ingest_latency_s: Optional[float] = None
    max_silent_drops: Optional[int] = None
    # Streaming crash-safety criteria (r14, graded from the runner's
    # ``recovery_s`` / ``lost_after_restart`` channels — emitted on every
    # streaming run, zeros when no fault fired, so the SLO never passes
    # vacuously).  ``max_recovery_s`` bounds crash→resumed wall time;
    # ``max_lost_after_restart`` is the exactly-once floor: accepted valid
    # messages neither delivered, in flight, nor attributed to a named shed
    # counter after the run (0 = no accepted message vanished in the
    # crash).  ``max_duplicate_deliveries`` (above) reads the engine's
    # content-hash duplicate counter on this plane.
    max_recovery_s: Optional[float] = None
    max_lost_after_restart: Optional[int] = None
    # Degraded-links comparison (r16, hybrid streaming runs with
    # ``compare_eager`` set): ceiling on hybrid p99 ingest→delivery divided
    # by the eager-forced twin's p99 over the same timeline.  < 1.0 asserts
    # the adaptive hybrid strictly beat pure eager under the injected loss;
    # when the eager twin completes FEWER messages than the hybrid the
    # ratio is reported as 0.0 (unboundedly worse eager tail).
    max_p99_vs_eager_ratio: Optional[float] = None
    # Self-tuning criteria (r20, streaming runs with a ``controller`` dict
    # and ``compare_static`` set — graded from the runner's
    # ``p99_vs_best_static_ratio`` / ``controller_decisions`` /
    # ``unplanned_recompiles`` channels).
    # ``max_p99_vs_best_static_ratio``: ceiling on the self-tuned engine's
    # p99 ingest→delivery divided by the BEST p99 any single static rung of
    # the same ladder achieves over the same timeline — < 1.0 asserts the
    # controller strictly beat every static configuration; when no static
    # twin completes at least as many messages as the tuned engine the
    # ratio is reported as 0.0 (every static tail is unboundedly worse).
    # ``min_controller_decisions`` asserts the controller actually acted
    # (no vacuous pass on a loop that never moved a knob);
    # ``max_unplanned_recompiles`` is the pre-warm contract: the engine's
    # ``compile_cache_size() - ladder_size()`` after the whole run,
    # crash/restore included (0 = stepping the ladder never compiled).
    max_p99_vs_best_static_ratio: Optional[float] = None
    min_controller_decisions: Optional[int] = None
    max_unplanned_recompiles: Optional[int] = None


@dataclass
class ScenarioSpec:
    """One named, seeded, fully declarative adversity campaign."""

    name: str
    family: str = "gossipsub"
    n_steps: int = 32
    seed: int = 0
    model: Dict[str, Any] = field(default_factory=dict)
    workloads: List[Workload] = field(default_factory=list)
    churn: List[ChurnPhase] = field(default_factory=list)
    attacks: List[AttackWave] = field(default_factory=list)
    links: List[LinkWindow] = field(default_factory=list)
    # Bridge for existing FaultPlan schedules: {"kills": {step: [ids]},
    # "leaves": {step: [ids]}} — the compiler lowers them alongside churn
    # (see ScenarioSpec.from_fault_plan / compiler._lower_faults).
    faults: Optional[Dict[str, Dict[str, List[int]]]] = None
    # Live-plane overrides for scenario.live_runner (ignored by the sim
    # compiler): {"n_hosts": int, "step_ms": float}.  None = the runner's
    # defaults — keeping this a plain optional dict preserves the exact
    # JSON round-trip for specs that never touch the live plane.
    live: Optional[Dict[str, Any]] = None
    # Streaming-plane config for scenario.streaming_runner (ignored by the
    # sim compiler): {"streaming_only": bool, "chunk_steps": int,
    # "capacity": int, "policy": str, "pub_width": int,
    # "completion_frac": float}.  Same plain-dict shape as ``live`` so the
    # JSON round-trip stays exact for specs that never stream.
    #
    # Fault-injection keys (r14 chaos, all optional, lowered by
    # compiler.compile_streaming_plan onto StreamingPlan.faults):
    #   "snapshot_every": int       — engine auto-snapshot period in chunks
    #                                 (defaults to 1 when a crash is staged)
    #   "crash_at_chunk": int       — kill the engine+ring after that many
    #                                 traffic chunks; recovery = fresh engine
    #                                 over an equal model + restore()
    #   "verifier_crash_at_chunk": int — drop the validation pipeline with a
    #                                 batch in flight; the producer resubmits
    #                                 its retry window (at-least-once), the
    #                                 engine's dedup keeps delivery
    #                                 exactly-once
    #   "producer_stall": {"start": int, "steps": int} — publishes scheduled
    #                                 in the window are deferred to its end
    #                                 (stall-then-flood)
    #   "clock_skew": {"at_chunk": int, "skew_s": float} — step the host
    #                                 clock the latency stamps read
    #
    # Degraded-links keys (r16 adaptive coded gossip, hybrid family):
    #   "loss": {"start_chunk": int, "stop_chunk": int, "delay": int} —
    #                                 stamp an all-peer ingress delay for
    #                                 chunks [start_chunk, stop_chunk) and
    #                                 reset to 0 after; ``delay`` semantics
    #                                 are per-family (pend-hold for
    #                                 multitopic, DECIMATION loss for the
    #                                 hybrid — the r11 asymmetry)
    #   "compare_eager": bool       — also run an eager-forced twin engine
    #                                 (switch thresholds pinned above 1.0)
    #                                 over the same timeline and emit the
    #                                 ``p99_vs_eager_ratio`` channel
    #
    # Self-tuning keys (r20 controller, both streaming families):
    #   "controller": {"ladder": [[chunk_steps, pub_width], ...],
    #                  "policy": {ControllerPolicy field overrides}} —
    #                                 run with a serve.controller.Controller
    #                                 polled at every chunk boundary over a
    #                                 pre-warmed geometry ladder (must
    #                                 contain the spec's base geometry);
    #                                 zero unplanned recompiles is asserted
    #                                 via the ``unplanned_recompiles``
    #                                 channel
    #   "compare_static": bool      — also replay the same timeline through
    #                                 one STATIC twin engine per ladder rung
    #                                 (controller disabled, no faults) and
    #                                 emit ``p99_vs_best_static_ratio`` /
    #                                 ``best_static_p99_s`` — the self-tuned
    #                                 vs best-static A/B
    #   "loss_regimes": [{"start_step": int, "stop_step": int,
    #                     "delay": int}, ...] — step-keyed (NOT chunk-keyed:
    #                                 fair across geometries) non-overlapping
    #                                 ingress-delay windows; same per-family
    #                                 delay semantics as "loss"
    streaming: Optional[Dict[str, Any]] = None
    slo: SLO = field(default_factory=SLO)
    description: str = ""
    # Provenance stamp for archived replay artifacts (r21 co-evolution):
    # {"defense_digest": str, "found_by": str, "search_seed": int, ...}.
    # Never read by the compiler — a plain optional dict (like ``live`` /
    # ``streaming``) so the exact JSON round-trip holds and specs that
    # predate the field still load.
    meta: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_steps < 1:
            raise ValueError("n_steps must be >= 1")

    @property
    def live_only(self) -> bool:
        """True when the scenario exercises behavior that exists only on
        the socket plane (root failover, partition heal) and therefore has
        no sim lowering.  Marked via ``live={"live_only": True, ...}`` so
        the JSON round-trip stays exact."""
        return bool((self.live or {}).get("live_only"))

    @property
    def streaming_only(self) -> bool:
        """True when the scenario is a serving-plane campaign (unbounded
        ingest through the ring into the resident engine) with no closed-sim
        lowering.  Marked via ``streaming={"streaming_only": True, ...}``."""
        return bool((self.streaming or {}).get("streaming_only"))

    # -- FaultPlan bridge ---------------------------------------------------

    @classmethod
    def from_fault_plan(cls, name: str, plan, n_steps: int, **kw):
        """Wrap a ``utils.faults.FaultPlan`` as a scenario (kills/leaves
        become the spec's ``faults`` schedule; everything else from kw)."""
        import numpy as np

        faults = {
            "kills": {
                str(t): [int(i) for i in np.flatnonzero(m)]
                for t, m in sorted(plan.kills.items())
            },
            "leaves": {
                str(t): [int(i) for i in np.flatnonzero(m)]
                for t, m in sorted(plan.leaves.items())
            },
        }
        return cls(name=name, n_steps=n_steps, faults=faults, **kw)

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        d = dict(d)
        d["workloads"] = [Workload(**w) for w in d.get("workloads", [])]
        d["churn"] = [ChurnPhase(**c) for c in d.get("churn", [])]
        d["attacks"] = [AttackWave(**a) for a in d.get("attacks", [])]
        d["links"] = [LinkWindow(**l) for l in d.get("links", [])]
        slo = d.get("slo", {})
        d["slo"] = slo if isinstance(slo, SLO) else SLO(**slo)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))
