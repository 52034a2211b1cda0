"""SLO verdicts: grade a scenario's flight record against its thresholds.

(The JAX package's ``scenario/slo.py``, copied into the port; the latency
quantiles come from the port's ``ops/histogram.hist_quantile``.)

Each enabled :class:`~.spec.SLO` field becomes one :class:`Criterion` with
the measured value next to the threshold, so a failing verdict says not
just *that* the campaign regressed but *which* guarantee broke and by how
much.  Every measurement is sourced from the flight record the rollout
scan emitted (the flight recorder plus the campaign channels) — the verdict
is a pure host-side reduction of device telemetry, never a re-simulation.

r19: on the live plane with cross-host tracing enabled, the runner
substitutes the ``lat_hist`` channel with one rebuilt from span-exact
propagation times (origin publish stamp → subscriber deliver stamp, merged
across per-host ledgers by ``obs.merge``) before grading, and adds
``span_prop_p50_s``/``span_prop_p99_s`` channels carrying the merged
second-domain quantiles.  The latency criteria below read the substituted
histogram unchanged — span-exact verdicts need no new criterion kinds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from .spec import SLO, ScenarioSpec


@dataclasses.dataclass(frozen=True)
class Criterion:
    """One graded threshold: ``actual`` measured vs ``threshold`` bound."""

    name: str
    kind: str            # "max" | "min"
    threshold: float
    actual: float
    passed: bool

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Verdict:
    """A scenario's pass/fail with the per-criterion breakdown."""

    scenario: str
    passed: bool
    criteria: List[Criterion]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "passed": self.passed,
            "criteria": [c.to_dict() for c in self.criteria],
        }

    def __str__(self) -> str:
        rows = [
            f"  {'PASS' if c.passed else 'FAIL'}  {c.name}: "
            f"{c.actual:.4g} ({c.kind} {c.threshold:.4g})"
            for c in self.criteria
        ]
        head = f"{'PASS' if self.passed else 'FAIL'}  {self.scenario}"
        return "\n".join([head] + rows)


def _crit(name: str, kind: str, threshold, actual) -> Criterion:
    actual = float(actual)
    threshold = float(threshold)
    ok = actual <= threshold if kind == "max" else actual >= threshold
    # NaN never passes: a criterion that could not be measured is a failure
    # of the scenario, not a vacuous success.
    if not np.isfinite(actual):
        ok = False
    return Criterion(name, kind, threshold, actual, bool(ok))


def evaluate(
    spec: ScenarioSpec,
    record: Dict[str, np.ndarray],
    n_publishes: int,
) -> Verdict:
    """Grade ``record`` (host-side flight record, time axis leading)
    against ``spec.slo`` -> :class:`Verdict`."""
    slo: SLO = spec.slo
    crits: List[Criterion] = []

    def have(key: str) -> bool:
        return key in record

    if spec.family == "treecast":
        if slo.min_delivered_total is not None:
            crits.append(_crit(
                "delivered_total", "min", slo.min_delivered_total,
                record["msgs_delivered_total"][-1],
            ))
        if slo.max_final_orphans is not None:
            crits.append(_crit(
                "final_orphans", "max", slo.max_final_orphans,
                record["peers_orphaned"][-1],
            ))
        if slo.min_delivery_frac is not None:
            # The tree record counts total receipts, not per-message rows:
            # normalize by the ideal receipt count (every publish reaching
            # every finally-alive peer).
            alive = float(record["peers_alive"][-1])
            ideal = max(n_publishes * alive, 1.0)
            crits.append(_crit(
                "delivery_frac", "min", slo.min_delivery_frac,
                float(record["msgs_delivered_total"][-1]) / ideal,
            ))
    else:
        import torch

        from ..ops import histogram as hist_ops

        if slo.min_delivery_frac is not None:
            crits.append(_crit(
                "delivery_frac", "min", slo.min_delivery_frac,
                record["delivery_frac"][-1],
            ))
        if slo.max_p50 is not None or slo.max_p99 is not None:
            final_hist = torch.as_tensor(np.asarray(record["lat_hist"][-1]))
            if slo.max_p50 is not None:
                crits.append(_crit(
                    "latency_p50", "max", slo.max_p50,
                    hist_ops.hist_quantile(final_hist, 0.5),
                ))
            if slo.max_p99 is not None:
                crits.append(_crit(
                    "latency_p99", "max", slo.max_p99,
                    hist_ops.hist_quantile(final_hist, 0.99),
                ))
        if slo.max_capture_frac is not None:
            if not have("attacker_capture_frac"):
                raise ValueError(
                    "max_capture_frac SLO needs an attack wave (the "
                    "attacker channels are only recorded with attackers)"
                )
            crits.append(_crit(
                "capture_frac_peak", "max", slo.max_capture_frac,
                np.max(record["attacker_capture_frac"]),
            ))
        if slo.max_final_attacker_mesh_edges is not None:
            crits.append(_crit(
                "final_attacker_mesh_edges", "max",
                slo.max_final_attacker_mesh_edges,
                record["attacker_mesh_edges"][-1],
            ))
        if slo.min_final_target_honest_edges is not None:
            if not have("target_honest_mesh_edges"):
                raise ValueError(
                    "min_final_target_honest_edges SLO needs an eclipse "
                    "wave (no target, no target channel)"
                )
            crits.append(_crit(
                "final_target_honest_edges", "min",
                slo.min_final_target_honest_edges,
                record["target_honest_mesh_edges"][-1],
            ))
        if slo.max_final_attacker_score is not None:
            if not have("attacker_score_mean"):
                raise ValueError(
                    "max_final_attacker_score SLO needs an attack wave "
                    "(the score channels are only recorded with attackers)"
                )
            crits.append(_crit(
                "final_attacker_score", "max", slo.max_final_attacker_score,
                record["attacker_score_mean"][-1],
            ))
        if slo.min_final_honest_score is not None:
            if not have("honest_score_min"):
                raise ValueError(
                    "min_final_honest_score SLO needs an attack wave "
                    "(the score channels are only recorded with attackers)"
                )
            crits.append(_crit(
                "final_honest_score", "min", slo.min_final_honest_score,
                record["honest_score_min"][-1],
            ))

    # Failover criteria (family-agnostic: the live runner emits these
    # channels for whatever family it ran).  Requesting one without the
    # channel is a misconfigured scenario, not a vacuous pass.
    def _failover_channel(key: str, slo_name: str) -> np.ndarray:
        if not have(key):
            raise ValueError(
                f"{slo_name} SLO needs the {key!r} record channel "
                "(emitted by the live runner's failover scenarios)"
            )
        return record[key]

    if slo.min_final_epoch is not None:
        crits.append(_crit(
            "final_epoch", "min", slo.min_final_epoch,
            _failover_channel("final_epoch", "min_final_epoch")[-1],
        ))
    if slo.max_epoch_spread is not None:
        crits.append(_crit(
            "epoch_spread", "max", slo.max_epoch_spread,
            _failover_channel("epoch_spread", "max_epoch_spread")[-1],
        ))
    if slo.max_duplicate_deliveries is not None:
        crits.append(_crit(
            "duplicate_deliveries", "max", slo.max_duplicate_deliveries,
            _failover_channel(
                "duplicate_deliveries", "max_duplicate_deliveries"
            )[-1],
        ))

    # Streaming criteria (serving plane, scenario.streaming_runner).  Same
    # contract as failover: asking for a channel the runner didn't emit is
    # a misconfigured scenario, not a vacuous pass.
    def _streaming_channel(key: str, slo_name: str) -> np.ndarray:
        if not have(key):
            raise ValueError(
                f"{slo_name} SLO needs the {key!r} record channel "
                "(emitted by the streaming runner's serving scenarios)"
            )
        return record[key]

    if slo.max_queue_depth is not None:
        crits.append(_crit(
            "queue_depth_peak", "max", slo.max_queue_depth,
            _streaming_channel("queue_depth_peak", "max_queue_depth")[-1],
        ))
    if slo.max_ingest_latency_s is not None:
        crits.append(_crit(
            "ingest_lat_max_s", "max", slo.max_ingest_latency_s,
            _streaming_channel(
                "ingest_lat_max_s", "max_ingest_latency_s"
            )[-1],
        ))
    if slo.max_silent_drops is not None:
        crits.append(_crit(
            "silent_drops", "max", slo.max_silent_drops,
            _streaming_channel("silent_drops", "max_silent_drops")[-1],
        ))
    # Crash-safety criteria (r14): the streaming runner emits recovery_s /
    # lost_after_restart on EVERY run (zeros when no fault fired), so these
    # grade real measurements, never a vacuous pass.
    if slo.max_recovery_s is not None:
        crits.append(_crit(
            "recovery_s", "max", slo.max_recovery_s,
            _streaming_channel("recovery_s", "max_recovery_s")[-1],
        ))
    if slo.max_lost_after_restart is not None:
        crits.append(_crit(
            "lost_after_restart", "max", slo.max_lost_after_restart,
            _streaming_channel(
                "lost_after_restart", "max_lost_after_restart"
            )[-1],
        ))
    # Hybrid-plane comparative criterion (r16): the runner's eager-forced
    # twin emits p99_vs_eager_ratio; 0.0 encodes "eager completed fewer
    # messages than the hybrid" (unboundedly worse tail), which passes any
    # max-ratio bound.  NaN (twin produced no latencies at all) fails
    # closed as everywhere else.
    if slo.max_p99_vs_eager_ratio is not None:
        crits.append(_crit(
            "p99_vs_eager_ratio", "max", slo.max_p99_vs_eager_ratio,
            _streaming_channel(
                "p99_vs_eager_ratio", "max_p99_vs_eager_ratio"
            )[-1],
        ))
    # Self-tuning criteria (r20): the controller runner's A/B channels.
    # p99_vs_best_static_ratio < 1.0 asserts the self-tuned engine beat
    # EVERY static rung of its own ladder on p99 ingest→delivery (0.0
    # encodes "no static twin completed as many messages" — every static
    # tail unboundedly worse); min_controller_decisions rejects a loop that
    # never moved a knob; max_unplanned_recompiles grades the pre-warm
    # contract, compile_cache_size() - ladder_size() over the WHOLE run.
    if slo.max_p99_vs_best_static_ratio is not None:
        crits.append(_crit(
            "p99_vs_best_static_ratio", "max",
            slo.max_p99_vs_best_static_ratio,
            _streaming_channel(
                "p99_vs_best_static_ratio", "max_p99_vs_best_static_ratio"
            )[-1],
        ))
    if slo.min_controller_decisions is not None:
        crits.append(_crit(
            "controller_decisions", "min", slo.min_controller_decisions,
            _streaming_channel(
                "controller_decisions", "min_controller_decisions"
            )[-1],
        ))
    if slo.max_unplanned_recompiles is not None:
        crits.append(_crit(
            "unplanned_recompiles", "max", slo.max_unplanned_recompiles,
            _streaming_channel(
                "unplanned_recompiles", "max_unplanned_recompiles"
            )[-1],
        ))

    return Verdict(
        scenario=spec.name,
        passed=all(c.passed for c in crits),
        criteria=crits,
    )
