"""Defense configuration registry + the co-evolution invariant gate (r21).

(The JAX package's ``scenario/defense.py``, copied into the port with
``promoted_defense.json`` beside it; the gate's sweeps run the port's
torch scoring ops and its deep gate the port's model on ``device``.)

The fuzzer (``tools/scenario_fuzz.py``) and the co-evolution loop
(``tools/coevolve.py``) both grade attack campaigns against a *defense*:
a score-parameter dict lowered into :class:`~..config.ScoreParams` by the
scenario compiler.  This module is the single home for those dicts —
``STANDING_DEFENSE`` (pre-taxonomy shipped config), ``HARDENED_DEFENSE``
(the cold-boot fix), and ``PROMOTED_DEFENSE`` (whatever the last
co-evolution run promoted, loaded from the committed
``promoted_defense.json`` next to this file; falls back to HARDENED when
no promotion has ever happened).

It also hosts :func:`check_invariants`, the machine-checkable gate
distilled from ``tests/test_scoring_invariants.py``.  The co-evolution
loop may ONLY grade a defense candidate after this gate passes — the
formal-model constraints (P4/P7 penalty monotonicity, P6 penalty
non-positivity, bounded mesh capture, honest-score floor) are what make
an automated search over P1-P7 weight space safe to promote.  The gate is
a plain function so the loop can *reject* candidates instead of crashing,
and so the audit artifact can record exactly which invariant each
rejected candidate violated.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "STANDING_DEFENSE",
    "HARDENED_DEFENSE",
    "PROMOTED_DEFENSE",
    "PROMOTED_PATH",
    "defense_digest",
    "load_promoted",
    "check_invariants",
]

# The standing defense: the scored config the canon shipped BEFORE the
# attack taxonomy — P4 hammer + P6 colocation, P3 at its shipped default
# (disabled; upstream guidance is that its threshold must be rate-tuned).
STANDING_DEFENSE: Dict[str, float] = {
    "invalid_message_deliveries_weight": -30.0,
    "ip_colocation_factor_weight": -1.0,
    "ip_colocation_factor_threshold": 1.0,
}

# The hardened config: the fix for the cold-boot monopoly the first fuzz
# hunt found.  P3 enabled with a threshold tuned to the fuzz mesh's
# observed steady delivery rate (~2 msgs / decay interval on the every-2
# workload).
HARDENED_DEFENSE: Dict[str, float] = dict(
    STANDING_DEFENSE,
    mesh_message_deliveries_weight=-1.0,
    mesh_message_deliveries_threshold=1.5,
    mesh_message_deliveries_activation_s=3.0,
)

# Where a co-evolution run publishes its surviving config.  Committed, so
# the shipped default is the promoted config — not a hand-picked one.
PROMOTED_PATH = os.path.join(os.path.dirname(__file__),
                             "promoted_defense.json")


def defense_digest(defense: Dict[str, float]) -> str:
    """Stable short digest of a defense dict (keys sorted, JSON encoded).

    Stamped into fuzz red reports and replay artifacts so every archived
    red names the exact config it was red AGAINST.
    """
    return hashlib.sha256(
        json.dumps(defense, sort_keys=True).encode()
    ).hexdigest()[:12]


def load_promoted(path: Optional[str] = None) -> Dict[str, float]:
    """The last promoted defense, or HARDENED when none is committed.

    The artifact is written by ``tools/coevolve.py`` as
    ``{"defense": {...}, "digest": ..., ...provenance...}``; only the
    ``defense`` dict is the config, the rest is audit trail.
    """
    p = PROMOTED_PATH if path is None else path
    try:
        with open(p) as f:
            doc = json.load(f)
        return dict(doc["defense"])
    except (OSError, KeyError, ValueError):
        return dict(HARDENED_DEFENSE)


PROMOTED_DEFENSE: Dict[str, float] = load_promoted()


# ---------------------------------------------------------------------------
# invariant gate
# ---------------------------------------------------------------------------

def _score_params(defense: Dict[str, float]):
    from ..config import ScoreParams
    return ScoreParams(**defense)


def _check_p4(defense: Dict[str, float], violations: List[str]) -> None:
    """More invalid deliveries may never RAISE a slot's score, and with a
    negative weight every extra invalid delivery must strictly lower it
    (mirrors test_p4_monotonicity_sweep at the ops level)."""
    import torch

    from ..ops import scoring as scoring_ops

    params = _score_params(defense)
    counts = np.array([0.0, 1.0, 2.0, 4.0, 8.0, 16.0])
    c = scoring_ops.TopicCounters.zeros(1, len(counts))._replace(
        invalid_message_deliveries=torch.tensor([counts], dtype=torch.float32),
    )
    s = np.asarray(scoring_ops.topic_score(c, params))[0]
    if not np.all(np.diff(s) <= 1e-6):
        violations.append(
            "p4_monotonicity: score increases with more invalid "
            f"deliveries (weight "
            f"{params.invalid_message_deliveries_weight:+g})"
        )
    elif params.invalid_message_deliveries_weight < 0 \
            and not np.all(np.diff(s) < 0):
        violations.append(
            "p4_monotonicity: invalid deliveries do not strictly lower "
            "the score despite a negative weight"
        )


def _check_p7(defense: Dict[str, float], violations: List[str]) -> None:
    """Behaviour penalty: more violations may never raise the global
    score (mirrors test_p7_monotonicity_sweep)."""
    import torch

    from ..ops import scoring as scoring_ops

    params = _score_params(defense)
    pens = np.array([0.0, 1.0, 2.0, 5.0, 10.0], np.float32)
    g = scoring_ops.GlobalCounters.zeros(len(pens))._replace(
        behaviour_penalty=torch.from_numpy(pens)
    )
    s = np.asarray(scoring_ops.global_score(g, params))
    if not np.all(np.diff(s) <= 1e-6):
        violations.append(
            "p7_monotonicity: behaviour violations raise the global "
            f"score (weight {params.behaviour_penalty_weight:+g})"
        )


def _check_p6(defense: Dict[str, float], violations: List[str]) -> None:
    """Colocation penalty must be non-positive for every group size
    (mirrors test_colocation_penalty_monotone_sweep's sign half)."""
    import torch

    from ..ops import scoring as scoring_ops

    params = _score_params(defense)
    n = 64
    for k in (2, 8, 32):
        groups = np.arange(n, dtype=np.int32)
        groups[:k] = 0
        pen = np.asarray(
            scoring_ops.colocation_penalty(torch.from_numpy(groups), params)
        )
        if not np.all(pen <= 1e-9):
            violations.append(
                f"p6_sign: colocation penalty positive for group size {k} "
                f"(weight {params.ip_colocation_factor_weight:+g})"
            )
            return


def _check_capture_and_floor(
    defense: Dict[str, float], violations: List[str], device="cuda",
) -> None:
    """Deep gate: k colocated sybils hold <= 2.5x their fair share of
    honest mesh slots under the candidate's P6, and no honest peer's
    score is dragged below the collateral floor on the same rollout
    (mirrors test_bounded_mesh_capture_under_sybils + the honest-floor
    bound of test_honest_score_floor_under_every_canon_attack)."""
    from ..models.attacks import sybil_colocation_attack
    from ..models.gossipsub import GossipSub

    params = _score_params(defense)
    n, k = 64, 8
    gs = GossipSub(
        n_peers=n, n_slots=16, conn_degree=8, msg_window=16,
        heartbeat_steps=4, score_params=params, device=device,
    )
    st = gs.init(seed=5)
    st, report, att = sybil_colocation_attack(gs, st, k, n_steps=24)
    captured = int(report["attacker_mesh_edges"][-1])
    honest = ~att & st.alive
    honest_edges = int((st.mesh & st.nbr_valid & honest[:, None]).sum())
    frac = captured / max(honest_edges, 1)
    if frac > 2.5 * k / n:
        violations.append(
            f"mesh_capture: {k} sybils hold {frac:.3f} of honest mesh "
            f"edges (bound {2.5 * k / n:.3f})"
        )
    floor = float(report["honest_score_min"][-1])
    if not np.isfinite(floor) or floor < -2.0 \
            or floor <= params.graylist_threshold / 2 \
            or floor <= params.publish_threshold / 2:
        violations.append(
            f"honest_floor: honest score floor {floor:.3f} breaches the "
            "collateral bound under sybil colocation"
        )


def check_invariants(
    defense: Dict[str, float], deep: bool = False, device="cuda",
) -> Tuple[bool, List[str]]:
    """Gate a defense candidate against the formal-model invariants.

    Returns ``(ok, violations)``.  The shallow gate (construction +
    P4/P6/P7 ops sweeps) is cheap enough to run on every candidate; the
    deep gate adds the 64-peer sybil rollout (bounded mesh capture +
    honest-score floor) and is meant for candidates that survived the
    shallow gate and are about to be graded.  Never raises for a bad
    candidate — rejection is data, recorded in the audit trail.  The deep
    gate's rollout runs on ``device`` (the card by default).
    """
    violations: List[str] = []
    try:
        _score_params(defense)
    except (TypeError, ValueError) as e:
        return False, [f"params: {str(e).splitlines()[0][:100]}"]
    _check_p4(defense, violations)
    _check_p7(defense, violations)
    _check_p6(defense, violations)
    if deep and not violations:
        _check_capture_and_floor(defense, violations, device)
    return (not violations), violations
