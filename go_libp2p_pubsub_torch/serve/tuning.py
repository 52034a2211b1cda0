"""Tuning-plane data: the controller's policy, state, and decision record.

The serving plane's knobs split into two classes.  *Runtime* knobs swap
without touching the compiled program — backpressure policy, shed
watermarks, snapshot cadence, verify batch grouping — and the controller
moves them through the existing ``set_*`` controls.  The one knob that
recompiles is the chunk *geometry* (``chunk_steps`` scan rows x
``pub_width`` publish slots): for that the engine pre-warms a small, fixed
ladder of geometries on the SAME jitted rollout, so the controller can step
along the ladder at a chunk boundary with zero unplanned recompiles
(``compile_cache_size() == ladder size`` is the contract, crash/restore
included).

Everything here is pure data, in the spec-module style: dataclasses with
loud validation, JSON-safe ``to_dict`` forms, no behavior.  The behavior
lives in :mod:`.controller`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ChunkGeometry:
    """One rung of the pre-warmed ladder: the compiled chunk's fixed event
    shape.  ``slots`` is the chunk's publish throughput (items drained per
    dispatch); ``chunk_steps`` is the device rounds one dispatch advances —
    the two axes the controller trades off (wide chunks drain bursts, long
    chunks cover delayed propagation under loss)."""

    chunk_steps: int
    pub_width: int

    def __post_init__(self) -> None:
        if self.chunk_steps < 1 or self.pub_width < 1:
            raise ValueError("chunk_steps and pub_width must be >= 1")

    @property
    def slots(self) -> int:
        return self.chunk_steps * self.pub_width

    def as_tuple(self) -> Tuple[int, int]:
        return (self.chunk_steps, self.pub_width)


@dataclass(frozen=True)
class ControllerPolicy:
    """The controller's reaction thresholds — all poll-relative, no wall
    clock, so a fake-clock test drives every branch deterministically.

    Geometry selection reads two pressure signals each poll:

    - *depth pressure*: ring depth vs the current geometry's ``slots``
      (``depth >= depth_up_frac * slots`` wants more slots);
    - *carry pressure*: the max number of chunk boundaries any pending
      message has survived (``carry >= carry_up_chunks`` means propagation
      outruns the chunk length — the loss-regime signature — and wants
      more ``chunk_steps``).

    De-escalation is hysteretic: only after ``cooldown_polls`` consecutive
    calm polls (depth below ``depth_down_frac`` of the CALM geometry's
    slots and no carry) does the controller step back to the calm rung.
    """

    # Geometry ladder triggers.
    depth_up_frac: float = 0.75
    depth_down_frac: float = 0.5
    carry_up_chunks: int = 2
    cooldown_polls: int = 2
    # Snapshot cadence: stretch when checkpoint wall dominates chunk wall,
    # tighten back toward the floor when calm.
    snapshot_every_min: int = 1
    snapshot_every_max: int = 8
    snapshot_cost_frac: float = 0.25
    # Verify batch grouping: halve the flush threshold when verify wall
    # dominates, double it back (bounded) when verify is cheap.
    flush_threshold_min: int = 64
    flush_threshold_max: int = 1 << 20
    verify_cost_frac: float = 0.5
    # Watermark composition: on a geometry switch the watchdog's shed
    # watermarks are retuned to the new drain rate — high at
    # ``watermark_high_chunks`` chunks of backlog, low at half a chunk.
    watermark_high_chunks: float = 2.0

    def __post_init__(self) -> None:
        if not (0.0 < self.depth_down_frac < self.depth_up_frac):
            raise ValueError(
                "need 0 < depth_down_frac < depth_up_frac "
                f"(got {self.depth_down_frac} / {self.depth_up_frac})"
            )
        if self.carry_up_chunks < 1:
            raise ValueError("carry_up_chunks must be >= 1")
        if self.cooldown_polls < 1:
            raise ValueError("cooldown_polls must be >= 1")
        if not (1 <= self.snapshot_every_min <= self.snapshot_every_max):
            raise ValueError(
                "need 1 <= snapshot_every_min <= snapshot_every_max"
            )
        if not (1 <= self.flush_threshold_min <= self.flush_threshold_max):
            raise ValueError(
                "need 1 <= flush_threshold_min <= flush_threshold_max"
            )
        if self.watermark_high_chunks <= 0.5:
            raise ValueError("watermark_high_chunks must be > 0.5")


@dataclass
class KnobState:
    """The single source of truth for every runtime knob the controller
    owns.  The watchdog reads ``backpressure_policy`` here on de-escalation
    (instead of the policy it memorized at construction), so a controller
    retune mid-escalation is never reverted by the tier ladder — the two
    control surfaces compose through this one record."""

    geometry_index: int = 0
    backpressure_policy: str = "block"
    snapshot_every: int = 0
    flush_threshold: int = 4096
    high_watermark: int = 0
    low_watermark: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class Decision:
    """One controller action: which knob moved, from what to what, and the
    evidence that triggered it.  Stamped verbatim into the span ledger
    (``controller_decision`` events) so a verdict flip is attributable to
    the measurement that caused it."""

    t: float
    knob: str
    old: Any
    new: Any
    reason: str
    evidence: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "t": self.t,
            "knob": self.knob,
            "old": self.old,
            "new": self.new,
            "reason": self.reason,
            "evidence": dict(self.evidence),
        }


def validate_ladder(
    ladder, base: Tuple[int, int]
) -> List[ChunkGeometry]:
    """Normalize a geometry ladder (sequence of (chunk_steps, pub_width)
    pairs or :class:`ChunkGeometry`) and require it to contain ``base`` —
    the engine's constructed geometry must be a rung, or the pre-warm
    contract (cache size == ladder size) could not hold."""
    rungs: List[ChunkGeometry] = []
    for g in ladder:
        if isinstance(g, ChunkGeometry):
            rungs.append(g)
        else:
            steps, width = g
            rungs.append(ChunkGeometry(int(steps), int(width)))
    if len(rungs) < 1:
        raise ValueError("geometry ladder must have at least one rung")
    if len({r.as_tuple() for r in rungs}) != len(rungs):
        raise ValueError("geometry ladder has duplicate rungs")
    if tuple(base) not in {r.as_tuple() for r in rungs}:
        raise ValueError(
            f"engine geometry {tuple(base)} is not on the ladder "
            f"{[r.as_tuple() for r in rungs]}"
        )
    return rungs
