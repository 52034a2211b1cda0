"""Streaming serving plane of the port: a resident chunked rollout fed by
a host ingest ring, supervised and tuned.

- :mod:`.ingest` -- the bounded ring with its three backpressure policies
  and conservation ledger (a copy of the JAX package's);
- :mod:`.tuning` -- chunk geometries and the controller's policy data (a
  copy);
- :mod:`.engine` -- :class:`StreamingEngine` over the multi-topic model,
  with crash-safe snapshot/restore in the reference's file format;
- :mod:`.watchdog` -- stall restarts through ``StreamingEngine.restore``
  and the degradation tiers normal -> shed_priority -> drop_oldest (a
  copy);
- :mod:`.controller` -- the poll-driven controller from telemetry to the
  runtime knobs over a prepared geometry ladder (a copy).
"""

from .controller import Controller
from .engine import PendingMessage, StreamingEngine, content_hash
from .ingest import BACKPRESSURE_POLICIES, IngestItem, IngestRing
from .tuning import ChunkGeometry, ControllerPolicy, Decision, KnobState
from .watchdog import TIER_NAMES, Watchdog

__all__ = [
    "BACKPRESSURE_POLICIES",
    "ChunkGeometry",
    "Controller",
    "ControllerPolicy",
    "Decision",
    "IngestItem",
    "IngestRing",
    "KnobState",
    "PendingMessage",
    "StreamingEngine",
    "TIER_NAMES",
    "Watchdog",
    "content_hash",
]
