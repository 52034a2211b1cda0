"""Streaming serving plane of the port: a resident chunked rollout fed by
a host ingest ring.

- :mod:`.ingest` -- the bounded ring with its three backpressure policies
  and conservation ledger (a copy of the JAX package's);
- :mod:`.tuning` -- chunk geometries and the controller's policy data (a
  copy);
- :mod:`.engine` -- :class:`StreamingEngine` over the multi-topic model,
  with crash-safe snapshot/restore in the reference's file format.

The watchdog and the controller of the JAX package are not ported yet.
"""

from .engine import PendingMessage, StreamingEngine, content_hash
from .ingest import BACKPRESSURE_POLICIES, IngestItem, IngestRing
from .tuning import ChunkGeometry, ControllerPolicy, Decision, KnobState

__all__ = [
    "BACKPRESSURE_POLICIES",
    "ChunkGeometry",
    "ControllerPolicy",
    "Decision",
    "IngestItem",
    "IngestRing",
    "KnobState",
    "PendingMessage",
    "StreamingEngine",
    "content_hash",
]
