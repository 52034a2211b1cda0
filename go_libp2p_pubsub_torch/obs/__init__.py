"""Observability plane of the port (copies of the JAX package's host-side
modules, pinned to their originals by the tests):

- :mod:`.spans` -- the sampled per-message span ledger keyed on the
  ``content_hash`` identity, with its Chrome-trace and OTLP exports;
  spans ride the engine's checkpoint, so a crash is an annotated gap;
- :mod:`.blackbox` -- the bounded ring of per-chunk telemetry frames the
  watchdog dumps to a post-mortem JSON on ``restart_engine``;
- :mod:`.export` -- the ``--trace-out`` artifact builders.

The cross-host merge and the HTTP endpoint of the JAX package are not
ported yet.
"""

from .blackbox import BlackBox
from .export import build_record_artifact, build_span_artifact, write_json
from .spans import (
    HOP_STAGES,
    STAGES,
    SpanLedger,
    content_hash,
    envelope_span_key,
    live_span_key,
)

__all__ = [
    "BlackBox",
    "HOP_STAGES",
    "STAGES",
    "SpanLedger",
    "build_record_artifact",
    "build_span_artifact",
    "content_hash",
    "envelope_span_key",
    "live_span_key",
    "write_json",
]
