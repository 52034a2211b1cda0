"""Observability plane of the port (copies of the JAX package's host-side
modules, pinned to their originals by the tests):

- :mod:`.spans` -- the sampled per-message span ledger keyed on the
  ``content_hash`` identity, with its Chrome-trace and OTLP exports;
  spans ride the engine's checkpoint, so a crash is an annotated gap;
- :mod:`.blackbox` -- the bounded ring of per-chunk telemetry frames the
  watchdog dumps to a post-mortem JSON on ``restart_engine``;
- :mod:`.export` -- the ``--trace-out`` artifact builders;
- :mod:`.merge` -- the cross-host collector: per-host live ledgers
  (``obs-span-host/1``) fold into one ``obs-span-merged/1`` artifact of
  end-to-end publish-to-delivery traces, propagation quantiles, the
  per-hop breakdown and failover windows as annotated gaps;
- :mod:`.server` -- the ``/metrics`` (Prometheus) and ``/debug`` HTTP
  endpoint over one ``MetricsRegistry``.
"""

from .blackbox import BlackBox
from .export import build_record_artifact, build_span_artifact, write_json
from .merge import (
    build_host_span_artifact,
    merge_host_artifacts,
    propagation_latencies,
)
from .server import ObsHTTPServer
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
    "ObsHTTPServer",
    "STAGES",
    "SpanLedger",
    "build_host_span_artifact",
    "build_record_artifact",
    "build_span_artifact",
    "content_hash",
    "envelope_span_key",
    "live_span_key",
    "merge_host_artifacts",
    "propagation_latencies",
    "write_json",
]
