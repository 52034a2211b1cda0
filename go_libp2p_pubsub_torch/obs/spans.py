"""Sampled per-message span ledger keyed on the ``content_hash`` identity.

A span is one message's host-clock lifecycle through the serving plane:

    verify_submit → verify_verdict → ring_accept → chunk_dispatch →
    device_delivery

(the crypto stage fronts the ring in the streaming plane, so submit/verdict
precede ring-accept; the exporters sort by timestamp, not by stage name).
Stages are *stamps* — (stage, host time, attrs) appended to the span — so a
retry or resubmission shows up as a repeated stamp instead of corrupting
state.  ``close`` is once-only: the second close of the same content is
counted (``duplicate_closes``) and ignored, mirroring the engine's
exactly-once delivery contract.

Sampling is deterministic on the key itself (``int(key[:8], 16) %
sample_n``), so every plane — ring, pipeline, engine, and a post-crash
incarnation replaying the same content — independently agrees on which
messages are sampled with no shared state.

The ledger is JSON-safe end to end: ``snapshot()``/``restore_snapshot()``
ride the engine checkpoint meta, so in-flight spans survive a crash and the
restore path annotates them with the measured recovery gap.  Exports:
Chrome trace-event JSON (the same ``{"traceEvents": ..., "displayTimeUnit":
"ms"}`` envelope as ``utils.trace.StepTimer.export_chrome_trace``) and an
OTLP-shaped ``resourceSpans`` record.  Timestamps are the injected host
clock (monotonic by default), NOT unix epoch — documented in the OTLP
resource attributes.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional

STAGES = (
    "ring_accept",
    "verify_submit",
    "verify_verdict",
    "chunk_dispatch",
    "device_delivery",
)

# Live-plane hop stages (r19, net/live.py): one message's path across
# hosts.  "publish" lands on the origin; "send"/"replay_send" on every
# fanning-out interior node; "recv"/"deliver" on every subscriber.  The
# ledger accepts any stage string — this tuple is the vocabulary the
# cross-host merge (obs/merge.py) orders hops by.
HOP_STAGES = ("publish", "send", "recv", "deliver", "replay_send")


def content_hash(topic: int, publisher: int, payload: bytes) -> str:
    """Stable identity of a publish for exactly-once dedup (hex).  Keyed on
    content, not ring seq — a resubmitted message gets a fresh seq but the
    same hash.  (Canonical definition; ``serve.engine`` re-exports it.)"""
    h = hashlib.sha256()
    h.update(int(topic).to_bytes(4, "little"))
    h.update(int(publisher).to_bytes(8, "little"))
    h.update(payload)
    return h.hexdigest()[:32]


def live_span_key(topic: str, payload: bytes) -> str:
    """Span identity of a live-plane Data frame (hex, 32 chars — the same
    shape as :func:`content_hash` so the deterministic hash-mod sampling
    applies unchanged).  Keyed on (topic, wire payload): every host on the
    frame's path computes the same key from the frame alone, so per-host
    ledgers agree on identity AND sampling with no coordination.  The wire
    payload (post-envelope on the signed plane) is hashed, not the
    application bytes — receivers never need to unwrap to key a frame."""
    h = hashlib.sha256()
    topic_b = topic.encode()
    h.update(len(topic_b).to_bytes(4, "little"))
    h.update(topic_b)
    h.update(payload)
    return h.hexdigest()[:32]


def envelope_span_key(payload: bytes, ctx: object) -> Optional[str]:
    """Span key for a pipeline envelope.  The streaming plane's routing
    ``ctx`` is ``(topic, src)``, which together with the payload is exactly
    the engine's content identity; any other ctx shape has no span."""
    if isinstance(ctx, (tuple, list)) and len(ctx) == 2:
        try:
            return content_hash(int(ctx[0]), int(ctx[1]), payload)
        except (TypeError, ValueError):
            return None
    return None


class SpanLedger:
    """Bounded, deterministic-sampled span store with global events.

    ``sample_n=1`` traces every message; ``sample_n=k`` traces the
    deterministic 1/k subset.  ``max_spans`` bounds memory — past it, new
    spans are counted under ``dropped_spans`` instead of created (stamps on
    EXISTING spans always land).
    """

    def __init__(
        self,
        sample_n: int = 1,
        clock=time.monotonic,
        max_spans: int = 65536,
    ) -> None:
        if sample_n < 1:
            raise ValueError("sample_n must be >= 1")
        if max_spans < 1:
            raise ValueError("max_spans must be >= 1")
        self.sample_n = int(sample_n)
        self.max_spans = int(max_spans)
        self._clock = clock
        self._spans: Dict[str, dict] = {}   # insertion-ordered
        self._events: List[dict] = []
        self.dropped_spans = 0
        self.duplicate_closes = 0

    # -- sampling -----------------------------------------------------------

    def sampled(self, key: str) -> bool:
        """Deterministic sampling verdict for a content-hash key; every
        stage (and every post-crash incarnation) computes the same answer
        from the key alone."""
        if self.sample_n == 1:
            return True
        try:
            return int(key[:8], 16) % self.sample_n == 0
        except (TypeError, ValueError):
            return False

    # -- write side ---------------------------------------------------------

    def stamp(self, key: str, stage: str, t: Optional[float] = None,
              **attrs: Any) -> bool:
        """Append one lifecycle stamp to ``key``'s span.  Returns True iff
        the stamp landed (sampled, span not closed, ledger not full)."""
        if not self.sampled(key):
            return False
        span = self._spans.get(key)
        if span is None:
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
                return False
            span = {"key": key, "stamps": [], "events": [],
                    "closed": False, "t_close": None, "attrs": {}}
            self._spans[key] = span
        elif span["closed"]:
            return False
        rec = {"stage": stage, "t": float(t if t is not None
                                          else self._clock())}
        if attrs:
            rec.update(_json_attrs(attrs))
        span["stamps"].append(rec)
        return True

    def close(self, key: str, t: Optional[float] = None,
              **attrs: Any) -> bool:
        """Close ``key``'s span exactly once.  A second close is counted
        under ``duplicate_closes`` and ignored; closing a key with no span
        (unsampled, or never stamped) is a no-op returning False."""
        if not self.sampled(key):
            return False
        span = self._spans.get(key)
        if span is None:
            return False
        if span["closed"]:
            self.duplicate_closes += 1
            return False
        span["closed"] = True
        span["t_close"] = float(t if t is not None else self._clock())
        if attrs:
            span["attrs"].update(_json_attrs(attrs))
        return True

    def event(self, name: str, t: Optional[float] = None,
              **attrs: Any) -> None:
        """Record a ledger-global instant event (tier transition, engine
        restart, recovery gap)."""
        rec = {"name": name, "t": float(t if t is not None
                                        else self._clock())}
        if attrs:
            rec.update(_json_attrs(attrs))
        self._events.append(rec)

    def annotate_open(self, name: str, t: Optional[float] = None,
                      **attrs: Any) -> int:
        """Attach an instant event to every OPEN span (the restore path's
        crash-gap annotation).  Returns the number of spans annotated."""
        tv = float(t if t is not None else self._clock())
        rec = {"name": name, "t": tv}
        if attrs:
            rec.update(_json_attrs(attrs))
        n = 0
        for span in self._spans.values():
            if not span["closed"]:
                span["events"].append(dict(rec))
                n += 1
        return n

    # -- read side ----------------------------------------------------------

    def spans(self) -> List[dict]:
        return [dict(s) for s in self._spans.values()]

    def get(self, key: str) -> Optional[dict]:
        s = self._spans.get(key)
        return dict(s) if s is not None else None

    def events(self) -> List[dict]:
        return list(self._events)

    @property
    def n_spans(self) -> int:
        return len(self._spans)

    @property
    def n_open(self) -> int:
        return sum(1 for s in self._spans.values() if not s["closed"])

    @property
    def n_closed(self) -> int:
        return len(self._spans) - self.n_open

    def summary(self) -> dict:
        """Host digest: span counts, per-transition latency quantiles
        (consecutive time-ordered stamps), event counts by name."""
        from ..utils.metrics import quantiles

        transitions: Dict[str, List[float]] = {}
        for span in self._spans.values():
            stamps = sorted(span["stamps"], key=lambda r: r["t"])
            for a, b in zip(stamps, stamps[1:]):
                transitions.setdefault(
                    f"{a['stage']}->{b['stage']}", []
                ).append(b["t"] - a["t"])
        ev_counts: Dict[str, int] = {}
        for e in self._events:
            ev_counts[e["name"]] = ev_counts.get(e["name"], 0) + 1
        for span in self._spans.values():
            for e in span["events"]:
                ev_counts[e["name"]] = ev_counts.get(e["name"], 0) + 1
        return {
            "sample_n": self.sample_n,
            "spans": len(self._spans),
            "open": self.n_open,
            "closed": self.n_closed,
            "dropped_spans": self.dropped_spans,
            "duplicate_closes": self.duplicate_closes,
            "transitions": {
                name: {"count": len(xs), **quantiles(xs, (0.5, 0.99))}
                for name, xs in sorted(transitions.items())
            },
            "events": ev_counts,
        }

    # -- checkpoint ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe full state (spans + events + counters) — rides the
        engine checkpoint meta so in-flight spans survive a crash."""
        return {
            "sample_n": self.sample_n,
            "spans": [dict(s) for s in self._spans.values()],
            "events": list(self._events),
            "dropped_spans": self.dropped_spans,
            "duplicate_closes": self.duplicate_closes,
        }

    def restore_snapshot(self, snap: dict) -> int:
        """Reinstate spans + events from :meth:`snapshot`, replacing current
        contents.  ``sample_n`` must match — a restored ledger that sampled
        differently would disagree with live stamping on the same keys.
        Returns the number of spans reinstated."""
        if int(snap["sample_n"]) != self.sample_n:
            raise ValueError(
                f"snapshot sample_n={snap['sample_n']} != ledger "
                f"sample_n={self.sample_n}; the deterministic sampling "
                "contract would break"
            )
        self._spans = {s["key"]: dict(s) for s in snap["spans"]}
        self._events = [dict(e) for e in snap["events"]]
        self.dropped_spans = int(snap.get("dropped_spans", 0))
        self.duplicate_closes = int(snap.get("duplicate_closes", 0))
        return len(self._spans)

    # -- exports ------------------------------------------------------------

    def export_chrome_trace(self) -> dict:
        """Chrome trace-event JSON dict (the ``StepTimer`` envelope: "X"
        complete events, µs timestamps, ``displayTimeUnit: ms``).  Each
        span gets its own tid track: one whole-span X event, one X segment
        per consecutive stamp pair, instant "i" events for span
        annotations; ledger-global events are process-scoped instants."""
        events: List[dict] = []
        for tid, span in enumerate(self._spans.values(), start=1):
            stamps = sorted(span["stamps"], key=lambda r: r["t"])
            if not stamps:
                continue
            t0 = stamps[0]["t"]
            t1 = span["t_close"] if span["t_close"] is not None \
                else stamps[-1]["t"]
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": f"msg {span['key'][:12]}"},
            })
            events.append({
                "name": "span", "cat": "message", "ph": "X",
                "ts": round(t0 * 1e6, 3),
                "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                "pid": 0, "tid": tid,
                "args": {"key": span["key"], "closed": span["closed"],
                         **span["attrs"]},
            })
            for a, b in zip(stamps, stamps[1:]):
                events.append({
                    "name": f"{a['stage']}->{b['stage']}", "cat": "stage",
                    "ph": "X", "ts": round(a["t"] * 1e6, 3),
                    "dur": round(max(0.0, b["t"] - a["t"]) * 1e6, 3),
                    "pid": 0, "tid": tid,
                    "args": {k: v for k, v in b.items()
                             if k not in ("stage", "t")},
                })
            for e in span["events"]:
                events.append({
                    "name": e["name"], "cat": "annotation", "ph": "i",
                    "ts": round(e["t"] * 1e6, 3), "pid": 0, "tid": tid,
                    "s": "t",
                    "args": {k: v for k, v in e.items()
                             if k not in ("name", "t")},
                })
        for e in self._events:
            events.append({
                "name": e["name"], "cat": "ledger", "ph": "i",
                "ts": round(e["t"] * 1e6, 3), "pid": 0, "tid": 0, "s": "g",
                "args": {k: v for k, v in e.items()
                         if k not in ("name", "t")},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_otlp(
        self, service_name: str = "go_libp2p_pubsub_tpu.serve"
    ) -> dict:
        """OTLP-shaped JSON (``resourceSpans``/``scopeSpans``/``spans``).
        Trace/span ids derive from the content hash; timestamps are the
        injected host clock scaled to nanos (monotonic, NOT unix epoch —
        flagged in the resource attributes)."""
        spans_out = []
        for span in self._spans.values():
            stamps = sorted(span["stamps"], key=lambda r: r["t"])
            if not stamps:
                continue
            t0 = stamps[0]["t"]
            t1 = span["t_close"] if span["t_close"] is not None \
                else stamps[-1]["t"]
            otlp_events = [
                {
                    "timeUnixNano": str(int(rec["t"] * 1e9)),
                    "name": rec.get("stage", rec.get("name", "event")),
                    "attributes": [
                        _otlp_attr(k, v) for k, v in rec.items()
                        if k not in ("stage", "name", "t")
                    ],
                }
                for rec in stamps + sorted(span["events"],
                                           key=lambda r: r["t"])
            ]
            spans_out.append({
                "traceId": (span["key"] * 2)[:32],
                "spanId": span["key"][:16],
                "name": "message",
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(t0 * 1e9)),
                "endTimeUnixNano": str(int(t1 * 1e9)),
                "attributes": [
                    _otlp_attr("closed", span["closed"]),
                    *(_otlp_attr(k, v) for k, v in span["attrs"].items()),
                ],
                "events": otlp_events,
            })
        return {
            "resourceSpans": [{
                "resource": {
                    "attributes": [
                        _otlp_attr("service.name", service_name),
                        _otlp_attr("clock", "host-monotonic"),
                    ],
                },
                "scopeSpans": [{
                    "scope": {"name": "go_libp2p_pubsub_tpu.obs.spans"},
                    "spans": spans_out,
                }],
            }],
        }


def _json_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce stamp/event attrs to JSON-safe scalars (numpy ints from the
    digest path are the usual offenders)."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif hasattr(v, "item"):
            out[k] = v.item()
        else:
            out[k] = str(v)
    return out


def _otlp_attr(key: str, v: Any) -> dict:
    if isinstance(v, bool):
        val = {"boolValue": v}
    elif isinstance(v, int):
        val = {"intValue": str(v)}
    elif isinstance(v, float):
        val = {"doubleValue": v}
    else:
        val = {"stringValue": str(v)}
    return {"key": key, "value": val}
