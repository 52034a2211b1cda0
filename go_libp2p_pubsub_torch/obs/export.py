"""Trace-artifact builders for the three scenario planes (``--trace-out``).

Two artifact shapes, discriminated by their ``format`` key (what
``tools/trace_view.py`` switches on):

- ``obs-span-artifact/1``   — streaming plane: the span ledger's full
  story (spans, events, Chrome trace, OTLP record, Prometheus render,
  black-box frames) next to the SLO verdict;
- ``obs-record-trace/1``    — sim/live planes: the flight record's scalar
  series as Chrome counter ("C") tracks plus per-channel summary stats.
  The sim plane has no host wall clock per round, so its time axis is the
  step index (1 step = 1 virtual µs unless a real cadence is given).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def write_json(path: str, doc: Dict[str, Any]) -> str:
    """Atomic JSON write (write → fsync → rename), same discipline as
    ``utils.checkpoint`` — a crash mid-write never leaves a torn artifact."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True, allow_nan=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def build_span_artifact(
    plane: str,
    scenario: str,
    verdict: Dict[str, Any],
    ledger,
    registry=None,
    blackbox=None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The streaming plane's trace artifact: one file holding everything an
    operator would ask the run for after the fact."""
    snap = ledger.snapshot()
    doc: Dict[str, Any] = {
        "format": "obs-span-artifact/1",
        "plane": plane,
        "scenario": scenario,
        "verdict": verdict,
        "summary": ledger.summary(),
        "spans": snap["spans"],
        "events": snap["events"],
        "chrome_trace": ledger.export_chrome_trace(),
        "otlp": ledger.export_otlp(),
    }
    if registry is not None:
        doc["metrics_prometheus"] = registry.render_prometheus()
    if blackbox is not None:
        doc["blackbox"] = {
            "recorded": blackbox.recorded,
            "frames": blackbox.frames(),
        }
    if extra:
        doc.update(extra)
    return doc


def build_record_artifact(
    plane: str,
    scenario: str,
    verdict: Dict[str, Any],
    record: Dict[str, Any],
    time_per_step_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Sim/live trace artifact from a flight record (dict of arrays with a
    leading time axis).  Scalar series become Chrome counter tracks; the
    artifact also carries per-channel min/mean/max so ``trace_view`` can
    summarize without reparsing the trace events."""
    dt = float(time_per_step_s) if time_per_step_s else None
    events = []
    channels: Dict[str, Any] = {}
    for name in sorted(record):
        a = np.asarray(record[name])
        if a.ndim != 1 or a.size == 0:
            continue
        vals = a.astype(np.float64)
        finite = vals[np.isfinite(vals)]
        channels[name] = {
            "len": int(vals.size),
            "min": float(finite.min()) if finite.size else float("nan"),
            "mean": float(finite.mean()) if finite.size else float("nan"),
            "max": float(finite.max()) if finite.size else float("nan"),
            "last": float(vals[-1]),
        }
        for i, v in enumerate(vals):
            if not np.isfinite(v):
                continue
            # Step index as the timeline when no real cadence exists: one
            # step renders as 1 µs, honest about being virtual time.
            ts = i * dt * 1e6 if dt is not None else float(i)
            events.append({
                "name": name, "cat": "channel", "ph": "C",
                "ts": round(ts, 3), "pid": 0, "tid": 0,
                "args": {name: float(v)},
            })
    return {
        "format": "obs-record-trace/1",
        "plane": plane,
        "scenario": scenario,
        "verdict": verdict,
        "time_axis": "seconds" if dt is not None else "steps",
        "channels": channels,
        "chrome_trace": {"traceEvents": events, "displayTimeUnit": "ms"},
    }
