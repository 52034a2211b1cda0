"""The canon's streaming campaigns (the multitopic ones and the coded
hybrid's) under a stepping clock, and their committed trace.

``capture`` runs one campaign through a streaming runner with the
runner's ``_SkewClock`` replaced by :class:`SteppingSkewClock` (a clock
that advances ``CLOCK_STEP_S`` at every read and keeps the ``offset`` the
``clock_skew`` fault steps), and records every chunk the runner's engines
run: the chunk counter, the completed count, the (topic, slot) pairs the
chunk completed, the latencies it added and the ring's depth after it.
Two runners that read the clock in the same order then produce the same
document, apart from what the runner times with ``time.monotonic``
itself: ``recovery_s`` (graded here by its SLO only), the run's
``seconds`` and the snapshot and verify walls (not recorded).

Engine-agnostic: the runner module and its engine class are passed in, so
the JAX package's runner wrote ``traces/stream_canon.trace.json`` through
this code (a test does, outside the package), and the port's runner must
reproduce it exactly on any device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

TRACE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "traces", "stream_canon.trace.json")
CAMPAIGNS = (
    "streaming_steady",
    "streaming_burst_overload",
    "streaming_engine_crash_recovery",
    "streaming_verifier_crash",
)
# The hybrid plane's campaigns (ingress-loss windows, the eager twin, a
# crash mid-decode, the controller under loss regimes).
HYBRID_CAMPAIGNS = (
    "streaming_degraded_links",
    "streaming_rlnc_crash_recovery",
    "streaming_drifting_load",
)
CLOCK_STEP_S = 0.001
# Channels and criteria the runner times with time.monotonic.
TIMED = ("recovery_s",)
# The engine counters a run must reproduce (the walls, the trace path and
# the program count are not the run's result).
STATS = (
    "chunks_run", "published", "completed", "evicted", "valid_published",
    "rejected_pushes", "admitted_valid", "restores", "replayed",
    "replay_deduped", "duplicate_completions", "clock_anomalies",
    "snapshots_taken", "pipeline_restarts", "watchdog_restarts", "pipeline",
    "eager_completed",
)


class SteppingSkewClock:
    """The runner's skew clock with a stepping base: every read advances
    ``step_s``; ``offset`` is the ``clock_skew`` fault's lever."""

    def __init__(self, step_s: float = CLOCK_STEP_S):
        self.t, self.step_s, self.offset = 0.0, step_s, 0.0

    def __call__(self) -> float:
        self.t += self.step_s
        return self.t + self.offset


def _hex(x) -> str:
    return float(x).hex()


def _series(a) -> Dict[str, Any]:
    a = np.asarray(a)
    vals = a.reshape(-1).tolist()
    if a.dtype.kind == "f":
        vals = [_hex(v) for v in vals]
    return {"dtype": str(a.dtype), "data": vals}


def _criterion(c: Dict[str, Any]) -> Dict[str, Any]:
    out = {"name": c["name"], "kind": c["kind"],
           "threshold": _hex(c["threshold"]), "passed": bool(c["passed"])}
    if c["name"] not in TIMED:
        out["actual"] = _hex(c["actual"])
    return out


def capture(runner, engine_cls, spec, **kw) -> Tuple[Dict[str, Any], Any]:
    """Run ``spec`` through ``runner.run_streaming_scenario(spec, **kw)``
    under the stepping clock, recording every chunk of ``engine_cls``
    (the class the runner builds) -> (the campaign's document, the
    engine that ran the last chunk)."""
    chunks: List[Dict[str, Any]] = []
    last: Dict[str, Any] = {}
    run_chunk = engine_cls.run_chunk

    def recorded(eng):
        before = set(eng.pending)
        n0, l0 = len(eng.publish_log), len(eng.latencies_s)
        out = run_chunk(eng)
        new = {(p.topic, p.slot) for p in eng.publish_log[n0:]}
        chunks.append({
            "chunk": eng.chunks_run,
            "completed": eng.completed,
            "done": sorted([list(k) for k in
                            (before | new) - set(eng.pending)]),
            "latencies_s": [_hex(x) for x in eng.latencies_s[l0:]],
            "depth": eng.ring.depth,
        })
        last["engine"] = eng
        return out

    skew_clock = runner._SkewClock
    runner._SkewClock = SteppingSkewClock
    engine_cls.run_chunk = recorded
    try:
        res = runner.run_streaming_scenario(spec, **kw)
    finally:
        runner._SkewClock = skew_clock
        engine_cls.run_chunk = run_chunk
    verdict = res.verdict.to_dict()
    doc = {
        "verdict": {"passed": bool(verdict["passed"]),
                    "criteria": [_criterion(c)
                                 for c in verdict["criteria"]]},
        "record": {k: _series(v) for k, v in sorted(res.record.items())
                   if k not in TIMED},
        "accounting": {k: int(v) for k, v in sorted(res.accounting.items())},
        "engine_stats": {k: res.engine_stats[k] for k in STATS},
        "n_publishes": int(res.n_publishes),
        "chunks": chunks,
    }
    return doc, last.get("engine")


def mismatches(doc: Dict[str, Any], ref: Dict[str, Any]) -> List[str]:
    """Where two campaign documents differ, channel by channel."""
    out = [key for key in ("verdict", "accounting", "engine_stats",
                           "n_publishes") if doc.get(key) != ref.get(key)]
    for ch in sorted(set(doc["record"]) | set(ref["record"])):
        if doc["record"].get(ch) != ref["record"].get(ch):
            out.append(f"record.{ch}")
    got, want = doc["chunks"], ref["chunks"]
    if len(got) != len(want):
        out.append(f"{len(got)} chunks, trace has {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        out.extend(f"chunk {i}: {key}" for key in b if a.get(key) != b[key])
    return out


def load_trace(path: str = TRACE_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def write_trace(runner, engine_cls, build,
                path: str = TRACE_PATH) -> Dict[str, Any]:
    """Capture every campaign of ``CAMPAIGNS`` and ``HYBRID_CAMPAIGNS``
    (``build(name)`` gives the spec) through ``runner`` and write the trace
    document."""
    doc = {"trace_version": 1, "clock_step_s": CLOCK_STEP_S,
           "campaigns": {name: capture(runner, engine_cls, build(name))[0]
                         for name in CAMPAIGNS + HYBRID_CAMPAIGNS}}
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    return doc


def port_replay(device="cuda", doc: Optional[Dict[str, Any]] = None,
                names=CAMPAIGNS) -> Dict[str, List[str]]:
    """The port's runner on ``device`` through the trace's campaigns
    ``names`` (the multitopic ones by default) -> the mismatches of each
    (empty lists when it reproduces the trace)."""
    from ..serve import StreamingEngine
    from . import canon, streaming_runner

    doc = load_trace() if doc is None else doc
    return {name: mismatches(
                capture(streaming_runner, StreamingEngine, canon.build(name),
                        device=device)[0], doc["campaigns"][name])
            for name in names}
