"""The serving bench's workloads and the committed 100k-peer stream trace.

The configuration is the reference's serving bench
(``bench.py:streaming_child_main`` with ``STREAMING_SCALE``): 2 topics, a
128-message window, a heartbeat every 4 rounds, chunks of 8 rounds x 8
publish lanes, a 128-item ring under ``block``, completion at 99% of a
topic's participants; three workloads on one engine -- ``constant`` (96
messages, 8 a chunk, alternating topics, the first 4 forged), ``burst``
(64 on topic 0 at once) and ``hot`` (64 from peer 3 on topic 1).  The peer
count is the bench's ``BENCH_STREAMING_PEERS`` knob, raised to 100,000,
and the topology takes the closed loop's 32 slots and degree 16.

``workloads`` reproduces the bench's draws (publishers, then one signing
seed a message) from its generator.  ``replay`` runs them through an
engine with fixed verdicts (the forged messages pushed as invalid) under
a stepping clock, and records for every chunk the device step, the
digest's delivered counts, the (topic, slot) pairs it completed and the
flight tail, then the latencies and ``delivery_stats``: the document the
JAX package's engine wrote into ``traces/stream_100000.trace.json``, and
that the port's engine must reproduce exactly.  Engine-agnostic: it reads
the model's digest and stats through ``to_host``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

TRACE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "traces", "stream_100000.trace.json")
N_FORGED = 4
CONFIG = dict(n_topics=2, n_peers=100_000, n_slots=32, conn_degree=16,
              msg_window=128, heartbeat_steps=4)
ENGINE = dict(chunk_steps=8, pub_width=8, completion_frac=0.99)
CAPACITY = 128
N_CONSTANT, N_BURST, N_HOT = 96, 64, 64
CLOCK_STEP_S = 0.001

# One publish: (topic, publisher, forged, signing seed, seqno).
Item = Tuple[int, int, bool, bytes, int]


def workloads(n_peers: int, seed: int = 2) -> Dict[str, List[List[Item]]]:
    """The bench's three feeds as chunk groups, with its draw order: each
    feed draws its publishers first, then one 32-byte signing seed a
    message."""
    rng = np.random.default_rng(seed)
    p = ENGINE["pub_width"]
    seqno = 0

    def signed(msgs):
        nonlocal seqno
        out = []
        for topic, src, forged in msgs:
            out.append((topic, src, forged, rng.bytes(32), seqno))
            seqno += 1
        return out

    constant = [(i % 2, int(rng.integers(n_peers)), i < N_FORGED)
                for i in range(N_CONSTANT)]
    constant = signed(constant)
    burst = signed([(0, int(rng.integers(n_peers)), False)
                    for _ in range(N_BURST)])
    hot = signed([(1, 3, False) for _ in range(N_HOT)])
    return {
        "constant": [constant[i:i + p] for i in range(0, N_CONSTANT, p)],
        "burst": [burst],
        "hot": [hot[i:i + p] for i in range(0, N_HOT, p)],
    }


def payload(item: Item) -> bytes:
    """The message body (the bench's; a forged one tampered after
    signing)."""
    body = b"stream payload %d" % item[4]
    return body + b"!" if item[2] else body


class SteppingClock:
    """A host clock that advances ``step_s`` at every read: two engines
    that read it in the same order see the same times."""

    def __init__(self, step_s: float = CLOCK_STEP_S):
        self.t, self.step_s = 0.0, step_s

    def __call__(self) -> float:
        self.t += self.step_s
        return self.t


def _hex(x) -> str:
    return float(x).hex()


def tail_doc(tail: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A flight tail with exact floats (``float.hex``)."""
    out = {}
    for k in sorted(tail):
        a = np.asarray(tail[k])
        vals = a.reshape(-1).tolist()
        if a.dtype.kind == "f":
            vals = [_hex(v) for v in vals]
        out[k] = {"dtype": str(a.dtype), "shape": list(a.shape),
                  "data": vals}
    return out


def replay(engine, ring, model, groups: Dict[str, List[List[Item]]],
           to_host: Callable[[Any], np.ndarray]) -> Dict[str, Any]:
    """Feed ``groups`` through ``engine`` (warmed) with fixed verdicts,
    one group a chunk, then drain; returns the trace document body."""
    doc: Dict[str, Any] = {"workloads": {}}
    for name, feed in groups.items():
        chunks = []

        def run(chunk_fn):
            before = set(engine.pending)
            n0 = len(engine.publish_log)
            chunk_fn()
            new = {(p.topic, p.slot) for p in engine.publish_log[n0:]}
            digest = model.stream_digest(engine.state)
            chunks.append({
                "step": int(digest["step"]),
                "delivered": to_host(digest["delivered"]).tolist(),
                "completed": sorted([list(k) for k in
                                     (before | new) - set(engine.pending)]),
                "flight_tail": tail_doc(engine.flight_tail),
            })

        for group in feed:
            for item in group:
                if not ring.push(topic=item[0], payload=payload(item),
                                 publisher=item[1], valid=not item[2],
                                 timeout=30.0):
                    raise RuntimeError("the ring refused a trace message")
            run(engine.run_chunk)
        for _ in range(64):
            if not (ring.depth > 0 or engine.pending):
                break
            run(engine.run_chunk)
        chunks_acct = ring.accounting()
        doc["workloads"][name] = {"chunks": chunks,
                                  "silent_drops": chunks_acct["silent_drops"]}
    frac, p50, p99 = model.delivery_stats(engine.state)
    doc["latencies_s"] = [_hex(x) for x in engine.latencies_s]
    doc["invalid_published"] = [list(x) for x in engine.invalid_published]
    doc["delivery_stats"] = {
        "frac": [[_hex(v) for v in row] for row in to_host(frac)],
        "p50": [_hex(v) for v in to_host(p50)],
        "p99": [_hex(v) for v in to_host(p99)],
    }
    return doc


def mismatches(doc: Dict[str, Any], ref: Dict[str, Any]) -> List[str]:
    """Where two replay documents differ (every chunk's step, delivered
    counts, completions and flight tail; the latencies, the invalid
    publishes and the delivery stats)."""
    out = []
    for name, wl in ref["workloads"].items():
        got = doc["workloads"].get(name, {"chunks": []})["chunks"]
        if len(got) != len(wl["chunks"]):
            out.append(f"{name}: {len(got)} chunks, trace has "
                       f"{len(wl['chunks'])}")
        for i, (a, b) in enumerate(zip(got, wl["chunks"])):
            for key in b:
                if a.get(key) != b[key]:
                    out.append(f"{name} chunk {i}: {key}")
    for key in ("latencies_s", "invalid_published", "delivery_stats"):
        if doc.get(key) != ref.get(key):
            out.append(key)
    return out


def load_trace(path: str = TRACE_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def header(n_peers: int) -> Dict[str, Any]:
    """The trace's configuration block."""
    return {"trace_version": 1, "config": dict(CONFIG, n_peers=n_peers),
            "engine": dict(ENGINE), "capacity": CAPACITY, "seed": 0,
            "clock_step_s": CLOCK_STEP_S}


def port_replay(n_peers: int, device="cuda"):
    """The port's engine on ``device`` through the trace's workloads at
    ``n_peers`` -> (the document to hold against the JAX-written trace,
    the engine after the run)."""
    from ..models.multitopic import MultiTopicGossipSub
    from .engine import StreamingEngine
    from .ingest import IngestRing

    clock = SteppingClock()
    model = MultiTopicGossipSub(device=device,
                                **dict(CONFIG, n_peers=n_peers))
    ring = IngestRing(capacity=CAPACITY, policy="block", clock=clock)
    engine = StreamingEngine(model, ring, seed=0, clock=clock, **ENGINE)
    engine.warmup()
    body = replay(engine, ring, model, workloads(n_peers),
                  lambda t: t.cpu().numpy())
    return dict(header(n_peers), **body), engine
