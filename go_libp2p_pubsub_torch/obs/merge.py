"""Cross-host span merge: per-host ledgers → end-to-end per-message traces.

r18 gave each host a :class:`~.spans.SpanLedger`; r19 makes it distributed
(``net/live.py`` stamps hop spans on every traced frame's path).  This
module is the collector side: each host exports its ledger as an
``obs-span-host/1`` artifact, and :func:`merge_host_artifacts` folds any
number of them into ONE ``obs-span-merged/1`` artifact holding an
end-to-end trace per message — the origin's ``publish`` stamp through every
subscriber's ``deliver`` stamp — with per-message propagation quantiles,
a per-hop breakdown, and failover/park windows rendered as annotated gaps
spanning the hosts that observed them.

Clock model: span timestamps are each host's injected clock (monotonic by
default), NOT comparable across real machines.  Every host artifact carries
a ``clock_offset_s`` estimate (host clock minus the deployment's reference
clock) and the merge subtracts it before comparing timestamps; traced wire
frames additionally carry the ORIGIN's estimate so a receiver records it on
the recv stamp (``origin_offset``) even when the origin's artifact never
reaches the collector.  In-process test networks share one clock, so
offsets default to 0.0 and the subtraction is exact.

The merge is deterministic in the input *set*: artifacts are keyed and
sorted by host id, spans by content key, stamps by time — shuffling the
input list yields a byte-identical artifact (a test pins this).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..utils.metrics import quantiles

# Stage vocabulary (write side: net/live.py; see spans.HOP_STAGES).
_PUBLISH = "publish"
_SEND = "send"
_RECV = "recv"
_DELIVER = "deliver"
_REPLAY_SEND = "replay_send"

# Event names that open / close a failover window (write side: the live
# subscription's failover walk).  "parent_lost" marks when a host first
# observed the old regime die; any of the _HEAL names marks the moment a
# live regime claimed it back.
_LOST_EVENTS = ("parent_lost",)
_PARK_EVENTS = ("failover_parked",)
_HEAL_EVENTS = ("promoted", "failover_merged")


def build_host_span_artifact(
    host: str,
    ledger,
    clock_offset_s: float = 0.0,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One live host's ledger as a self-contained, merge-ready artifact."""
    snap = ledger.snapshot()
    doc: Dict[str, Any] = {
        "format": "obs-span-host/1",
        "host": host,
        "clock_offset_s": float(clock_offset_s),
        "sample_n": snap["sample_n"],
        "spans": snap["spans"],
        "events": snap["events"],
        "dropped_spans": snap["dropped_spans"],
        "duplicate_closes": snap["duplicate_closes"],
        "summary": ledger.summary(),
    }
    if extra:
        doc.update(extra)
    return doc


def merge_host_artifacts(
    artifacts: List[Dict[str, Any]],
    scenario: Optional[str] = None,
    verdict: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Fold per-host ``obs-span-host/1`` artifacts into one
    ``obs-span-merged/1`` document (see module docstring)."""
    if not artifacts:
        raise ValueError("merge needs at least one host artifact")
    by_host: Dict[str, Dict[str, Any]] = {}
    for doc in artifacts:
        if doc.get("format") != "obs-span-host/1":
            raise ValueError(
                f"not an obs-span-host/1 artifact: {doc.get('format')!r}"
            )
        host = str(doc["host"])
        if host in by_host:
            raise ValueError(f"duplicate host artifact: {host!r}")
        by_host[host] = doc
    hosts = sorted(by_host)
    sample_ns = {int(by_host[h]["sample_n"]) for h in hosts}
    if len(sample_ns) != 1:
        # Hosts sampling at different rates would silently disagree on
        # which messages have cross-host traces — refuse to merge.
        raise ValueError(
            f"host artifacts disagree on sample_n: {sorted(sample_ns)}"
        )
    sample_n = sample_ns.pop()

    # -- normalize: every stamp/event onto the reference clock --------------
    # hops[key] = list of {host, stage, t, ...attrs}; events = global list.
    hops: Dict[str, List[dict]] = {}
    events: List[dict] = []
    for h in hosts:
        doc = by_host[h]
        off = float(doc.get("clock_offset_s", 0.0))
        for span in doc["spans"]:
            key = span["key"]
            for rec in span["stamps"]:
                hop = {k: v for k, v in rec.items() if k != "t"}
                hop["host"] = h
                hop["t"] = float(rec["t"]) - off
                hops.setdefault(key, []).append(hop)
            for ev in span.get("events", []):
                rec2 = {k: v for k, v in ev.items() if k != "t"}
                rec2["host"] = h
                rec2["t"] = float(ev["t"]) - off
                rec2["span"] = key
                events.append(rec2)
        for ev in doc["events"]:
            rec2 = {k: v for k, v in ev.items() if k != "t"}
            rec2["host"] = h
            rec2["t"] = float(ev["t"]) - off
            events.append(rec2)
    events.sort(key=lambda e: (e["t"], e["host"], e["name"]))

    # -- per-message end-to-end traces --------------------------------------
    traces: List[dict] = []
    all_latencies: List[float] = []
    per_hop: Dict[str, List[float]] = {}
    for key in sorted(hops):
        recs = sorted(hops[key],
                      key=lambda r: (r["t"], r["host"], r["stage"]))
        pubs = [r for r in recs if r["stage"] == _PUBLISH]
        delivers = [r for r in recs if r["stage"] == _DELIVER]
        t_pub = pubs[0]["t"] if pubs else None
        deliveries = []
        for d in delivers:
            row = {"host": d["host"], "t": d["t"]}
            if t_pub is not None:
                row["latency_s"] = d["t"] - t_pub
                all_latencies.append(row["latency_s"])
            deliveries.append(row)
        lat = [d["latency_s"] for d in deliveries if "latency_s" in d]
        trace: Dict[str, Any] = {
            "key": key,
            "hosts": sorted({r["host"] for r in recs}),
            "publish": (
                {"host": pubs[0]["host"], "t": t_pub} if pubs else None
            ),
            "deliveries": deliveries,
            "hops": recs,
        }
        if lat:
            q = quantiles(lat, (0.5, 0.99))
            trace["propagation"] = {
                "n": len(lat), "p50_s": q["p50"], "p99_s": q["p99"],
                "max_s": max(lat),
            }
        traces.append(trace)
        _accumulate_hop_breakdown(recs, per_hop)

    q_all = quantiles(all_latencies, (0.5, 0.99))
    propagation = {
        "sample_n": sample_n,
        "messages": sum(1 for t in traces if t["publish"] is not None),
        "deliveries": len(all_latencies),
        "p50_s": q_all["p50"],
        "p99_s": q_all["p99"],
        "max_s": max(all_latencies) if all_latencies else float("nan"),
        "per_hop": {
            name: {"count": len(xs), **quantiles(xs, (0.5, 0.99))}
            for name, xs in sorted(per_hop.items())
        },
    }

    gap = _recovery_gap(events)
    doc = {
        "format": "obs-span-merged/1",
        "plane": "live",
        "scenario": scenario,
        "verdict": verdict,
        "hosts": hosts,
        "sample_n": sample_n,
        "clock_offsets_s": {
            h: float(by_host[h].get("clock_offset_s", 0.0)) for h in hosts
        },
        "dropped_spans": sum(
            int(by_host[h].get("dropped_spans", 0)) for h in hosts),
        "traces": traces,
        "events": events,
        "propagation": propagation,
        "recovery_gap": gap,
        "chrome_trace": _merged_chrome_trace(hosts, traces, events, gap),
        "otlp": _merged_otlp(hosts, traces),
    }
    if extra:
        doc.update(extra)
    return doc


def propagation_latencies(merged: Dict[str, Any]) -> List[Tuple[str, str, float]]:
    """Flatten a merged artifact back to ``(key, host, latency_s)`` rows —
    what the live runner feeds the SLO's latency histogram."""
    out: List[Tuple[str, str, float]] = []
    for tr in merged["traces"]:
        for d in tr["deliveries"]:
            if "latency_s" in d:
                out.append((tr["key"], d["host"], d["latency_s"]))
    return out


def _accumulate_hop_breakdown(
    recs: List[dict], per_hop: Dict[str, List[float]]
) -> None:
    """Per-hop latency components for one trace.

    - ``publish->send``: the origin's local fan-out cost;
    - ``send->recv``:    one tree edge (wire + chaos), paired exactly: each
      recv stamp carries ``from`` (the sender id) and each host sends a
      given key once, so the edge is (sender's send stamp) → (this recv);
    - ``recv->send``:    relay turnaround on an interior host;
    - ``recv->deliver``: local delivery on the receiving host.
    Replayed copies (``replay_send`` and recvs flagged ``replay``) are
    excluded — a repair's second copy is not a propagation hop.
    """
    first_send: Dict[str, dict] = {}
    by_host: Dict[str, List[dict]] = {}
    for r in recs:
        by_host.setdefault(r["host"], []).append(r)
        if r["stage"] == _SEND and r["host"] not in first_send:
            first_send[r["host"]] = r
    for r in recs:
        if r["stage"] == _RECV and not r.get("replay"):
            sender = r.get("from")
            s = first_send.get(sender)
            if s is not None and s["t"] <= r["t"]:
                per_hop.setdefault("send->recv", []).append(r["t"] - s["t"])
    for host, rows in by_host.items():
        stages: Dict[str, dict] = {}  # first stamp of each stage on host
        for r in rows:
            stages.setdefault(r["stage"], r)
        pub, snd = stages.get(_PUBLISH), stages.get(_SEND)
        rcv, dlv = stages.get(_RECV), stages.get(_DELIVER)
        if pub is not None and snd is not None and snd["t"] >= pub["t"]:
            per_hop.setdefault("publish->send", []).append(
                snd["t"] - pub["t"])
        if rcv is not None and not rcv.get("replay"):
            if snd is not None and snd["t"] >= rcv["t"]:
                per_hop.setdefault("recv->send", []).append(
                    snd["t"] - rcv["t"])
            if dlv is not None and dlv["t"] >= rcv["t"]:
                per_hop.setdefault("recv->deliver", []).append(
                    dlv["t"] - rcv["t"])


def _recovery_gap(events: List[dict]) -> Optional[dict]:
    """The failover window across the hosts that observed it.

    A promotion regime (root kill): first ``parent_lost`` → first
    ``promoted``.  A park/merge regime (partition minority): first
    ``failover_parked`` → last heal-class event.  ``None`` when no heal
    ever happened (nothing to annotate)."""
    lost = [e for e in events if e["name"] in _LOST_EVENTS]
    parked = [e for e in events if e["name"] in _PARK_EVENTS]
    heals = [e for e in events if e["name"] in _HEAL_EVENTS]
    if not heals:
        return None
    promoted = [e for e in heals if e["name"] == "promoted"]
    if promoted and lost:
        start = min(e["t"] for e in lost)
        end = min(e["t"] for e in promoted)
        kind = "promotion"
        observers = lost + promoted
    elif parked:
        start = min(e["t"] for e in parked)
        end = max(e["t"] for e in heals)
        kind = "park_merge"
        observers = parked + heals
    else:
        return None
    return {
        "kind": kind,
        "start_s": start,
        "end_s": end,
        "gap_s": max(0.0, end - start),
        "hosts": sorted({e["host"] for e in observers}),
    }


def _merged_chrome_trace(
    hosts: List[str],
    traces: List[dict],
    events: List[dict],
    gap: Optional[dict],
) -> dict:
    """Chrome trace-event JSON: ONE track (tid) per host, pid 0; each
    message renders as an X segment on every host it touched (that host's
    first → last stamp), ledger events as instants on their host's track,
    and the failover window as an annotated gap on track 0."""
    tid_of = {h: i + 1 for i, h in enumerate(hosts)}
    out: List[dict] = [{
        "name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": "cluster"},
    }]
    for h in hosts:
        out.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid_of[h],
            "args": {"name": f"host {h}"},
        })
    for tr in traces:
        by_host: Dict[str, List[dict]] = {}
        for r in tr["hops"]:
            by_host.setdefault(r["host"], []).append(r)
        for h in sorted(by_host):
            rows = by_host[h]
            t0, t1 = rows[0]["t"], rows[-1]["t"]
            out.append({
                "name": f"msg {tr['key'][:12]}", "cat": "message",
                "ph": "X", "ts": round(t0 * 1e6, 3),
                "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                "pid": 0, "tid": tid_of[h],
                "args": {
                    "key": tr["key"],
                    "stages": [r["stage"] for r in rows],
                },
            })
    for e in events:
        out.append({
            "name": e["name"], "cat": "ledger", "ph": "i",
            "ts": round(e["t"] * 1e6, 3), "pid": 0,
            "tid": tid_of.get(e["host"], 0), "s": "t",
            "args": {k: v for k, v in e.items()
                     if k not in ("name", "t", "host")},
        })
    if gap is not None:
        out.append({
            "name": "failover_gap", "cat": "annotation", "ph": "X",
            "ts": round(gap["start_s"] * 1e6, 3),
            "dur": round(gap["gap_s"] * 1e6, 3),
            "pid": 0, "tid": 0,
            "args": {"kind": gap["kind"], "gap_s": gap["gap_s"],
                     "hosts": gap["hosts"]},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _merged_otlp(
    hosts: List[str],
    traces: List[dict],
    service_name: str = "go_libp2p_pubsub_tpu.live",
) -> dict:
    """OTLP-shaped record: one resource per host; each message becomes one
    span per host it touched, all sharing the content-derived traceId so a
    backend reassembles the cross-host trace."""
    from .spans import _otlp_attr

    resource_spans = []
    for i, h in enumerate(hosts):
        spans_out = []
        for tr in traces:
            rows = [r for r in tr["hops"] if r["host"] == h]
            if not rows:
                continue
            t0, t1 = rows[0]["t"], rows[-1]["t"]
            spans_out.append({
                "traceId": (tr["key"] * 2)[:32],
                "spanId": f"{i:04x}{tr['key'][:12]}",
                "name": "message",
                "kind": 1,
                "startTimeUnixNano": str(int(t0 * 1e9)),
                "endTimeUnixNano": str(int(t1 * 1e9)),
                "attributes": [_otlp_attr("host.id", h)],
                "events": [
                    {
                        "timeUnixNano": str(int(r["t"] * 1e9)),
                        "name": r["stage"],
                        "attributes": [
                            _otlp_attr(k, v) for k, v in r.items()
                            if k not in ("stage", "t", "host")
                        ],
                    }
                    for r in rows
                ],
            })
        resource_spans.append({
            "resource": {
                "attributes": [
                    _otlp_attr("service.name", service_name),
                    _otlp_attr("host.id", h),
                    _otlp_attr("clock", "reference-normalized"),
                ],
            },
            "scopeSpans": [{
                "scope": {"name": "go_libp2p_pubsub_tpu.obs.merge"},
                "spans": spans_out,
            }],
        })
    return {"resourceSpans": resource_spans}
