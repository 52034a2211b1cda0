"""Summarize a ``--trace-out`` observability artifact.

Usage (``V = python -m go_libp2p_pubsub_torch.tools.trace_view``)::

    V trace.json
    V trace.json --json                   # machine-readable
    V crash.postmortem.json               # black-box dump
    V --merge trace.spans/                # merge per-host ledgers

Switches on the artifact's ``format`` key:

- ``obs-span-artifact/1``  — streaming-plane span ledger: span counts,
  stage-transition latency quantiles, events (watchdog tiers, restarts,
  crash-recovery gaps), verdict, and the embedded latency comparison;
- ``obs-record-trace/1``   — sim/live flight-record trace: per-channel
  stats + verdict;
- ``obs-blackbox/1``       — watchdog post-mortem: the last-K per-chunk
  frames leading up to an engine restart;
- ``obs-span-merged/1``    — r19 cross-host merge: end-to-end per-message
  traces, propagation quantiles, per-hop breakdown, failover gap;
- ``obs-span-host/1``      — one live host's ledger (input to the merge).

``--merge DIR`` re-merges the ``host-*.json`` per-host artifacts a traced
live run dropped in its ``<trace>.spans/`` directory and summarizes the
result — byte-identical to the ``merged.json`` the runner wrote (the merge
is deterministic), useful when hosts were scraped separately.

The artifact itself is self-contained — its ``chrome_trace`` member loads
directly in ``chrome://tracing`` / Perfetto; this tool is the terminal
view.  Exit 2 on an unreadable file or unknown format (infrastructure
error, distinct from anything the run itself did).  It reads files only
and runs nothing on a device, so it has no ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List

from ..obs.merge import merge_host_artifacts


def _fmt_s(v: Any) -> str:
    try:
        return f"{float(v) * 1e3:.3f}ms"
    except (TypeError, ValueError):
        return str(v)


def _decision_rows(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Chronological ``controller_decision`` ledger events (r20): the
    self-tuning controller stamps one per knob change, carrying the
    triggering evidence as ``ev_*`` keys — this is the audit trail that
    makes a verdict flip attributable to a measurement."""
    rows = []
    for ev in doc.get("events", []):
        if ev.get("name") != "controller_decision":
            continue
        rows.append({
            "t": ev.get("t"),
            "knob": ev.get("knob"),
            "old": ev.get("old"),
            "new": ev.get("new"),
            "reason": ev.get("reason"),
            "evidence": {k[3:]: v for k, v in ev.items()
                         if k.startswith("ev_")},
        })
    rows.sort(key=lambda r: (r["t"] is None, r["t"]))
    return rows


def _span_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    s = doc.get("summary", {})
    gaps: List[float] = []
    for span in doc.get("spans", []):
        for ev in span.get("events", []):
            if ev.get("name") == "crash_recovery" and "gap_s" in ev:
                gaps.append(float(ev["gap_s"]))
    out = {
        "format": doc["format"],
        "plane": doc.get("plane"),
        "scenario": doc.get("scenario"),
        "passed": doc.get("verdict", {}).get("passed"),
        "sample_n": s.get("sample_n"),
        "spans": s.get("spans"),
        "open": s.get("open"),
        "closed": s.get("closed"),
        "dropped_spans": s.get("dropped_spans"),
        "duplicate_closes": s.get("duplicate_closes"),
        "transitions": s.get("transitions", {}),
        "events": s.get("events", {}),
        "spans_with_recovery_gap": len(gaps),
        "max_recovery_gap_s": max(gaps) if gaps else None,
        "controller_decisions": _decision_rows(doc),
        "chrome_events": len(
            doc.get("chrome_trace", {}).get("traceEvents", [])),
    }
    for key in ("recovery_s", "recovery_gap_s", "chunk_wall_s", "latency",
                "controller"):
        if key in doc:
            out[key] = doc[key]
    return out


def _print_span(out: Dict[str, Any]) -> None:
    print(f"span artifact  {out['scenario']}  plane={out['plane']}  "
          f"{'PASS' if out['passed'] else 'FAIL'}")
    print(f"  spans: {out['spans']} (open {out['open']}, closed "
          f"{out['closed']}, dropped {out['dropped_spans']}, dup-closes "
          f"{out['duplicate_closes']}, 1/{out['sample_n']} sampled)")
    for name in sorted(out["transitions"]):
        t = out["transitions"][name]
        print(f"  {name:34s} n={t['count']:<5d} p50={_fmt_s(t['p50'])} "
              f"p99={_fmt_s(t['p99'])}")
    if out["events"]:
        evs = ", ".join(f"{k}x{v}" for k, v in sorted(out["events"].items()))
        print(f"  events: {evs}")
    if out["spans_with_recovery_gap"]:
        print(f"  crash-recovery gap on {out['spans_with_recovery_gap']} "
              f"spans (max {_fmt_s(out['max_recovery_gap_s'])}; runner "
              f"recovery_s {_fmt_s(out.get('recovery_s'))})")
    lat = out.get("latency")
    if isinstance(lat, dict):
        for mode in ("chunk", "exact"):
            q = lat.get(mode)
            if q:
                qs = "  ".join(f"{k}={_fmt_s(v)}" for k, v in sorted(
                    q.items()))
                print(f"  latency[{mode}]: {qs}")
    decisions = out.get("controller_decisions") or []
    if decisions:
        print(f"  controller decisions: {len(decisions)}")
        for d in decisions:
            # Show the two or three evidence values a reader needs to
            # check the decision against its policy threshold, not the
            # whole evidence dict.
            ev = d["evidence"]
            keys = [k for k in ("depth", "carry",
                                "avg_snapshot_s", "chunk_wall_s",
                                "verify_batch", "block_waits")
                    if k in ev][:3]
            ev_s = " ".join(
                f"{k}={ev[k]:.4g}" if isinstance(ev[k], float)
                else f"{k}={ev[k]}" for k in keys)
            print(f"    t={_fmt_s(d['t'])} {d['knob']}: "
                  f"{d['old']} -> {d['new']}  [{d['reason']}]  {ev_s}")
    ctl = out.get("controller")
    if isinstance(ctl, dict):
        print(f"  controller A/B: tuned p99 {_fmt_s(ctl.get('tuned_p99_s'))}"
              f" vs best static {_fmt_s(ctl.get('best_static_p99_s'))} "
              f"(ratio {ctl.get('p99_vs_best_static_ratio')})")
    print(f"  chrome_trace: {out['chrome_events']} events "
          f"(load the artifact in chrome://tracing)")


def _record_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "format": doc["format"],
        "plane": doc.get("plane"),
        "scenario": doc.get("scenario"),
        "passed": doc.get("verdict", {}).get("passed"),
        "time_axis": doc.get("time_axis"),
        "channels": doc.get("channels", {}),
        "chrome_events": len(
            doc.get("chrome_trace", {}).get("traceEvents", [])),
    }


def _print_record(out: Dict[str, Any]) -> None:
    print(f"record trace  {out['scenario']}  plane={out['plane']}  "
          f"{'PASS' if out['passed'] else 'FAIL'}  "
          f"(time axis: {out['time_axis']})")
    for name in sorted(out["channels"]):
        c = out["channels"][name]
        print(f"  {name:28s} len={c['len']:<5d} min={c['min']:.4g} "
              f"mean={c['mean']:.4g} max={c['max']:.4g} last={c['last']:.4g}")
    print(f"  chrome_trace: {out['chrome_events']} counter events")


def _blackbox_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "format": doc["format"],
        "recorded": doc.get("recorded"),
        "capacity": doc.get("capacity"),
        "frames": len(doc.get("frames", [])),
        "extra": doc.get("extra"),
        "last_frame": (doc.get("frames") or [None])[-1],
    }


def _print_blackbox(doc: Dict[str, Any], out: Dict[str, Any]) -> None:
    extra = out.get("extra") or {}
    print(f"black box  frames={out['frames']}/{out['capacity']}  "
          f"recorded={out['recorded']}")
    if extra:
        print(f"  restart: tier={extra.get('tier')}  "
              f"reason={extra.get('reason')}")
    for fr in doc.get("frames", [])[-8:]:
        print(f"  chunk={fr.get('chunk'):<4} step={fr.get('step'):<6} "
              f"depth={fr.get('queue_depth'):<4} "
              f"wall={_fmt_s(fr.get('chunk_wall_s'))} "
              f"completed={fr.get('completed')} shed={fr.get('shed_priority')}")


def _merged_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    prop = doc.get("propagation", {})
    return {
        "format": doc["format"],
        "scenario": doc.get("scenario"),
        "passed": (doc.get("verdict") or {}).get("passed"),
        "hosts": doc.get("hosts", []),
        "messages": prop.get("messages"),
        "deliveries": prop.get("deliveries"),
        "sample_n": prop.get("sample_n"),
        "p50_s": prop.get("p50_s"),
        "p99_s": prop.get("p99_s"),
        "max_s": prop.get("max_s"),
        "per_hop": prop.get("per_hop", {}),
        "events": len(doc.get("events", [])),
        "recovery_gap": doc.get("recovery_gap"),
        "chrome_events": len(
            doc.get("chrome_trace", {}).get("traceEvents", [])),
    }


def _print_merged(out: Dict[str, Any]) -> None:
    passed = out["passed"]
    verdict = "PASS" if passed else ("FAIL" if passed is not None else "-")
    print(f"merged trace  {out['scenario'] or '(unnamed)'}  "
          f"hosts={len(out['hosts'])}  {verdict}")
    print(f"  propagation: {out['messages']} msgs, {out['deliveries']} "
          f"deliveries (1/{out['sample_n']} sampled)  "
          f"p50={_fmt_s(out['p50_s'])} p99={_fmt_s(out['p99_s'])} "
          f"max={_fmt_s(out['max_s'])}")
    for name in sorted(out["per_hop"]):
        h = out["per_hop"][name]
        print(f"  {name:18s} n={h['count']:<6d} p50={_fmt_s(h['p50'])} "
              f"p99={_fmt_s(h['p99'])}")
    gap = out.get("recovery_gap")
    if gap:
        print(f"  failover gap [{gap['kind']}]: {_fmt_s(gap['gap_s'])} "
              f"across {len(gap['hosts'])} host(s)")
    print(f"  ledger events: {out['events']}")
    print(f"  chrome_trace: {out['chrome_events']} events "
          f"(one track per host; load in chrome://tracing)")


def _host_summary(doc: Dict[str, Any]) -> Dict[str, Any]:
    s = doc.get("summary", {})
    return {
        "format": doc["format"],
        "host": doc.get("host"),
        "clock_offset_s": doc.get("clock_offset_s"),
        "sample_n": doc.get("sample_n"),
        "spans": len(doc.get("spans", [])),
        "events": len(doc.get("events", [])),
        "transitions": s.get("transitions", {}),
    }


def _print_host(out: Dict[str, Any]) -> None:
    print(f"host ledger  {out['host']}  spans={out['spans']}  "
          f"events={out['events']}  1/{out['sample_n']} sampled  "
          f"clock_offset={out['clock_offset_s']}s")
    for name in sorted(out["transitions"]):
        t = out["transitions"][name]
        print(f"  {name:24s} n={t['count']:<6d} p50={_fmt_s(t['p50'])} "
              f"p99={_fmt_s(t['p99'])}")


def _merge_dir(path: str) -> Dict[str, Any]:
    """Re-merge the ``host-*.json`` per-host artifacts under ``path``."""
    files = sorted(glob.glob(os.path.join(path, "host-*.json")))
    if not files:
        raise OSError(f"no host-*.json artifacts under {path}")
    arts = []
    for f in files:
        with open(f) as fh:
            arts.append(json.load(fh))
    return merge_host_artifacts(arts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", nargs="?",
                    help="path to a --trace-out JSON artifact")
    ap.add_argument("--merge", metavar="DIR",
                    help="merge per-host obs-span-host/1 artifacts "
                         "(host-*.json) from DIR and summarize the result")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    args = ap.parse_args(argv)
    if (args.artifact is None) == (args.merge is None):
        ap.error("give exactly one of: an artifact path, or --merge DIR")

    if args.merge is not None:
        try:
            doc = _merge_dir(args.merge)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot merge {args.merge}: {e}", file=sys.stderr)
            return 2
    else:
        try:
            with open(args.artifact) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read {args.artifact}: {e}", file=sys.stderr)
            return 2
    fmt = doc.get("format") if isinstance(doc, dict) else None

    if fmt == "obs-span-artifact/1":
        out = _span_summary(doc)
        print(json.dumps(out, indent=1, sort_keys=True)) if args.json \
            else _print_span(out)
    elif fmt == "obs-record-trace/1":
        out = _record_summary(doc)
        print(json.dumps(out, indent=1, sort_keys=True)) if args.json \
            else _print_record(out)
    elif fmt == "obs-blackbox/1":
        out = _blackbox_summary(doc)
        print(json.dumps(out, indent=1, sort_keys=True)) if args.json \
            else _print_blackbox(doc, out)
    elif fmt == "obs-span-merged/1":
        out = _merged_summary(doc)
        print(json.dumps(out, indent=1, sort_keys=True)) if args.json \
            else _print_merged(out)
    elif fmt == "obs-span-host/1":
        out = _host_summary(doc)
        print(json.dumps(out, indent=1, sort_keys=True)) if args.json \
            else _print_host(out)
    else:
        print(f"error: unknown artifact format {fmt!r} "
              f"(expected obs-span-artifact/1, obs-record-trace/1, "
              f"obs-blackbox/1, obs-span-merged/1, or obs-span-host/1)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
