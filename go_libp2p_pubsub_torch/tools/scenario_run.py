"""Run scenario campaigns and print their SLO verdicts.

Usage (``R = python -m go_libp2p_pubsub_torch.tools.scenario_run``)::

    R                                      # whole canon suite, on the card
    R steady_state churn_10pct
    R --list                               # name the canon
    R --spec my.json                       # a spec file
    R steady_state --save-trace trace.json
    R --replay trace.json                  # bit-for-bit check
    R --json                               # machine-readable
    R --plane live degraded_links churn_10pct
    R --plane streaming streaming_steady
    R --device cpu steady_state            # on the CPU

``--plane live`` runs the campaigns over real sockets: link windows become
chaos delay policies, churn becomes host kills, and the SAME SLO
thresholds grade the socket-level run (scenario.live_runner).

``--plane streaming`` replays the campaign's workloads as an OPEN stream
through the serving plane (crypto stage -> ingest ring -> resident engine,
scenario.streaming_runner) and grades the streaming SLO channels (queue
depth, exact ingest latency, zero silent drops).

Exit code 0 iff every verdict passed (and, with ``--replay``, the stored
flight record reproduced exactly) — the scenario suite is a regression
gate, not a demo.  Exit 2 means a plane failed to START
(infrastructure, not a red verdict), a missing card for ``--device cuda``
included.  The sim and streaming planes run on ``--device``; the live
plane runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

from .. import scenario
from . import device_error


def _verdict_table(results) -> str:
    rows = []
    width = max((len(r.spec.name) for r in results), default=8)
    for r in results:
        v = r.verdict
        crit = "; ".join(
            f"{c.name}={c.actual:.4g} ({'<=' if c.kind == 'max' else '>='} "
            f"{c.threshold:.4g}){'' if c.passed else ' FAIL'}"
            for c in v.criteria
        ) or "(no criteria)"
        rows.append(
            f"{'PASS' if v.passed else 'FAIL'}  "
            f"{r.spec.name:<{width}}  {r.spec.family:<10}  {crit}"
        )
    return "\n".join(rows)


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("names", nargs="*", help="canon scenario names "
                    "(default: the whole canon)")
    ap.add_argument("--list", action="store_true", help="list canon names")
    ap.add_argument("--family", metavar="FAMILY",
                    help="filter --list (and the default canon sweep) to "
                    "one spec family, e.g. gossipsub, rlnc, treecast")
    ap.add_argument("--spec", action="append", default=[],
                    help="run a ScenarioSpec JSON file (repeatable)")
    ap.add_argument("--replay", action="append", default=[],
                    help="replay a saved trace and require an exact match "
                    "(repeatable)")
    ap.add_argument("--save-trace", metavar="PATH",
                    help="write the (single) run's replayable trace here")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the (single) run's observability artifact "
                    "here: per-message spans on the streaming plane, "
                    "flight-record channel traces on sim/live; view with "
                    "go_libp2p_pubsub_torch.tools.trace_view or "
                    "chrome://tracing")
    ap.add_argument("--trace-sample", type=int, default=1, metavar="N",
                    help="streaming/live planes: trace every Nth sampled "
                    "message (deterministic on content hash; default 1 = "
                    "all).  On the live plane, --trace-out turns on "
                    "cross-host tracing at this rate: every host ledgers "
                    "the same 1/N subset, the run grades span-exact "
                    "propagation, and per-host + merged span artifacts "
                    "land in <trace-out stem>.spans/")
    ap.add_argument("--json", action="store_true",
                    help="emit verdicts as JSON instead of the table")
    ap.add_argument("--plane", choices=("sim", "live", "streaming"),
                    default=None,
                    help="execution plane: device-compiled sim (default), "
                    "real sockets under chaos, or the streaming serving "
                    "plane (ring + resident engine); with --list, filters "
                    "to canon the plane supports")
    ap.add_argument("--live-hosts", type=int, default=None, metavar="N",
                    help="live plane: number of hosts (default 16, or the "
                    "spec's live.n_hosts)")
    ap.add_argument("--live-step-ms", type=float, default=None, metavar="MS",
                    help="live plane: wall-clock milliseconds per scenario "
                    "step (default 50, or the spec's live.step_ms)")
    ap.add_argument("--device", default="cuda",
                    help="where the sim and streaming planes run (default "
                    "cuda; cpu runs them on the CPU)")
    args = ap.parse_args(argv)
    plane = args.plane or "sim"

    if args.list:
        supported = {
            "sim": scenario.sim_supported,
            "live": scenario.live_supported,
            "streaming": scenario.streaming_supported,
        }
        shown = 0
        for name, builder in scenario.CANON.items():
            s = builder()
            if args.family and s.family != args.family:
                continue
            # --plane filters the listing only when given explicitly
            # (the run-path default of sim would otherwise hide
            # live/streaming-only canon from a bare --list).
            if args.plane and not supported[args.plane](s):
                continue
            planes = [p for p, ok_fn in supported.items() if ok_fn(s)]
            # Self-tuning canons (r20) carry a controller block: the run
            # closes the telemetry→knob loop and grades the self-tuned
            # engine against its own static rungs.
            if s.streaming and "controller" in s.streaming:
                planes.append("ctl")
            print(f"{name:<26} {'+'.join(planes):<10} {s.description}")
            shown += 1
        if shown == 0:
            print("# no canon scenarios match the filter", file=sys.stderr)
        return 0

    err = (None if plane == "live" and not args.replay
           else device_error(args.device))
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2

    if args.replay:
        ok_all = True
        out = []
        for path in args.replay:
            t0 = time.time()
            result, ok, bad = scenario.replay_trace(path, device=args.device)
            ok_all &= ok and result.verdict.passed
            out.append({
                "trace": path,
                "replay_exact": ok,
                "mismatched_channels": bad,
                "verdict": result.verdict.to_dict(),
                "seconds": round(time.time() - t0, 3),
            })
            if not args.json:
                state = "EXACT" if ok else f"MISMATCH {bad}"
                print(f"{'PASS' if ok else 'FAIL'}  replay {path}: {state}")
        if args.json:
            print(json.dumps(out, indent=2))
        return 0 if ok_all else 1

    specs = []
    for path in args.spec:
        with open(path) as f:
            specs.append(scenario.ScenarioSpec.from_json(f.read()))
    specs.extend(scenario.build_all(args.names or None))
    if args.family:
        specs = [s for s in specs if s.family == args.family]
        if not specs:
            ap.error(f"no selected scenario has family {args.family!r}")

    if args.save_trace and len(specs) != 1:
        ap.error("--save-trace takes exactly one scenario")
    if plane != "sim" and (args.save_trace or args.replay):
        ap.error("--save-trace/--replay are sim-plane features")
    if args.trace_out and len(specs) != 1:
        ap.error("--trace-out takes exactly one scenario")

    if plane == "live" and not args.names and not args.spec:
        # Default canon sweep: keep only what the live plane can lower
        # (attack waves and multitopic are sim-plane subsystems).
        skipped = [s.name for s in specs if not scenario.live_supported(s)]
        specs = [s for s in specs if scenario.live_supported(s)]
        if skipped:
            print(f"# live plane: skipping unsupported canon: "
                  f"{', '.join(skipped)}", file=sys.stderr)
    if plane == "sim" and not args.names and not args.spec:
        # Mirror filter: live-only and streaming-only canon (root failover,
        # socket partition heal, serving-plane streams) have no device
        # lowering and are skipped from the sim sweep.
        skipped = [s.name for s in specs if not scenario.sim_supported(s)]
        specs = [s for s in specs if scenario.sim_supported(s)]
        if skipped:
            print(f"# sim plane: skipping live/streaming-only canon: "
                  f"{', '.join(skipped)}", file=sys.stderr)
    if plane == "streaming" and not args.names and not args.spec:
        # Streaming sweep: only what the serving plane can replay.
        skipped = [s.name for s in specs
                   if not scenario.streaming_supported(s)]
        specs = [s for s in specs if scenario.streaming_supported(s)]
        if skipped:
            print(f"# streaming plane: skipping unsupported canon: "
                  f"{', '.join(skipped)}", file=sys.stderr)

    results = []
    for spec in specs:
        t0 = time.time()
        if plane == "live":
            try:
                res = scenario.run_live_scenario(
                    spec,
                    n_hosts=args.live_hosts,
                    step_s=(args.live_step_ms / 1e3
                            if args.live_step_ms is not None else None),
                    trace_out=args.trace_out,
                    # Cross-host tracing rides the artifact request: no
                    # --trace-out, no ledgers — the untraced plane stays
                    # bit-identical to r18.
                    trace_sample=(args.trace_sample
                                  if args.trace_out else None),
                )
            except scenario.LivePlaneError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        elif plane == "streaming":
            try:
                res = scenario.run_streaming_scenario(
                    spec, trace_out=args.trace_out,
                    trace_sample=args.trace_sample, device=args.device,
                )
            except scenario.StreamingPlaneError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        else:
            res = scenario.run_scenario(spec, trace_out=args.trace_out,
                                        device=args.device)
        res.seconds = round(time.time() - t0, 3)
        results.append(res)

    if args.save_trace:
        scenario.save_trace(args.save_trace, results[0])

    if args.json:
        print(json.dumps(
            [dict(res.verdict.to_dict(), family=res.spec.family,
                  plane=plane,
                  n_publishes=(res.compiled.n_publishes
                               if plane == "sim"
                               else res.n_publishes),
                  seconds=res.seconds)
             for res in results],
            indent=2,
        ))
    else:
        print(_verdict_table(results))
        n_fail = sum(not r.verdict.passed for r in results)
        print(f"\n{len(results) - n_fail}/{len(results)} scenarios passed")
    return 0 if all(r.verdict.passed for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
