"""The knee of a steady stream cell: its driver at a ladder of offered
rates, on the card, at the cell's own size.

    python3 pubsub_bench/knee.py --workload <cell> --seed <n> \\
        --seconds <window> --rates <r1,r2,...>

Each rate is one run of the cell with the traffic mix's
``rate_msgs_per_s`` replaced, and no comparison after the window.  A rate
is sustained when the ring holds at most one chunk's lanes when the window
closes and every valid message completes in the drain.  One JSON line a
rate on standard output, then the highest sustained rate.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402,F401  (sets the caches and the import path first)


def main() -> int:
    from pubsub_bench.harness import common, registry

    ap = argparse.ArgumentParser(prog="pubsub_bench/knee.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True,
                    help="offered rates in msgs/s, comma-separated")
    args = ap.parse_args()
    try:
        cell = registry.cell(args.workload)
        driver = registry.driver(cell["config"])
        dev = common.require_cards(int(cell["entry"]["chips"]))
    except common.RunError as exc:
        print(f"pubsub_bench: {exc}", file=sys.stderr)
        return 2
    card = common.card_facts(dev)
    lanes = cell["config"]["chunk_steps"] * cell["config"]["pub_width"]
    best = None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        out = driver.run(dict(
            config=cell["config"], traffic=cell["traffic"],
            seed=args.seed + i, seconds=args.seconds, trace=0, dev=dev,
            card=card, t_start=time.perf_counter(), rate=rate, check=False))
        c = out["records"]["counters"]
        ok = (c["depth_at_end"] <= lanes and c["pending_after_drain"] == 0)
        if ok:
            best = rate if best is None else max(best, rate)
        print(json.dumps({
            "rate_msgs_per_s": rate, "sustained": ok,
            "pushed_msgs_per_s": c["pushed_in_window"] / c["window_s"],
            "depth_at_end": c["depth_at_end"], "chunks": c["chunks"],
            "chunk_ms": 1e3 * c["window_s"] / max(c["chunks"], 1),
            "drain_chunks": c["drain_chunks"],
            "pending_after_drain": c["pending_after_drain"],
            "validated_msgs_per_s": out["e2e"]["validated_msgs_per_s"],
            "card": card["kind"], "power_limit_w": card["power_limit_w"]}),
            flush=True)
    print(json.dumps({"knee_msgs_per_s": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
