"""Run one cell of the benchmark of ``go_libp2p_pubsub_torch`` once.

    python3 pubsub_bench/run.py --workload <cell> --seed <n> \\
        --seconds <window> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Everything is found by name (``harness/registry.py``): the cell in
``BENCHMARK.json``, its configuration, its traffic mix, its driver and
its per-layer metrics' readers.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
part of the window.  Either way the run checks what the timed path
produced against the plain reference (``reference/``) once the window
has closed, and prints the compared numbers beside their limits.

Exit codes: 0 with a result line (``correct`` true or false); 2 when the
run cannot start (no card, too few cards, an unknown name); 3 when JAX or
the JAX package is loaded once the window has closed; 4 when a traced
run's trace holds no device time.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The kernel caches: fixed directories inside the checkout, so a cell's
# first run there builds and every later one loads.  The port's nvcc and
# g++ builds go to its own fixed ``go_libp2p_pubsub_torch/build/``.
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None, **extra) -> int:
    """One run; ``extra`` goes into the driver's context (``control.py``
    passes ``control=True``)."""
    from pubsub_bench.harness import common, registry

    args = common.parse_args(argv)
    try:
        cell = registry.cell(args.workload)
        driver = registry.driver(cell["config"])
        readers = ({m["name"]: registry.metric_reader(m["name"])
                    for m in cell["per_layer"]} if args.trace else {})
        dev = common.require_cards(int(cell["entry"]["chips"]))
    except common.RunError as exc:
        print(f"pubsub_bench: {exc}", file=sys.stderr)
        return 2
    card = common.card_facts(dev)
    out = driver.run(dict(
        config=cell["config"], traffic=cell["traffic"], seed=args.seed,
        seconds=args.seconds, trace=args.trace, dev=dev, card=card,
        t_start=T_START, **extra))
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"pubsub_bench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": card["kind"],
              "count": int(cell["entry"]["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": card["power_limit_w"]}
    metrics = {}
    result = {}
    if args.trace:
        trace = out["records"].get("trace")
        if not trace or trace["busy_s"] <= 0:
            print("pubsub_bench: the trace holds no device time",
                  file=sys.stderr)
            return 4
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        for m in cell["per_layer"]:
            value = readers[m["name"]](out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = trace["breakdown"]
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    checks = out["checks"]
    line = {"correct": all(common.check_passes(c) for c in checks),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    line.update(result)
    common.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
