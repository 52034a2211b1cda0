"""What every cell's run shares: arguments, the card, the result line.

A run prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (``{name: {"value",
"unit"}}``), ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: every number that decided ``correct`` beside its limit.  The
same checks close its standard error, one a line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

# Top-level module names that may not be loaded in the process that prints
# a result: JAX, its libraries, and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "go_libp2p_pubsub_tpu")


class RunError(RuntimeError):
    """A run that cannot produce a result (no card, unknown name, ...)."""


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="pubsub_bench/run.py",
        description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True,
                    help="a cell name from BENCHMARK.json's workloads")
    ap.add_argument("--seed", type=int, required=True,
                    help="makes the cell's inputs and data")
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: a traced run that reports the per-layer metrics")
    return ap.parse_args(argv)


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names present in ``sys.modules`` (whole
    names: ``go_libp2p_pubsub_torch`` is not ``go_libp2p_pubsub_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def seed_words(seed: int) -> List[int]:
    """A seed as non-negative words for ``numpy.random.default_rng``
    (any whole number, also past 32 bits or below 0)."""
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]


def rng_for(seed: int, purpose: int):
    """An independent numpy generator a purpose under one seed."""
    import numpy as np

    return np.random.default_rng(seed_words(seed) + [int(purpose)])


def model_seed(seed: int) -> int:
    """The models' own seed: a 32-bit image of ``seed``."""
    return int(seed) % (1 << 32)


def query_gpu(field: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of the first card, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    if out.returncode != 0 or not out.stdout.strip():
        return ""
    return out.stdout.strip().splitlines()[0].strip()


def require_cards(count: int):
    """The first card as a ``torch.device``; raises unless CUDA is there
    with at least ``count`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false: no card")
    have = torch.cuda.device_count()
    if have < count:
        raise RunError(f"the cell needs {count} cards, {have} visible")
    return torch.device("cuda", 0)


def card_facts(dev) -> Dict[str, object]:
    """Name, SM count, maximum SM clock and power limit of the card."""
    import torch

    props = torch.cuda.get_device_properties(dev)
    clock = query_gpu("clocks.max.sm")
    power = query_gpu("power.limit")
    return {
        "kind": torch.cuda.get_device_name(dev),
        "sms": int(props.multi_processor_count),
        "max_sm_clock_mhz": float(clock) if clock else None,
        "power_limit_w": float(power) if power else None,
    }


def check(name: str, value: float, limit: float, op: str = "<=") -> dict:
    """One compared number: ``value op limit`` must hold."""
    return {"name": name, "value": value, "limit": limit, "op": op}


def check_passes(c: dict) -> bool:
    v, lim = c["value"], c["limit"]
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return False
    return v <= lim if c["op"] == "<=" else v >= lim


def emit(result: dict, checks: List[dict]) -> None:
    """The checks as the last lines of standard error, then the result
    line (with the checks under its last key) as the last line of
    standard output."""
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['op']} "
              f"{c['limit']!r}): {'ok' if check_passes(c) else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = {c["name"]: {"value": c["value"],
                                 "limit": f"{c['op']} {c['limit']}"}
                     for c in checks}
    print(json.dumps(out), flush=True)


def bench_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
