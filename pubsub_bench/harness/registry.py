"""Everything a cell needs, found by name.

- ``BENCHMARK.json`` (the checkout's root): the cell's entry, and the
  per-layer metrics whose ``workloads`` name it.
- ``configs/<config>.json``: one deployment.  Its ``driver`` names the
  module under ``harness/`` that runs it (``closed_loop``).
- ``traffic/<traffic>.json``: one traffic mix, the parameters of the
  generator it names (``generator``: ``traffic/<generator>.py``).
- ``metrics/<metric>.py``: one reader a per-layer metric, with
  ``read(records) -> float | None``.

A name that is not there raises ``RunError``: nothing falls back.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

from .common import RunError, bench_dir


def root_dir() -> str:
    return os.path.dirname(bench_dir())


def load_benchmark(root: Optional[str] = None) -> dict:
    path = os.path.join(root or root_dir(), "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(f"no BENCHMARK.json at {path}")
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(e["name"] for e in entries)
    raise RunError(f"unknown {what} {name!r}; BENCHMARK.json has: {known}")


def data_file(sub: str, name: str) -> dict:
    """``<sub>/<name>.json`` under the benchmark's folder."""
    path = os.path.join(bench_dir(), sub, f"{name}.json")
    if not os.path.exists(path):
        raise RunError(f"no {sub} file for {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: Optional[dict] = None) -> Dict[str, object]:
    """The cell ``name``: its entry, its configuration (the file the
    configs entry names), its traffic mix, and its end-to-end and
    per-layer metric entries."""
    bench = bench if bench is not None else load_benchmark()
    entry = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], entry["config"], "config")
    path = os.path.join(root_dir(), cfg_entry["file"])
    if not os.path.exists(path):
        raise RunError(f"no configuration file {path}")
    with open(path) as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [])]
    return dict(entry=entry, config=config,
                traffic=data_file("traffic", entry["traffic"]),
                end_to_end=e2e, per_layer=per_layer)


def driver(config: dict):
    """The module that runs a configuration (``harness/<driver>.py``)."""
    name = config.get("driver")
    path = os.path.join(bench_dir(), "harness", f"{name}.py")
    if not name or not os.path.exists(path):
        raise RunError(f"configuration names no known driver ({name!r})")
    return importlib.import_module(f"pubsub_bench.harness.{name}")


def generator(mix: dict):
    """The module a traffic mix names (``traffic/<generator>.py``)."""
    name = mix.get("generator")
    path = os.path.join(bench_dir(), "traffic", f"{name}.py")
    if not name or not os.path.exists(path):
        raise RunError(f"the traffic mix names no known generator ({name!r})")
    return importlib.import_module(f"pubsub_bench.traffic.{name}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(bench_dir(), "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise RunError(f"no reader for per-layer metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"pubsub_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
