"""Scenario execution: run campaigns, grade SLOs, write replayable traces.

The JAX package's ``scenario/runner.py`` in the port.  ``run_scenario``
compiles a spec on ``device`` (the card by default; raises without one),
executes the whole campaign in the model's ``rollout_events`` with
``record=True``, and grades the flight record into a
:class:`~.slo.Verdict`.  ``save_trace`` persists (spec + seed + flight
record) as one JSON document; ``replay_trace`` re-compiles the embedded
spec, re-runs it, and compares the fresh flight record against the stored
one bit for bit -- also a trace the JAX package wrote, since both packages
lower a spec to the same events and compute the same record.

Bit-for-bit means EXACT: floats go through ``float.hex`` (no decimal
rounding), NaN/Inf become explicit tokens, and the replay comparison is
string equality on the re-encoded record.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from . import slo as slo_mod
from .compiler import CompiledScenario, compile_scenario
from .spec import ScenarioSpec

TRACE_VERSION = 1


@dataclasses.dataclass
class ScenarioResult:
    """One executed campaign: the compiled form, device outputs, verdict."""

    compiled: CompiledScenario
    final_state: Any
    record: Dict[str, np.ndarray]
    verdict: slo_mod.Verdict

    @property
    def spec(self) -> ScenarioSpec:
        return self.compiled.spec


def _run_compiled(
    comp: CompiledScenario,
) -> Tuple[Any, Dict[str, np.ndarray]]:
    """One campaign's ``rollout_events`` (record=True) of the family's
    model -> (final state, host flight record)."""
    if comp.spec.family == "gossipsub":
        return comp.model.rollout_events(
            comp.state, comp.events, attackers=comp.attackers,
            target=comp.target, record=True,
        )
    return comp.model.rollout_events(comp.state, comp.events, record=True)


def run_scenario(
    spec_or_compiled: Union[ScenarioSpec, CompiledScenario],
    trace_out: Optional[str] = None,
    device="cuda",
) -> ScenarioResult:
    """Compile (if needed, on ``device``) and execute one scenario, verdict
    included.  ``trace_out`` writes the reference's ``obs-record-trace/1``
    artifact: the flight record's per-step series as Chrome counter
    events, on a step-index time axis."""
    comp = (
        spec_or_compiled
        if isinstance(spec_or_compiled, CompiledScenario)
        else compile_scenario(spec_or_compiled, device=device)
    )
    final, record = _run_compiled(comp)
    verdict = slo_mod.evaluate(comp.spec, record, comp.n_publishes)
    if trace_out is not None:
        from ..obs.export import build_record_artifact, write_json

        write_json(trace_out, build_record_artifact(
            plane="sim", scenario=comp.spec.name,
            verdict=verdict.to_dict(), record=record,
        ))
    return ScenarioResult(
        compiled=comp, final_state=final, record=record, verdict=verdict
    )


def run_suite(
    specs: List[ScenarioSpec], device="cuda",
) -> List[ScenarioResult]:
    """Run a list of scenarios in order -> their results (one process,
    one device)."""
    return [run_scenario(s, device=device) for s in specs]


# ---------------------------------------------------------------------------
# exact-float flight-record encoding
# ---------------------------------------------------------------------------

def _encode_scalar(x) -> Any:
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    f = float(x)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    # float.hex round-trips the exact bit pattern; repr-decimal does too in
    # CPython, but hex makes the exactness contract explicit in the file.
    return f.hex()


def _encode_array(a: np.ndarray) -> Any:
    if a.ndim == 0:
        return _encode_scalar(a[()])
    return [_encode_array(x) for x in a]


def flight_to_jsonable(record: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Flight record -> JSON-safe dict with EXACT float encoding (hex
    floats, NaN/Inf tokens) — the replay-comparison surface."""
    out = {}
    for k in sorted(record):
        arr = np.asarray(record[k])
        out[k] = {
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "data": _encode_array(arr),
        }
    return out


def _decode_scalar(x, dtype: np.dtype):
    if isinstance(x, str):
        if x == "NaN":
            return dtype.type(np.nan)
        if x == "Infinity":
            return dtype.type(np.inf)
        if x == "-Infinity":
            return dtype.type(-np.inf)
        return dtype.type(float.fromhex(x))
    return dtype.type(x)


def jsonable_to_flight(doc: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`flight_to_jsonable`."""
    out = {}
    for k, ent in doc.items():
        dtype = np.dtype(ent["dtype"])

        def conv(x):
            if isinstance(x, list):
                return [conv(v) for v in x]
            return _decode_scalar(x, dtype)

        out[k] = np.asarray(conv(ent["data"]), dtype=dtype).reshape(
            ent["shape"]
        )
    return out


# ---------------------------------------------------------------------------
# traces: save + bit-for-bit replay
# ---------------------------------------------------------------------------

def trace_document(result: ScenarioResult) -> Dict[str, Any]:
    """The replayable trace: spec + seed + flight record + verdict."""
    return {
        "trace_version": TRACE_VERSION,
        "spec": result.spec.to_dict(),
        "seed": result.spec.seed,
        "n_publishes": result.compiled.n_publishes,
        "flight": flight_to_jsonable(result.record),
        "verdict": result.verdict.to_dict(),
    }


def save_trace(path: str, result: ScenarioResult) -> None:
    with open(path, "w") as f:
        json.dump(trace_document(result), f, sort_keys=True, indent=1)
        f.write("\n")


def replay_trace(
    path_or_doc: Union[str, Dict[str, Any]],
    device="cuda",
    compiled: Optional[CompiledScenario] = None,
) -> Tuple[ScenarioResult, bool, List[str]]:
    """Re-run a saved trace's spec on ``device`` and compare flight records
    EXACTLY (a trace the JAX package wrote replays on the port).
    ``compiled`` runs an already compiled copy of the trace's spec instead
    of compiling it again (``device`` is then the compiled model's).

    Returns ``(fresh_result, matched, mismatched_channels)`` where
    ``matched`` is True iff every channel of the fresh flight record
    re-encodes to exactly the stored bytes (same dtype, shape, and bit
    pattern for every value — NaNs compare equal by token).
    """
    if isinstance(path_or_doc, str):
        with open(path_or_doc) as f:
            doc = json.load(f)
    else:
        doc = path_or_doc
    spec = ScenarioSpec.from_dict(doc["spec"])
    if compiled is not None and compiled.spec.to_dict() != spec.to_dict():
        raise ValueError("the compiled scenario is not the trace's spec")
    result = run_scenario(spec if compiled is None else compiled,
                          device=device)
    fresh = flight_to_jsonable(result.record)
    stored = doc["flight"]
    mismatches = [
        k for k in sorted(set(fresh) | set(stored))
        if fresh.get(k) != stored.get(k)
    ]
    return result, not mismatches, mismatches
