"""The composite attack campaign at the headline's width, and its trace.

``traces/campaign_100000.trace.json`` is a trace the JAX package wrote
(its ``scenario.run_scenario`` + ``save_trace`` on the CPU): the spec, its
publish count, the exact-float flight record and the verdict of a
48-round campaign at 100,000 peers that uses every event kind the
gossipsub lowering emits (abrupt and graceful churn with rejoin, a
per-peer link-delay window, sybil, spam, an eclipse with GRAFT spam, and
IHAVE self-promotion).  ``replay_trace`` of it on the port must give the
same record.  ``campaign_spec(n)`` reads the spec from the trace and
scales it to ``n`` peers for the smaller runs: only ``n_peers`` and the
churn phases' ``kills_per_event`` shares change.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from .spec import ScenarioSpec

TRACE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "traces",
    "campaign_100000.trace.json")


def load_trace(path: str = TRACE_PATH) -> Dict[str, Any]:
    """The committed trace document."""
    with open(path) as f:
        return json.load(f)


def campaign_spec(n_peers: Optional[int] = None,
                  doc: Optional[Dict[str, Any]] = None) -> ScenarioSpec:
    """The trace's spec, scaled to ``n_peers`` (default: its own width)."""
    spec = ScenarioSpec.from_dict((doc or load_trace())["spec"])
    n0 = spec.model["n_peers"]
    if n_peers is None or n_peers == n0:
        return spec
    return dataclasses.replace(
        spec,
        name=f"campaign_{n_peers}",
        model=dict(spec.model, n_peers=n_peers),
        churn=[dataclasses.replace(
            ph, kills_per_event=max(1, ph.kills_per_event * n_peers // n0))
            for ph in spec.churn],
    )
