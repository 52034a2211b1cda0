"""Scenario engine of the port: declarative adversity campaigns replayed on
the card.

- :mod:`.spec` -- the declarative layer (:class:`ScenarioSpec` + JSON);
- :mod:`.compiler` -- lowering to ``ops.schedule`` event rows
  (``gossipsub`` and ``multitopic`` families), and the serving plane's
  publish timeline (``compile_streaming_plan``);
- :mod:`.runner` -- execution, traces, bit-for-bit replay;
- :mod:`.streaming_runner` -- campaigns as open streams through the
  ingest ring into the resident engine, with the watchdog, the
  controller and the staged faults;
- :mod:`.slo` -- verdicts graded from the flight record;
- :mod:`.canon` -- the named, committed campaign suite;
- :mod:`.defense`, :mod:`.realism` -- defense configs, network texture.

The live runner of the JAX package is not ported yet.
"""

from .canon import CANON, build, build_all
from .compiler import (
    CompiledScenario,
    StreamingPlan,
    compile_scenario,
    compile_streaming_plan,
)
from .defense import (
    HARDENED_DEFENSE,
    PROMOTED_DEFENSE,
    STANDING_DEFENSE,
    check_invariants,
    defense_digest,
)
from .realism import (
    apply_realism,
    diurnal_churn,
    geo_latency_links,
    heavy_tailed_builder,
    topology_builder,
)
from .runner import (
    ScenarioResult,
    replay_trace,
    run_scenario,
    run_suite,
    save_trace,
    trace_document,
)
from .slo import Criterion, Verdict, evaluate
from .streaming_runner import (
    StreamingPlaneError,
    StreamingScenarioResult,
    run_streaming_scenario,
    streaming_supported,
)
from .spec import (
    SLO,
    AttackWave,
    ChurnPhase,
    LinkWindow,
    ScenarioSpec,
    Workload,
)


def sim_supported(spec: ScenarioSpec) -> bool:
    """Can this spec be lowered onto the sim plane?  Live-only and
    streaming-only scenarios have no closed-loop lowering (the canon's
    sim campaigns: the gossipsub ones and ``multitopic_hot_publisher``)."""
    return not spec.live_only and not spec.streaming_only


__all__ = [
    "CANON",
    "AttackWave",
    "ChurnPhase",
    "CompiledScenario",
    "Criterion",
    "HARDENED_DEFENSE",
    "LinkWindow",
    "PROMOTED_DEFENSE",
    "SLO",
    "STANDING_DEFENSE",
    "ScenarioResult",
    "ScenarioSpec",
    "StreamingPlan",
    "StreamingPlaneError",
    "StreamingScenarioResult",
    "Verdict",
    "Workload",
    "apply_realism",
    "build",
    "build_all",
    "check_invariants",
    "compile_scenario",
    "compile_streaming_plan",
    "defense_digest",
    "diurnal_churn",
    "evaluate",
    "geo_latency_links",
    "heavy_tailed_builder",
    "replay_trace",
    "run_scenario",
    "run_streaming_scenario",
    "run_suite",
    "save_trace",
    "sim_supported",
    "streaming_supported",
    "topology_builder",
    "trace_document",
]
