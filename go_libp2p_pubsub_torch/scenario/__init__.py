"""Scenario engine of the port: declarative adversity campaigns replayed on
the card.

- :mod:`.spec` -- the declarative layer (:class:`ScenarioSpec` + JSON);
- :mod:`.compiler` -- lowering to ``ops.schedule`` event rows
  (``gossipsub`` and ``multitopic`` families), and the serving plane's
  publish timeline (``compile_streaming_plan``);
- :mod:`.runner` -- execution, traces, bit-for-bit replay;
- :mod:`.live_runner` -- the same campaigns over real sockets and chaos
  (the live plane, ``net/live.py``);
- :mod:`.streaming_runner` -- campaigns as open streams through the
  ingest ring into the resident engine, with the watchdog, the
  controller and the staged faults;
- :mod:`.slo` -- verdicts graded from the flight record;
- :mod:`.canon` -- the named, committed campaign suite;
- :mod:`.defense`, :mod:`.realism` -- defense configs, network texture.
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
from .live_runner import (
    LivePlaneError,
    LiveScenarioResult,
    live_supported,
    run_live_scenario,
    sim_supported,
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


__all__ = [
    "CANON",
    "AttackWave",
    "ChurnPhase",
    "CompiledScenario",
    "Criterion",
    "HARDENED_DEFENSE",
    "LinkWindow",
    "LivePlaneError",
    "LiveScenarioResult",
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
    "live_supported",
    "replay_trace",
    "run_live_scenario",
    "run_scenario",
    "run_streaming_scenario",
    "run_suite",
    "save_trace",
    "sim_supported",
    "streaming_supported",
    "topology_builder",
    "trace_document",
]
