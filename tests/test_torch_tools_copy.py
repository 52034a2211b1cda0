"""The port's tools are copies of the JAX package's (``tools/*.py``).

Each ``go_libp2p_pubsub_torch/tools/<name>.py`` equals the reference's
``tools/<name>.py`` byte for byte once each listed (old, new) substitution
has replaced its one occurrence, so a change anywhere else in the port's
copy (a sampler, ``shrink``, ``_mutations``, the promotion gate,
``--search defense``) fails here even where the sampled runs of
``tests/test_torch_tools.py`` never reach it.
"""

import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scenario_run: no shebang, the usage as ``python -m``, relative imports,
# ``--device`` (its option, the missing-card check, the replay and the two
# runners).
SCENARIO_RUN_SUBSTITUTIONS = [
    ("#!/usr/bin/env python\n",
     ""),
    ("Usage::\n",
     "Usage (``R = python -m go_libp2p_pubsub_torch.tools.scenario_run``)::\n"),
    (("    python tools/scenario_run.py                      # whole canon suite\n"
      "    python tools/scenario_run.py steady_state churn_10pct\n"
      "    python tools/scenario_run.py --list               # name the canon\n"
      "    python tools/scenario_run.py --spec my.json       # a spec file\n"
      "    python tools/scenario_run.py steady_state --save-trace trace.json\n"
      "    python tools/scenario_run.py --replay trace.json  # bit-for-bit check\n"
      "    python tools/scenario_run.py --json               # machine-readable\n"
      "    python tools/scenario_run.py --plane live degraded_links churn_10pct\n"
      "    python tools/scenario_run.py --plane streaming streaming_steady\n"),
     ("    R                                      # whole canon suite, on the card\n"
      "    R steady_state churn_10pct\n"
      "    R --list                               # name the canon\n"
      "    R --spec my.json                       # a spec file\n"
      "    R steady_state --save-trace trace.json\n"
      "    R --replay trace.json                  # bit-for-bit check\n"
      "    R --json                               # machine-readable\n"
      "    R --plane live degraded_links churn_10pct\n"
      "    R --plane streaming streaming_steady\n"
      "    R --device cpu steady_state            # on the CPU\n")),
    (('gate, not a demo (PERF.md "Scenario verdicts").  Exit 2 means a plane\n'
      "failed to START (infrastructure, not a red verdict).\n"),
     ("gate, not a demo.  Exit 2 means a plane failed to START\n"
      "(infrastructure, not a red verdict), a missing card for ``--device cuda``\n"
      "included.  The sim and streaming planes run on ``--device``; the live\n"
      "plane runs on the host.\n")),
    ("import os\n",
     ""),
    (("sys.path.insert(\n"
      "    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))\n"
      ")\n"
      "\n"
      "from go_libp2p_pubsub_tpu import scenario  # noqa: E402\n"),
     ("from .. import scenario\n"
      "from . import device_error\n")),
    ('                    "tools/trace_view.py or chrome://tracing")\n',
     ('                    "go_libp2p_pubsub_torch.tools.trace_view or "\n'
      '                    "chrome://tracing")\n')),
    ('                    "step (default 50, or the spec\'s live.step_ms)")\n',
     ('                    "step (default 50, or the spec\'s live.step_ms)")\n'
      '    ap.add_argument("--device", default="cuda",\n'
      '                    help="where the sim and streaming planes run (default "\n'
      '                    "cuda; cpu runs them on the CPU)")\n')),
    (("        return 0\n"
      "\n"),
     ("        return 0\n"
      "\n"
      '    err = (None if plane == "live" and not args.replay\n'
      "           else device_error(args.device))\n"
      "    if err is not None:\n"
      '        print(f"error: {err}", file=sys.stderr)\n'
      "        return 2\n"
      "\n")),
    ("            result, ok, bad = scenario.replay_trace(path)\n",
     "            result, ok, bad = scenario.replay_trace(path, device=args.device)\n"),
    ("                    trace_sample=args.trace_sample,\n",
     "                    trace_sample=args.trace_sample, device=args.device,\n"),
    ("            res = scenario.run_scenario(spec, trace_out=args.trace_out)\n",
     ("            res = scenario.run_scenario(spec, trace_out=args.trace_out,\n"
      "                                        device=args.device)\n")),
]

# trace_view: no shebang, the usage as ``python -m``, the merge imported
# relatively at the top (not after a ``sys.path`` insert), no ``--device``.
TRACE_VIEW_SUBSTITUTIONS = [
    ("#!/usr/bin/env python\n",
     ""),
    ("Usage::\n",
     "Usage (``V = python -m go_libp2p_pubsub_torch.tools.trace_view``)::\n"),
    (("    python tools/trace_view.py trace.json\n"
      "    python tools/trace_view.py trace.json --json     # machine-readable\n"
      "    python tools/trace_view.py crash.postmortem.json # black-box dump\n"
      "    python tools/trace_view.py --merge trace.spans/  # merge per-host ledgers\n"),
     ("    V trace.json\n"
      "    V trace.json --json                   # machine-readable\n"
      "    V crash.postmortem.json               # black-box dump\n"
      "    V --merge trace.spans/                # merge per-host ledgers\n")),
    ("error, distinct from anything the run itself did).\n",
     ("error, distinct from anything the run itself did).  It reads files only\n"
      "and runs nothing on a device, so it has no ``--device``.\n")),
    ("from typing import Any, Dict, List\n",
     ("from typing import Any, Dict, List\n"
      "\n"
      "from ..obs.merge import merge_host_artifacts\n")),
    (("    sys.path.insert(\n"
      "        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))\n"
      "    )\n"
      "    from go_libp2p_pubsub_tpu.obs.merge import merge_host_artifacts\n"
      "\n"),
     ""),
]

# scenario_fuzz: no shebang, the usage, relative imports, ``--device``
# threaded through ``grade_defense``, ``_RUNNERS``, ``_grade``, ``shrink``
# and ``main``, and ``_grade``'s re-raise of a device failure.
SCENARIO_FUZZ_SUBSTITUTIONS = [
    ("#!/usr/bin/env python\n",
     ""),
    ("``tools/scenario_run.py --spec``.\n",
     "``go_libp2p_pubsub_torch.tools.scenario_run --spec``.\n"),
    ("Usage::\n",
     "Usage (``F = python -m go_libp2p_pubsub_torch.tools.scenario_fuzz``)::\n"),
    (("    python tools/scenario_fuzz.py --budget 40 --seed 0\n"
      "    python tools/scenario_fuzz.py --budget 40 --seed 0 --defense hardened\n"
      "    python tools/scenario_fuzz.py --budget 40 --seed 0 --shrink \\\n"
      "        --save-red red.json\n"
      "    python tools/scenario_fuzz.py --budget 5 --seed 0 --json   # smoke\n"
      "    python tools/scenario_fuzz.py --plane streaming --budget 10 --seed 0\n"
      "    python tools/scenario_fuzz.py --search defense --budget 5 --seed 0\n"),
     ("    F --budget 40 --seed 0\n"
      "    F --budget 40 --seed 0 --defense hardened\n"
      "    F --budget 40 --seed 0 --shrink --save-red red.json\n"
      "    F --budget 5 --seed 0 --json                     # smoke\n"
      "    F --plane streaming --budget 10 --seed 0\n"
      "    F --search defense --budget 5 --seed 0\n"
      "    F --budget 5 --seed 0 --device cpu               # on the CPU\n")),
    ("failure); 1 on usage errors.\n",
     ("failure); 1 on usage errors; 2 without a card for ``--device cuda``.\n"
      "Campaigns run on ``--device`` (the live plane on the host).  A failure\n"
      "of the device itself is raised, never graded as an invalid spec.\n")),
    ("import os\n",
     ""),
    (("sys.path.insert(\n"
      "    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))\n"
      ")\n"),
     "import numpy as np\n"),
    (("import numpy as np  # noqa: E402\n"
      "\n"
      "from go_libp2p_pubsub_tpu import scenario  # noqa: E402\n"
      "from go_libp2p_pubsub_tpu.scenario.defense import (  # noqa: E402\n"),
     ("from .. import scenario\n"
      "from ..scenario.defense import (\n")),
    ("from go_libp2p_pubsub_tpu.scenario.spec import (  # noqa: E402\n",
     "from ..scenario.spec import (\n"),
    (("    SLO, AttackWave, ChurnPhase, LinkWindow, ScenarioSpec, Workload,\n"
      ")\n"),
     ("    SLO, AttackWave, ChurnPhase, LinkWindow, ScenarioSpec, Workload,\n"
      ")\n"
      "from . import device_error, device_failure\n")),
    ("def grade_defense(defense: dict, battery=DEFENSE_BATTERY):\n",
     'def grade_defense(defense: dict, battery=DEFENSE_BATTERY, device="cuda"):\n'),
    ("        status, _, failed = _grade(spec)\n",
     "        status, _, failed = _grade(spec, device=device)\n"),
    (('    "sim": lambda spec: scenario.run_scenario(spec),\n'
      '    "streaming": lambda spec: scenario.run_streaming_scenario(spec),\n'
      '    "live": lambda spec: scenario.run_live_scenario(spec),\n'),
     ('    "sim": lambda spec, device: scenario.run_scenario(spec, device=device),\n'
      '    "streaming": lambda spec, device: scenario.run_streaming_scenario(\n'
      "        spec, device=device),\n"
      '    "live": lambda spec, device: scenario.run_live_scenario(spec),\n')),
    (('def _grade(spec: ScenarioSpec, plane: str = "sim"):\n'
      '    """Run one spec -> (status, verdict | None, failed-criteria names).\n'),
     ('def _grade(spec: ScenarioSpec, plane: str = "sim", device="cuda"):\n'
      '    """Run one spec on ``device`` -> (status, verdict | None,\n'
      "    failed-criteria names).\n")),
    ("    of the search space, not a defense failure.\n",
     ("    of the search space, not a defense failure.  A failure of the device\n"
      "    (``device_failure``) is not the spec's, and propagates.\n")),
    ("        res = _RUNNERS[plane](spec)\n",
     "        res = _RUNNERS[plane](spec, device)\n"),
    ("    except (ValueError, RuntimeError) as e:\n",
     ("    except (ValueError, RuntimeError) as e:\n"
      "        if device_failure(e):\n"
      "            raise\n")),
    ('    plane: str = "sim",\n',
     ('    plane: str = "sim",\n'
      '    device="cuda",\n')),
    ("            status, _, failed = _grade(cand, plane)\n",
     "            status, _, failed = _grade(cand, plane, device)\n"),
    ('                    help="emit the trajectory as JSON")\n',
     ('                    help="emit the trajectory as JSON")\n'
      '    ap.add_argument("--device", default="cuda",\n'
      '                    help="where the campaigns run (default cuda; cpu runs "\n'
      '                    "them on the CPU)")\n')),
    ('                 "exists on the sim plane")\n',
     ('                 "exists on the sim plane")\n'
      '    err = None if args.plane == "live" else device_error(args.device)\n'
      "    if err is not None:\n"
      '        print(f"error: {err}", file=sys.stderr)\n'
      "        return 2\n")),
    ("            worst, results = grade_defense(defense, battery=battery)\n",
     ("            worst, results = grade_defense(defense, battery=battery,\n"
      "                                           device=args.device)\n")),
    ("        status, verdict, failed = _grade(spec, args.plane)\n",
     "        status, verdict, failed = _grade(spec, args.plane, args.device)\n"),
    ("            plane=args.plane,\n",
     "            plane=args.plane, device=args.device,\n"),
]

# coevolve: no shebang, the usage, relative imports (the fuzzer as
# ``from . import scenario_fuzz as fuzz``, no ``sys.path`` trick) and
# ``--device`` threaded through every grade and gate.
COEVOLVE_SUBSTITUTIONS = [
    ("#!/usr/bin/env python\n",
     ""),
    ("``go_libp2p_pubsub_tpu/scenario/promoted_defense.json`` (the shipped\n",
     "``go_libp2p_pubsub_torch/scenario/promoted_defense.json`` (the shipped\n"),
    ("Usage::\n",
     "Usage (``C = python -m go_libp2p_pubsub_torch.tools.coevolve``)::\n"),
    (("    python tools/coevolve.py --budget 3 --seed 0\n"
      "    python tools/coevolve.py --budget 2 --seed 0 --attack-budget 2 \\\n"),
     ("    C --budget 3 --seed 0\n"
      "    C --budget 2 --seed 0 --attack-budget 2 \\\n")),
    ("        --defense-probes 2 --no-shrink --dry-run --json   # tier-1 smoke\n",
     ("        --defense-probes 2 --no-shrink --dry-run --json   # tier-1 smoke\n"
      "    C --budget 3 --seed 0 --device cpu                    # on the CPU\n")),
    ("1 on usage errors.\n",
     ("1 on usage errors; 2 without a card for ``--device cuda``.  Every\n"
      "campaign and the deep invariant gate's rollout run on ``--device``.\n")),
    (("sys.path.insert(\n"
      "    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))\n"
      ")\n"),
     "import numpy as np\n"),
    (("import numpy as np  # noqa: E402\n"
      "\n"
      "sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))\n"
      "\n"
      "import scenario_fuzz as fuzz  # noqa: E402\n"
      "\n"
      "from go_libp2p_pubsub_tpu.scenario import realism  # noqa: E402\n"
      "from go_libp2p_pubsub_tpu.scenario.defense import (  # noqa: E402\n"),
     ("from ..scenario import realism\n"
      "from ..scenario.defense import (\n")),
    ("from go_libp2p_pubsub_tpu.scenario.spec import ScenarioSpec  # noqa: E402\n",
     ("from ..scenario.spec import ScenarioSpec\n"
      "from . import device_error\n"
      "from . import scenario_fuzz as fuzz\n")),
    (("def red_under(spec: ScenarioSpec, defense: Dict[str, float]) -> bool:\n"
      "    status, _, _ = fuzz._grade(_with_defense(spec, defense))\n"),
     ("def red_under(spec: ScenarioSpec, defense: Dict[str, float],\n"
      '              device="cuda") -> bool:\n'
      "    status, _, _ = fuzz._grade(_with_defense(spec, defense), device=device)\n")),
    ("    quick_battery: bool,\n",
     ("    quick_battery: bool,\n"
      '    device="cuda",\n')),
    ("    archive_reds = sum(red_under(s, defense) for s in archive)\n",
     "    archive_reds = sum(red_under(s, defense, device) for s in archive)\n"),
    ("        worst, results = fuzz.grade_defense(defense)\n",
     "        worst, results = fuzz.grade_defense(defense, device=device)\n"),
    ("    limit: int = 0,\n",
     ("    limit: int = 0,\n"
      '    device="cuda",\n')),
    ("    worst, results = fuzz.grade_defense(defense, battery=battery)\n",
     ("    worst, results = fuzz.grade_defense(defense, battery=battery,\n"
      "                                        device=device)\n")),
    (("        spec = fuzz.sample_spec(seed, _GATE_INDEX_OFFSET + i, defense)\n"
      "        status, _, failed = fuzz._grade(spec)\n"),
     ("        spec = fuzz.sample_spec(seed, _GATE_INDEX_OFFSET + i, defense)\n"
      "        status, _, failed = fuzz._grade(spec, device=device)\n")),
    ("            sum(red_under(s, defense) for s in archive)\n",
     "            sum(red_under(s, defense, device) for s in archive)\n"),
    ('                    help="emit the audit document to stdout as JSON")\n',
     ('                    help="emit the audit document to stdout as JSON")\n'
      '    ap.add_argument("--device", default="cuda",\n'
      '                    help="where the campaigns and the deep gate\'s rollout "\n'
      '                    "run (default cuda; cpu runs them on the CPU)")\n')),
    ('        ap.error("--attack-budget and --defense-probes must be >= 1")\n',
     ('        ap.error("--attack-budget and --defense-probes must be >= 1")\n'
      "    err = device_error(args.device)\n"
      "    if err is not None:\n"
      '        print(f"error: {err}", file=sys.stderr)\n'
      "        return 2\n")),
    ("            status, _, failed = fuzz._grade(spec)\n",
     "            status, _, failed = fuzz._grade(spec, device=args.device)\n"),
    ('                    red = fuzz.shrink(spec, lambda m: log("   " + m))\n',
     ('                    red = fuzz.shrink(spec, lambda m: log("   " + m),\n'
      "                                      device=args.device)\n")),
    ("            current, archive, quick_battery=not args.no_quick_battery\n",
     ("            current, archive, quick_battery=not args.no_quick_battery,\n"
      "            device=args.device,\n")),
    ("                cand, deep=not args.shallow_gate\n",
     "                cand, deep=not args.shallow_gate, device=args.device\n"),
    ("                    quick_battery=not args.no_quick_battery,\n",
     ("                    quick_battery=not args.no_quick_battery,\n"
      "                    device=args.device,\n")),
    (("        STANDING_DEFENSE, args.seed, args.fresh_budget, archive,\n"
      "        full=not args.quick_gate, limit=args.gate_battery,\n"),
     ("        STANDING_DEFENSE, args.seed, args.fresh_budget, archive,\n"
      "        full=not args.quick_gate, limit=args.gate_battery,\n"
      "        device=args.device,\n")),
    (("        current, args.seed, args.fresh_budget, archive,\n"
      "        full=not args.quick_gate, limit=args.gate_battery,\n"),
     ("        current, args.seed, args.fresh_budget, archive,\n"
      "        full=not args.quick_gate, limit=args.gate_battery,\n"
      "        device=args.device,\n")),
]

# mem_audit: no shebang, the usage, relative imports, ``--device``, the
# buffers read through ``bridge.py``'s spec functions, the carry check as
# one real step, and ``--compile`` as the card's allocator readings.
MEM_AUDIT_SUBSTITUTIONS = [
    ("#!/usr/bin/env python\n",
     ""),
    ("Usage::\n",
     "Usage (``M = python -m go_libp2p_pubsub_torch.tools.mem_audit``)::\n"),
    (("    python tools/mem_audit.py                       # human-readable tables\n"
      "    python tools/mem_audit.py --json                # one JSON document\n"
      "    python tools/mem_audit.py --peers 16384 --compile\n"
      "    python tools/mem_audit.py --models gossipsub,rlnc --peers 512 --json\n"),
     ("    M                                          # human-readable tables\n"
      "    M --json                                   # one JSON document\n"
      "    M --peers 16384 --compile\n"
      "    M --models gossipsub,rlnc --peers 512 --json\n"
      "    M --device cpu --json                      # on the CPU\n")),
    (("``jax.eval_shape`` over the model's jitted ``step`` asserts the scan carry\n"
      "keeps the SAME structure — what init allocates is what stays resident\n"
      "through a rollout, narrow index dtypes included.\n"),
     ("The buffers read in the reference's dtypes (``bridge.py``'s spec\n"
      "functions): the port stores the packed windows and the keys as int32 bit\n"
      "patterns of the reference's uint32, and its round counter on the host.\n"
      "One real ``step`` of the model on ``--device`` asserts the carry keeps\n"
      "the SAME structure — what init allocates is what stays resident through a\n"
      "rollout, narrow index dtypes included.\n")),
    (("``--compile`` additionally lowers + compiles the gossipsub rollout and\n"
      "reports XLA's ``memory_analysis`` totals (argument/output/temp/alias\n"
      "bytes) — the compile is the expensive part, so the tier-1 smoke leaves it\n"
      "off and the bench's ``mem`` child turns it on.\n"),
     ("``--compile`` additionally reads the card's own allocator on the\n"
      "gossipsub narrow arm (it needs a CUDA ``--device``): the rise of\n"
      "``torch.cuda.memory_allocated`` over ``init`` (the resident state) and,\n"
      "over an 8-step ``rollout(record=False)``, the rise of\n"
      "``torch.cuda.max_memory_allocated`` above what was allocated when it\n"
      "started (the rollout's temporaries).\n")),
    ("import os\n",
     ""),
    ("import numpy as np\n",
     ("import numpy as np\n"
      "import torch\n")),
    ("sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))\n",
     ("from .. import bridge\n"
      "from . import device_error\n")),
    ("    from go_libp2p_pubsub_tpu.ops.graphs import index_dtype\n",
     "    from ..ops.graphs import index_dtype\n"),
    (("                msg_window: int, override):\n"
      "    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub\n"
      "    from go_libp2p_pubsub_tpu.models.hybrid import HybridGossipSub\n"
      "    from go_libp2p_pubsub_tpu.models.multitopic import MultiTopicGossipSub\n"
      "    from go_libp2p_pubsub_tpu.models.rlnc import RLNC\n"),
     ('                msg_window: int, override, device="cuda"):\n'
      "    from ..models.gossipsub import GossipSub\n"
      "    from ..models.hybrid import HybridGossipSub\n"
      "    from ..models.multitopic import MultiTopicGossipSub\n"
      "    from ..models.rlnc import RLNC\n")),
    ("                  msg_window=msg_window, index_dtype_override=override)\n",
     ("                  msg_window=msg_window, index_dtype_override=override,\n"
      "                  device=device)\n")),
    (('    raise ValueError(f"unknown model family: {name}")\n'
      "\n"
      "\n"),
     ('    raise ValueError(f"unknown model family: {name}")\n'
      "\n"
      "\n"
      "# Each family's state -> its numpy form's shapes and dtypes (the\n"
      "# reference's), without reading the device.\n"
      "STATE_SPEC = {\n"
      '    "gossipsub": bridge.state_spec,\n'
      '    "multitopic": bridge.multitopic_state_spec,\n'
      '    "hybrid": bridge.hybrid_state_spec,\n'
      '    "rlnc": bridge.rlnc_state_spec,\n'
      "}\n"
      "\n"
      "\n"
      "def _carried(leaf) -> Tuple[Tuple[int, ...], str]:\n"
      '    """(shape, dtype) of a state leaf as the port holds it (the round\n'
      '    counter is a host int)."""\n'
      "    if isinstance(leaf, torch.Tensor):\n"
      "        return tuple(leaf.shape), str(leaf.dtype)\n"
      "    return (), type(leaf).__name__\n"
      "\n"
      "\n")),
    ("                compile_rollout: bool) -> Dict[str, Any]:\n",
     '                compile_rollout: bool, device="cuda") -> Dict[str, Any]:\n'),
    (("    import jax\n"
      "\n"),
     ""),
    ("                           override)\n",
     ("                           override, device)\n"
      '        card = compile_rollout and name == "gossipsub" and arm == "narrow"\n'
      "        if card:\n"
      "            torch.cuda.synchronize(device)\n"
      "            before = torch.cuda.memory_allocated(device)\n")),
    (("        a = audit_state(st, n_peers)\n"
      "        # The rollout carry is exactly the state: eval_shape the public\n"
      "        # step (no compile, no execution) and assert every buffer keeps its\n"
      "        # shape AND dtype — the narrow planes stay narrow while resident.\n"
      "        stepped = jax.eval_shape(model.step, st)\n"),
     ("        if card:\n"
      "            torch.cuda.synchronize(device)\n"
      "            resident = torch.cuda.memory_allocated(device) - before\n"
      "        a = audit_state(STATE_SPEC[name](st), n_peers)\n"
      "        # The rollout carry is exactly the state: one real step of the\n"
      "        # public ``step`` on the device, and every buffer keeps its shape\n"
      "        # AND dtype — the narrow planes stay narrow while resident.\n"
      "        stepped = model.step(st)\n")),
    (("            assert pa == pb and la.shape == lb.shape and \\\n"
      "                np.dtype(la.dtype) == np.dtype(lb.dtype), (\n"
      '                    f"{name}/{arm}: step changes resident buffer {pa}: "\n'
      '                    f"{la.shape}/{la.dtype} -> {lb.shape}/{lb.dtype}"\n'
      "                )\n"),
     ("            assert pa == pb and _carried(la) == _carried(lb), (\n"
      '                f"{name}/{arm}: step changes resident buffer {pa}: "\n'
      '                f"{_carried(la)} -> {_carried(lb)}"\n'
      "            )\n"
      "        del stepped\n")),
    ('        if compile_rollout and name == "gossipsub" and arm == "narrow":\n',
     "        if card:\n"),
    (("            lowered = jax.jit(\n"
      "                lambda s: model.rollout(s, steps, record=False)[0]\n"
      "            ).lower(st)\n"
      "            mem = lowered.compile().memory_analysis()\n"),
     ("            torch.cuda.synchronize(device)\n"
      "            start = torch.cuda.memory_allocated(device)\n"
      "            torch.cuda.reset_peak_memory_stats(device)\n"
      "            model.rollout(st, steps, record=False)\n"
      "            torch.cuda.synchronize(device)\n"
      "            peak = torch.cuda.max_memory_allocated(device)\n")),
    (('                "argument_bytes": int(mem.argument_size_in_bytes),\n'
      '                "output_bytes": int(mem.output_size_in_bytes),\n'
      '                "temp_bytes": int(mem.temp_size_in_bytes),\n'
      '                "alias_bytes": int(mem.alias_size_in_bytes),\n'),
     ('                "init_allocated_rise_bytes": int(resident),\n'
      '                "rollout_peak_rise_bytes": int(peak - start),\n')),
    (("              msg_window: int, targets: List[int],\n"
      "              compile_rollout: bool) -> Dict[str, Any]:\n"),
     ("              msg_window: int, targets: List[int],\n"
      '              compile_rollout: bool, device="cuda") -> Dict[str, Any]:\n')),
    ("                              targets, compile_rollout)\n",
     "                              targets, compile_rollout, device)\n"),
    (('            print(f"  compiled rollout ({rm[\'rollout_steps\']} steps): "\n'
      '                  f"arg {_fmt_bytes(rm[\'argument_bytes\'])}, "\n'
      '                  f"temp {_fmt_bytes(rm[\'temp_bytes\'])}, "\n'
      '                  f"alias {_fmt_bytes(rm[\'alias_bytes\'])}")\n'),
     ('            print(f"  on the card: init allocated "\n'
      '                  f"{_fmt_bytes(rm[\'init_allocated_rise_bytes\'])}, "\n'
      '                  f"rollout ({rm[\'rollout_steps\']} steps) peak above its "\n'
      '                  f"start {_fmt_bytes(rm[\'rollout_peak_rise_bytes\'])}")\n')),
    (('                    help="also compile the gossipsub rollout and report "\n'
      '                         "XLA memory_analysis totals (slow)")\n'),
     ('                    help="also read the card\'s allocator over the gossipsub "\n'
      '                         "init and an 8-step rollout (CUDA devices only)")\n'
      '    ap.add_argument("--device", default="cuda",\n'
      '                    help="where the models are built and stepped (default "\n'
      '                         "cuda; cpu runs them on the CPU)")\n')),
    ("    args = ap.parse_args(argv)\n",
     ("    args = ap.parse_args(argv)\n"
      "    err = device_error(args.device)\n"
      "    if err is not None:\n"
      '        print(f"error: {err}", file=sys.stderr)\n'
      "        return 2\n"
      '    if args.compile and torch.device(args.device).type != "cuda":\n'
      '        ap.error("--compile reads the card\'s allocator: it needs a CUDA "\n'
      '                 "--device")\n')),
    ("                    args.window, targets, args.compile)\n",
     "                    args.window, targets, args.compile, args.device)\n"),
]


SUBSTITUTIONS = {
    "scenario_run": SCENARIO_RUN_SUBSTITUTIONS,
    "trace_view": TRACE_VIEW_SUBSTITUTIONS,
    "scenario_fuzz": SCENARIO_FUZZ_SUBSTITUTIONS,
    "coevolve": COEVOLVE_SUBSTITUTIONS,
    "mem_audit": MEM_AUDIT_SUBSTITUTIONS,
}


def assert_tool_copy(name, substitutions):
    """The port's tool ``name`` equals the reference tool after each
    (old, new) substitution replaces its one occurrence."""
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        ref = f.read()
    with open(os.path.join(REPO, "go_libp2p_pubsub_torch", "tools",
                           f"{name}.py")) as f:
        port = f.read()
    for old, new in substitutions:
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    assert port == ref


@pytest.mark.parametrize("name", sorted(SUBSTITUTIONS))
def test_tool_is_a_copy_of_the_reference(name):
    assert_tool_copy(name, SUBSTITUTIONS[name])
