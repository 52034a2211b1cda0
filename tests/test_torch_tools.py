"""The tools on the port (``go_libp2p_pubsub_torch/tools/``) against the
JAX package's (``tools/``).

The port's tools keep the reference tools' flags (plus ``--device``),
output and exit codes.  What the reference tools print for a fixed set of
runs is committed as data, ``go_libp2p_pubsub_torch/tools/traces/
reference_tools.json``, written by the JAX tools on the CPU: the
``--json`` verdicts of three small canon campaigns, the fuzzer's first 8
seed-0 sim samples, the four samplers' digests at indices 0-63, the
co-evolution smoke's audit (archive paths relative to the archive
directory), whether each of the 11 archived co-evolution reds
(``tests/golden/coevolve_red_s0_*.json``) is red under the standing and
under the promoted defense, and ``mem_audit --json`` at its defaults.  The tier-1 tests
hold the port, on the CPU, to that file (the JAX loops are too slow to
run again in tier 1); the ``slow`` one regenerates it with the JAX tools
(a few minutes of CPU) and asserts it is the committed file byte for
byte.  To rewrite it after a deliberate change of the reference:

    JAX_PLATFORMS=cpu python tests/test_torch_tools.py --write

The cheap comparisons run both packages' tools side by side: the option
strings, the samplers, ``scenario_run --list`` and ``trace_view`` (the
reference tool in a subprocess) on artifacts the port wrote.
"""

import argparse
import contextlib
import glob
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from go_libp2p_pubsub_torch.tools import coevolve as p_coevolve  # noqa: E402
from go_libp2p_pubsub_torch.tools import mem_audit as p_mem  # noqa: E402
from go_libp2p_pubsub_torch.tools import scenario_fuzz as p_fuzz  # noqa: E402
from go_libp2p_pubsub_torch.tools import scenario_run as p_run  # noqa: E402
from go_libp2p_pubsub_torch.tools import trace_view as p_view  # noqa: E402

REFERENCE_PATH = os.path.join(
    REPO, "go_libp2p_pubsub_torch", "tools", "traces", "reference_tools.json")
GOLDEN = os.path.join(REPO, "tests", "golden")
CPU = ["--device", "cpu"]

# Small sim canon campaigns whose --json verdicts are committed.
VERDICT_CAMPAIGNS = ("steady_state", "flash_crowd",
                     "fuzz_regression_cold_boot")
FUZZ_BUDGET = 8          # the fuzzer's first seed-0 sim samples
SAMPLER_INDICES = 64
# tests/test_coevolve.py's two-iteration smoke.
COEVOLVE_ARGS = [
    "--budget", "2", "--seed", "0",
    "--attack-budget", "1", "--defense-probes", "2",
    "--fresh-budget", "1",
    "--shallow-gate", "--no-shrink", "--no-realism",
    "--quick-gate", "--gate-battery", "1",
    "--no-quick-battery", "--dry-run",
]
ARCHIVED_REDS = tuple(sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(GOLDEN, "coevolve_red_s0_*.json"))))
# tests/test_coevolve.py's pins; its first flips in the reference.
PINNED_REDS = ("coevolve_red_s0_i0008.json", "coevolve_red_s0_i0009.json",
               "coevolve_red_s0_i0012.json")
# bench.py phase_breakdown's names, in the order it returns them.
PHASE_NAMES = ("propagate", "heartbeat", "hb_scores", "hb_mesh", "hb_px",
               "hb_prologue_unfused", "hb_prologue_fused", "hb_gossip",
               "hb_fanout", "round_amortized")


def _reference(name: str):
    """The JAX package's tool ``tools/<name>.py`` (imports JAX)."""
    return importlib.import_module(f"tools.{name}")


def _call(main, argv):
    """(exit code, stdout, stderr) of a tool's ``main(argv)`` in process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


# -- what the reference tools print (the committed document's sections) ----

def verdicts(main, extra=()) -> list:
    """``scenario_run --json`` of VERDICT_CAMPAIGNS, ``seconds`` dropped."""
    rc, out, _ = _call(main, ["--json", *VERDICT_CAMPAIGNS, *extra])
    assert rc == 0
    doc = json.loads(out)
    for entry in doc:
        entry.pop("seconds")
    return doc


def fuzz_hunt(main, budget: int, extra=()) -> dict:
    """``scenario_fuzz --json``'s document for the first ``budget`` seed-0
    sim samples."""
    rc, out, _ = _call(main, ["--budget", str(budget), "--seed", "0",
                              "--json", *extra])
    assert rc == 0
    return json.loads(out)


def sampler_digests(fuzz) -> dict:
    """Each sampler's draws at indices 0..SAMPLER_INDICES-1, by digest."""
    return {
        "sim": [fuzz._digest(fuzz.sample_spec(0, i, fuzz.STANDING_DEFENSE))
                for i in range(SAMPLER_INDICES)],
        "streaming": [fuzz._digest(fuzz.sample_streaming_spec(0, i))
                      for i in range(SAMPLER_INDICES)],
        "live": [fuzz._digest(fuzz.sample_live_spec(0, i))
                 for i in range(SAMPLER_INDICES)],
        "defense": [fuzz.defense_digest(fuzz.sample_defense(0, i))
                    for i in range(SAMPLER_INDICES)],
    }


def coevolve_audit(main, extra=()) -> dict:
    """The two-iteration smoke's audit document, its archive paths written
    relative to the archive directory."""
    with tempfile.TemporaryDirectory() as tmp:
        archive = os.path.join(tmp, "golden")
        audit = os.path.join(tmp, "audit.json")
        rc, _, _ = _call(main, [*COEVOLVE_ARGS, "--archive-dir", archive,
                                "--audit", audit, "--json", *extra])
        assert rc == 0
        with open(audit) as f:
            return json.loads(f.read().replace(archive + os.sep, ""))


def archived(name: str, spec_cls):
    with open(os.path.join(GOLDEN, name)) as f:
        return spec_cls.from_json(f.read())


def archive_grades(coevolve, scenario, names=ARCHIVED_REDS,
                   **device) -> dict:
    """{archived red: {"standing": red?, "promoted": red?}}."""
    return {name: {
        side: bool(coevolve.red_under(archived(name, scenario.ScenarioSpec),
                                      defense, **device))
        for side, defense in (("standing", scenario.STANDING_DEFENSE),
                              ("promoted", scenario.PROMOTED_DEFENSE))}
        for name in names}


def mem_audit_doc(main, extra=()) -> dict:
    rc, out, _ = _call(main, ["--json", *extra])
    assert rc == 0
    return json.loads(out)


def reference_document() -> dict:
    """Run the JAX package's tools on the CPU -> the committed document."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from go_libp2p_pubsub_tpu import scenario as jax_scenario

    fuzz, coevolve = _reference("scenario_fuzz"), _reference("coevolve")
    return {
        "verdicts": verdicts(_reference("scenario_run").main),
        "fuzz": fuzz_hunt(fuzz.main, FUZZ_BUDGET),
        "samplers": sampler_digests(fuzz),
        "coevolve_audit": coevolve_audit(coevolve.main),
        "archive": archive_grades(coevolve, jax_scenario),
        "mem_audit": mem_audit_doc(_reference("mem_audit").main),
    }


def write_reference(path: str) -> None:
    doc = reference_document()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


@pytest.fixture(scope="module")
def committed() -> dict:
    with open(REFERENCE_PATH) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- flags ----------------------------------------------------------------

class _Parsed(Exception):
    pass


def _option_strings(main) -> list:
    """Every option string of the parser ``main`` builds."""
    seen = []

    def capture(parser, *a, **kw):
        seen.append(parser)
        raise _Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return [s for a in seen[0]._actions for s in a.option_strings]


@pytest.mark.parametrize("name,port,device", [
    ("scenario_run", p_run, True), ("trace_view", p_view, False),
    ("scenario_fuzz", p_fuzz, True), ("coevolve", p_coevolve, True),
    ("mem_audit", p_mem, True)])
def test_options_are_the_reference_tools_plus_device(name, port, device):
    want = _option_strings(_reference(name).main)
    assert _option_strings(port.main) == want + ["--device"] * device


def test_tools_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.path.insert(0, sys.argv[1]); "
        "import go_libp2p_pubsub_torch.tools.scenario_run, "
        "go_libp2p_pubsub_torch.tools.trace_view, "
        "go_libp2p_pubsub_torch.tools.scenario_fuzz, "
        "go_libp2p_pubsub_torch.tools.coevolve, "
        "go_libp2p_pubsub_torch.tools.mem_audit, "
        "go_libp2p_pubsub_torch.profile_rollout, "
        "go_libp2p_pubsub_torch.utils.trace; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'go_libp2p_pubsub_tpu', 'tools') "
        "and sys.modules[m] is not None]; "
        "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code, REPO],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_no_card_stops_every_tool_before_it_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((p_run.main, ["steady_state"]),
                       (p_fuzz.main, ["--budget", "1"]),
                       (p_coevolve.main, COEVOLVE_ARGS),
                       (p_mem.main, ["--json"])):
        rc, out, err = _call(main, argv)
        assert rc == 2 and out == "" and "CUDA is not available" in err


# -- the fuzzer -------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["sample_spec", "sample_streaming_spec",
                                     "sample_live_spec", "sample_defense"])
def test_samplers_are_the_reference_tools(sampler, committed):
    ref = _reference("scenario_fuzz")
    args = (ref.STANDING_DEFENSE,) if sampler == "sample_spec" else ()
    for i in range(SAMPLER_INDICES):
        a = getattr(ref, sampler)(0, i, *args)
        b = getattr(p_fuzz, sampler)(0, i, *args)
        if sampler == "sample_defense":
            assert json.dumps(a, sort_keys=True) == \
                json.dumps(b, sort_keys=True)
        else:
            assert a.to_json() == b.to_json()
    key = {"sample_spec": "sim", "sample_streaming_spec": "streaming",
           "sample_live_spec": "live", "sample_defense": "defense"}[sampler]
    assert sampler_digests(p_fuzz)[key] == committed["samplers"][key]


def test_grade_cold_boot_red_is_red_on_final_attacker_score():
    with open(os.path.join(GOLDEN, "fuzz_red_cold_boot.json")) as f:
        spec = p_fuzz.ScenarioSpec.from_json(f.read())
    status, verdict, failed = p_fuzz._grade(spec, device="cpu")
    assert status == "red" and set(failed) == {"final_attacker_score"}


def test_first_fuzz_samples_are_the_committed_trajectory(committed):
    doc = fuzz_hunt(p_fuzz.main, 5, CPU)
    assert doc["trajectory"] == committed["fuzz"]["trajectory"][:5]


def _failing_run(monkeypatch, fail):
    """Every sim campaign of the fuzzer calls ``fail()`` instead of
    running."""
    def run(spec, trace_out=None, device="cuda"):
        fail()

    monkeypatch.setattr(p_fuzz.scenario, "run_scenario", run)
    return p_fuzz.sample_spec(0, 0, p_fuzz.STANDING_DEFENSE)


def test_device_failure_is_raised_not_graded_invalid(monkeypatch):
    """A kernel's launch status (``cuda_build.raise_on``)."""
    from go_libp2p_pubsub_torch.ops import cuda_build

    spec = _failing_run(
        monkeypatch, lambda: cuda_build.raise_on(700, "gossip_propagate"))
    with pytest.raises(RuntimeError, match="CUDA error"):
        p_fuzz._grade(spec, device="cpu")


def test_kernel_build_failure_stops_the_hunt(monkeypatch, tmp_path):
    """nvcc fails to build K1/K2's library: the error propagates out of
    ``_grade`` and out of the fuzzer's ``main``; nothing is graded."""
    from go_libp2p_pubsub_torch.ops import cuda_build, cuda_gossip

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_gossip, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(cuda_gossip, "_lib", None)
    spec = _failing_run(monkeypatch, cuda_gossip._load)
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc failed"):
        p_fuzz._grade(spec, device="cpu")
    with pytest.raises(cuda_build.KernelBuildError, match="no sm_90a"):
        _call(p_fuzz.main, ["--budget", "1", "--seed", "0", "--json", *CPU])
    with pytest.raises(cuda_build.KernelBuildError):
        p_coevolve.red_under(spec, p_fuzz.STANDING_DEFENSE, device="cpu")


def test_kernel_input_check_and_torch_device_errors_are_raised(monkeypatch):
    """A wrapper's input check (a ValueError raised in ``ops/cuda_*``) and
    torch's own device error are the device's, whatever their text."""
    from go_libp2p_pubsub_torch.ops import cuda_gossip

    def wrong_device():
        cuda_gossip._check("nbrs", torch.zeros(2, dtype=torch.int32),
                           torch.int32, (2,), torch.device("cuda", 0))

    spec = _failing_run(monkeypatch, wrong_device)
    with pytest.raises(ValueError, match="nbrs: on cpu, expected cuda:0"):
        p_fuzz._grade(spec, device="cpu")

    def fault():
        raise torch.AcceleratorError("an illegal memory access")

    spec = _failing_run(monkeypatch, fault)
    with pytest.raises(torch.AcceleratorError):
        p_fuzz._grade(spec, device="cpu")


def test_a_spec_the_compiler_refuses_grades_invalid():
    import dataclasses

    spec = p_fuzz.sample_spec(0, 0, p_fuzz.STANDING_DEFENSE)
    wave = dataclasses.replace(spec.attacks[0], target=10**6)
    spec = dataclasses.replace(spec, attacks=[wave, *spec.attacks[1:]])
    assert p_fuzz._grade(spec, device="cpu") == (
        "invalid", None, [f"{wave.kind} target 1000000 out of range"])


# -- co-evolution -----------------------------------------------------------

def test_coevolve_smoke_is_the_committed_audit(committed):
    assert coevolve_audit(p_coevolve.main, CPU) == committed["coevolve_audit"]


def test_a_pinned_red_flips_with_the_promoted_defense(committed):
    name = PINNED_REDS[0]
    got = archive_grades(p_coevolve, p_fuzz.scenario, (name,), device="cpu")
    assert got[name] == {"standing": True, "promoted": False}
    assert got[name] == committed["archive"][name]


@pytest.mark.slow
@pytest.mark.parametrize("name", ARCHIVED_REDS)
def test_archived_reds_grade_as_the_reference_grades_them(name, committed):
    """Red or green under each defense as the JAX package grades them.
    There, i0009 (a pin) stays red under the promoted defense and i0004,
    i0010 and i0011 are green under the standing one."""
    got = archive_grades(p_coevolve, p_fuzz.scenario, (name,), device="cpu")
    assert got[name] == committed["archive"][name]


def test_the_archive_holds_eleven_reds(committed):
    assert len(ARCHIVED_REDS) == 11
    assert sorted(committed["archive"]) == list(ARCHIVED_REDS)


# -- scenario_run -----------------------------------------------------------

@pytest.mark.parametrize("argv", [["--list"], ["--list", "--plane", "live"],
                                  ["--list", "--family", "rlnc"]])
def test_list_prints_the_reference_text(argv):
    assert _call(p_run.main, argv) == _call(
        _reference("scenario_run").main, argv)


def test_json_verdicts_are_the_committed_ones(committed):
    assert verdicts(p_run.main, CPU) == committed["verdicts"]


def test_exit_codes_red_and_plane_failure(monkeypatch):
    # A --spec runs beside the named canon campaigns, or beside the whole
    # canon when none is named (the reference's rule, live-only ones too).
    rc, out, _ = _call(p_run.main, [
        "--json", "--spec", os.path.join(GOLDEN, "fuzz_red_cold_boot.json"),
        "steady_state", *CPU])
    red, green = json.loads(out)
    assert rc == 1 and not red["passed"] and green["passed"]
    assert {c["name"] for c in red["criteria"]
            if not c["passed"]} == {"final_attacker_score"}

    def refuse(*a, **kw):
        raise p_run.scenario.StreamingPlaneError("no engine")

    monkeypatch.setattr(p_run.scenario, "run_streaming_scenario", refuse)
    rc, out, err = _call(p_run.main, ["--plane", "streaming",
                                      "streaming_steady", *CPU])
    assert rc == 2 and out == "" and err == "error: no engine\n"


def test_save_trace_then_replay_is_exact(tmp_path):
    path = str(tmp_path / "steady.trace.json")
    assert _call(p_run.main, ["steady_state", "--save-trace", path,
                              *CPU])[0] == 0
    rc, out, _ = _call(p_run.main, ["--replay", path, *CPU])
    assert rc == 0 and out == f"PASS  replay {path}: EXACT\n"


# -- trace_view -------------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Observability artifacts the port's scenario_run writes on the CPU:
    a sim record trace, a streaming span artifact and a traced live run's
    per-host ledgers."""
    d = tmp_path_factory.mktemp("artifacts")
    out = {"sim": str(d / "sim.json"), "streaming": str(d / "stream.json"),
           "merge": str(d / "live.spans")}
    for argv in (["steady_state", "--trace-out", out["sim"], *CPU],
                 ["--plane", "streaming", "streaming_steady", "--trace-out",
                  out["streaming"], *CPU],
                 ["--plane", "live", "steady_state", "--live-hosts", "4",
                  "--live-step-ms", "20", "--trace-out",
                  str(d / "live.json")]):
        assert _call(p_run.main, argv)[0] == 0
    bad = d / "unknown.json"
    bad.write_text(json.dumps({"format": "obs-unknown/9"}))
    out["unknown"] = str(bad)
    return out


def _reference_view(argv):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_view.py"), *argv],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("kind", ["sim", "streaming", "merge", "unknown"])
def test_trace_view_prints_what_the_reference_tool_prints(kind, artifacts):
    path = artifacts[kind]
    for argv in ([path, "--json"], [path]):
        if kind == "merge":
            argv = ["--merge", *argv]
        assert _call(p_view.main, argv) == _reference_view(argv)


def test_merge_summary_is_the_runners_merged_json(artifacts):
    d = artifacts["merge"]
    _, merged, _ = _call(p_view.main, ["--merge", d, "--json"])
    _, runner, _ = _call(p_view.main, [os.path.join(d, "merged.json"),
                                       "--json"])
    merged, runner = json.loads(merged), json.loads(runner)
    # The runner names the campaign and adds its verdict; the re-merge of
    # the host files knows neither.
    assert merged.pop("scenario") is None and merged.pop("passed") is None
    assert runner.pop("scenario") == "steady_state"
    runner.pop("passed")
    assert merged == runner


# -- mem_audit --------------------------------------------------------------

def test_mem_audit_classifies_every_field_as_the_reference():
    """The same plane for every field name (the other families' fields
    outside the table, such as the multi-topic ``keys``, land in "misc"
    in both), and every ``GossipState`` field classified explicitly."""
    from go_libp2p_pubsub_torch.models.gossipsub import GossipState

    assert p_mem.PLANE_BY_FIELD == _reference("mem_audit").PLANE_BY_FIELD
    for f in GossipState._fields:
        assert f in p_mem.PLANE_BY_FIELD, f


def test_mem_audit_at_its_defaults_is_the_committed_document(committed):
    assert mem_audit_doc(p_mem.main, CPU) == committed["mem_audit"]


def test_carry_check_fails_a_step_that_changes_a_dtype(monkeypatch):
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub

    step = GossipSub.step

    def widened(self, st):
        st = step(self, st)
        return st._replace(fanout_age=st.fanout_age.to(torch.int64))

    audit = lambda: p_mem.audit_model(  # noqa: E731
        "gossipsub", 96, 8, 4, 8, [1000], False, "cpu")
    assert audit()["narrow"]["n_peers"] == 96
    monkeypatch.setattr(GossipSub, "step", widened)
    with pytest.raises(AssertionError, match="fanout_age"):
        audit()


# -- StepTimer, profiler capture, the phase split ---------------------------

def test_step_timer_is_the_references(monkeypatch):
    from go_libp2p_pubsub_tpu.utils.trace import StepTimer as JaxTimer

    from go_libp2p_pubsub_torch.utils.trace import StepTimer

    def run(cls):
        clock = iter([10.0, 10.5, 10.75, 11.0, 11.125, 12.0, 12.5])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        timer = cls()
        for name in ("propagate", "heartbeat", "propagate"):
            with timer(name):
                timer.fence(torch.zeros(2) if cls is StepTimer else None)
        return timer.samples, timer.events, timer.stats(), \
            timer.export_chrome_trace()

    assert run(StepTimer) == run(JaxTimer)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    from go_libp2p_pubsub_torch.utils.trace import profiler_trace

    with profiler_trace(None):
        pass
    assert os.listdir(tmp_path) == []
    with profiler_trace(str(tmp_path / "p"), "cpu", "t.json"):
        torch.ones(8).sum()
    with open(tmp_path / "p" / "t.json") as f:
        assert "traceEvents" in json.load(f)


def test_phases_print_phase_breakdowns_names(tmp_path):
    from go_libp2p_pubsub_torch import profile_rollout

    trace = str(tmp_path / "phases.json")
    rc, out, _ = _call(profile_rollout.main, [
        "--phases", "--device", "cpu", "--peers", "96", "--trace-out",
        trace])
    assert rc is None
    lines = out.splitlines()
    assert lines[0] == "device: cpu  n=96  kernel=plain"
    assert tuple(line.split()[0] for line in lines[2:]) == PHASE_NAMES
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert names == set(PHASE_NAMES[:-1]) | {"round_cycle"}


@pytest.mark.slow
def test_committed_reference_is_what_the_jax_tools_write(tmp_path):
    path = str(tmp_path / "reference_tools.json")
    write_reference(path)
    with open(path, "rb") as f, open(REFERENCE_PATH, "rb") as g:
        assert f.read() == g.read()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_tools.py --write")
    write_reference(REFERENCE_PATH)
    with open(REFERENCE_PATH) as f:
        print(json.dumps(json.load(f)["fuzz"]["summary"]))
