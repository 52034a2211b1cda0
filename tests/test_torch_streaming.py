"""The port's streaming scenario plane held against the JAX package's: the
streaming plan (``compile_streaming_plan``, its fault and controller
lowerings and every refusal), the runner on the canon's four multitopic
streaming campaigns and on fault and controller compositions, the traced
crash run's span artifact, and a JAX-written snapshot with spans restored
in the port.

Both runners run under one stepping clock (``scenario/stream_canon.py``
replaces the runner's ``_SkewClock``), so every channel the runner does
not time with ``time.monotonic`` must be equal, with tolerance 0.

The committed trace (``go_libp2p_pubsub_torch/scenario/traces/
stream_canon.trace.json``) is the JAX package's runner over the four
campaigns; the card replays it.  To rewrite it after a deliberate change
of the reference:

    JAX_PLATFORMS=cpu python tests/test_torch_streaming.py --write
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from go_libp2p_pubsub_torch.scenario import stream_canon as C  # noqa: E402


def _reference():
    from go_libp2p_pubsub_tpu import scenario as jscn
    from go_libp2p_pubsub_tpu.scenario import streaming_runner as jrun
    from go_libp2p_pubsub_tpu.serve import StreamingEngine as JE

    return jscn, jrun, JE


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_streaming.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jscn, jrun, JE = _reference()
    C.write_trace(jrun, JE, jscn.build)
    sys.exit(0)


import torch  # noqa: E402

from go_libp2p_pubsub_torch import scenario as tscn  # noqa: E402
from go_libp2p_pubsub_torch.scenario import (  # noqa: E402
    streaming_runner as trun)
from go_libp2p_pubsub_torch.serve import StreamingEngine as TE  # noqa: E402

jscn, jrun, JE = _reference()

# The canon's streaming model (the fault runs share its chunk program).
_STREAM = dict(n_topics=2, n_peers=64, n_slots=16, conn_degree=8,
               msg_window=64, heartbeat_steps=4)
# The controller run's own model value: its unplanned-recompiles channel
# counts the programs of the model value, in each package's process.
_CTL_MODEL = dict(_STREAM, msg_window=48)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(doc):
    return json.loads(json.dumps(doc, sort_keys=True))


# ---------------------------------------------------------------------------
# the runner on the canon's multitopic streaming campaigns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", C.CAMPAIGNS)
def test_runner_matches_reference(name):
    """The port's runner against the JAX runner's document of the campaign
    (the committed trace, which the next test holds to a fresh JAX
    run)."""
    out, _ = C.capture(trun, TE, tscn.build(name), device="cpu")
    ref = C.load_trace()["campaigns"][name]
    assert C.mismatches(_json(out), ref) == []
    assert _json(out) == ref
    assert ref["verdict"]["passed"] and ref["chunks"]
    assert out["record"]["silent_drops"]["data"] == [0]


@pytest.mark.parametrize("name", C.CAMPAIGNS)
def test_committed_trace_is_the_reference_run(name):
    ref, _ = C.capture(jrun, JE, jscn.build(name))
    assert C.load_trace()["campaigns"][name] == _json(ref)


def test_port_replays_the_committed_trace():
    """What the card does with the trace, on the CPU."""
    assert C.port_replay("cpu") == {name: [] for name in C.CAMPAIGNS}


def test_mismatches_name_a_changed_channel():
    ref = C.load_trace()["campaigns"]["streaming_engine_crash_recovery"]
    doc = json.loads(json.dumps(ref))
    doc["record"]["queue_depth"]["data"][1] += 1
    doc["chunks"][2]["done"].pop()
    doc["verdict"]["criteria"][0]["passed"] ^= True
    assert C.mismatches(doc, ref) == [
        "verdict", "record.queue_depth", "chunk 2: done"]
    assert C.mismatches(ref, ref) == []


def test_crash_campaign_exercises_the_fault_path():
    ref = C.load_trace()["campaigns"]["streaming_engine_crash_recovery"]
    st = ref["engine_stats"]
    assert st["restores"] == st["watchdog_restarts"] == 1
    assert st["duplicate_completions"] == 0
    assert ref["record"]["lost_after_restart"]["data"] == [0]
    crit = {c["name"]: c for c in ref["verdict"]["criteria"]}
    assert crit["recovery_s"]["passed"] and "actual" not in crit["recovery_s"]
    vc = C.load_trace()["campaigns"]["streaming_verifier_crash"]
    assert vc["engine_stats"]["pipeline_restarts"] == 1
    assert vc["engine_stats"]["replay_deduped"] > 0


def _variant(name="t_stream", n_steps=24, workloads=None, slo=None,
             model=_STREAM, **streaming):
    cfg = {"streaming_only": True, "chunk_steps": 8, "capacity": 16,
           "policy": "block"}
    cfg.update(streaming)
    return dict(
        name=name, family="multitopic", n_steps=n_steps, seed=7,
        model=dict(model), streaming=cfg,
        workloads=workloads or [
            dict(kind="constant", topic=0, start=0, stop=n_steps, every=2),
            dict(kind="burst", topic=1, start=3, n_msgs=6)],
        slo=slo or dict(min_delivery_frac=0.9, max_silent_drops=0))


def _specs(d):
    """The same spec dict as each package's ScenarioSpec."""
    return (jscn.ScenarioSpec.from_dict(d), tscn.ScenarioSpec.from_dict(d))


_RUNS = {
    "stall_and_skew": _variant(
        capacity=32, pub_width=2,
        producer_stall={"start": 4, "steps": 6},
        clock_skew={"at_chunk": 2, "skew_s": -0.5},
        workloads=[dict(kind="constant", topic=0, start=0, stop=24,
                        every=2),
                   dict(kind="burst", topic=1, start=9, n_msgs=20)]),
    "controller_and_static_twins": _variant(
        model=_CTL_MODEL, n_steps=16, chunk_steps=4, pub_width=4, capacity=64,
        controller={"ladder": [[4, 4], [4, 8]],
                    "policy": {"cooldown_polls": 1}},
        compare_static=True,
        loss_regimes=[{"start_step": 8, "stop_step": 12, "delay": 1}],
        workloads=[dict(kind="burst", topic=0, start=0, n_msgs=40),
                   dict(kind="constant", topic=1, start=0, stop=16,
                        every=4)],
        slo=dict(min_delivery_frac=0.9, max_queue_depth=64,
                 min_controller_decisions=1, max_unplanned_recompiles=0)),
    "crash_with_forged": _variant(
        crash_at_chunk=1, snapshot_every=1,
        workloads=[dict(kind="constant", topic=0, start=0, stop=24,
                        every=2),
                   dict(kind="constant", topic=1, start=1, stop=24,
                        every=3, valid=False)],
        slo=dict(min_delivery_frac=0.5, max_lost_after_restart=0,
                 max_duplicate_deliveries=0, max_recovery_s=60.0)),
}


@pytest.mark.parametrize("case", sorted(_RUNS))
def test_fault_and_controller_runs_match_reference(case):
    js, ts = _specs(_RUNS[case])
    ref, _ = C.capture(jrun, JE, js)
    out, _ = C.capture(trun, TE, ts, device="cpu")
    assert C.mismatches(_json(out), _json(ref)) == []
    assert _json(out) == _json(ref)
    if case == "controller_and_static_twins":
        assert ref["record"]["controller_decisions"]["data"][0] >= 1
        assert ref["record"]["unplanned_recompiles"]["data"] == [0]
        assert "p99_vs_best_static_ratio" in ref["record"]
    if case == "stall_and_skew":
        assert ref["engine_stats"]["clock_anomalies"] > 0
        assert ref["n_publishes"] == out["n_publishes"] > 0


def _strip_timed(doc):
    """A span artifact without what the runner or the pipeline times with
    ``time.monotonic`` (the recovery wall, the verify walls)."""
    doc = dict(doc)
    doc.pop("recovery_s")
    doc["metrics_prometheus"] = "\n".join(
        ln for ln in doc["metrics_prometheus"].splitlines()
        if "verify_s" not in ln)
    doc["blackbox"] = dict(doc["blackbox"], frames=[
        {k: v for k, v in f.items() if k != "verify_s"}
        for f in doc["blackbox"]["frames"]])
    doc["verdict"] = dict(doc["verdict"], criteria=[
        {k: v for k, v in c.items()
         if not (c["name"] == "recovery_s" and k == "actual")}
        for c in doc["verdict"]["criteria"]])
    return doc


def test_traced_crash_run_writes_the_references_artifact(tmp_path):
    """``trace_out=`` on the crash campaign: the same spans, events,
    Chrome trace, OTLP record, black-box frames and post-mortem, every
    sampled span closed and the reopened ones annotated with the gap."""
    name = "streaming_engine_crash_recovery"
    docs = []
    for runner, eng_cls, scn, kw in ((jrun, JE, jscn, {}),
                                     (trun, TE, tscn, {"device": "cpu"})):
        path = str(tmp_path / f"{runner.__name__}.json")
        C.capture(runner, eng_cls, scn.build(name), trace_out=path, **kw)
        with open(path) as f:
            art = json.load(f)
        with open(path + ".postmortem.json") as f:
            post = json.load(f)
        post["extra"]["restore_info"].pop("recovery_gap_s", None)
        docs.append((_strip_timed(art), post["extra"], len(post["frames"])))
    (ja, jp, jn), (ta, tp, tn) = docs
    assert ta == ja and tp == jp and tn == jn
    assert ta["summary"]["open"] == 0 and ta["summary"]["spans"] > 0
    reopened = [s for s in ta["spans"]
                if any(e["name"] == "crash_recovery" for e in s["events"])]
    assert reopened and all(s["closed"] for s in reopened)
    assert all(e["gap_s"] >= 0 for s in reopened for e in s["events"])
    assert ta["summary"]["events"]["engine_restart"] == 1


def test_results_carry_the_references_fields():
    js, ts = _specs(_RUNS["stall_and_skew"])
    a = C.capture(jrun, JE, js)[0]
    fields = [f.name for f in dataclasses.fields(trun.StreamingScenarioResult)]
    assert fields == [f.name for f in dataclasses.fields(
        jrun.StreamingScenarioResult)]
    assert sorted(a["engine_stats"]) == sorted(C.STATS)
    assert math.isfinite(float.fromhex(
        a["record"]["ingest_lat_p99_s"]["data"][0]))


# ---------------------------------------------------------------------------
# the streaming plan
# ---------------------------------------------------------------------------


def _plan_doc(plan):
    d = dataclasses.asdict(plan)
    d["spec"] = plan.spec.to_dict()
    return _json(d)


_PLANS = {
    "stall": dict(producer_stall={"start": 2, "steps": 5}),
    "skew": dict(clock_skew={"at_chunk": 3, "skew_s": 2.5}),
    "crash": dict(crash_at_chunk=2),
    "crash_every_2": dict(crash_at_chunk=3, snapshot_every=2),
    "verifier": dict(verifier_crash_at_chunk=1),
    "pub_width": dict(pub_width=3, completion_frac=0.5, capacity=40),
    "controller": dict(controller={"ladder": [[8, 2], [8, 4], [16, 1]],
                                   "policy": {"carry_up_chunks": 3}},
                       compare_static=True),
    "regimes": dict(loss_regimes=[
        {"start_step": 0, "stop_step": 4, "delay": 2},
        {"start_step": 6, "stop_step": 9}]),
}


@pytest.mark.parametrize("name", list(C.CAMPAIGNS) + sorted(_PLANS))
def test_plans_match_reference(name):
    if name in _PLANS:
        js, ts = _specs(_variant(**_PLANS[name]))
    else:
        js, ts = jscn.build(name), tscn.build(name)
    assert _plan_doc(tscn.compile_streaming_plan(ts)) == _plan_doc(
        jscn.compile_streaming_plan(js))
    assert trun.streaming_supported(ts) == jrun.streaming_supported(js)


_REFUSED = {
    "crash_range": dict(crash_at_chunk=9),
    "verifier_range": dict(verifier_crash_at_chunk=0),
    "stall_end": dict(producer_stall={"start": 20, "steps": 4}),
    "stall_steps": dict(producer_stall={"start": 2}),
    "skew_range": dict(clock_skew={"at_chunk": 4}),
    "snapshot_negative": dict(snapshot_every=-1),
    "crash_no_snapshot": dict(crash_at_chunk=1, snapshot_every=0),
    "static_without_controller": dict(compare_static=True),
    "ladder_base": dict(controller={"ladder": [[4, 2]]}),
    "ladder_empty": dict(controller={"ladder": []}),
    "controller_key": dict(controller={"ladder": [[8, 2]], "x": 1}),
    "controller_policy": dict(controller={"ladder": [[8, 2]],
                                          "policy": {"nope": 1}}),
    "regime_delay": dict(loss_regimes=[{"start_step": 1, "delay": 0}]),
    "regime_window": dict(loss_regimes=[{"start_step": 5, "stop_step": 3}]),
    "regime_order": dict(loss_regimes=[{"start_step": 4, "stop_step": 8},
                                       {"start_step": 6, "stop_step": 9}]),
    "loss_on_multitopic": dict(loss={"delay": 2}),
    "loss_delay": dict(loss={"delay": 0}),
    "oscillate_on_multitopic": dict(loss_oscillate={"period_chunks": 1}),
    "oscillate_period": dict(loss_oscillate={"period_chunks": 0}),
    "loss_and_oscillate": dict(loss={"delay": 2},
                               loss_oscillate={"delay": 2}),
    "loss_and_regimes": dict(loss={"delay": 2},
                             loss_regimes=[{"start_step": 1}]),
    "eager_on_multitopic": dict(compare_eager=True),
    "topic_range": dict(workloads=[dict(kind="burst", topic=5, start=0)]),
    "publisher_range": dict(
        workloads=[dict(kind="burst", topic=0, start=0, src=64)]),
}


@pytest.mark.parametrize("name", sorted(_REFUSED))
def test_plan_refusals_match_reference(name):
    kw = dict(_REFUSED[name])
    d = _variant(workloads=kw.pop("workloads", None), **kw)
    js, ts = _specs(d)
    with pytest.raises(ValueError) as je:
        jscn.compile_streaming_plan(js)
    with pytest.raises(ValueError) as te:
        tscn.compile_streaming_plan(ts)
    assert str(te.value) == str(je.value)


def test_non_streaming_families_and_components_refused_as_reference():
    churned = next(n for n in jscn.CANON if jscn.build(n).churn)

    def with_churn(scn):
        return dataclasses.replace(scn.build("multitopic_hot_publisher"),
                                   churn=scn.build(churned).churn)

    for make in (lambda scn: scn.build("steady_state"), with_churn):
        with pytest.raises(ValueError) as je:
            jscn.compile_streaming_plan(make(jscn))
        with pytest.raises(ValueError) as te:
            tscn.compile_streaming_plan(make(tscn))
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["streaming_degraded_links",
                                  "streaming_rlnc_crash_recovery",
                                  "streaming_drifting_load"])
def test_hybrid_streaming_specs_raise_naming_a9(name):
    """The coded plane (ROADMAP A9) is ported: the hybrid campaigns' plans
    lower as the reference's, and the runner builds the hybrid model (a
    ``peer_uid`` still raises, naming A10)."""
    assert jscn.compile_streaming_plan(jscn.build(name)).spec.family == \
        "hybrid"
    assert _plan_doc(tscn.compile_streaming_plan(tscn.build(name))) == \
        _plan_doc(jscn.compile_streaming_plan(jscn.build(name)))
    spec = tscn.build(name)
    uid = dataclasses.replace(spec, model=dict(
        spec.model, peer_uid=list(range(spec.model["n_peers"]))))
    with pytest.raises(tscn.StreamingPlaneError, match="ROADMAP A10"):
        tscn.run_streaming_scenario(uid, device="cpu")


def test_cuda_runner_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(tscn.StreamingPlaneError, match="model build"):
        tscn.run_streaming_scenario(tscn.build("streaming_steady"))


# ---------------------------------------------------------------------------
# spans across packages
# ---------------------------------------------------------------------------


def test_jax_snapshot_with_spans_restores_in_the_port(tmp_path):
    """A snapshot the JAX engine wrote with a span ledger restores into the
    port's engine with its spans, and the recovery gap annotates the same
    reopened spans; both then close every span alike."""
    from go_libp2p_pubsub_torch.models.multitopic import (
        MultiTopicGossipSub as TM)
    from go_libp2p_pubsub_torch.obs import SpanLedger
    from go_libp2p_pubsub_torch.serve import IngestRing
    from go_libp2p_pubsub_torch.serve import stream_trace as S
    from go_libp2p_pubsub_tpu.models.multitopic import (
        MultiTopicGossipSub as JM)
    from go_libp2p_pubsub_tpu.obs import SpanLedger as JL
    from go_libp2p_pubsub_tpu.serve import IngestRing as JR

    path = str(tmp_path / "jax.ckpt")

    def pair(Model, Ring, Engine, Ledger, clock, **kw):
        led = Ledger(sample_n=1, clock=clock)
        ring = Ring(capacity=16, policy="block", clock=clock, tracer=led)
        eng = Engine(Model(**_STREAM, **kw), ring, chunk_steps=8,
                     pub_width=2, clock=clock, tracer=led,
                     snapshot_path=path)
        eng.warmup()
        return eng, ring, led

    jc = S.SteppingClock()
    je, jring, jled = pair(JM, JR, JE, JL, jc)
    for i in range(10):
        jring.push(topic=i % 2, payload=b"span %d" % i, publisher=i)
    je.run_chunk()
    je.snapshot()
    assert jled.n_open > 0
    t_crash = jc.t + 5.0

    out = []
    for Model, Ring, Engine, Ledger, kw in (
            (JM, JR, JE, JL, {}), (TM, IngestRing, TE, SpanLedger,
                                   {"device": "cpu"})):
        clock = S.SteppingClock()
        eng, ring, led = pair(Model, Ring, Engine, Ledger, clock, **kw)
        clock.t = t_crash
        eng.recovery_context = {"tier": "normal", "reason": "test crash"}
        info = eng.restore(path)
        reopened = sum(1 for s in led.spans() if any(
            e["name"] == "crash_recovery" for e in s["events"]))
        eng.run_until_drained()
        out.append((_json(led.snapshot()), reopened, info["replayed"],
                    eng.latencies_s, led.n_open))
    assert out[1] == out[0]
    assert out[1][1] > 0 and out[1][4] == 0


def test_engine_snapshot_meta_carries_the_ledger(tmp_path):
    from go_libp2p_pubsub_torch.models.multitopic import (
        MultiTopicGossipSub as TM)
    from go_libp2p_pubsub_torch.obs import SpanLedger
    from go_libp2p_pubsub_torch.serve import IngestRing
    from go_libp2p_pubsub_torch.utils import checkpoint

    led = SpanLedger(sample_n=2)
    ring = IngestRing(capacity=8, tracer=led)
    path = str(tmp_path / "e.ckpt")
    eng = TE(TM(device="cpu", **_STREAM), ring, chunk_steps=8, pub_width=2,
             tracer=led, snapshot_path=path)
    eng.warmup()
    for i in range(6):
        ring.push(topic=i % 2, payload=b"meta %d" % i, publisher=i)
    eng.run_chunk()
    eng.snapshot()
    meta = checkpoint.meta(path)
    assert meta["spans"] == _json(led.snapshot())
    assert np.isfinite(meta["t_wall"])
