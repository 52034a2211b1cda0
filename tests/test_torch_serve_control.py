"""The port's control and fault layers of the serving plane held against
the JAX package's: the watchdog, the controller, the span ledger and the
black box.

Each case below is one of the reference's own tests (``tests/
test_crash_safety.py``, ``tests/test_controller.py``, ``tests/
test_obs.py``), written once over a namespace of one package's classes.
It runs on both packages under the same fake clock and returns what it
observed -- restart counts, tier logs, ring accounting, decision lists,
``controls()``, gauges, Prometheus text, ledger snapshots, Chrome and
OTLP exports, black-box dumps -- and the two observations must be equal,
exactly.  The reference's assertions inside each case hold on both.  The
copied modules are pinned to their originals.
"""

import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# One model value of this file's own for every engine (the prepared
# programs and the reference's jit cache are shared per model value and
# counted by ``compile_cache_size``), run only at the ladder's geometries,
# so each package prepares the three rungs once a process.
_MODEL = dict(n_topics=2, n_peers=16, n_slots=8, conn_degree=4,
              msg_window=18, heartbeat_steps=4)
_CHUNK = dict(chunk_steps=6, pub_width=2)
_LADDER = [(6, 2), (6, 4), (12, 1)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of small ops: one intra-op thread per test worker keeps
    them from spinning against each other's pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _namespace(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        from go_libp2p_pubsub_tpu.models.multitopic import MultiTopicGossipSub
        from go_libp2p_pubsub_tpu.obs import (
            STAGES, BlackBox, SpanLedger, build_span_artifact, content_hash)
        from go_libp2p_pubsub_tpu.serve import (
            Controller, ControllerPolicy, IngestRing, StreamingEngine,
            Watchdog)
        from go_libp2p_pubsub_tpu.utils.metrics import MetricsRegistry

        def model(**kw):
            return MultiTopicGossipSub(**kw)
    else:
        from go_libp2p_pubsub_torch.models.multitopic import (
            MultiTopicGossipSub)
        from go_libp2p_pubsub_torch.obs import (
            STAGES, BlackBox, SpanLedger, build_span_artifact, content_hash)
        from go_libp2p_pubsub_torch.serve import (
            Controller, ControllerPolicy, IngestRing, StreamingEngine,
            Watchdog)
        from go_libp2p_pubsub_torch.utils.metrics import MetricsRegistry

        def model(**kw):
            return MultiTopicGossipSub(device="cpu", **kw)
    return SimpleNamespace(
        pkg=pkg, Engine=StreamingEngine, Ring=IngestRing, Watchdog=Watchdog,
        Controller=Controller, ControllerPolicy=ControllerPolicy,
        SpanLedger=SpanLedger, BlackBox=BlackBox, STAGES=STAGES,
        content_hash=content_hash, MetricsRegistry=MetricsRegistry,
        build_span_artifact=build_span_artifact, model=model)


_MODELS = {}


def _model(ns, config):
    key = (ns.pkg, tuple(sorted(config.items())))
    if key not in _MODELS:
        _MODELS[key] = ns.model(**config)
    return _MODELS[key]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _jsonable(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def _decisions(ctl):
    return [(d.knob, d.old, d.new, d.reason, d.evidence)
            for d in ctl.decisions]


def _pair(ns, config, **kw):
    """An engine and its ring on one clock (a still fake one by default:
    the chunk walls the controller reads are then 0 in both packages)."""
    clock = kw.setdefault("clock", FakeClock())
    ring = ns.Ring(capacity=kw.pop("capacity", 16),
                   policy=kw.pop("policy", "block"),
                   metrics=kw.get("metrics"), clock=clock)
    kw.setdefault("chunk_steps", 6)
    kw.setdefault("pub_width", 2)
    return ns.Engine(_model(ns, config), ring, **kw), ring


# ---------------------------------------------------------------------------
# the watchdog (tests/test_crash_safety.py)
# ---------------------------------------------------------------------------


def case_watchdog_restarts_stalled_engine(ns, tmp):
    path = os.path.join(tmp, "engine.ckpt")
    clock = FakeClock()
    eng, ring = _pair(ns, _MODEL, clock=clock)
    eng.warmup()
    ring.push(topic=0, payload=b"w", publisher=1)
    eng.run_chunk()
    eng.snapshot(path)
    restarted = []
    wd = ns.Watchdog(eng, ring, checkpoint_path=path, chunk_stall_s=5.0,
                     on_engine_restart=restarted.append, clock=clock)
    wd.note_chunk()
    clock.t = 4.0
    polls = [wd.poll()]
    clock.t = 10.0
    polls.append(wd.poll())
    assert polls == [[], ["engine_restart"]]
    assert wd.engine_restarts == 1 and eng.restores == 1
    assert restarted[0]["chunk"] >= 1
    clock.t = 12.0
    polls.append(wd.poll())
    assert polls[-1] == []
    return dict(polls=polls, restarted=_jsonable(restarted),
                tier_log=wd.tier_log, restarts=wd.engine_restarts,
                acct=ring.accounting(), pending=sorted(eng.pending))


def case_watchdog_restarts_dead_verifier(ns, tmp):
    clock = FakeClock()
    rebuilt = []
    reg = ns.MetricsRegistry(clock=clock)
    stub = SimpleNamespace(model=SimpleNamespace(t=2))
    wd = ns.Watchdog(stub, ns.Ring(capacity=8), chunk_stall_s=100.0,
                     verifier_stall_s=3.0, metrics=reg,
                     on_verifier_restart=lambda: rebuilt.append(clock.t),
                     clock=clock)
    wd.note_verifier()
    clock.t = 2.0
    polls = [wd.poll()]
    clock.t = 5.0
    polls.append(wd.poll())
    assert polls == [[], ["verifier_restart"]]
    assert wd.verifier_restarts == 1 and rebuilt == [5.0]
    return dict(polls=polls, rebuilt=rebuilt, prom=reg.render_prometheus())


def case_watchdog_tier_ladder_sheds_loudly(ns, tmp):
    clock = FakeClock()
    ring = ns.Ring(capacity=8, policy="reject")
    reg = ns.MetricsRegistry(clock=clock)
    stub = SimpleNamespace(model=SimpleNamespace(t=2))
    wd = ns.Watchdog(stub, ring, chunk_stall_s=100.0, high_watermark=6,
                     low_watermark=2, topic_priority=[0, 1], metrics=reg,
                     clock=clock)
    seen = [wd.tier_name]
    for i in range(6):
        assert ring.push(topic=1, payload=b"t%d" % i, publisher=i)
    polls = [wd.poll()]
    assert wd.tier_name == "shed_priority"
    assert not ring.push(topic=0, payload=b"shed me", publisher=9)
    assert ring.accounting()["shed_priority"] == 1
    assert ring.push(topic=1, payload=b"keep", publisher=9)
    clock.advance(1.0)
    polls.append(wd.poll())
    assert wd.tier_name == "drop_oldest" and ring.policy == "drop_oldest"
    assert ring.push(topic=1, payload=b"fresh0", publisher=10)
    assert ring.push(topic=1, payload=b"fresh1", publisher=10)
    acct = ring.accounting()
    assert acct["dropped_oldest"] == 1 and acct["silent_drops"] == 0
    ring.pop_batch(8)
    for _ in range(2):
        clock.advance(1.0)
        polls.append(wd.poll())
        seen.append(wd.tier_name)
    assert polls == [["tier_up"]] * 2 + [["tier_down"]] * 2
    assert ring.policy == "reject"
    assert ring.push(topic=0, payload=b"welcome back", publisher=1)
    assert len(wd.tier_log) == 4 and ring.accounting()["silent_drops"] == 0
    return dict(polls=polls, seen=seen, tier_log=wd.tier_log,
                acct=ring.accounting(), prom=reg.render_prometheus())


def case_watchdog_rejects_bad_config(ns, tmp):
    eng, ring = _pair(ns, _MODEL)
    msgs = []
    for kw in (dict(chunk_stall_s=0.0),
               dict(high_watermark=2, low_watermark=4),
               dict(topic_priority=[1, 2, 3])):
        with pytest.raises(ValueError) as e:
            ns.Watchdog(eng, ring, **kw)
        msgs.append(str(e.value))
    assert "chunk_stall_s" in msgs[0] and "watermark" in msgs[1]
    assert "topic_priority" in msgs[2]
    return msgs


def case_crash_during_shed_tier(ns, tmp):
    """The engine dies while the watchdog sits in shed_priority: the
    replacement comes back through the checkpoint and re-enters the tier,
    the controller's knobs ride across, delivery stays exactly-once and
    the gap is annotated on the spans in flight."""
    ladder = _LADDER
    clock = FakeClock(50.0)
    ledger = ns.SpanLedger(clock=clock)
    path = os.path.join(tmp, "engine.ckpt")
    box = ns.BlackBox(capacity=8, clock=clock)
    post = os.path.join(tmp, "post.json")

    def build_pair():
        ring = ns.Ring(capacity=16, policy="block", clock=clock,
                       tracer=ledger)
        eng = ns.Engine(_model(ns, _MODEL), ring, **_CHUNK, clock=clock,
                        tracer=ledger, snapshot_path=path, snapshot_every=1,
                        geometry_ladder=ladder, blackbox=box)
        eng.warmup()
        return eng, ring

    eng1, ring1 = build_pair()
    wd = ns.Watchdog(eng1, ring1, checkpoint_path=path, chunk_stall_s=1e9,
                     high_watermark=6, low_watermark=2,
                     topic_priority=[0, 1], clock=clock, blackbox=box,
                     postmortem_path=post)
    ctl = ns.Controller(eng1, ring1, watchdog=wd, clock=clock)
    for i in range(4):
        ring1.push(topic=1, payload=b"pre %d" % i, publisher=i)
    eng1.run_chunk()
    for i in range(14):
        assert ring1.push(topic=1, payload=b"load %d" % i, publisher=i % 8)
    assert wd.poll() == ["tier_up"] and wd.tier_name == "shed_priority"
    assert not ring1.push(topic=0, payload=b"shed me", publisher=9)
    eng1.run_chunk()
    assert ring1.depth == 2

    clock.t += 7.0
    eng2, ring2 = build_pair()
    wd.reattach(eng2, ring2)
    ctl.reattach(eng2, ring2)
    info = wd.restart_engine("chunk stall during shed_priority overload")
    assert info["replayed"] == 2
    assert wd.tier_name == "shed_priority"
    assert not ring2.push(topic=0, payload=b"still shed", publisher=9)
    assert ring2.accounting()["shed_priority"] == 2
    assert wd.controller is ctl and ctl.ring is ring2
    gaps = [e for sp in ledger.spans() for e in sp["events"]
            if e["name"] == "crash_recovery"]
    assert gaps and all(e["gap_s"] >= 7.0 and e["tier"] == "shed_priority"
                        for e in gaps)
    eng2.run_until_drained(max_chunks=16)
    assert eng2.completed == 18 and eng2.duplicate_completions == 0
    assert ring2.accounting()["silent_drops"] == 0
    assert eng2.compile_cache_size() == eng2.ladder_size() == 3
    polls = wd.poll()
    assert polls == ["tier_down"] and ring2.policy == "block"
    with open(post) as f:
        dump = json.load(f)
    return dict(info=_jsonable(info), polls=polls, tier_log=wd.tier_log,
                acct=[ring1.accounting(), ring2.accounting()],
                latencies=eng2.latencies_s, knobs=ctl.knobs.to_dict(),
                ledger=ledger.snapshot(), postmortem=dump,
                controls=_jsonable(ctl.controls()))


# ---------------------------------------------------------------------------
# the controller (tests/test_controller.py), scripted evidence
# ---------------------------------------------------------------------------


def case_ladder_warmup_cache_equals_ladder_size(ns, tmp):
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER)
    eng.warmup()
    sizes = [eng.compile_cache_size()]
    for steps, width in [(6, 4), (12, 1), (6, 2)]:
        eng.set_geometry(steps, width)
        ring.push(topic=0, payload=bytes([steps, width]), publisher=1)
        eng.run_chunk()
        sizes.append(eng.compile_cache_size())
    assert sizes == [eng.ladder_size()] * 4 and eng.geometry_switches == 3
    with pytest.raises(ValueError, match="not on the pre-warmed ladder"):
        eng.set_geometry(7, 3)
    return dict(sizes=sizes, steps=eng.steps_run, done=eng.completed)


def case_geometry_escalates_and_returns(ns, tmp):
    clock = FakeClock(100.0)
    ledger = ns.SpanLedger(clock=clock)
    reg = ns.MetricsRegistry(clock=clock)
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER,
                      clock=clock)
    eng.warmup()
    wd = ns.Watchdog(eng, ring, chunk_stall_s=1e9, high_watermark=30,
                     low_watermark=2, clock=clock)
    ctl = ns.Controller(eng, ring, watchdog=wd, tracer=ledger, metrics=reg,
                        clock=clock)
    for i in range(16):
        ring.push(topic=0, payload=bytes([i]), publisher=i % 8)
    dec = ctl.poll()
    assert eng.geometry.as_tuple() == (6, 4)
    assert {"geometry", "watermarks"} <= {d.knob for d in dec}
    assert wd.high_watermark == 32 and wd.low_watermark == 12
    while ring.depth or eng.pending:
        eng.run_chunk()
    calm = ctl.poll()
    dec2 = ctl.poll()
    assert calm == [] and eng.geometry.as_tuple() == (6, 2)
    assert [d.knob for d in dec2][0] == "geometry"
    return dict(decisions=_jsonable(_decisions(ctl)),
                events=ledger.events(), controls=_jsonable(ctl.controls()),
                prom=reg.render_prometheus(),
                watermarks=[wd.high_watermark, wd.low_watermark])


def case_geometry_escalates_on_carry(ns, tmp):
    clock = FakeClock(100.0)
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER)
    eng.warmup()
    ctl = ns.Controller(eng, ring,
                        policy=ns.ControllerPolicy(carry_up_chunks=2),
                        clock=clock)
    eng.pending[(0, 7)] = "stuck"
    ctl.poll()
    for _ in range(2):
        eng.chunks_run += 1
        ctl.poll()
    del eng.pending[(0, 7)]
    assert eng.geometry.as_tuple() == (12, 1)
    assert any("carry" in d.reason for d in ctl.decisions
               if d.knob == "geometry")
    return _jsonable(_decisions(ctl))


def case_snapshot_cadence_stretches_and_tightens(ns, tmp):
    clock = FakeClock(100.0)
    path = os.path.join(tmp, "eng.ckpt")
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER,
                      snapshot_path=path, snapshot_every=1)
    eng.warmup()
    ring.push(topic=0, payload=b"a", publisher=1)
    eng.run_chunk()
    ctl = ns.Controller(eng, ring, clock=clock)
    eng.last_chunk_wall_s = 0.010
    eng.snapshots_taken, eng.snapshot_seconds = 2, 0.040
    seen = []
    for _ in range(4):
        seen += [d for d in ctl.poll() if d.knob == "snapshot_every"]
    assert eng.snapshot_every == ns.ControllerPolicy().snapshot_every_max
    assert [(d.old, d.new) for d in seen] == [(1, 2), (2, 4), (4, 8)]
    eng.restores += 1
    dec = [d for d in ctl.poll() if d.knob == "snapshot_every"]
    assert eng.snapshot_every == 1 and "restore observed" in dec[0].reason
    eng.snapshots_taken, eng.snapshot_seconds = 100, 0.001
    assert [d for d in ctl.poll() if d.knob == "snapshot_every"] == []
    return dict(decisions=_jsonable(_decisions(ctl)),
                knobs=ctl.knobs.to_dict())


class _FakePipe:
    def __init__(self, flush_threshold=256):
        self.flush_threshold = flush_threshold


def case_flush_threshold_moves_only_while_binding(ns, tmp):
    clock = FakeClock(100.0)
    reg = ns.MetricsRegistry(clock=clock)
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER,
                      metrics=reg)
    eng.warmup()
    pipe = _FakePipe(flush_threshold=256)
    ctl = ns.Controller(eng, ring, pipe=pipe, metrics=reg, clock=clock)
    eng.last_chunk_wall_s = 0.010
    reg.gauge("crypto.pipeline.batch", 40)
    reg.gauge("crypto.pipeline.verify_s", 0.100)
    thresholds = []
    assert ctl.poll() == []
    thresholds.append(pipe.flush_threshold)
    reg.gauge("crypto.pipeline.batch", 256)
    assert [d.knob for d in ctl.poll()] == ["flush_threshold"]
    thresholds.append(pipe.flush_threshold)
    reg.gauge("crypto.pipeline.batch", 128)
    reg.gauge("crypto.pipeline.verify_s", 0.0001)
    ctl.poll()
    thresholds.append(pipe.flush_threshold)
    assert thresholds == [256, 128, 256]
    return dict(decisions=_jsonable(_decisions(ctl)),
                prom=reg.render_prometheus(), export=_jsonable(reg.export()))


def case_backpressure_fails_fast_then_restores(ns, tmp):
    class WaitsRing(ns.Ring):
        def force_waits(self, n):
            self._block_waits = n

    clock = FakeClock(100.0)
    ring = WaitsRing(capacity=4, policy="block", clock=clock)
    eng = ns.Engine(_model(ns, _MODEL), ring, chunk_steps=6, pub_width=2,
                    geometry_ladder=[(6, 2)], clock=clock)
    eng.warmup()
    ctl = ns.Controller(eng, ring, clock=clock)
    for i in range(4):
        ring.push(topic=0, payload=bytes([i]), publisher=i)
    ring.force_waits(3)
    ctl.poll()
    policies = [ring.policy, ctl.knobs.backpressure_policy]
    while ring.depth or eng.pending:
        eng.run_chunk()
    ctl.poll()
    policies += [ring.policy, ctl.knobs.backpressure_policy]
    assert policies == ["reject", "reject", "block", "block"]
    return dict(decisions=_jsonable(_decisions(ctl)), policies=policies)


def case_deescalation_restores_desired_policy(ns, tmp):
    clock = FakeClock(100.0)
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER)
    eng.warmup()
    wd = ns.Watchdog(eng, ring, chunk_stall_s=1e9, high_watermark=8,
                     low_watermark=2, clock=clock)
    ctl = ns.Controller(eng, ring, watchdog=wd, clock=clock)
    assert wd.controller is ctl
    ctl.knobs.backpressure_policy = "reject"
    for i in range(10):
        ring.push(topic=0, payload=bytes([i]), publisher=i % 8)
    polls = [wd.poll(), wd.poll()]
    assert wd.tier == 2 and ring.policy == "drop_oldest"
    ring.pop_batch(64)
    polls += [wd.poll(), wd.poll()]
    assert wd.tier == 0 and ring.policy == "reject"
    return dict(polls=polls, tier_log=wd.tier_log, acct=ring.accounting())


def case_reattach_reapplies_tier(ns, tmp):
    clock = FakeClock(100.0)
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER)
    eng.warmup()
    wd = ns.Watchdog(eng, ring, chunk_stall_s=1e9, high_watermark=8,
                     low_watermark=2, topic_priority=[1, 0], clock=clock)
    ctl = ns.Controller(eng, ring, watchdog=wd, clock=clock)
    for i in range(10):
        ring.push(topic=0, payload=bytes([i]), publisher=i % 8)
    wd.poll()
    wd.poll()
    assert wd.tier == 2
    n_dec = len(ctl.decisions)
    eng2, ring2 = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER)
    eng2.warmup()
    wd.reattach(eng2, ring2)
    ctl.reattach(eng2, ring2)
    assert ring2.policy == "drop_oldest"
    assert not ring2.push(topic=1, payload=b"shed", publisher=1)
    assert ring2.accounting()["shed_priority"] == 1
    assert len(ctl.decisions) == n_dec
    assert ctl.engine is eng2 and ctl.ring is ring2
    return dict(acct=ring2.accounting(), controls=_jsonable(ctl.controls()),
                tier_log=wd.tier_log)


def case_controller_gauges_and_controls(ns, tmp):
    reg = ns.MetricsRegistry(clock=FakeClock())
    eng, ring = _pair(ns, _MODEL, capacity=32, geometry_ladder=_LADDER,
                      metrics=reg)
    eng.warmup()
    wd = ns.Watchdog(eng, ring, chunk_stall_s=1e9, high_watermark=30,
                     low_watermark=2, metrics=reg, clock=FakeClock())
    ctl = ns.Controller(eng, ring, watchdog=wd, metrics=reg,
                        clock=FakeClock())
    prom = reg.render_prometheus()
    for fam in ("serve_controller_geometry_index",
                "serve_controller_snapshot_every",
                "serve_controller_desired_policy", "serve_watchdog_tier"):
        assert fam in prom
    doc = ctl.controls()
    assert doc["ladder"] == [list(g) for g in _LADDER]
    assert doc["watchdog_tier_name"] == "normal"
    return dict(prom=prom, controls=_jsonable(doc))


# ---------------------------------------------------------------------------
# the span ledger and the black box (tests/test_obs.py)
# ---------------------------------------------------------------------------


class _StepClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def case_ledger_stamps_and_closes_once(ns, tmp):
    led = ns.SpanLedger(sample_n=1, clock=_StepClock())
    key = ns.content_hash(0, 3, b"hello")
    for stage in ns.STAGES:
        led.stamp(key, stage)
    led.close(key)
    led.close(key)
    led.stamp(key, "ring_accept")
    assert led.duplicate_closes == 1 and led.n_closed == 1
    assert len(led.get(key)["stamps"]) == len(ns.STAGES)
    return dict(summary=led.summary(), snapshot=led.snapshot())


def case_ledger_sampling_is_deterministic(ns, tmp):
    led = ns.SpanLedger(sample_n=4)
    keys = [ns.content_hash(t, p, b"payload %d" % i)
            for i, (t, p) in enumerate((i % 2, i) for i in range(64))]
    picked = [k for k in keys if led.sampled(k)]
    assert 0 < len(picked) < len(keys)
    for k in keys:
        led.stamp(k, "ring_accept", t=1.0)
    assert led.n_spans == len(picked)
    return picked


def case_ledger_close_status_and_events(ns, tmp):
    led = ns.SpanLedger(sample_n=1, clock=_StepClock())
    k_rej = ns.content_hash(0, 1, b"forged")
    led.stamp(k_rej, "verify_submit")
    led.close(k_rej, status="rejected")
    k_open = ns.content_hash(1, 2, b"inflight")
    led.stamp(k_open, "ring_accept", seq=7)
    led.event("watchdog_tier", tier="shed_priority", reason="depth")
    n = led.annotate_open("crash_recovery", gap_s=0.5, tier="normal")
    assert n == 1 and led.summary()["events"]["watchdog_tier"] == 1
    assert led.get(k_rej)["attrs"]["status"] == "rejected"
    return dict(snapshot=led.snapshot(), summary=led.summary(),
                chrome=led.export_chrome_trace(), otlp=led.export_otlp())


def case_ledger_snapshot_restore(ns, tmp):
    led = ns.SpanLedger(sample_n=2, clock=_StepClock())
    keys = [ns.content_hash(0, i, b"snap %d" % i) for i in range(16)]
    for k in keys:
        led.stamp(k, "ring_accept")
    snap = json.loads(json.dumps(led.snapshot()))
    led2 = ns.SpanLedger(sample_n=2)
    assert led2.restore_snapshot(snap) == led.n_spans
    with pytest.raises(ValueError, match="sample_n") as e:
        ns.SpanLedger(sample_n=3).restore_snapshot(snap)
    return dict(snap=snap, again=led2.snapshot(), error=str(e.value))


def case_ledger_bounds_spans(ns, tmp):
    led = ns.SpanLedger(sample_n=1, max_spans=4, clock=_StepClock())
    for i in range(8):
        led.stamp(ns.content_hash(0, i, b"flood %d" % i), "ring_accept")
    assert led.n_spans == 4 and led.dropped_spans == 4
    return led.snapshot()


def case_chrome_and_otlp_exports(ns, tmp):
    led = ns.SpanLedger(sample_n=1, clock=_StepClock())
    for j in range(3):
        key = ns.content_hash(1, 7 + j, b"export me")
        for stage in ns.STAGES[:3 + j]:
            led.stamp(key, stage, n=j)
        if j != 1:
            led.close(key, ok=True)
    led.event("engine_restart", reason="test", tier="normal")
    chrome, otlp = led.export_chrome_trace(), led.export_otlp()
    assert chrome["displayTimeUnit"] == "ms"
    spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert len(spans) == 3 and len(spans[0]["traceId"]) == 32
    return dict(chrome=chrome, otlp=otlp)


def case_render_prometheus_golden_text(ns, tmp):
    reg = ns.MetricsRegistry()
    reg.describe("serve.ingest.accepted",
                 'messages admitted\nby the ring "door"')
    reg.inc("serve.ingest.accepted", 3)
    reg.inc("serve.ingest.shed", 1,
            labels={"topic": "1", "why": 'depth "high"\nback\\slash'})
    reg.inc("serve.ingest.shed", 2, labels={"topic": "0", "why": "priority"})
    reg.gauge("serve.watchdog.tier", 2)
    reg.gauge("gossip.delivery-frac", 0.5)
    return reg.render_prometheus()


def case_blackbox_ring_and_postmortem(ns, tmp):
    box = ns.BlackBox(capacity=4, clock=_StepClock())
    for i in range(10):
        box.record({"chunk": i, "queue_depth": i % 3})
    assert len(box) == 4 and box.recorded == 10
    assert [f["chunk"] for f in box.frames()] == [6, 7, 8, 9]
    path = os.path.join(tmp, "post.json")
    box.dump(path, extra={"reason": "test"})
    with open(path) as f:
        doc = json.load(f)
    assert doc["format"] == "obs-blackbox/1" and len(doc["frames"]) == 4
    with pytest.raises(ValueError):
        ns.BlackBox(capacity=0)
    return doc


def case_engine_spans_frames_and_export(ns, tmp):
    """A traced engine: the ledger, the black box and the span artifact
    (Chrome trace, OTLP, Prometheus) of a few chunks."""
    clock = _StepClock()
    reg = ns.MetricsRegistry(clock=clock)
    led = ns.SpanLedger(sample_n=1, clock=clock)
    box = ns.BlackBox(capacity=64, clock=clock)
    eng, ring = _pair(ns, _MODEL, clock=clock, metrics=reg, tracer=led,
                      blackbox=box)
    ring.tracer = led
    eng.warmup()
    for c in range(3):
        for i in range(3):
            ring.push(topic=i % 2, payload=b"m %d %d" % (c, i),
                      publisher=(c * 5 + i) % 16)
        eng.run_chunk()
    eng.run_until_drained()
    assert led.n_open == 0 and led.n_spans == 9
    doc = ns.build_span_artifact("streaming", "t", {"passed": True}, led,
                              registry=reg, blackbox=box)
    return _jsonable(doc)


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_port_observes_what_the_reference_observes(case, tmp_path):
    seen = {}
    for pkg in ("jax", "torch"):
        tmp = tmp_path / pkg
        tmp.mkdir()
        seen[pkg] = _jsonable(case(_namespace(pkg), str(tmp)))
    assert seen["torch"] == seen["jax"]


@pytest.mark.parametrize("rel", ["serve/watchdog.py", "serve/controller.py",
                                 "obs/blackbox.py", "obs/spans.py"])
def test_copied_modules_equal_their_originals(rel):
    with open(os.path.join(REPO, "go_libp2p_pubsub_tpu", rel)) as a, \
            open(os.path.join(REPO, "go_libp2p_pubsub_torch", rel)) as b:
        assert a.read() == b.read()


def test_exports_name_the_references_objects():
    import go_libp2p_pubsub_torch.obs as tobs
    import go_libp2p_pubsub_torch.serve as tserve
    import go_libp2p_pubsub_tpu.obs as jobs
    import go_libp2p_pubsub_tpu.serve as jserve

    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    assert {"BlackBox", "SpanLedger", "live_span_key"} <= set(tobs.__all__)
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
