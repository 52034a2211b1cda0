"""The coded hybrid on the port's serving plane, held against the JAX
package's: the streaming plans of the canon's three hybrid campaigns, the
campaigns themselves replayed from the committed stream-canon trace (the
JAX runner's, written under the stepping clock), and the streaming engine
over a ``HybridGossipSub``: a snapshot the JAX engine wrote mid-decode
(``decode_ranks`` in its meta) restores in the port's engine, and both
then continue equal, leaf for leaf."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import scenario as jscn
from go_libp2p_pubsub_tpu.models.hybrid import HybridGossipSub as JH
from go_libp2p_pubsub_tpu.serve import IngestRing as JRing
from go_libp2p_pubsub_tpu.serve import StreamingEngine as JE
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch import scenario as tscn
from go_libp2p_pubsub_torch.models import coded_trace as CT
from go_libp2p_pubsub_torch.models.hybrid import HybridGossipSub as TH
from go_libp2p_pubsub_torch.scenario import stream_canon as C
from go_libp2p_pubsub_torch.scenario import streaming_runner as trun
from go_libp2p_pubsub_torch.serve import IngestRing as TRing
from go_libp2p_pubsub_torch.serve import StreamingEngine as TE
from go_libp2p_pubsub_torch.serve import stream_trace as S
from go_libp2p_pubsub_torch.utils import checkpoint


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(doc):
    return json.loads(json.dumps(doc, sort_keys=True))


def _plan_doc(plan):
    d = dataclasses.asdict(plan)
    d["spec"] = plan.spec.to_dict()
    return _json(d)


@pytest.mark.parametrize("name", C.HYBRID_CAMPAIGNS)
def test_hybrid_plans_match_reference(name):
    js, ts = jscn.build(name), tscn.build(name)
    assert ts.family == "hybrid"
    assert _plan_doc(tscn.compile_streaming_plan(ts)) == _plan_doc(
        jscn.compile_streaming_plan(js))


@pytest.mark.parametrize("name", C.HYBRID_CAMPAIGNS)
def test_hybrid_campaign_replays_the_committed_trace(name):
    """The port's runner against the JAX runner's document of the campaign
    (the committed trace)."""
    ref = C.load_trace()["campaigns"][name]
    out, eng = C.capture(trun, TE, tscn.build(name), device="cpu")
    assert C.mismatches(_json(out), ref) == []
    assert _json(out) == ref
    assert isinstance(eng.model, TH) and ref["chunks"]
    assert out["record"]["silent_drops"]["data"] == [0]


def test_hybrid_trace_exercises_the_coded_arms():
    doc = C.load_trace()["campaigns"]
    deg = doc["streaming_degraded_links"]
    assert deg["verdict"]["passed"]
    # The eager twin ran (its completions and the p99 ratio are channels).
    assert "eager_completed" in deg["engine_stats"]
    assert "p99_vs_eager_ratio" in deg["record"]
    assert deg["engine_stats"]["completed"] > 0
    crash = doc["streaming_rlnc_crash_recovery"]
    assert crash["engine_stats"]["restores"] == 1
    assert crash["engine_stats"]["duplicate_completions"] == 0
    drift = doc["streaming_drifting_load"]
    assert drift["record"]["controller_decisions"]["data"][0] > 0
    assert drift["record"]["unplanned_recompiles"]["data"] == [0]
    assert set(C.load_trace()["campaigns"]) == set(
        C.CAMPAIGNS + C.HYBRID_CAMPAIGNS)


# K = 16: the mean-loss channel of the flight tail sums in the order the
# port models (ops/reduce_order.xla_sum).
_MODEL = dict(n_peers=48, n_slots=16, conn_degree=6, msg_window=16,
              heartbeat_steps=4, gen_size=4)


def _pair(Model, Ring, Engine, clock, path, **kw):
    ring = Ring(capacity=32, policy="block", clock=clock)
    eng = Engine(Model(**_MODEL, **kw), ring, chunk_steps=4, pub_width=2,
                 clock=clock, snapshot_path=path)
    eng.warmup()
    return eng, ring


def _push(ring, lo, hi):
    for i in range(lo, hi):
        ring.push(topic=0, payload=b"coded %d" % i, publisher=(7 * i) % 48)


def test_jax_hybrid_snapshot_restores_in_the_port(tmp_path):
    """Mid-decode under loss: the JAX engine's snapshot (partial ranks in
    ``decode_ranks``) restores into the port's engine, and both continue
    through more chunks equal: state leaves, flight tail, completions and
    latencies under one stepping clock."""
    path = str(tmp_path / "hybrid.ckpt")
    je, jring = _pair(JH, JRing, JE, S.SteppingClock(), path)
    je.set_ingress_delay(2)
    _push(jring, 0, 8)
    je.run_chunk()
    je.run_chunk()
    je.snapshot()
    meta = checkpoint.meta(path)
    assert meta["model"] == TH(device="cpu", **_MODEL).stream_model_key()
    assert meta["decode_ranks"]["partial"] > 0
    t_snap = je._clock.t

    out = []
    for Model, Ring, Engine, kw in ((JH, JRing, JE, {}),
                                    (TH, TRing, TE, {"device": "cpu"})):
        clock = S.SteppingClock()
        eng, ring = _pair(Model, Ring, Engine, clock, path, **kw)
        clock.t = t_snap
        eng.restore(path)
        _push(ring, 8, 14)
        for _ in range(3):
            eng.run_chunk()
        eng.set_ingress_delay(0)
        eng.run_until_drained()
        eng.snapshot(str(tmp_path / f"after_{Engine.__module__}.ckpt"))
        state = (eng.state if Engine is JE
                 else bridge.hybrid_state_to_numpy(eng.state))
        out.append((state, {k: np.asarray(v)
                            for k, v in eng.flight_tail.items()},
                    eng.completed, eng.latencies_s, sorted(eng.pending),
                    checkpoint.meta(str(tmp_path / f"after_{Engine.__module__}"
                                        ".ckpt"))["decode_ranks"]))
    (js, jtail, *jrest), (ts, ttail, *trest) = out
    ja, tb = CT.flatten(js), CT.flatten(ts)
    assert ja.keys() == tb.keys()
    for name in ja:
        a, b = np.asarray(ja[name]), tb[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(
            b.view(np.int32) if b.dtype == np.float32 else b,
            a.view(np.int32) if a.dtype == np.float32 else a, err_msg=name)
    assert jtail.keys() == ttail.keys()
    for k in jtail:
        assert jtail[k].dtype == ttail[k].dtype, k
        np.testing.assert_array_equal(ttail[k], jtail[k], err_msg=k)
    assert trest == jrest
    assert trest[0] > 0


def test_port_hybrid_engine_round_trips_its_own_snapshot(tmp_path):
    path = str(tmp_path / "port.ckpt")
    eng, ring = _pair(TH, TRing, TE, S.SteppingClock(), path, device="cpu")
    eng.set_ingress_delay(1)
    _push(ring, 0, 6)
    eng.run_chunk()
    eng.snapshot()
    before = CT.flatten(bridge.hybrid_state_to_numpy(eng.state))
    fresh, _ = _pair(TH, TRing, TE, S.SteppingClock(), path, device="cpu")
    assert fresh.compile_cache_size() == 1
    fresh.restore(path)
    after = CT.flatten(bridge.hybrid_state_to_numpy(fresh.state))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert fresh.compile_cache_size() == 1
    assert set(eng.flight_tail) >= {"coded_edges", "loss_ewma_mean",
                                    "lat_hist", "step"}
