"""The port's scenario event path held against the JAX package's.

- the copied host modules (canon, spec, slo, defense, realism) against
  their originals;
- the model side leaf for leaf, started from one state: the ``set_*``
  mutators, ``graft_spammers`` through 3 heartbeats, a recorded rollout
  under per-edge delay, and ``rollout_events`` on the composite campaign
  at 256 peers (with and without the adversary channels, and bare);
- the compiler's event rows, the golden trace, the five attack runners,
  and the XLA-ordered sum the record's two score means use.

Everything runs on the CPU.  State leaves and record channels are compared
exactly (f32 bit for bit); the golden trace's floats are held to 1e-6, the
tolerance of the reference's own golden test.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import scenario as jscn
from go_libp2p_pubsub_tpu.config import GossipSubParams as JP
from go_libp2p_pubsub_tpu.config import ScoreParams as JS
from go_libp2p_pubsub_tpu.models import attacks as jatt
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG
from go_libp2p_pubsub_tpu.scenario import defense as jdef
from go_libp2p_pubsub_tpu.scenario import realism as jreal
from go_libp2p_pubsub_tpu.scenario.runner import flight_to_jsonable
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch import scenario as tscn
from go_libp2p_pubsub_torch.config import GossipSubParams as TP
from go_libp2p_pubsub_torch.config import ScoreParams as TS
from go_libp2p_pubsub_torch.models import attacks as tatt
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG
from go_libp2p_pubsub_torch.ops import reduce_order
from go_libp2p_pubsub_torch.scenario import defense as tdef
from go_libp2p_pubsub_torch.scenario import realism as treal
from go_libp2p_pubsub_torch.scenario.campaign import campaign_spec
from go_libp2p_pubsub_torch.scenario.runner import jsonable_to_flight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden",
                      "scenario_steady_small.trace.json")
KW = dict(n_peers=200, n_slots=16, conn_degree=12, msg_window=64)


def _leaves(st, prefix=""):
    out = {}
    for name in type(st)._fields:
        v = getattr(st, name)
        if hasattr(v, "_fields"):
            out.update(_leaves(v, prefix + name + "."))
        else:
            out[prefix + name] = np.asarray(v)
    return out


def assert_same_state(ref, port, what):
    la, lb = _leaves(ref), _leaves(bridge.state_to_numpy(port))
    assert la.keys() == lb.keys()
    for name in la:
        a, b = la[name], lb[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {name}")


def assert_same_record(ref, port, what):
    """Exact equality through the trace encoding (hex floats)."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    a, b = flight_to_jsonable(ref), flight_to_jsonable(port)
    bad = [k for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)]
    assert not bad, (what, bad)


def assert_same_events(ref, port, what):
    assert type(ref)._fields == type(port)._fields
    for name in type(ref)._fields:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, (what, name)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {name}")


def models(**kw):
    jkw, tkw = dict(kw), dict(kw)
    for key, jcls, tcls in (("params", JP, TP), ("score_params", JS, TS)):
        if key in kw:
            jkw[key], tkw[key] = jcls(**kw[key]), tcls(**kw[key])
    return JG(use_pallas=False, **jkw), TG(device="cpu", **tkw)


# -- the copied host modules -------------------------------------------------


def test_canon_and_specs_match_reference():
    assert list(tscn.CANON) == list(jscn.CANON)
    for a, b in zip(jscn.build_all(), tscn.build_all()):
        assert a.to_dict() == b.to_dict()
        assert tscn.ScenarioSpec.from_dict(a.to_dict()).to_dict() == \
            a.to_dict()
        assert tscn.sim_supported(b) == jscn.sim_supported(a)
    assert sum(s.family == "gossipsub" and tscn.sim_supported(s)
               for s in tscn.build_all()) == 14


def test_slo_evaluate_matches_reference():
    with open(GOLDEN) as f:
        doc = json.load(f)
    record = jsonable_to_flight(doc["flight"])
    base = jscn.ScenarioSpec.from_dict(doc["spec"])
    n = record["lat_hist"].shape[0]
    for slo in (base.slo, dataclasses.replace(
            base.slo, max_p50=0.5, max_p99=1.0, min_delivery_frac=0.999)):
        spec = dataclasses.replace(base, slo=slo)
        ref = jscn.evaluate(spec, record, doc["n_publishes"])
        out = tscn.evaluate(tscn.ScenarioSpec.from_dict(spec.to_dict()),
                            record, doc["n_publishes"])
        assert out.to_dict() == ref.to_dict()
    # An empty histogram grades NaN, which never passes.
    empty = dict(record, lat_hist=np.zeros_like(record["lat_hist"]))
    spec = dataclasses.replace(base, slo=dataclasses.replace(
        base.slo, max_p50=1.0))
    out = tscn.evaluate(tscn.ScenarioSpec.from_dict(spec.to_dict()), empty,
                        n).to_dict()
    assert json.dumps(out) == json.dumps(
        jscn.evaluate(spec, empty, n).to_dict())
    assert not out["passed"]


def test_defense_registry_and_gate_match_reference():
    assert tdef.load_promoted() == jdef.load_promoted()
    assert tdef.defense_digest(tdef.load_promoted()) == \
        jdef.defense_digest(jdef.load_promoted())
    for name in ("STANDING_DEFENSE", "HARDENED_DEFENSE", "PROMOTED_DEFENSE"):
        assert getattr(tdef, name) == getattr(jdef, name)
    bad = [
        dict(invalid_message_deliveries_weight=5.0),
        dict(behaviour_penalty_weight=3.0),
        dict(ip_colocation_factor_weight=2.0),
        dict(no_such_field=1.0),
    ]
    for cand in [tdef.STANDING_DEFENSE, tdef.HARDENED_DEFENSE] + bad:
        assert tdef.check_invariants(cand) == jdef.check_invariants(cand)
    assert tdef.check_invariants(tdef.PROMOTED_DEFENSE, deep=True,
                                 device="cpu") == \
        jdef.check_invariants(jdef.PROMOTED_DEFENSE, deep=True)


@pytest.mark.parametrize("topo", [
    {"kind": "heavy_tailed", "alpha": 2.0},
    {"kind": "local", "spread": 6},
    {"kind": "uniform"},
])
def test_topology_builders_match_reference(topo):
    jb, tb = jreal.topology_builder(topo), treal.topology_builder(topo)
    assert jb.config_key == tb.config_key
    for n, k, d in ((150, 16, 8), (3, 8, 4)):
        ref = jb(np.random.default_rng(4), n, k, d)
        out = tb(np.random.default_rng(4), n, k, d)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b, a)
    spec = jscn.build("steady_state")
    a = jreal.apply_realism(spec, 3, topology=topo, geo=True, diurnal=True)
    b = treal.apply_realism(tscn.build("steady_state"), 3, topology=topo,
                            geo=True, diurnal=True)
    assert a.to_dict() == b.to_dict()


def test_unported_families_raise_not_implemented():
    """The coded families compile (rlnc on the sim plane, the hybrid on the
    streaming plane, refused on the sim plane as the reference refuses
    it); placement relabeling (``peer_uid``) still raises, naming its
    ROADMAP item."""
    comp = tscn.compile_scenario(tscn.build("degraded_links_rlnc"),
                                 device="cpu")
    ref = jscn.compile_scenario(jscn.build("degraded_links_rlnc"))
    assert_same_events(ref.events, comp.events, "degraded_links_rlnc")
    assert type(comp.model).__name__ == "RLNC"
    # The treecast family is ported: tree_churn_heal compiles.
    comp = tscn.compile_scenario(tscn.build("tree_churn_heal"), device="cpu")
    assert comp.events.pub_msg.shape[0] == 64
    hybrid = dataclasses.replace(tscn.build("steady_state"), family="hybrid")
    with pytest.raises(ValueError) as te:
        tscn.compile_scenario(hybrid, device="cpu")
    with pytest.raises(ValueError) as je:
        jscn.compile_scenario(dataclasses.replace(
            jscn.build("steady_state"), family="hybrid"))
    assert str(te.value) == str(je.value)
    from go_libp2p_pubsub_torch.scenario.compiler import compile_streaming_plan
    plan = compile_streaming_plan(tscn.build("streaming_degraded_links"))
    assert plan.compare_eager and plan.spec.family == "hybrid"
    uid = dataclasses.replace(
        tscn.build("degraded_links_rlnc"),
        model=dict(tscn.build("degraded_links_rlnc").model,
                   peer_uid=list(range(64))))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tscn.compile_scenario(uid, device="cpu")


def test_per_edge_delay_rejects_eclipse_silence():
    spec = campaign_spec(256)
    spec = dataclasses.replace(spec, model=dict(spec.model, max_edge_delay=2))
    with pytest.raises(ValueError, match="max_edge_delay"):
        tscn.compile_scenario(spec, device="cpu")


# -- the model side, leaf for leaf -------------------------------------------


def test_mutators_match_reference():
    ga, gt = models(**KW)
    sa = ga.init(seed=3)
    st = bridge.state_from_jax(sa, device="cpu")
    rng = np.random.default_rng(3)
    n, k = KW["n_peers"], KW["n_slots"]
    for name, value in (
        ("set_gossip_delay", rng.integers(0, 4, n).astype(np.int32)),
        ("set_gossip_mute", rng.random(n) < 0.2),
        ("set_self_promo", rng.random(n) < 0.2),
        ("set_subscribed", rng.random(n) < 0.8),
        ("set_subscribed", rng.random(n) < 0.9),
    ):
        sa = getattr(ga, name)(sa, jnp.asarray(value))
        st = getattr(gt, name)(st, value)
        assert_same_state(sa, st, name)
    ga, gt = models(max_edge_delay=3, **KW)
    sa = ga.init(seed=3)
    st = bridge.state_from_jax(sa, device="cpu")
    delay = rng.integers(0, 4, (n, k))
    assert_same_state(ga.set_edge_delay(sa, delay),
                      gt.set_edge_delay(st, delay), "set_edge_delay")
    for bad in (delay + 1, delay - 1):
        with pytest.raises(ValueError):
            gt.set_edge_delay(st, bad)


def test_graft_spammers_match_reference_through_three_heartbeats():
    spam = np.arange(KW["n_peers"]) < 6
    sp = dict(invalid_message_deliveries_weight=-30.0)
    ga, gt = models(graft_spammers=spam, score_params=sp, **KW)
    sa = ga.init(seed=5)
    st = bridge.state_from_jax(sa, device="cpu")
    assert_same_state(sa, st, "init")
    for i in range(6):
        sa = ga.publish(sa, jnp.int32(i), jnp.int32(i), jnp.asarray(False))
        st = gt.publish(st, i, i, False)
    sa = ga.run(sa, 24)
    st, _ = gt.rollout(st, 24, record=False)
    assert_same_state(sa, st, "graft_spammers")
    assert float(st.gcounters.behaviour_penalty[:6].sum()) > 0


def test_per_edge_delay_rollout_matches_reference():
    """40 recorded rounds with max_edge_delay=2, random edge delays and
    IDONTWANT asked for (the reference turns it off in this mode)."""
    ga, gt = models(max_edge_delay=2, params=dict(idontwant=True), **KW)
    sa = ga.init(seed=9)
    st = bridge.state_from_jax(sa, device="cpu")
    delay = np.random.default_rng(9).integers(0, 3, (KW["n_peers"],
                                                     KW["n_slots"]))
    sa, st = ga.set_edge_delay(sa, delay), gt.set_edge_delay(st, delay)
    for s in range(12):
        src, valid = (s * 37) % KW["n_peers"], s % 5 != 3
        sa = ga.publish(sa, jnp.int32(src), jnp.int32(s), jnp.asarray(valid))
        st = gt.publish(st, src, s, valid)
    assert_same_state(sa, st, "publish")
    sa = ga.kill_peers(sa, jnp.arange(KW["n_peers"]) % 17 == 0)
    st = gt.kill_peers(st, torch.arange(KW["n_peers"]) % 17 == 0)
    sa, ra = ga.rollout(sa, 40, record=True)
    st, rt = gt.rollout(st, 40, record=True)
    assert_same_state(sa, st, "rollout")
    assert_same_record(ra, {k: v.numpy() for k, v in rt.items()}, "record")
    # The delays moved receipts: the same run on the ideal fabric differs.
    st0 = bridge.state_from_jax(ga.init(seed=9), device="cpu")
    for s in range(12):
        st0 = gt.publish(st0, (s * 37) % KW["n_peers"], s, s % 5 != 3)
    _, r0 = gt.rollout(st0, 40, record=True)
    assert not torch.equal(r0["lat_hist"], rt["lat_hist"])


def test_composite_campaign_matches_reference():
    """The composite at 256 peers: the compiler's rows, attackers and state
    surgery, then ``rollout_events`` recorded with the adversary channels,
    recorded without them, and bare, each held against the reference's
    recorded run (recording changes no state, and the plain record is the
    adversary record's shared channels)."""
    spec = campaign_spec(256)
    comp_j = jscn.compile_scenario(
        jscn.ScenarioSpec.from_dict(spec.to_dict()))
    comp_t = tscn.compile_scenario(spec, device="cpu")
    assert comp_t.n_publishes == comp_j.n_publishes == 112
    assert comp_t.target == comp_j.target
    np.testing.assert_array_equal(comp_t.attackers, comp_j.attackers)
    assert_same_events(comp_j.events, comp_t.events, "composite")
    assert_same_state(comp_j.state, comp_t.state, "compiled state")
    np.testing.assert_array_equal(
        comp_t.model.graft_spammers.numpy(),
        np.asarray(comp_j.model.graft_spammers))

    fa, ra = comp_j.model.rollout_events(
        comp_j.state, comp_j.events, attackers=jnp.asarray(comp_j.attackers),
        target=comp_j.target, record=True)
    ft, rt = comp_t.model.rollout_events(
        comp_t.state, comp_t.events, attackers=comp_t.attackers,
        target=comp_t.target, record=True)
    assert_same_state(fa, ft, "adversary")
    assert_same_record(ra, rt, "adversary")
    adversary = {"attacker_mesh_edges", "attacker_capture_frac",
                 "attacker_score_mean", "honest_score_min",
                 "attacker_behaviour_penalty", "attacker_global_score",
                 "honest_behaviour_penalty_max", "target_honest_mesh_edges"}
    assert adversary <= set(rt)

    ft, rt = comp_t.model.rollout_events(comp_t.state, comp_t.events)
    assert_same_state(fa, ft, "plain")
    assert_same_record({k: v for k, v in ra.items() if k not in adversary},
                       rt, "plain")
    ft, rt = comp_t.model.rollout_events(comp_t.state, comp_t.events,
                                         record=False)
    assert rt is None
    assert_same_state(fa, ft, "bare")


@pytest.mark.parametrize("n_attackers", [0, 1])
def test_adversary_channels_with_no_and_one_attacker(n_attackers):
    """``behaviour_penalty.max(where=attackers, initial=0.0)`` and the
    masked means on an all-honest set (0 and NaN) and on one attacker."""
    ga, gt = models(heartbeat_steps=4, **MESH_64)
    sa = ga.init(seed=4)
    st = bridge.state_from_jax(sa, device="cpu")
    ev = jscn.compile_scenario(jscn.build("steady_state")).events
    ev = type(ev)(*(plane[:12] for plane in ev))
    att = np.zeros(64, bool)
    att[3:3 + n_attackers] = True
    ev.mute_on[2] |= att
    fa, ra = ga.rollout_events(sa, ev, attackers=jnp.asarray(att), target=3)
    ft, rt = gt.rollout_events(st, ev, attackers=att, target=3)
    assert_same_state(fa, ft, "attackers")
    assert_same_record(ra, rt, "attackers")
    if n_attackers == 0:
        assert np.isnan(rt["attacker_score_mean"]).all()
        assert np.isnan(rt["attacker_global_score"]).all()
        assert (rt["attacker_behaviour_penalty"] == 0.0).all()


def test_golden_trace_reproduces_on_the_port():
    with open(GOLDEN) as f:
        doc = json.load(f)
    res = tscn.run_scenario(tscn.ScenarioSpec.from_dict(doc["spec"]),
                            device="cpu")
    stored = jsonable_to_flight(doc["flight"])
    assert set(stored) == set(res.record)
    for k, want in stored.items():
        got = res.record[k]
        assert got.shape == want.shape, k
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert res.verdict.passed
    # A saved trace replays on the port bit for bit.
    doc2 = json.loads(json.dumps(tscn.trace_document(res)))
    _, matched, bad = tscn.replay_trace(doc2, device="cpu")
    assert matched and not bad


# -- attack runners ------------------------------------------------------------


MESH_64 = dict(n_peers=64, n_slots=16, conn_degree=8, msg_window=64)


def _run_attack(name):
    if name in ("gossip_promise_spam_attack", "backoff_spam_attack"):
        kw = dict(n_peers=64, n_slots=16, conn_degree=8, msg_window=64,
                  n_rounds=4)
        ref = getattr(jatt, name)(**kw, use_pallas=False)
        out = getattr(tatt, name)(**kw, device="cpu")
        return ref[1:], out[1:]
    sp = dict(invalid_message_deliveries_weight=-30.0,
              ip_colocation_factor_weight=-1.0,
              ip_colocation_factor_threshold=1.0,
              mesh_message_deliveries_weight=-1.0,
              mesh_message_deliveries_threshold=1.5,
              mesh_message_deliveries_activation_s=3.0)
    ga, gt = models(score_params=sp, heartbeat_steps=4, **MESH_64)
    sa = ga.init(seed=1)
    st = bridge.state_from_jax(sa, device="cpu")
    args = {"invalid_spam_attack": dict(n_attackers=4, n_rounds=3),
            "sybil_colocation_attack": dict(n_sybils=6, n_steps=12),
            "eclipse_attempt": dict(target=7, n_rounds=3)}[name]
    return (getattr(jatt, name)(ga, sa, **args),
            getattr(tatt, name)(gt, st, **args))


# The runners' campaigns are the canon's attack kinds, which the canon
# parity tests hold in tier-1; these compile one reference scan each.
@pytest.mark.slow
@pytest.mark.parametrize("name", [
    "invalid_spam_attack", "sybil_colocation_attack", "eclipse_attempt",
    "gossip_promise_spam_attack", "backoff_spam_attack",
])
def test_attack_runner_matches_reference(name):
    (sa, ra, aa), (st, rt, at) = _run_attack(name)
    assert_same_state(sa, st, name)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aa))
    assert_same_record(ra, rt, name)


@pytest.mark.slow
def test_run_with_metrics_matches_reference():
    ga, gt = models(score_params=dict(ip_colocation_factor_weight=-1.0,
                                      ip_colocation_factor_threshold=1.0),
                    heartbeat_steps=4, **MESH_64)
    sa = ga.init(seed=2)
    st = bridge.state_from_jax(sa, device="cpu")
    att = np.arange(64) < 5
    sa, ra = jatt.run_with_metrics(ga, sa, 12, jnp.asarray(att))
    st, rt = tatt.run_with_metrics(gt, st, 12, att)
    assert_same_state(sa, st, "run_with_metrics")
    assert_same_record(ra, rt, "run_with_metrics")


# -- the record's XLA-ordered sums -------------------------------------------


@pytest.mark.parametrize("shape", [(7, 3), (64, 16), (200, 16), (33,),
                                   (2000, 32), (5000,)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_sparse_sum_adds_in_xla_order(shape, density):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-3, 3, shape))).astype(np.float32)
    mask = rng.random(shape) < density
    if density == 0.3:
        x[mask & (rng.random(shape) < 0.05)] = -np.inf
    ref = jax.jit(lambda x, m: jnp.where(m, x, 0.0).sum())(x, mask)
    idx = np.flatnonzero(mask)
    got = reduce_order.sparse_sum(shape, idx, x.reshape(-1)[idx])
    assert np.float32(got).tobytes() == np.asarray(ref).tobytes()
    cnt = int(mask.sum())
    mean = jax.jit(JG.masked_mean)(x, mask)
    assert np.float32(reduce_order.masked_mean(
        shape, idx, x.reshape(-1)[idx], cnt)).tobytes() == \
        np.asarray(mean).tobytes()
