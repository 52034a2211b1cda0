"""The rest of the router family on the port, held against the JAX
package: ``FloodSub`` and ``RandomSub`` (the cases of
``tests/test_floodsub.py`` and the flood smoke test, every state leaf and
``delivery_stats`` exact, the reference's assertions on both),
``GossipSub(direct_edges=)`` (the cases of ``tests/test_gossipsub.py``,
its validation errors, and a recorded rollout with direct edges, fanout
publishers and a kill), ``utils/faults.py`` (the cases of
``tests/test_utils.py``, ``run_with_faults`` on the tree and the gossip
model against the reference's), ``export_mesh``, and the pins of
``config.py``'s tree classes and ``faults.py`` to their originals."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import config as jcfg
from go_libp2p_pubsub_tpu.config import GossipSubParams as JP
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models import randomsub as jrand
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG
from go_libp2p_pubsub_tpu.models.gossipsub import build_topology
from go_libp2p_pubsub_tpu.ops import tree as jt
from go_libp2p_pubsub_tpu.utils import faults as jfaults
from go_libp2p_pubsub_tpu.utils import trace as jtrace
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch import config as tcfg
from go_libp2p_pubsub_torch.config import GossipSubParams as TP
from go_libp2p_pubsub_torch.models import floodsub as tflood
from go_libp2p_pubsub_torch.models import randomsub as trand
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG
from go_libp2p_pubsub_torch.ops import tree as tt
from go_libp2p_pubsub_torch.utils import faults as tfaults
from go_libp2p_pubsub_torch.utils import trace as ttrace

from chip_smoke import direct_edges_for
from test_torch_gossipsub import _assert_same_record, _assert_same_state
from test_torch_tree import assert_same_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- FloodSub / RandomSub ---------------------------------------------------------


def assert_same_flood(ref, port, what):
    b = bridge.flood_state_to_numpy(port)
    assert ref._fields == b._fields
    for f in ref._fields:
        x, y = np.asarray(getattr(ref, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert x.tobytes() == y.tobytes(), f"{what}: {f}"


def assert_same_stats(jm, tm, js, ts):
    """``delivery_stats`` of both packages, bit for bit -> (frac, p50)."""
    (jf, jp), (tf, tp) = jm.delivery_stats(js), tm.delivery_stats(ts)
    jf, jp = np.asarray(jf), np.asarray(jp)
    assert jf.dtype == tf.numpy().dtype == np.float32
    assert jf.tobytes() == tf.numpy().tobytes()
    assert jp.dtype == tp.numpy().dtype and jp.tobytes() == tp.numpy().tobytes()
    return jf, float(jp)


def routers(cls_j, cls_t, **kw):
    return cls_j(**kw), cls_t(device="cpu", **kw)


def publish_both(jm, tm, js, ts, src, slot, valid):
    js = jm.publish(js, jnp.int32(src), jnp.int32(slot), jnp.asarray(valid))
    return js, tm.publish(ts, src, slot, valid)


def test_flood_reaches_all_fast():
    jm, tm = routers(jflood.FloodSub, tflood.FloodSub, n_peers=256,
                     n_slots=24, conn_degree=10, msg_window=8)
    js, ts = jm.init(seed=2), tm.init(seed=2)
    assert_same_flood(js, ts, "init")
    js, ts = publish_both(jm, tm, js, ts, 0, 0, True)
    js, ts = jm.run(js, 12), tm.run(ts, 12)
    assert_same_flood(js, ts, "run")
    frac, p50 = assert_same_stats(jm, tm, js, ts)
    assert frac[0] == 1.0 and p50 <= 4


def test_flood_respects_liveness_and_drops_invalid():
    jm, tm = routers(jflood.FloodSub, tflood.FloodSub, n_peers=64,
                     n_slots=16, conn_degree=8, msg_window=4)
    js, ts = jm.init(seed=3), tm.init(seed=3)
    dead = np.zeros(64, bool)
    dead[10] = True
    js = js._replace(alive=js.alive & ~jnp.asarray(dead))
    ts = ts._replace(alive=ts.alive & ~torch.from_numpy(dead))
    js, ts = publish_both(jm, tm, js, ts, 0, 0, True)
    js, ts = publish_both(jm, tm, js, ts, 0, 1, False)
    js, ts = jm.run(js, 10), tm.run(ts, 10)
    assert_same_flood(js, ts, "liveness")
    assert not bool(ts.have[10, 0]) and int(ts.have[:, 1].sum()) <= 1
    frac, _ = assert_same_stats(jm, tm, js, ts)
    assert frac[0] == 1.0 and np.isnan(frac[1])


def test_floodsub_smoke():
    jm, tm = routers(jflood.FloodSub, tflood.FloodSub, n_peers=16,
                     n_slots=8, conn_degree=4, msg_window=4)
    js, ts = publish_both(jm, tm, jm.init(seed=0), tm.init(seed=0), 0, 0,
                          True)
    js, ts = jm.run(js, 8), tm.run(ts, 8)
    assert_same_flood(js, ts, "smoke")
    assert assert_same_stats(jm, tm, js, ts)[0][0] == 1.0


def test_randomsub_delivers_with_longer_tail_than_flood():
    n = 256
    fj, ft = routers(jflood.FloodSub, tflood.FloodSub, n_peers=n,
                     n_slots=16, conn_degree=8, msg_window=8)
    rj, rt = routers(jrand.RandomSub, trand.RandomSub, n_peers=n,
                     n_slots=16, conn_degree=8, msg_window=8, emit=3)
    sf, sft = publish_both(fj, ft, fj.init(seed=2), ft.init(seed=2), 0, 0,
                           True)
    sr, srt = publish_both(rj, rt, rj.init(seed=2), rt.init(seed=2), 0, 0,
                           True)
    assert_same_flood(sr, srt, "randomsub publish")
    sf, sft = fj.run(sf, 40), ft.run(sft, 40)
    sr, srt = rj.run(sr, 40), rt.run(srt, 40)
    assert_same_flood(sf, sft, "flood")
    assert_same_flood(sr, srt, "randomsub")
    frac_f, p50_f = assert_same_stats(fj, ft, sf, sft)
    frac_r, p50_r = assert_same_stats(rj, rt, sr, srt)
    assert frac_f[0] == 1.0 and frac_r[0] >= 0.95 and p50_r > p50_f


def test_randomsub_emit_caps_per_round_sends():
    jm, tm = routers(jrand.RandomSub, trand.RandomSub, n_peers=128,
                     n_slots=16, conn_degree=12, msg_window=4, emit=2)
    js, ts = publish_both(jm, tm, jm.init(seed=0), tm.init(seed=0), 5, 0,
                          True)
    js, ts = jm.run(js, 1), tm.run(ts, 1)
    assert_same_flood(js, ts, "one round")
    assert 1 <= int(ts.have[:, 0].sum()) <= 3


def test_randomsub_invalid_not_relayed_and_survives_kills():
    jm, tm = routers(jrand.RandomSub, trand.RandomSub, n_peers=256,
                     n_slots=16, conn_degree=8, msg_window=4)
    assert jm.emit == tm.emit == 16
    js, ts = jm.init(seed=3), tm.init(seed=3)
    kill = np.zeros(256, bool)
    kill[50:90] = True
    js, ts = jm.kill_peers(js, jnp.asarray(kill)), tm.kill_peers(ts, kill)
    js, ts = publish_both(jm, tm, js, ts, 0, 0, True)
    js, ts = publish_both(jm, tm, js, ts, 1, 1, False)
    js, ts = jm.run(js, 40), tm.run(ts, 40)
    assert_same_flood(js, ts, "kills")
    frac, _ = assert_same_stats(jm, tm, js, ts)
    assert frac[0] >= 0.95 and int(ts.have[:, 1].sum()) <= 1


@pytest.mark.parametrize("n,k,d,emit", [
    (100_000, 32, 6, None), (100_000, 32, 6, 6), (64, 16, 6, None),
    (10, 8, 6, None), (1000, 64, 3, 100)])
def test_randomsub_emission_rule_matches_reference(n, k, d, emit):
    a = jrand.RandomSub(n_peers=n, n_slots=k, d=d, emit=emit)
    b = trand.RandomSub(n_peers=n, n_slots=k, d=d, emit=emit, device="cpu")
    assert a.emit == b.emit


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_routers_default_to_the_card():
    for cls in (tflood.FloodSub, trand.RandomSub):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(n_peers=8, n_slots=4, conn_degree=2, msg_window=4)


def test_flood_bridge_round_trips_reference_states():
    jm = jrand.RandomSub(n_peers=32, n_slots=8, conn_degree=4, msg_window=4)
    js = jm.init(seed=1)
    ts = bridge.flood_state_from_jax(js, device="cpu")
    assert isinstance(ts, trand.RandomSubState) and isinstance(ts.step, int)
    assert_same_flood(js, ts, "bridge")
    fj = jflood.FloodSub(n_peers=32, n_slots=8, conn_degree=4, msg_window=4)
    fs = bridge.flood_state_from_jax(fj.init(seed=1), device="cpu")
    assert isinstance(fs, tflood.FloodState)


# -- GossipSub(direct_edges=) ------------------------------------------------------


def _pinned(n, k, seed, degree=4):
    nbrs, rev, valid, outbound = build_topology(
        np.random.default_rng(seed), n, k, degree)

    def builder(_rng, _n, _k, _deg):
        return nbrs, rev, valid, outbound

    return builder, nbrs, rev, valid


def _friend_edge(n, k):
    builder, nbrs, rev, valid = _pinned(n, k, 3)
    s0 = int(np.nonzero(valid[0])[0][0])
    friend, r0 = int(nbrs[0, s0]), int(rev[0, s0])
    direct = np.zeros((n, k), bool)
    direct[0, s0] = direct[friend, r0] = True
    return builder, direct, friend, s0, r0


def gossip_pair(**kw):
    return JG(use_pallas=False, **kw), TG(device="cpu", **kw)


def test_direct_peering_always_forwards_and_stays_out_of_mesh():
    n, k = 32, 8
    builder, direct, friend, s0, r0 = _friend_edge(n, k)
    ga, gt = gossip_pair(n_peers=n, n_slots=k, conn_degree=4, msg_window=8,
                         builder=builder, direct_edges=direct)
    sa, st = ga.init(seed=0), gt.init(seed=0)
    _assert_same_state(sa, st, "init")
    app = np.zeros(n, np.float32)
    app[0] = -1e6
    sa = sa._replace(gcounters=sa.gcounters._replace(app_score=jnp.asarray(app)))
    st = st._replace(gcounters=st.gcounters._replace(
        app_score=torch.from_numpy(app)))
    sa, (st, _) = ga.run(sa, ga.heartbeat_steps), gt.rollout(
        st, gt.heartbeat_steps, record=False)
    _assert_same_state(sa, st, "graylisted")
    assert not bool(st.mesh[0].any()), "graylisted peer meshed"
    sa = ga.publish(sa, jnp.int32(0), jnp.int32(0), jnp.asarray(True))
    st = gt.publish(st, 0, 0, True)
    sa, (st, _) = ga.run(sa, 2), gt.rollout(st, 2, record=False)
    _assert_same_state(sa, st, "published")
    assert int(st.first_step[friend, 0]) >= 0
    assert not bool(st.mesh[0, s0]) and not bool(st.mesh[friend, r0])


def test_direct_edges_validation():
    n, k = 16, 8
    builder, nbrs, rev, valid = _pinned(n, k, 1)
    bad = np.zeros((n, k), bool)
    bad[0, int(np.nonzero(valid[0])[0][0])] = True
    unwired = np.zeros((n, k), bool)
    unwired[0, int(np.nonzero(~valid[0])[0][0])] = True
    for mask, match in ((bad, "symmetric"), (unwired, "unwired")):
        ga, gt = gossip_pair(n_peers=n, n_slots=k, conn_degree=4,
                             msg_window=8, builder=builder, direct_edges=mask)
        with pytest.raises(ValueError, match=match):
            ga.init(seed=0)
        with pytest.raises(ValueError, match=match):
            gt.init(seed=0)
    with pytest.raises(ValueError, match=r"\[N=16, K=8\]"):
        TG(n_peers=n, n_slots=k, direct_edges=np.zeros((n, 4), bool),
           device="cpu")


def test_direct_edge_respects_receiver_subscription():
    n, k = 32, 8
    builder, direct, friend, _, _ = _friend_edge(n, k)
    ga, gt = gossip_pair(n_peers=n, n_slots=k, conn_degree=4, msg_window=8,
                         builder=builder, direct_edges=direct)
    sub = np.ones(n, bool)
    sub[friend] = False
    sa = ga.set_subscribed(ga.init(seed=0), jnp.asarray(sub))
    st = gt.set_subscribed(gt.init(seed=0), sub)
    sa = ga.publish(sa, jnp.int32(0), jnp.int32(0), jnp.asarray(True))
    st = gt.publish(st, 0, 0, True)
    sa, (st, _) = ga.run(sa, 8), gt.rollout(st, 8, record=False)
    _assert_same_state(sa, st, "unsubscribed direct peer")
    assert int(st.first_step[friend, 0]) < 0


def test_direct_edges_recorded_rollout_matches_reference():
    """200 peers, 10% of the edge pairs direct, a non-flooding publisher
    set (fanout picks exclude direct edges), unsubscribed peers, a kill:
    every leaf and record channel after 24 recorded rounds."""
    n, k = 200, 16
    builder, nbrs, rev, valid = _pinned(n, k, 5, degree=12)
    de = direct_edges_for(nbrs, rev, valid, 0.1, 2)
    kw = dict(n_peers=n, n_slots=k, conn_degree=12, msg_window=64,
              builder=builder, direct_edges=de)
    ga = JG(use_pallas=False, params=JP(flood_publish=False), **kw)
    gt = TG(params=TP(flood_publish=False), device="cpu", **kw)
    sub = np.random.default_rng(1).random(n) < 0.9
    sa = ga.set_subscribed(ga.init(seed=4), jnp.asarray(sub))
    st = gt.set_subscribed(gt.init(seed=4), sub)
    _assert_same_state(sa, st, "init")
    for s in range(20):
        src = (s * 37) % n
        sa = ga.publish(sa, jnp.int32(src), jnp.int32(s), jnp.asarray(s != 7))
        st = gt.publish(st, src, s, s != 7)
    kill = np.zeros(n, bool)
    kill[:: 17] = True
    sa, st = ga.kill_peers(sa, jnp.asarray(kill)), gt.kill_peers(st, kill)
    sa, ra = ga.rollout(sa, 24, record=True)
    st, rt = gt.rollout(st, 24, record=True)
    _assert_same_state(sa, st, "rollout")
    _assert_same_record(ra, rt, "rollout")
    mesh = st.mesh.numpy()
    assert not (mesh & de).any(), "a direct edge entered the mesh"
    plain = dict(n_peers=n, n_slots=k, device="cpu")
    assert TG(direct_edges=de, **plain) == TG(direct_edges=de, **plain)
    assert TG(direct_edges=de, **plain) != TG(**plain)


# -- utils/faults.py -------------------------------------------------------------


def small_trees(n=8):
    params = dict(max_peers=n, max_width=8, queue_cap=16, out_cap=32)
    js = jt.init_state(jcfg.SimParams(**params), jcfg.TreeOpts(), root=0)
    ts = tt.init_state(tcfg.SimParams(**params), tcfg.TreeOpts(), root=0,
                       device="cpu")
    steps = 4 * int(np.ceil(np.log2(n))) + 8
    js = jt.run_steps(jt.begin_subscribe_many(js, jnp.arange(n) > 0), steps)
    ts = tt.run_steps(tt.begin_subscribe_many(ts, torch.arange(n) > 0),
                      steps)
    return js, ts


def test_run_with_faults_tree_kill_and_leave_match_reference():
    js, ts = small_trees(8)
    js = jt.publish_many(js, jnp.arange(6, dtype=jnp.int32))
    ts = tt.publish_many(ts, torch.arange(6, dtype=torch.int32))
    outs = []
    for fx, st, ops in ((jfaults, js, jt), (tfaults, ts, tt)):
        plan = fx.FaultPlan().kill_at(4, [3], 8).leave_at(9, [5], 8)
        outs.append(fx.run_with_faults(
            st, 40, lambda s, k, ops=ops: ops.run_steps(s, k), plan,
            lambda s, m: s._replace(alive=s.alive & ~m),
            lambda s, m: s._replace(leaving=s.leaving | m)))
    assert_same_tree(outs[0], outs[1], "run_with_faults")
    out_len, alive = outs[1].out_len.numpy(), outs[1].alive.numpy()
    assert not alive[3] and not alive[5]
    assert all(out_len[p] > 0 for p in range(1, 8) if p not in (3, 5))


def test_run_with_faults_gossip_matches_reference():
    ga, gt = gossip_pair(n_peers=64, n_slots=16, conn_degree=8,
                         msg_window=8)
    sa = ga.publish(ga.init(seed=0), jnp.asarray(0), jnp.asarray(0),
                    jnp.asarray(True))
    st = gt.publish(gt.init(seed=0), 0, 0, True)
    kill = np.zeros(64, bool)
    kill[10:20] = True
    pa, pt = jfaults.FaultPlan(), tfaults.FaultPlan()
    pa.kills[2] = pt.kills[2] = kill
    oa = jfaults.run_with_faults(sa, 32, ga.run, pa, ga.kill_peers)
    ot = tfaults.run_with_faults(
        st, 32, lambda s, k: gt.rollout(s, k, record=False)[0], pt,
        gt.kill_peers)
    _assert_same_state(oa, ot, "run_with_faults gossip")
    assert int(ot.alive.sum()) == 54
    have = gt.have_bool(ot)[:, 0].numpy()
    assert have[ot.alive.numpy()].all()


def test_fault_plan_validation_and_generators_match_reference():
    def run(fx):
        out = []
        plan = fx.FaultPlan().kill_at(3, [1, 2], 8).kill_at(6, [5], 8)
        out.append(plan.liveness_timeline(8, 8).tolist())
        for bad in ([8], [-1]):
            with pytest.raises(ValueError) as err:
                fx.FaultPlan().kill_at(0, bad, 8)
            out.append(str(err.value))
        with pytest.raises(ValueError, match="out of range"):
            fx.FaultPlan().leave_at(0, [3, 99], 8)
        with pytest.raises(ValueError, match="shape"):
            fx.FaultPlan().kill_at(0, np.zeros(4, bool), 8)
        with pytest.raises(TypeError, match="dtype"):
            fx.FaultPlan().kill_at(0, np.array([0.5, 1.5]), 8)
        mask = np.zeros(8, bool)
        mask[2] = True
        plan = fx.FaultPlan().kill_at(3, mask, 8).kill_at(3, [5], 8)
        out.append(plan.kills[3].tolist())
        with pytest.raises(ValueError, match="n=8"):
            plan.kill_at(3, [1], 16)
        plan = fx.FaultPlan().leave_at(1, [2], 4)
        with pytest.raises(ValueError, match="leave_fn"):
            fx.run_with_faults(None, 4, lambda s, k: s, plan, lambda s, m: s)
        out.append(fx.sybil_ip_groups(16, 4).tolist())
        out.append(fx.sybil_ip_groups(16, 4, group=3,
                                      honest_unique=False).tolist())
        att, plan = fx.eclipse_campaign(np.random.default_rng(0), n=32,
                                        target=0, n_attackers=8,
                                        start_step=4, n_steps=32)
        out.append((att.tolist(), {t: m.tolist()
                                   for t, m in plan.kills.items()}))
        return out

    assert run(tfaults) == run(jfaults)


# -- export_mesh -----------------------------------------------------------------


def test_export_mesh_matches_reference():
    ga, gt = gossip_pair(n_peers=32, n_slots=8, conn_degree=4, msg_window=4)
    sa, st = ga.init(seed=0), gt.init(seed=0)
    adj = ttrace.export_mesh(st)
    assert adj == jtrace.export_mesh(sa)
    for p, nbrs in adj.items():
        for q in nbrs:
            assert p in adj[q]


# -- copies pinned to their originals --------------------------------------------


@pytest.mark.parametrize("name", ["TreeOpts", "SimParams"])
def test_tree_config_classes_match_reference(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    rf = [(f.name, f.type, f.default) for f in dataclasses.fields(ref)]
    pf = [(f.name, f.type, f.default) for f in dataclasses.fields(port)]
    assert rf == pf
    assert dataclasses.asdict(ref()) == dataclasses.asdict(port())
    assert (tcfg.DEFAULT_TREE_WIDTH, tcfg.DEFAULT_TREE_MAX_WIDTH) == (
        jcfg.DEFAULT_TREE_WIDTH, jcfg.DEFAULT_TREE_MAX_WIDTH) == (2, 5)


# The port's ``run_with_faults`` puts the plan's masks on the state's
# device where the reference calls ``jnp.asarray``; nothing else differs.
_FAULTS_SUBSTITUTIONS = (
    ("    import jax.numpy as jnp\n",
     "    import torch\n\n    def on_device(mask):\n"
     "        return torch.as_tensor(mask, device=st.alive.device)\n"),
    ("kill_fn(st, jnp.asarray(plan.kills[t]))",
     "kill_fn(st, on_device(plan.kills[t]))"),
    ("leave_fn(st, jnp.asarray(plan.leaves[t]))",
     "leave_fn(st, on_device(plan.leaves[t]))"),
)


def test_faults_module_is_a_copy_of_the_reference():
    with open(os.path.join(REPO, "go_libp2p_pubsub_tpu/utils/faults.py")) as f:
        ref = f.read()
    with open(os.path.join(REPO,
                           "go_libp2p_pubsub_torch/utils/faults.py")) as f:
        port = f.read()
    for a, b in _FAULTS_SUBSTITUTIONS:
        assert ref.count(a) == 1, a
        ref = ref.replace(a, b)
    assert port == ref
