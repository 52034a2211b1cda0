"""The PyTorch port's multi-topic model held against the JAX package's: the
per-topic keys (``fold_in``), init, a 40-round event rollout with a kill,
PX rewiring, mute and delay windows and topic-stamped publishes (every
state leaf and record channel, both index widths), the fanout arm,
``delivery_stats`` and the streaming digests, the canon's
``multitopic_hot_publisher`` and the ``trace_out`` artifact.  Every
comparison is exact (f32 bit for bit).  Then the behaviours of the
reference's ``tests/test_multitopic.py``, on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import scenario as jscn
from go_libp2p_pubsub_tpu.config import GossipSubParams as JP
from go_libp2p_pubsub_tpu.config import ScoreParams as JS
from go_libp2p_pubsub_tpu.models.multitopic import MultiTopicGossipSub as JM
from go_libp2p_pubsub_tpu.ops import schedule as jsched
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch import scenario as tscn
from go_libp2p_pubsub_torch.config import ScoreParams as TS
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG
from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub as TM
from go_libp2p_pubsub_torch.ops import rng as trng
from go_libp2p_pubsub_torch.ops import schedule as tsched
from go_libp2p_pubsub_torch.scenario.runner import flight_to_jsonable

KW = dict(n_topics=3, n_peers=200, n_slots=16, conn_degree=12,
          msg_window=64, heartbeat_steps=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of small ops: with several test workers on the same cores,
    torch's intra-op thread pools spin against each other and run them
    several times slower.  One thread per op keeps them fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    la = _leaves(ref)
    lb = _leaves(bridge.multitopic_state_to_numpy(port))
    assert la.keys() == lb.keys()
    for name in la:
        a, b = la[name], lb[name]
        assert a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, name)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {name}")


def assert_same_record(ref, port, what):
    assert sorted(ref) == sorted(port), what
    for name in ref:
        a, b = np.asarray(ref[name]), np.asarray(port[name])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), f"{what}: {name}"


def _pair(**kw):
    jkw = dict(KW, **kw)
    tkw = dict(jkw)
    for key in ("params", "score_params"):
        if key in tkw:
            tkw[key] = bridge.params_from(tkw[key])
    return JM(**jkw), TM(device="cpu", **tkw)


# -- fold_in -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 41, 2**32 - 1])
def test_fold_in_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
    for data in (0, 1, 2, 3, 30, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1):
        np.testing.assert_array_equal(
            trng.fold_in(tk, data).numpy().view(np.uint32),
            np.asarray(jax.random.fold_in(jk, data)))
    t = 7
    np.testing.assert_array_equal(
        trng.fold_in(tk, torch.arange(t)).numpy().view(np.uint32),
        np.asarray(jax.vmap(jax.random.fold_in, (None, 0))(
            jk, jnp.arange(t))))


# -- the model, leaf for leaf ------------------------------------------------


def _events(n, t_steps=40, width=3):
    """Topic-stamped publishes (some invalid) over 30 rounds, a kill at
    round 10, a mute window 5-25 and a delay window 12-28."""
    ev = jsched.empty_multitopic_events(t_steps, n, width)
    slot = 0
    for t in range(0, 30, 2):
        for j in range(1 + t % 3):
            src = (t * 13 + j * 29 + 1) % n
            jsched.add_publish(ev, t, {"src": src, "slot": slot % 64,
                                       "valid": (t + j) % 7 != 3,
                                       "topic": (t + j) % 3})
            slot += 1
    ev.kill[10, ::7] = True
    ev.mute_on[5, [1, 2, 3, 50]] = True
    ev.mute_off[25, [1, 2, 3, 50]] = True
    ev.delay[12, 100:140] = 2
    ev.delay[28, 100:140] = 0
    return ev


@pytest.mark.parametrize("wide", [False, True])
def test_rollout_events_matches_reference(wide):
    """40 recorded rounds (ten heartbeats) of kills, PX rewiring, mute and
    delay windows and topic-stamped publishes from one seed are leaf for
    leaf the reference's, every record channel included, with the narrow
    index storage and with ``index_dtype_override=np.int32``."""
    kw = dict(params=JP(d_lo=5, d_hi=9, max_ihave_length=40,
                        max_iwant_length=24),
              score_params=JS(accept_px_threshold=0.0))
    if wide:
        kw["index_dtype_override"] = np.int32
    jm, tm = _pair(**kw)
    sa, st = jm.init(seed=3), tm.init(seed=3)
    assert_same_state(sa, st, "init")
    valid0 = np.asarray(sa.nbr_valid)
    ev = _events(KW["n_peers"])
    tev = tsched.MultiTopicEvents(*ev)
    half = lambda e, a, b: type(e)(*(x[a:b] for x in e))  # noqa: E731
    sa, ra = jm.rollout_events(sa, half(ev, 0, 20), record=True)
    st, rt = tm.rollout_events(st, half(tev, 0, 20), record=True)
    assert_same_state(sa, st, "rounds 0-19")
    assert_same_record(ra, rt, "record 0-19")
    sa, ra = jm.rollout_events(sa, half(ev, 20, 40), record=True)
    st, rt = tm.rollout_events(st, half(tev, 20, 40), record=True)
    assert_same_state(sa, st, "rounds 20-39")
    assert_same_record(ra, rt, "record 20-39")
    assert (np.asarray(sa.nbr_valid) != valid0).any()       # PX rewired
    assert int(np.asarray(ra["gossip_pending"]).sum()) > 0  # gossip ran
    for a, b in zip(jm.delivery_stats(sa), tm.delivery_stats(st)):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      np.asarray(a).view(np.int32))
    jd, td = jm.stream_digest(sa), tm.stream_digest(st)
    assert sorted(jd) == sorted(td)
    for name in jd:
        np.testing.assert_array_equal(np.asarray(td[name]),
                                      np.asarray(jd[name]), err_msg=name)
    np.testing.assert_array_equal(
        tm.stream_deliver_steps(st, 8, 0.99).numpy(),
        np.asarray(jm.stream_deliver_steps(sa, 8, 0.99)))


def test_fanout_publish_and_subscription_match_reference():
    """Non-subscribed publishers keep a fanout set (``flood_publish=False``),
    unsubscribed peers sit out of their topic, and ``step``/``run``/
    ``publish``/``kill_peers``/``set_gossip_*`` equal the reference's."""
    jm, tm = _pair(params=JP(flood_publish=False), n_topics=2)
    sub = np.ones((2, KW["n_peers"]), bool)
    sub[0, ::5] = False
    sub[1, 1::3] = False
    sa, st = jm.init(seed=6, subscribed=sub), tm.init(seed=6, subscribed=sub)
    assert_same_state(sa, st, "init")
    for s in range(8):
        topic, src = s % 2, (s * 5 if s % 2 == 0 else s * 3 + 1)
        sa = jm.publish(sa, jnp.int32(topic), jnp.int32(src), jnp.int32(s),
                        jnp.asarray(s != 5))
        st = tm.publish(st, topic, src, s, s != 5)
    assert_same_state(sa, st, "publish")
    assert np.asarray(sa.fanout).any()
    delay = np.zeros(KW["n_peers"], np.int32)
    delay[::4] = 1
    mute = np.zeros(KW["n_peers"], bool)
    mute[7::11] = True
    sa = jm.set_gossip_mute(jm.set_gossip_delay(sa, jnp.asarray(delay)),
                            jnp.asarray(mute))
    st = tm.set_gossip_mute(tm.set_gossip_delay(st, delay), mute)
    sa, st = jm.run(sa, 6), tm.run(st, 6)
    assert_same_state(sa, st, "run")
    kill = np.zeros(KW["n_peers"], bool)
    kill[3::17] = True
    sa, st = jm.kill_peers(sa, jnp.asarray(kill)), tm.kill_peers(st, kill)
    for _ in range(6):
        sa, st = jm.step(sa), tm.step(st)
    assert_same_state(sa, st, "step")
    np.testing.assert_array_equal(tm.have_bool(st).numpy(),
                                  np.asarray(jm.have_bool(sa)))


def test_bridge_round_trips_a_reference_state():
    jm, tm = _pair(n_topics=2)
    sa = jm.publish(jm.init(seed=1), jnp.int32(1), jnp.int32(4),
                    jnp.int32(0), jnp.asarray(True))
    st = bridge.multitopic_state_from_jax(sa, device="cpu")
    assert st.nbrs.dtype == torch.uint16 and st.keys.dtype == torch.int32
    assert isinstance(st.step, int)
    assert_same_state(sa, st, "bridge")
    spec = bridge.multitopic_state_spec(st)
    for (name, a), b in zip(_leaves(sa).items(), _leaves(spec).values()):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name


def test_value_semantics():
    a, b = TM(device="cpu", **KW), TM(device="cpu", **KW)
    assert a == b and hash(a) == hash(b)
    assert a != TM(device="cpu", **dict(KW, n_topics=2))
    assert a != TM(device="cpu", **dict(KW, msg_window=32))
    assert TG(device="cpu") == TG(device="cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM(**KW)


# -- the scenario path ---------------------------------------------------------


def test_canon_multitopic_hot_publisher_matches_reference(tmp_path):
    """The canon's multitopic campaign: the same events, verdict, record
    (exact bytes through the trace encoding) and final state, and the
    ``trace_out`` artifact byte for byte."""
    name = "multitopic_hot_publisher"
    assert tscn.sim_supported(tscn.build(name))
    ja, ta = tmp_path / "ref.json", tmp_path / "port.json"
    ref = jscn.run_scenario(jscn.build(name), trace_out=str(ja))
    out = tscn.run_scenario(tscn.build(name), device="cpu", trace_out=str(ta))
    for a, b in zip(ref.compiled.events, out.compiled.events):
        np.testing.assert_array_equal(b, a)
    assert out.compiled.n_publishes == ref.compiled.n_publishes
    assert out.verdict.to_dict() == ref.verdict.to_dict()
    assert flight_to_jsonable(out.record) == flight_to_jsonable(
        {k: np.asarray(v) for k, v in ref.record.items()})
    assert_same_state(ref.final_state, out.final_state, name)
    assert ta.read_bytes() == ja.read_bytes()


@pytest.mark.parametrize("change, match", [
    (dict(graceful=True), "graceful churn"),
    (dict(rejoin_after=2), "rejoin"),
])
def test_multitopic_lowering_refuses_what_the_reference_refuses(change,
                                                                 match):
    spec = tscn.build("multitopic_hot_publisher")
    spec.churn = [tscn.ChurnPhase(start=2, stop=8, every=2, **change)]
    with pytest.raises(ValueError, match=match):
        tscn.compile_scenario(spec, device="cpu")
    spec = tscn.build("multitopic_hot_publisher")
    spec.attacks = [tscn.AttackWave(kind="eclipse", target=5)]
    with pytest.raises(ValueError, match="gossipsub-only"):
        tscn.compile_scenario(spec, device="cpu")


# -- the reference's behaviours (tests/test_multitopic.py), on the port -------


@pytest.fixture(scope="module")
def mt():
    return TM(device="cpu", n_topics=3, n_peers=96, n_slots=16,
              conn_degree=8, msg_window=32)


@pytest.fixture(scope="module")
def st0(mt):
    return mt.init(seed=2)


def test_meshes_converge_independently(mt, st0):
    mesh = st0.mesh.numpy()
    deg = mesh.sum(axis=2)
    assert (deg.max(axis=1) <= mt.params.d_hi).all()
    assert deg.mean() >= mt.params.d_lo - 1
    assert (mesh[0] != mesh[1]).any() and (mesh[1] != mesh[2]).any()


def test_topic_isolation(mt, st0):
    st = mt.run(mt.publish(st0, 1, 0, 0, True), 24)
    frac, p50, _ = mt.delivery_stats(st)
    assert frac[1, 0] == 1.0
    have = mt.have_bool(st).numpy()
    assert not have[0].any() and not have[2].any()
    assert float(p50[1]) > 0


def test_subscription_masks_delivery(mt):
    sub = np.ones((3, 96), bool)
    sub[0, 48:] = False
    st = mt.run(mt.publish(mt.init(seed=4, subscribed=sub), 0, 0, 0, True),
                24)
    have = mt.have_bool(st).numpy()[0, :, 0]
    assert have[:48].all() and not have[48:].any()
    nbrs = st.nbrs.numpy().astype(np.int64)
    assert (st.mesh[0].numpy() & (nbrs >= 48))[:48].sum() == 0


def test_invalid_spam_in_one_topic_prunes_attacker_everywhere():
    m = TM(device="cpu", n_topics=2, n_peers=64, n_slots=16, conn_degree=8,
           msg_window=32, score_params=TS(
               invalid_message_deliveries_weight=-50.0,
               invalid_message_deliveries_decay=0.9))
    st = m.init(seed=7)
    for slot in range(12):
        st = m.run(m.publish(st, 0, 0, slot, False), 4)
    st = m.run(st, 2 * m.heartbeat_steps)
    mesh = st.mesh.numpy()
    to_attacker = st.nbr_valid.numpy() & (st.nbrs.numpy() == 0)
    assert (mesh[0] & to_attacker).sum() == 0
    assert (mesh[1] & to_attacker).sum() == 0
    assert (mesh[1].sum(axis=1) > 0).mean() > 0.9


def test_multitopic_matches_singletopic_delivery():
    kw = dict(n_peers=96, n_slots=16, conn_degree=8, msg_window=32)
    m, g = TM(device="cpu", n_topics=1, **kw), TG(device="cpu", **kw)
    sm = m.run(m.publish(m.init(seed=3), 0, 5, 0, True), 24)
    sg = g.init(seed=3)
    sg = g.publish(sg, 5, 0, True)
    for _ in range(24):
        sg = g.step(sg)
    assert float(m.delivery_stats(sm)[0][0, 0]) == 1.0
    assert float(g.delivery_stats(sg)[0][0]) == 1.0


def test_publish_advances_topic_key():
    m = TM(device="cpu", n_topics=2, n_peers=32, n_slots=8, conn_degree=4,
           msg_window=8)
    st = m.init(seed=0)
    before = st.keys.clone()
    after = m.publish(st, 1, 0, 0, True).keys
    assert not torch.equal(before[1], after[1])
    assert torch.equal(before[0], after[0])


def test_publish_recycle_clears_stale_iwant_grants_multitopic():
    m = TM(device="cpu", n_topics=2, n_peers=32, n_slots=8, conn_degree=4,
           msg_window=8)
    st = m.init(seed=0)
    st = st._replace(iwant_pend_w=torch.full_like(st.iwant_pend_w, -1))
    iw = m.publish(st, 0, 0, 3, True).iwant_pend_w.numpy()
    assert not (iw[0] & (1 << 3)).any()
    assert (iw[1] & (1 << 3)).all()


def test_px_forms_new_edges_and_preserves_pairing():
    from go_libp2p_pubsub_torch.config import GossipSubParams as TP

    m = TM(device="cpu", n_topics=3, n_peers=96, n_slots=24,
           conn_degree=16, msg_window=32, params=TP(d=6, d_lo=4, d_hi=7),
           score_params=TS(accept_px_threshold=-1.0))
    raw_valid = m.gs.build_graph(seed=4)[2].numpy()
    st = m.run(m.init(seed=4), 4 * m.heartbeat_steps)
    nbrs = st.nbrs.numpy().astype(np.int64)
    rev = st.rev.numpy().astype(np.int64)
    valid = st.nbr_valid.numpy()
    assert valid.sum() > raw_valid.sum()
    ii, ss = np.nonzero(valid)
    jj, rr = nbrs[ii, ss], rev[ii, ss]
    np.testing.assert_array_equal(nbrs[jj, rr], ii)
    np.testing.assert_array_equal(rev[jj, rr], ss)
    mesh = st.mesh.numpy()
    for t in range(m.t):
        sym = np.zeros_like(mesh[t])
        sym[ii, ss] = mesh[t][jj, rr]
        np.testing.assert_array_equal(mesh[t], sym)
    assert not (mesh & ~valid[None]).any()

