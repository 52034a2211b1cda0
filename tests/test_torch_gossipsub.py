"""The PyTorch port's GossipSub model held against the JAX package's, leaf
for leaf: the state bridge, ``init``, and a recorded rollout with a peer
kill, started from one bridged state, flight record and delivery stats
included.  Every leaf is compared exactly (f32 scores and counters bit
for bit); the only tolerance is on ``gossip_metrics``' two float means,
whose reductions add in another order than XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.config import GossipSubParams as JP
from go_libp2p_pubsub_tpu.config import ScoreParams as JS
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG
from go_libp2p_pubsub_tpu.models.gossipsub import GossipState as JState
from go_libp2p_pubsub_tpu.utils.metrics import flight_summary as j_summary
from go_libp2p_pubsub_tpu.utils.metrics import gossip_metrics as j_metrics
from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG
from go_libp2p_pubsub_torch.models.gossipsub import resolve_device
from go_libp2p_pubsub_torch.utils.metrics import flight_summary as t_summary
from go_libp2p_pubsub_torch.utils.metrics import gossip_metrics as t_metrics

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


def _assert_same_state(ref, port, what):
    la, lb = _leaves(ref), _leaves(bridge.state_to_numpy(port))
    assert la.keys() == lb.keys()
    for name in la:
        a, b = la[name], lb[name]
        assert a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, name)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {name}")


def _assert_same_record(ref, port, what):
    assert sorted(ref) == sorted(port)
    for name in ref:
        a, b = np.asarray(ref[name]), port[name].numpy()
        assert a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(
            b.astype(a.dtype).view(np.int32) if a.dtype == np.float32 else
            b.astype(a.dtype),
            a.view(np.int32) if a.dtype == np.float32 else a,
            err_msg=f"{what}: {name}")


def test_bridge_round_trips_a_reference_state():
    ga = JG(use_pallas=False, **KW)
    sa = ga.init(seed=3)
    sa = ga.publish(sa, jnp.int32(5), jnp.int32(0), jnp.asarray(True))
    st = bridge.state_from_jax(sa, device="cpu")
    assert st.nbrs.dtype == torch.uint16 and st.have_w.dtype == torch.int32
    assert isinstance(st.step, int)
    back = bridge.state_to_numpy(st)
    _assert_same_state(sa, st, "bridge")
    # The numpy form rebuilds a reference state that steps like the original.
    rebuilt = JState(*(
        type(v)(*map(jnp.asarray, v)) if hasattr(v, "_fields")
        else jnp.asarray(v) for v in back))
    for a, b in zip(jax.tree.leaves(ga.step(rebuilt)),
                    jax.tree.leaves(ga.step(sa))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    p = JP(d=7, d_hi=13, idontwant=True)
    assert bridge.params_from(p) == type(bridge.params_from(p))(
        **{f: getattr(p, f) for f in p.__dataclass_fields__})


@pytest.mark.parametrize("seed", [3, 8])
def test_init_matches_reference(seed):
    ga, gt = JG(use_pallas=False, **KW), TG(device="cpu", **KW)
    _assert_same_state(ga.init(seed=seed), gt.init(seed=seed), "init")


@pytest.mark.parametrize("fused", [True, False])
def test_recorded_rollout_with_kill_matches_reference(fused):
    """40 recorded rounds (five heartbeats, a kill at round 10, IHAVE/IWANT,
    PX) from one bridged state are leaf for leaf the reference's, flight
    record, delivery stats and flight summary included."""
    params = JP(d_lo=5, d_hi=9, max_ihave_length=40, max_iwant_length=24)
    # A low PX acceptance threshold makes prunes rewire the topology.
    sparams = JS(accept_px_threshold=0.0)
    kw = dict(KW, params=params, score_params=sparams, fused_prologue=fused)
    ga = JG(use_pallas=False, **kw)
    gt = TG(device="cpu", **dict(kw, params=bridge.params_from(params),
                                 score_params=bridge.params_from(sparams)))
    sa = ga.init(seed=3)
    st = bridge.state_from_jax(sa, device="cpu")
    valid0 = np.asarray(sa.nbr_valid)
    for s in range(6):
        valid = s != 2
        sa = ga.publish(sa, jnp.int32(s * 7), jnp.int32(s), jnp.asarray(valid))
        st = gt.publish(st, s * 7, s, valid)
    _assert_same_state(sa, st, "publish")

    sa, ra = ga.rollout(sa, 10, record=True)
    st, rt = gt.rollout(st, 10, record=True)
    _assert_same_state(sa, st, "rounds 0-9")
    _assert_same_record(ra, rt, "record 0-9")

    kill = np.zeros(KW["n_peers"], bool)
    kill[::7] = True
    sa = ga.kill_peers(sa, jnp.asarray(kill))
    st = gt.kill_peers(st, torch.from_numpy(kill))
    sa, ra = ga.rollout(sa, 4, record=True)
    st, rt = gt.rollout(st, 4, record=True)
    _assert_same_record(ra, rt, "record 10-13")
    # Publishing right before the heartbeat at round 15 leaves ids in
    # flight for IHAVE/IWANT to carry.
    for s in range(6, 12):
        sa = ga.publish(sa, jnp.int32(s * 11), jnp.int32(s), jnp.asarray(True))
        st = gt.publish(st, s * 11, s, True)
    sa, ra = ga.rollout(sa, 26, record=True)
    st, rt = gt.rollout(st, 26, record=True)
    _assert_same_state(sa, st, "rounds 10-39")
    _assert_same_record(ra, rt, "record 14-39")
    assert int(np.asarray(ra["gossip_pending"]).sum()) > 0  # gossip ran
    assert (np.asarray(sa.nbr_valid) != valid0).any()     # PX rewired

    for a, b in zip(ga.delivery_stats(sa), gt.delivery_stats(st)):
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      np.asarray(a).view(np.int32))
    np.testing.assert_array_equal(gt.have_bool(st).numpy(),
                                  np.asarray(ga.have_bool(sa)))
    assert t_summary(rt) == j_summary(ra)

    ma, mt = j_metrics(sa), t_metrics(st)
    assert sorted(ma) == sorted(mt)
    for name in ma:
        # nanmean's float sums add in another order than XLA's: 1e-6 rel.
        np.testing.assert_allclose(float(mt[name]), float(ma[name]),
                                   rtol=1e-6, err_msg=name)


def test_fanout_publish_and_idontwant_match_reference():
    """The other arms of the round: publishers outside the topic keep a
    fanout set (``flood_publish=False``), and IDONTWANT with the wire-lag
    snapshot trims duplicate counting."""
    params = JP(flood_publish=False, idontwant=True, idontwant_wire_lag=True)
    kw = dict(KW, params=params, heartbeat_steps=4)
    ga = JG(use_pallas=False, **kw)
    gt = TG(device="cpu", **dict(kw, params=bridge.params_from(params)))
    sub = np.ones(KW["n_peers"], bool)
    sub[::5] = False
    sa, st = ga.init(seed=6, subscribed=sub), gt.init(seed=6, subscribed=sub)
    _assert_same_state(sa, st, "init")
    for s in range(8):
        src = s * 5 if s % 2 else s * 3 + 1   # odd s: a non-member
        sa = ga.publish(sa, jnp.int32(src), jnp.int32(s), jnp.asarray(True))
        st = gt.publish(st, src, s, True)
    _assert_same_state(sa, st, "publish")
    assert np.asarray(sa.fanout).any()
    sa, ra = ga.rollout(sa, 16, record=True)
    st, rt = gt.rollout(st, 16, record=True)
    _assert_same_state(sa, st, "rollout")
    _assert_same_record(ra, rt, "record")


@pytest.mark.parametrize("n", [200, 65534, 65535, 100_000])
def test_index_storage_dtypes_match_reference(n):
    """Peer-index planes are stored as narrow as the reference stores them:
    uint16 up to 65,534 peers, int32 above; slot planes stay uint16."""
    kw = dict(KW, n_peers=n)
    ga, gt = JG(use_pallas=False, **kw), TG(device="cpu", **kw)
    assert (gt.idx_dtype, gt.rev_dtype) == (ga.idx_dtype, ga.rev_dtype)
    assert gt.rev_dtype == np.uint16


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG(**KW)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
