"""The port's ``SimNetwork`` front door held against the JAX package's: the
reference's integration contracts (``tests/test_parity.py``, the Go
reference's ``pubsub_test.go``) and the tree cases of
``tests/test_link_profile.py``, each run on both packages (the port with
``device="cpu"``) with the same calls.  Each case returns everything its
subscribers received, message for message, and the two packages' logs
must be equal; the reference's own assertions hold on both.  Then the
``TreeOpts``/``SimParams`` validation cases on both packages' classes."""

import functools
import types

import numpy as np
import pytest
import torch

import go_libp2p_pubsub_torch as tpkg
from go_libp2p_pubsub_torch import api as tapi
from go_libp2p_pubsub_torch.config import SimParams, TreeOpts
from go_libp2p_pubsub_torch.ops import tree as tt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _namespace(pkg: str):
    if pkg == "jax":
        import jax.numpy as jnp

        from go_libp2p_pubsub_tpu import api
        from go_libp2p_pubsub_tpu import config
        from go_libp2p_pubsub_tpu.ops import tree

        return types.SimpleNamespace(
            net=lambda params: api.SimNetwork(params), api=api,
            SimParams=config.SimParams, TreeOpts=config.TreeOpts,
            tree=tree, init_state=tree.init_state, arr=jnp.asarray,
            peer=jnp.int32, host=np.asarray)
    return types.SimpleNamespace(
        net=lambda params: tapi.SimNetwork(params, device="cpu"), api=tapi,
        SimParams=SimParams, TreeOpts=TreeOpts, tree=tt,
        init_state=functools.partial(tt.init_state, device="cpu"),
        arr=lambda a: torch.as_tensor(np.asarray(a)), peer=int,
        host=lambda t: t.numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t))


def init_pubsub(ns, hosts):
    tms = [ns.api.TopicManager(h) for h in hosts]
    topic = tms[0].new_topic("foobar")
    subchs = [tm.subscribe(hosts[0].id, "foobar") for tm in tms[1:]]
    return topic, tms, subchs


def check_system(log, topic, subs, skip=None, mid=0):
    """``checkSystem`` (pubsub_test.go:101-131): publish one message, every
    non-skipped subscriber receives those exact bytes (logged)."""
    skip = skip or set()
    mes = f"message number {mid}".encode()
    topic.publish_message(mes)
    for i, ch in enumerate(subs):
        if i in skip:
            continue
        data = ch.get()
        log.append((i, data))
        assert data == mes, f"wrong data on node {i}"


def settle_and_clear(log, net, subs, steps=16):
    net.step(steps)
    for i, s in enumerate(subs):
        if not s.closed:
            log.append((i, list(s.messages())))


# -- tests/test_parity.py -------------------------------------------------------


def case_basic_pubsub(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(4))
    for i in range(10):
        check_system(log, topic, subchs, None, i)
    return log


def case_nodes_dropping(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8))
    hosts = net.make_hosts(4)
    topic, _, subchs = init_pubsub(ns, hosts)
    check_system(log, topic, subchs, None, 0)
    hosts[1].close()
    check_system(log, topic, subchs, {0, 2}, 1)
    settle_and_clear(log, net, subchs)
    for i in range(10):
        check_system(log, topic, subchs, {0}, i + 100)
    return log


def case_lower_nodes_dropping(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=16))
    hosts = net.make_hosts(8)
    topic, _, subchs = init_pubsub(ns, hosts)
    check_system(log, topic, subchs, None, 0)
    hosts[3].close()
    net.step(8)
    check_system(log, topic, subchs, {2, 5, 6}, 1)
    settle_and_clear(log, net, subchs)
    for i in range(10):
        check_system(log, topic, subchs, {2}, i + 100)
    return log


def case_nodes_dropping_gracefully(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(4))
    check_system(log, topic, subchs, None, 0)
    subchs[0].close()
    net.step(8)
    check_system(log, topic, subchs, {0}, 1)
    settle_and_clear(log, net, subchs)
    for i in range(10):
        check_system(log, topic, subchs, {0}, i + 100)
    return log


def case_exact_fifo_order_per_subscriber(ns):
    net = ns.net(ns.SimParams(max_peers=8))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(5))
    for i in range(8):
        topic.publish_message(f"m{i}".encode())
    log = [[ch.get() for _ in range(8)] for ch in subchs]
    assert all(got == [f"m{i}".encode() for i in range(8)] for got in log)
    return log


def case_larger_tree_all_deliver(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=40))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(32))
    for i in range(3):
        check_system(log, topic, subchs, None, i)
    return log


def case_multi_topic_independent_trees(ns):
    net = ns.net(ns.SimParams(max_peers=8))
    hosts = net.make_hosts(4)
    tms = [ns.api.TopicManager(h) for h in hosts]
    t_a = tms[0].new_topic("alpha")
    t_b = tms[1].new_topic("beta")
    subs_a = [tms[i].subscribe(hosts[0].id, "alpha") for i in (1, 2, 3)]
    subs_b = [tms[i].subscribe(hosts[1].id, "beta") for i in (0, 2, 3)]
    t_a.publish_message(b"on-alpha")
    t_b.publish_message(b"on-beta")
    log = [s.get() for s in subs_a] + [s.get() for s in subs_b]
    assert log == [b"on-alpha"] * 3 + [b"on-beta"] * 3
    return log


def case_custom_tree_opts_widths(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=16, max_width=8))
    hosts = net.make_hosts(6)
    tms = [ns.api.TopicManager(h) for h in hosts]
    topic = tms[0].new_topic("wide", ns.TreeOpts(tree_width=5,
                                                 tree_max_width=8))
    subs = [tm.subscribe(hosts[0].id, "wide") for tm in tms[1:]]
    eng = net.engines[topic.protoid]
    assert int(np.sum(ns.host(eng.state.children[0]) >= 0)) == 5
    check_system(log, topic, subs, None, 0)
    return log


def case_repair_timeout_rejoins_at_root(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8, repair_timeout_steps=8))
    hosts = net.make_hosts(4)
    topic, _, subchs = init_pubsub(ns, hosts)
    check_system(log, topic, subchs, None, 0)
    hosts[1].close()
    net.step(128)
    check_system(log, topic, subchs, {0}, 1)
    return log


def case_killed_subscriber_times_out(ns):
    net = ns.net(ns.SimParams(max_peers=8))
    hosts = net.make_hosts(4)
    topic, _, subchs = init_pubsub(ns, hosts)
    hosts[1].close()
    topic.publish_message(b"x")
    with pytest.raises(ns.api.TimeoutError_):
        subchs[0].get(step_budget=32)
    return [ch.try_get() for ch in subchs[1:]]


def case_close_tree_and_overflow(ns):
    """``Topic.close`` / ``close_tree``, the full network and an unknown
    topic, as the verify recipe's probe flows drive them."""
    net = ns.net(ns.SimParams(max_peers=3))
    hosts = net.make_hosts(3)
    with pytest.raises(RuntimeError, match="full"):
        net.host()
    topic, tms, subchs = init_pubsub(ns, hosts)
    topic.publish_message(b"a")
    log = [s.get() for s in subchs]
    with pytest.raises(KeyError, match="no topic"):
        tms[1].subscribe(hosts[0].id, "nope")
    topic.close_tree()
    net.step(4)
    assert "foobar" not in tms[0].topics
    eng = net.engines[topic.protoid]
    log.append(ns.host(eng.state.joined).tolist())
    log.append(repr(hosts[2]))
    return log


# -- tests/test_link_profile.py, the tree cases ---------------------------------


def case_basic_pubsub_parity_under_delay(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(4))
    net.set_link_profile(np.ones((8, 8), np.int32),
                         np.zeros((8, 8), np.float32))
    for i in range(10):
        check_system(log, topic, subchs, None, i)
    return log


def case_nodes_dropping_parity_under_delay(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8))
    hosts = net.make_hosts(4)
    topic, _, subchs = init_pubsub(ns, hosts)
    delays = np.random.default_rng(0).integers(0, 3, (8, 8)).astype(np.int32)
    net.set_link_profile(delays, np.zeros((8, 8), np.float32))
    check_system(log, topic, subchs, None, 0)
    hosts[1].close()
    check_system(log, topic, subchs, {0, 2}, 1)
    settle_and_clear(log, net, subchs, 24)
    for i in range(10):
        check_system(log, topic, subchs, {0}, i + 100)
    return log


def case_nodes_dropping_gracefully_parity_under_delay(ns):
    log = []
    net = ns.net(ns.SimParams(max_peers=8))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(4))
    net.set_link_profile(np.full((8, 8), 2, np.int32),
                         np.zeros((8, 8), np.float32))
    check_system(log, topic, subchs, None, 0)
    subchs[0].close()
    net.step(8)
    check_system(log, topic, subchs, {0}, 1)
    settle_and_clear(log, net, subchs, 24)
    for i in range(10):
        check_system(log, topic, subchs, {0}, i + 100)
    return log


def case_lossy_links_through_the_api(ns):
    """A nonzero drop probability on every edge: which copies are lost is
    the keyed draw, so both packages lose the same ones."""
    net = ns.net(ns.SimParams(max_peers=16, queue_cap=64, out_cap=64))
    topic, _, subchs = init_pubsub(ns, net.make_hosts(10))
    net.set_link_profile(np.zeros((16, 8), np.int32),
                         np.full((16, 8), 0.2, np.float32))
    for i in range(24):
        topic.publish_message(b"lossy %d" % i)
    net.step(48)
    return [list(s.messages()) for s in subchs]


def _width4_tree(ns, seed=0, **kw):
    params = ns.SimParams(max_peers=8, max_width=8, **kw)
    st = ns.init_state(params, ns.TreeOpts(tree_width=4), root=0, seed=seed)
    st = ns.tree.begin_subscribe_many(st, ns.arr(np.arange(8) < 4))
    for _ in range(8):
        st = ns.tree.step(st)
    assert int(ns.host(st.joined)[:4].sum()) == 4
    slot = int(np.where(ns.host(st.children)[0] == 1)[0][0])
    return st, slot


def case_delay_scopes_lag_to_delayed_subtree(ns):
    st, slot = _width4_tree(ns)
    delay = np.zeros((8, 8), np.int32)
    delay[0, slot] = 5
    st = ns.tree.set_link_profile(st, ns.arr(delay),
                                  ns.arr(np.zeros((8, 8), np.float32)))
    st = ns.tree.publish(st, ns.peer(0))
    log = []
    for _ in range(7):
        st = ns.tree.step(st)
        log.append(ns.host(st.out_len).tolist())
    assert log[1][2] == 1 and log[1][3] == 1 and log[1][1] == 0
    assert log[-1][1] == 1 and int(ns.host(st.parent)[1]) == 0
    return log


def case_drop_prob_one_loses_copies_without_repair(ns):
    st, slot = _width4_tree(ns)
    drop = np.zeros((8, 8), np.float32)
    drop[0, slot] = 1.0
    st = ns.tree.set_link_profile(st, ns.arr(np.zeros((8, 8), np.int32)),
                                  ns.arr(drop))
    for m in range(3):
        st = ns.tree.publish(st, ns.peer(m))
    for _ in range(12):
        st = ns.tree.step(st)
    out_len = ns.host(st.out_len)
    assert out_len[2] == 3 and out_len[3] == 3 and out_len[1] == 0
    assert int(ns.host(st.parent)[1]) == 0 and bool(ns.host(st.joined)[1])
    return out_len.tolist()


def case_fractional_drop_loses_some_not_all(ns):
    st, slot = _width4_tree(ns, seed=3, queue_cap=64, out_cap=64)
    drop = np.zeros((8, 8), np.float32)
    drop[0, slot] = 0.5
    st = ns.tree.set_link_profile(st, ns.arr(np.zeros((8, 8), np.int32)),
                                  ns.arr(drop))
    st = ns.tree.publish_many(st, ns.arr(np.arange(32, dtype=np.int32)))
    st = ns.tree.run_steps(st, 40)
    out_len = ns.host(st.out_len)
    assert out_len[2] == 32 and out_len[3] == 32
    assert 0 < out_len[1] < 32
    return ns.host(st.out).tolist()


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_port_receives_what_the_reference_receives(case):
    ref = case(_namespace("jax"))
    out = case(_namespace("torch"))
    assert out == ref


# -- exports and validation -------------------------------------------------------


def test_package_exports_the_references_front_door():
    import go_libp2p_pubsub_tpu as jpkg

    from go_libp2p_pubsub_torch import wire as twire

    want = {"TreeOpts", "SimParams", "GossipSubParams", "ScoreParams",
            "TopicManager", "Topic", "Subscription", "SimHost", "SimNetwork",
            "Message", "MessageType", "encode_message", "decode_message",
            "MessageDecoder"}
    assert set(tpkg.__all__) == want
    assert want == set(jpkg.__all__) - {"__version__"}
    assert tpkg.SimNetwork is tapi.SimNetwork
    assert tpkg.MessageDecoder is twire.MessageDecoder


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_sim_network_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.SimNetwork()


@pytest.mark.parametrize("bad", [
    dict(tree_width=0), dict(tree_max_width=0), dict(tree_width=1 << 21),
    dict(tree_width=4, tree_max_width=3),
])
def test_tree_opts_validation_matches_reference(bad):
    from go_libp2p_pubsub_tpu.config import TreeOpts as JTO

    with pytest.raises(ValueError) as ref:
        JTO(**bad)
    with pytest.raises(ValueError) as out:
        TreeOpts(**bad)
    assert str(out.value) == str(ref.value)
    with pytest.raises(ValueError) as out:
        TreeOpts.validated_from_wire(bad.get("tree_width", 2),
                                     bad.get("tree_max_width", 5))
    assert str(out.value) == str(ref.value)
    assert TreeOpts.validated_from_wire(3, 6) == TreeOpts(3, 6)


@pytest.mark.parametrize("bad", [
    dict(max_peers=0), dict(max_peers=(1 << 24) + 1), dict(max_width=0),
    dict(max_width=1025), dict(queue_cap=0), dict(out_cap=(1 << 16) + 1),
])
def test_sim_params_validation_matches_reference(bad):
    from go_libp2p_pubsub_tpu.config import SimParams as JSP

    with pytest.raises(ValueError) as ref:
        JSP(**bad)
    with pytest.raises(ValueError) as out:
        SimParams(**bad)
    assert str(out.value) == str(ref.value)
