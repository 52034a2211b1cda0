"""The port's tree plane held against the JAX package's: ``ops/tree`` step
by step over N in {4, 8, 40} (kills, graceful leaves, rejoins, a link
profile with delay and a drop probability, a full out ring and queue
backpressure, drains), one step whose drop-mode scatters all fire (and a
child that two popping parents list), ``segment_rank``'s int32 wrap at
100,000 rows, ``tree_metrics``, ``TreeCast.rollout(record=)`` and
``rollout_events``, ``export_tree``/``tree_text``, the bridge, and the
tree trace module: the committed 100,000-peer trace's header, and a
small trace written by both packages.  Every comparison is exact.

The committed trace (``go_libp2p_pubsub_torch/models/traces/
tree_100000.trace.json``) is the JAX package's tree on the CPU through
``models/tree_trace.py``; the ``slow`` test regenerates it (about a
minute of CPU) and asserts it is the committed file byte for byte.  To
rewrite it after a deliberate change of the reference:

    JAX_PLATFORMS=cpu python tests/test_torch_tree.py --write
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from go_libp2p_pubsub_torch.models import tree_trace as TT  # noqa: E402


class JaxEngine:
    """The JAX package's tree behind ``tree_trace``'s engine interface."""

    def __init__(self, hdr):
        from go_libp2p_pubsub_tpu.config import SimParams, TreeOpts
        from go_libp2p_pubsub_tpu.models.treecast import TreeCast

        self.model = TreeCast(SimParams(**hdr["config"]),
                              TreeOpts(**hdr["opts"]))
        self.hdr = hdr

    def init(self):
        from go_libp2p_pubsub_tpu.ops import tree as tree_ops

        return tree_ops.init_state(self.model.params, self.model.opts,
                                   root=self.hdr["root"],
                                   seed=self.hdr["seed"])

    def begin_many(self, st, mask):
        import jax.numpy as jnp

        from go_libp2p_pubsub_tpu.ops import tree as tree_ops

        return tree_ops.begin_subscribe_many(st, jnp.asarray(mask))

    def publish_many(self, st, ids):
        import jax.numpy as jnp

        from go_libp2p_pubsub_tpu.ops import tree as tree_ops

        return tree_ops.publish_many(st, jnp.asarray(ids))

    def churn(self, st, kill, leave):
        import jax.numpy as jnp

        return st._replace(alive=st.alive & ~jnp.asarray(kill),
                           leaving=st.leaving | jnp.asarray(leave))

    def rollout(self, st, n):
        st, rec = self.model.rollout(st, n, record=True)
        return st, {k: np.asarray(v) for k, v in rec.items()}

    def host(self, st, names=None):
        return {k: np.asarray(getattr(st, k))
                for k in (st._fields if names is None else names)}


def reference_trace(n_peers: int):
    hdr = TT.header(n_peers)
    body, _ = TT.run(JaxEngine(hdr), hdr)
    return dict(hdr, **body)


def write_trace(path: str = TT.TRACE_PATH) -> None:
    doc = reference_trace(TT.N_PEERS)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_tree.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_trace()
    sys.exit(0)


import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from go_libp2p_pubsub_tpu.config import SimParams as JSP  # noqa: E402
from go_libp2p_pubsub_tpu.config import TreeOpts as JTO  # noqa: E402
from go_libp2p_pubsub_tpu.models import treecast as jtc  # noqa: E402
from go_libp2p_pubsub_tpu.ops import graphs as jgr  # noqa: E402
from go_libp2p_pubsub_tpu.ops import schedule as jsched  # noqa: E402
from go_libp2p_pubsub_tpu.ops import tree as jt  # noqa: E402
from go_libp2p_pubsub_tpu.utils import metrics as jmetrics  # noqa: E402
from go_libp2p_pubsub_tpu.utils import trace as jtrace  # noqa: E402
from go_libp2p_pubsub_torch import bridge  # noqa: E402
from go_libp2p_pubsub_torch.config import SimParams, TreeOpts  # noqa: E402
from go_libp2p_pubsub_torch.models import treecast as ttc  # noqa: E402
from go_libp2p_pubsub_torch.ops import graphs as tgr  # noqa: E402
from go_libp2p_pubsub_torch.ops import schedule as tsched  # noqa: E402
from go_libp2p_pubsub_torch.ops import tree as tt  # noqa: E402
from go_libp2p_pubsub_torch.utils import metrics as tmetrics  # noqa: E402
from go_libp2p_pubsub_torch.utils import trace as ttrace  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops: with several test workers on the same cores, torch's
    intra-op thread pools spin against each other.  One thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_tree(ref, port, what):
    b = bridge.tree_state_to_numpy(port)
    for f in ref._fields:
        x, y = np.asarray(getattr(ref, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert x.tobytes() == y.tobytes(), f"{what}: {f}"


def pair(n, root=0, seed=0, **kw):
    p = dict(max_peers=n, **kw)
    return (jt.init_state(JSP(**p), JTO(), root=root, seed=seed),
            tt.init_state(SimParams(**p), TreeOpts(), root=root, seed=seed,
                          device="cpu"))


# -- ops/tree, step by step ---------------------------------------------------


@pytest.mark.parametrize("n", [4, 8, 40])
def test_tree_ops_match_reference_step_by_step(n):
    """96+ steps of joins, kills, leaves, rejoins, link delay and drops,
    root publishes up to the queue's capacity, and sparse drains (the out
    rings fill and hold back their parents): every leaf after every
    step."""
    rng = np.random.default_rng(n)
    js, ts = pair(n, seed=5, max_width=8, queue_cap=8, out_cap=6)
    assert_same_tree(js, ts, "init")
    mask = rng.random(n) < 0.8
    js = jt.begin_subscribe_many(js, jnp.asarray(mask))
    ts = tt.begin_subscribe_many(ts, torch.from_numpy(mask))
    delay = rng.integers(0, 3, (n, 8)).astype(np.int32)
    drop = (rng.random((n, 8)) * 0.3).astype(np.float32)
    js = jt.set_link_profile(js, jnp.asarray(delay), jnp.asarray(drop))
    ts = tt.set_link_profile(ts, delay, drop)
    mid, full_rings = 0, 0
    for s in range(100):
        if int(np.asarray(js.q_len)[0]) <= 5 and s % 3 == 0:
            ids = np.arange(mid, mid + 3, dtype=np.int32)
            ids[1] = -1 if s % 2 else ids[1]   # NO_MSG entries are skipped
            mid += 3
            js = jt.publish_many(js, jnp.asarray(ids))
            ts = tt.publish_many(ts, torch.from_numpy(ids))
        if s % 11 == 4 and int(np.asarray(js.q_len)[0]) < 8:
            js, ts = jt.publish(js, jnp.int32(1000 + s)), tt.publish(
                ts, 1000 + s)
        if n > 4 and s % 17 == 5:
            v = int(rng.integers(1, n))
            js, ts = jt.kill_peer(js, jnp.int32(v)), tt.kill_peer(ts, v)
        if n > 4 and s % 19 == 7:
            v = int(rng.integers(1, n))
            js, ts = jt.leave_peer(js, jnp.int32(v)), tt.leave_peer(ts, v)
        if s % 23 == 11:
            v = int(rng.integers(1, n))
            js = jt.begin_subscribe(js, jnp.int32(v))
            ts = tt.begin_subscribe(ts, v)
        if s % 9 == 3:
            v = int(rng.integers(0, n))
            js, jm, jc = jt.drain_out(js, jnp.int32(v))
            ts, tm, tc = tt.drain_out(ts, v)
            assert np.asarray(jm).tolist() == tm.tolist()
            assert int(jc) == int(tc)
        js, ts = jt.step(js), tt.step(ts)
        assert_same_tree(js, ts, f"n={n} step {s}")
        full_rings += int(((np.asarray(js.out_len)
                            - np.asarray(js.out_drained)) == 6).sum())
    assert full_rings > 0, "no out ring filled: backpressure untested"
    assert int(np.asarray(js.out_len).sum()) > 0


def test_run_steps_and_size_iters_match_reference():
    js, ts = pair(16, max_width=8)
    js = jt.begin_subscribe_many(js, jnp.ones(16, bool))
    ts = tt.begin_subscribe_many(ts, torch.ones(16, dtype=torch.bool))
    js = jt.run_steps(js, 12, size_iters=2, repair_timeout_steps=3)
    ts = tt.run_steps(ts, 12, size_iters=2, repair_timeout_steps=3)
    assert_same_tree(js, ts, "run_steps")
    assert tt.default_size_iters(100_000) == 18


def _drop_state():
    """A hand-built 8-peer tree (root 0, W=4, Q=4, OC=2) where one step
    hits every drop-mode scatter: publish_many with NO_MSG entries, a
    joiner refused admission (row N / column W) next to an admitted one, a
    non-delivering popper and the root (out-ring row N), forwards into a
    dead and a lost child (queue row N), a dead child detected (the
    repair's drop index), and child 5 listed by two popping parents (2 and
    3) so two copies land in one tail slot."""
    n, w = 8, 4
    js = jt.init_state(JSP(max_peers=n, max_width=w, queue_cap=4,
                           out_cap=2), JTO(tree_width=3, tree_max_width=3))
    parent = np.array([-1, 0, 0, 1, 3, 2, -1, -1], np.int32)
    children = np.full((n, w), -1, np.int32)
    children[0, :2] = [1, 2]
    children[1, 0] = 3
    children[3, :2] = [4, 5]
    children[2, 0] = 5          # a stale second listing of child 5
    joined = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    alive = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)   # child 4 dead
    q = np.full((n, 4), -1, np.int32)
    q_len = np.zeros(n, np.int32)
    for peer, m in ((0, 10), (1, 11), (2, 12), (3, 13)):
        q[peer, 0], q_len[peer] = m, 1
    out_len = np.zeros(n, np.int32)
    out_len[1] = 2              # peer 1's ring is full: it does not pop
    drop = np.zeros((n, w), np.float32)
    drop[0, 1] = 1.0            # the copy to peer 2 is lost
    jtarget = np.array([-1, -1, -1, -1, -1, -1, 0, 0], np.int32)
    js = js._replace(
        parent=jnp.asarray(parent), children=jnp.asarray(children),
        joined=jnp.asarray(joined), alive=jnp.asarray(alive),
        q=jnp.asarray(q), q_len=jnp.asarray(q_len),
        out_len=jnp.asarray(out_len), edge_drop=jnp.asarray(drop),
        join_target=jnp.asarray(jtarget),
        subtree_size=jnp.asarray(np.array([6, 4, 2, 3, 1, 1, 0, 0],
                                          np.int32)),
    )
    return js


def test_step_whose_drop_mode_scatters_all_fire():
    js = _drop_state()
    ts = bridge.tree_state_from_jax(js, device="cpu")
    ids = np.array([-1, 20, -1, 21], np.int32)
    js = jt.publish_many(js, jnp.asarray(ids))
    ts = tt.publish_many(ts, torch.from_numpy(ids))
    assert_same_tree(js, ts, "publish_many with NO_MSG entries")
    js, ts = jt.step(js), tt.step(ts)
    assert_same_tree(js, ts, "the step")
    q, ql = np.asarray(js.q), np.asarray(js.q_len)
    # Root admitted one of the two joiners (width 3, one slot left after
    # peers 1 and 2) and redirected the other.
    assert int(np.asarray(js.joined)[6:].sum()) == 1
    # Peer 5 got two copies into one tail slot: the later source (parent
    # 3's message 13) won, and its length counts both.
    assert q[5, 0] == 13 and ql[5] == 2
    # The dead child 4 was detected and torn down.
    assert not bool(np.asarray(js.joined)[4])
    assert (np.asarray(js.children)[3] != 4).all()
    # The lost copy to peer 2 never arrived; peer 1 (full out ring) held
    # its message and queued the root's.
    assert ql[2] == 0 and ql[1] == 2


def test_segment_rank_wraps_like_reference_at_100k():
    """The composite key ``key * (n + 1) + index`` wraps in int32 above
    ~46,340 rows in both packages: the ranks agree exactly."""
    n = 100_000
    rng = np.random.default_rng(3)
    targets = rng.integers(-1, n, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    ref = np.asarray(jgr.segment_rank(jnp.asarray(targets),
                                      jnp.asarray(mask)))
    out = tgr.segment_rank(torch.from_numpy(targets), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)
    used = rng.random((n, 8)) < 0.5
    rank = rng.integers(0, 9, n).astype(np.int32)
    import jax

    ref = np.asarray(jax.vmap(jgr.nth_free_slot)(jnp.asarray(used),
                                                 jnp.asarray(rank)))
    out = tgr.nth_free_slot(torch.from_numpy(used), torch.from_numpy(rank))
    np.testing.assert_array_equal(out.numpy(), ref)


# -- TreeCast -------------------------------------------------------------------


def _models(n=24, **kw):
    p = dict(max_peers=n, **kw)
    return (jtc.TreeCast(JSP(**p), JTO()),
            ttc.TreeCast(SimParams(**p), TreeOpts(), device="cpu"))


def _joined(jm, tm, n_sub):
    mask = np.arange(jm.params.max_peers) < n_sub
    js = jt.begin_subscribe_many(jm.init(), jnp.asarray(mask))
    ts = tt.begin_subscribe_many(tm.init(), torch.from_numpy(mask))
    return jt.run_steps(js, 16), tt.run_steps(ts, 16)


def test_tree_metrics_and_rollout_record_match_reference():
    jm, tm = _models()
    js, ts = _joined(jm, tm, 20)
    a = jmetrics.tree_metrics(js)
    b = tmetrics.tree_metrics(ts)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == b[k].numpy().dtype, k
        assert int(a[k]) == int(b[k]), k
    js = jt.publish_many(js, jnp.arange(5, dtype=jnp.int32))
    ts = tt.publish_many(ts, torch.arange(5, dtype=torch.int32))
    js2, jrec = jm.rollout(js, 12, record=True)
    ts2, trec = tm.rollout(ts, 12, record=True)
    assert_same_tree(js2, ts2, "rollout")
    assert sorted(jrec) == sorted(trec)
    for k in jrec:
        a, b = np.asarray(jrec[k]), trec[k]
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, k
        assert a.tobytes() == b.tobytes(), k
    js3, none_j = jm.rollout(js, 3, record=False)
    ts3, none_t = tm.rollout(ts, 3, record=False)
    assert none_j is None and none_t is None
    assert_same_tree(js3, ts3, "rollout without record")
    assert_same_tree(jtc.TreeCast.forward(js3), ttc.TreeCast.forward(ts3),
                     "forward")


def test_rollout_events_match_reference():
    jm, tm = _models(32, queue_cap=16)
    js, ts = _joined(jm, tm, 28)
    T, n = 40, 32
    ev = jsched.empty_tree_events(T, n, 3)
    rng = np.random.default_rng(7)
    for t in (3, 11, 19):
        ev.kill[t][rng.choice(np.arange(1, 28), 2, replace=False)] = True
    for t in (6, 15):
        ev.leave[t][rng.choice(np.arange(1, 28), 2, replace=False)] = True
    ev.sub[24][[29, 30]] = True
    ev.sub[30][ev.kill[3]] = True
    for t in range(2, 34, 4):
        jsched.add_publish(ev, t, {"msg": t})
        jsched.add_publish(ev, t, {"msg": 100 + t})
    tev = tsched.TreeEvents(*(np.array(x) for x in ev))
    js2, jrec = jm.rollout_events(js, ev, record=True)
    ts2, trec = tm.rollout_events(ts, tev, record=True)
    assert_same_tree(js2, ts2, "rollout_events")
    for k in jrec:
        assert np.asarray(jrec[k]).tobytes() == trec[k].tobytes(), k
    js3, _ = jm.rollout_events(js, ev, record=False)
    ts3, rec = tm.rollout_events(ts, tev, record=False)
    assert rec is None
    assert_same_tree(js3, ts3, "rollout_events without record")


def test_demo_state_entry_point_and_value_semantics():
    jm, tm = _models(16)
    js, ts = jm.build_demo_state(8, n_msgs=2), tm.build_demo_state(8, 2)
    assert_same_tree(js, ts, "build_demo_state")
    assert bool(ts.joined[:8].all())
    fn, (st,) = ttc.entry_fn_and_args(6, device="cpu")
    jfn, (jst,) = jtc.entry_fn_and_args(6)
    assert_same_tree(jfn(jst), fn(st), "entry_fn_and_args")
    assert tm == ttc.TreeCast(SimParams(max_peers=16), device="cpu")
    assert hash(tm) == hash(ttc.TreeCast(SimParams(max_peers=16),
                                         device="cpu"))
    assert tm != ttc.TreeCast(SimParams(max_peers=17), device="cpu")
    with pytest.raises(ValueError, match="max_peers"):
        tm.build_demo_state(17)
    with pytest.raises(ValueError, match="max_width"):
        tt.init_state(SimParams(max_width=4), TreeOpts(), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_default_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        ttc.TreeCast()
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_state(SimParams(), TreeOpts())


def test_export_tree_text_and_bridge_match_reference():
    jm, tm = _models(24)
    js, ts = _joined(jm, tm, 24)
    assert ttrace.export_tree(ts) == jtrace.export_tree(js)
    assert ttrace.tree_text(ts) == jtrace.tree_text(js)
    back = bridge.tree_state_to_numpy(bridge.tree_state_from_jax(
        js, device="cpu"))
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(back, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert back.key.dtype == np.uint32
    cyc = bridge.tree_state_from_jax(js, device="cpu")
    parent = cyc.parent.clone()
    parent[0] = 1
    parent[1] = 0
    with pytest.raises(ValueError, match="cycle"):
        ttrace.export_tree(cyc._replace(parent=parent))


# -- the trace module -----------------------------------------------------------


def test_committed_trace_header_is_the_phase_configuration():
    doc = TT.load_trace()
    assert {k: doc[k] for k in TT.header(TT.N_PEERS)} == TT.header(
        TT.N_PEERS)
    assert doc["config"] == dict(max_peers=100_000, max_width=8,
                                 queue_cap=128, out_cap=128)
    assert SimParams(**doc["config"]).max_peers == 100_000
    assert TreeOpts(**doc["opts"]) == TreeOpts()
    assert doc["n_kill"] == doc["n_leave"] == 1000
    ph = doc["phases"]
    assert sorted(ph) == ["churn", "drain", "join"]
    assert ph["join"]["steps"] <= TT.JOIN_BOUND
    assert ph["join"]["record"]["peers_joined"]["data"][-1] == 100_000
    assert ph["drain"]["record"]["queue_backlog"]["data"][-1] == 0
    assert ph["churn"]["record"]["peers_orphaned"]["data"][-1] == 0
    assert ph["churn"]["waiting"] == 0
    for p in ph.values():
        assert sorted(p["digest"]) == sorted(tt.TreeState._fields)
        assert all(len(v["data"]) == p["steps"]
                   for v in p["record"].values())


def test_small_trace_written_by_both_packages_agrees():
    n = 300
    ref = reference_trace(n)
    hdr = TT.header(n)
    body, extras = TT.run(TT.PortEngine(hdr, device="cpu"), hdr)
    assert TT.mismatches(dict(hdr, **body), ref) == {}
    assert extras["conditions"]["healed"] and extras["conditions"]["drained"]
    doc, extras = TT.port_replay(ref, device="cpu")
    assert TT.mismatches(doc, ref) == {}
    assert extras["wall_s"]["drain"] > 0 and extras["conditions"]["healed"]
    # A perturbed document is caught, by channel.
    bad = json.loads(json.dumps(ref))
    bad["phases"]["drain"]["record"]["queue_backlog"]["data"][3] += 1
    bad["phases"]["churn"]["digest"]["q"]["sha256"] = "0"
    assert TT.mismatches(doc, bad) == {"drain.record.queue_backlog": 1,
                                       "churn.digest.q": 1}


@pytest.mark.slow
def test_trace_regenerates_byte_for_byte(tmp_path):
    path = str(tmp_path / "trace.json")
    write_trace(path)
    with open(path) as a, open(TT.TRACE_PATH) as b:
        assert a.read() == b.read()
