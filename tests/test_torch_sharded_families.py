"""The last two families of the JAX package's multichip dry run, sharded
over the port's ``PeerMesh``, against the reference.

A 4-rank gloo group, spawned once for the module
(``parallel.mesh.run_ranks``; the rank functions import no JAX and get only
numpy), runs:

- ``MultiTopicGossipSub(mesh=)`` on ``tests/test_gossip_sharded.py``'s
  bit-identity run (T = 2, N = 128, K = 8, degree 4, window 32, seed 3, one
  publish, peers 30-39 killed, 12 rounds) and on ``tests/
  test_multitopic.py``'s PX run (an oversubscribed graph whose pruned
  peers accept PX offers), each with the split-gather ring and with
  all-gathers: every gathered leaf, ``flight_record_round`` and
  ``delivery_stats`` equal the reference's sharded run (8 virtual CPU
  devices) and the port's unsharded run;
- the tree of ``__graft_entry__.py``'s ``dryrun_multichip`` at n = 16 x 4
  through ``TreeCast(mesh=)``: every leaf equals the reference's
  ``sharded_fn`` run on a 4-device mesh;
- the tree at 2,048 peers under a link profile (delays and drops, so the
  drop draw fires), 16 publishes, 1% kills and 1% graceful leaves: every
  leaf and every ``rollout(record=True)`` channel equal the port's
  unsharded run and the reference's;
- one tree step at 50,000 peers whose joiners target ids around and
  above 43,000, where ``segment_rank``'s int32 composite key wraps (and,
  for target 42,948, splits its joiners in the sort, so their admit ranks
  are not the exact ones): the sharded step equals the unsharded one;
- ``PeerMesh.scatter_drop`` (duplicate cells whose sources lie on
  different ranks, cells out of range), ``index_add_rows`` and
  ``all_gather_many`` against the unsharded operations;
- the error cases.

Every comparison is exact.  The reference runs in module-scoped fixtures
in the test process.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.config import (
    GossipSubParams, ScoreParams, SimParams, TreeOpts,
)
from go_libp2p_pubsub_torch.models import tree_trace as TT
from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub
from go_libp2p_pubsub_torch.models.treecast import TreeCast
from go_libp2p_pubsub_torch.ops import tree as tree_ops
from go_libp2p_pubsub_torch.ops.graphs import drop_index
from go_libp2p_pubsub_torch.parallel.mesh import (
    make_mesh, run_ranks, shard_state,
)

WORLD = 4

# tests/test_gossip_sharded.py:171: the reference's bit-identity run.
MT_CASES = {
    "bitwise": dict(
        model=dict(n_topics=2, n_peers=128, n_slots=8, conn_degree=4,
                   msg_window=32),
        seed=3, publish=(1, 5, 7, True), kill=(30, 40), rounds=12),
    # tests/test_multitopic.py:150: tight d_hi and a permissive PX
    # acceptance, so pruned peers take PX offers.
    "px": dict(
        model=dict(n_topics=3, n_peers=96, n_slots=24, conn_degree=16,
                   msg_window=32),
        params=dict(d=6, d_lo=4, d_hi=7), accept_px=-1.0,
        seed=4, publish=(2, 40, 3, True), kill=(10, 14), rounds=16),
}

DRY_N = 16 * WORLD                      # __graft_entry__.py:59
DRY_PARAMS = dict(max_peers=DRY_N, max_width=8, queue_cap=16, out_cap=32)

FAULT_N = 2048
FAULT_PARAMS = dict(max_peers=FAULT_N, max_width=8, queue_cap=32, out_cap=32)
FAULT_STEPS = (30, 6, 40)               # join, after the publishes, heal

WRAP_N = 50_000
WRAP_PARAMS = dict(max_peers=WRAP_N, max_width=8, queue_cap=4, out_cap=4)
WRAP_SPLIT_KEY = (2**31 - 1) // (WRAP_N + 1)   # 42,948

SCATTER = dict(n=16, c=3, per_rank=6)

# The trace replay cut in depth inside the drain, as the card's 8-rank
# tree check cuts it.
REPLAY = dict(n=256, cut=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- plans shared by the ranks, the port's unsharded runs and the reference --


def _fault_plan():
    """(delay i32[N, W], drop f32[N, W], kill, leave bool[N]): a link
    profile with 0-2 extra rounds on every edge and a 0.2 drop on a third
    of them, and disjoint 1% kill and leave draws (never the root)."""
    r = np.random.default_rng(21)
    n, w = FAULT_N, FAULT_PARAMS["max_width"]
    delay = r.integers(0, 3, (n, w)).astype(np.int32)
    drop = np.where(r.random((n, w)) < 1 / 3, 0.2, 0.0).astype(np.float32)
    pick = r.choice(np.arange(1, n), size=2 * (n // 100), replace=False)
    kill, leave = np.zeros(n, bool), np.zeros(n, bool)
    kill[pick[:n // 100]] = True
    leave[pick[n // 100:]] = True
    return delay, drop, kill, leave


def _wrap_whole(device="cpu"):
    """The whole 50,000-row state before the wrap step: the root and 160
    targets (ids 42,901 ... 43,060) alive and joined, 3,000 joiners spread
    over every rank's rows, each walking to a random target, some with
    priority.  ``segment_rank``'s composite key ``key * 50,001 + row``
    leaves int32 for every target here; for target 42,948 it does so
    from row 40,700 on, which splits that target's joiners in the sort,
    so a fifth of the joiners walk to it."""
    r = np.random.default_rng(9)
    st = tree_ops.init_state(SimParams(**WRAP_PARAMS), TreeOpts(), root=0,
                             seed=2, device=device)
    n = WRAP_N
    targets = np.arange(42_901, 43_061)
    joiners = r.choice(np.arange(1, 42_900), size=3_000, replace=False)
    alive = np.zeros(n, bool)
    alive[0] = alive[targets] = alive[joiners] = True
    joined = np.zeros(n, bool)
    joined[0] = joined[targets] = True
    parent = np.full(n, -1, np.int32)
    parent[targets] = 0
    jt = np.full(n, -1, np.int32)
    jt[joiners] = r.choice(targets, size=joiners.size)
    jt[joiners[::5]] = WRAP_SPLIT_KEY
    prio = np.zeros(n, bool)
    prio[joiners] = r.random(joiners.size) < 0.3
    t = lambda a: torch.from_numpy(a).to(st.parent.device)  # noqa: E731
    return st._replace(alive=t(alive), joined=t(joined), parent=t(parent),
                       join_target=t(jt), join_prio=t(prio))


def _scatter_inputs():
    """A whole [N, C] int32 table and the sources of every rank in rank
    order: duplicate cells, several of them written from two ranks, and
    rows / columns out of range."""
    n, c, s = SCATTER["n"], SCATTER["c"], SCATTER["per_rank"]
    r = np.random.default_rng(3)
    buf = r.integers(-100, 100, (n, c)).astype(np.int32)
    rows = r.integers(-1, n + 1, WORLD * s).astype(np.int32)
    cols = r.integers(0, c + 1, WORLD * s).astype(np.int32)
    rows[[2, 9, 15, 22]] = 5            # one cell from ranks 0, 1, 2, 3
    cols[[2, 9, 15, 22]] = 1
    rows[[4, 7]], cols[[4, 7]] = 12, 0  # ranks 0 and 1 write rank 3's row
    vals = np.arange(1000, 1000 + WORLD * s).astype(np.int32)
    return buf, rows, cols, vals


# -- what every rank runs (no JAX here) -------------------------------------


def _mt_model(case, **kw):
    c = MT_CASES[case]
    return MultiTopicGossipSub(
        **c["model"],
        params=GossipSubParams(**c["params"]) if "params" in c else None,
        score_params=(ScoreParams(accept_px_threshold=c["accept_px"])
                      if "accept_px" in c else None),
        **kw)


def mt_run(case, mt):
    """The case's events on ``mt`` -> whole leaves after init and at the
    end, the flight sample and the delivery stats (host numpy)."""
    c = MT_CASES[case]
    st = mt.init(seed=c["seed"])
    first = mt.gather_state(st)
    st = mt.publish(st, *c["publish"])
    kill = np.zeros(mt.n, bool)
    kill[slice(*c["kill"])] = True
    st = mt.kill_peers(st, kill)
    st = mt.run(st, c["rounds"])
    return dict(
        init=first, state=mt.gather_state(st),
        flight={k: v.cpu().numpy()
                for k, v in mt.flight_record_round(st).items()},
        stats=[x.cpu().numpy() for x in mt.delivery_stats(st)])


def dry_run(tc):
    """``dryrun_multichip``'s tree (``__graft_entry__.py:59-88``) on
    ``tc``: joins, publishes, one step and an 8-step rollout."""
    pm = tc.mesh
    n = DRY_N
    st = tc.init(root=0)
    ids = np.arange(n)
    mask = torch.from_numpy((ids > 0) & (ids < n // 2))
    st = tree_ops.begin_subscribe_many(st, mask, pm=pm)
    st = tree_ops.run_steps(st, 3 * int(np.ceil(np.log2(n))) + 8, pm=pm)
    st = tree_ops.publish_many(st, torch.arange(4, dtype=torch.int32), pm=pm)
    st = tree_ops.step(st, pm=pm)
    st = tree_ops.run_steps(st, 8, pm=pm)
    return tc.gather_state(st)


def fault_run(tc):
    """The 2,048-peer fault run on ``tc`` -> (whole leaves, the three
    rollouts' records)."""
    pm = tc.mesh
    delay, drop, kill, leave = _fault_plan()
    st = tc.init(root=0, seed=5)
    st = tree_ops.set_link_profile(st, delay, drop, pm=pm)
    st = tree_ops.begin_subscribe_many(st, np.ones(FAULT_N, bool), pm=pm)
    recs = []
    st, rec = tc.rollout(st, FAULT_STEPS[0])
    recs.append(rec)
    st = tree_ops.publish_many(st, torch.arange(16, dtype=torch.int32), pm=pm)
    st, rec = tc.rollout(st, FAULT_STEPS[1])
    recs.append(rec)
    rows = (lambda a: torch.from_numpy(a) if pm is None
            else pm.local(torch.from_numpy(a)))
    st = st._replace(alive=st.alive & ~rows(kill),
                     leaving=st.leaving | rows(leave))
    st, rec = tc.rollout(st, FAULT_STEPS[2])
    recs.append(rec)
    return tc.gather_state(st), recs


def wrap_step(pm):
    whole = _wrap_whole()
    if pm is None:
        st = tree_ops.step(whole)
        return {f: getattr(st, f).numpy() for f in st._fields}
    st = shard_state(whole, pm, replicated=tree_ops.TREE_REPLICATED_FIELDS,
                     peer_dim=tree_ops.TREE_PEER_DIMS)
    return pm.gather_canonical(tree_ops.step(st, pm=pm),
                               tree_ops.TREE_PEER_DIMS)


def replay_cut(pm):
    """The trace's phases at ``REPLAY["n"]`` peers on ``pm``, through the
    join and the first ``REPLAY["cut"]`` drain steps -> the document."""
    hdr = TT.header(REPLAY["n"])
    body, _ = TT.run(TT.PortEngine(hdr, device=pm.device, mesh=pm), hdr,
                     until="drain", cut_steps=REPLAY["cut"])
    return dict(hdr, **body)


def _mesh_primitives(pm):
    buf, rows, cols, vals = _scatter_inputs()
    s = SCATTER["per_rank"]
    mine = slice(pm.rank * s, (pm.rank + 1) * s)
    t = torch.from_numpy
    (out,) = pm.scatter_drop([pm.local(t(buf))], t(rows[mine]),
                             t(cols[mine]), [t(vals[mine])])
    added = pm.index_add_rows(t(rows[mine]), t(vals[mine]))
    b = pm.local(t(buf))
    flags, wide = pm.all_gather_many(b[:, 0] > 0, b)
    return dict(scatter=pm.all_gather_rows(out).numpy(),
                added=added.numpy(), flags=flags.numpy(), wide=wide.numpy())


def _errors(pm):
    msgs = {}
    n = DRY_N
    params = SimParams(**DRY_PARAMS)
    cases = (
        ("indivisible", lambda: make_mesh(n + 2, device="cpu")),
        ("tree_other_n", lambda: TreeCast(SimParams(max_peers=2 * n),
                                          device="cpu", mesh=pm)),
        ("mt_other_n", lambda: MultiTopicGossipSub(
            n_topics=2, n_peers=2 * n, n_slots=8, conn_degree=4,
            msg_window=32, device="cpu", mesh=pm)),
        ("tree_other_device", lambda: TreeCast(
            params, device="cpu", mesh=make_mesh(n, device="meta"))),
        ("mt_other_device", lambda: MultiTopicGossipSub(
            n_topics=2, n_peers=n, n_slots=8, conn_degree=4, msg_window=32,
            device="cpu", mesh=make_mesh(n, device="meta"))),
        ("tree_default_device", lambda: TreeCast(params, mesh=pm)),
        ("mt_default_device", lambda: MultiTopicGossipSub(
            n_topics=2, n_peers=n, n_slots=8, conn_degree=4, msg_window=32,
            mesh=pm)),
        ("mesh_default_device", lambda: make_mesh(n)),
        ("tree_rollout_events", lambda: TreeCast(
            params, device="cpu", mesh=pm).rollout_events(None, None)),
        ("mt_rollout_events", lambda: MultiTopicGossipSub(
            n_topics=2, n_peers=n, n_slots=8, conn_degree=4, msg_window=32,
            device="cpu", mesh=pm).rollout_events(None, None)),
    )
    for name, fn in cases:
        try:
            fn()
            msgs[name] = None
        except (ValueError, RuntimeError, NotImplementedError) as e:
            msgs[name] = f"{type(e).__name__}: {e}"
    return msgs


def _rank_main(device):
    pm = make_mesh(DRY_N, device=device)
    out = {"mt": {}}
    for case, c in MT_CASES.items():
        mesh = make_mesh(c["model"]["n_peers"], device=device)
        for ring in (True, False):
            out["mt"][(case, ring)] = mt_run(case, _mt_model(
                case, mesh=mesh.using_ring(ring), device=device))
    out["dry"] = dry_run(TreeCast(SimParams(**DRY_PARAMS), device=device,
                                  mesh=pm))
    out["fault"] = fault_run(TreeCast(
        SimParams(**FAULT_PARAMS), device=device,
        mesh=make_mesh(FAULT_N, device=device)))
    out["wrap"] = wrap_step(make_mesh(WRAP_N, device=device))
    out["replay"] = replay_cut(make_mesh(REPLAY["n"], device=device))
    out["prims"] = _mesh_primitives(make_mesh(SCATTER["n"], device=device))
    out["errors"] = _errors(pm)
    return out


# -- the parent: the JAX reference and comparisons ----------------------------


def _norm(a):
    a = np.asarray(a)
    if a.dtype in (np.uint32, np.float32):
        return a.view(np.int32)
    return a


def _named_leaves(st, prefix=""):
    out = {}
    for name in type(st)._fields:
        v = getattr(st, name)
        if hasattr(v, "_fields"):
            out.update(_named_leaves(v, prefix + name + "."))
        else:
            out[prefix + name] = np.asarray(v)
    return out


def _assert_leaves(want, got, what):
    assert set(want) == set(got), what
    for name, a in want.items():
        b = np.asarray(got[name])
        assert a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(_norm(b), _norm(a).astype(
            _norm(b).dtype) if name == "step" else _norm(a),
            err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank_main, WORLD, backend="gloo", device="cpu",
                     timeout=300.0)


@pytest.fixture(scope="module")
def mt_reference():
    """The reference's multitopic cases, sharded over the 8 virtual CPU
    devices as ``test_sharded_multitopic_matches_unsharded_bitwise``."""
    import jax
    import jax.numpy as jnp

    from go_libp2p_pubsub_tpu.config import GossipSubParams as JP
    from go_libp2p_pubsub_tpu.config import ScoreParams as JS
    from go_libp2p_pubsub_tpu.models.multitopic import (
        MultiTopicGossipSub as JM, multitopic_state_shardings,
    )
    from go_libp2p_pubsub_tpu.parallel.mesh import make_mesh as jmesh

    out = {}
    for case, c in MT_CASES.items():
        mt = JM(**c["model"],
                params=JP(**c["params"]) if "params" in c else None,
                score_params=(JS(accept_px_threshold=c["accept_px"])
                              if "accept_px" in c else None))
        st = mt.init(seed=c["seed"])
        st = jax.device_put(st, multitopic_state_shardings(st, jmesh(8),
                                                           mt.n))
        first = _named_leaves(st)
        topic, src, slot, ok = c["publish"]
        st = mt.publish(st, jnp.asarray(topic), jnp.asarray(src),
                        jnp.asarray(slot), jnp.asarray(ok))
        st = mt.kill_peers(st, jnp.zeros((mt.n,), bool).at[
            slice(*c["kill"])].set(True))
        st = mt.run(st, c["rounds"])
        out[case] = dict(
            init=first, state=_named_leaves(st),
            flight={k: np.asarray(v)
                    for k, v in mt.flight_record_round(st).items()},
            stats=[np.asarray(x) for x in mt.delivery_stats(st)])
    return out


@pytest.fixture(scope="module")
def mt_unsharded():
    return {case: mt_run(case, _mt_model(case, device="cpu"))
            for case in MT_CASES}


def _jax_tree_state(params):
    from go_libp2p_pubsub_tpu.config import SimParams as JSP
    from go_libp2p_pubsub_tpu.config import TreeOpts as JTO
    from go_libp2p_pubsub_tpu.ops import tree as jt

    return jt, JSP(**params), JTO()


@pytest.fixture(scope="module")
def dry_reference():
    """``__graft_entry__.py:59-88`` at n = 16 x 4 on a 4-device mesh."""
    import jax.numpy as jnp

    from go_libp2p_pubsub_tpu.parallel.mesh import make_mesh as jmesh
    from go_libp2p_pubsub_tpu.parallel.mesh import shard_state as jshard
    from go_libp2p_pubsub_tpu.parallel.mesh import sharded_fn

    jt, params, opts = _jax_tree_state(DRY_PARAMS)
    n = DRY_N
    st = jt.init_state(params, opts, root=0)
    mask = (jnp.arange(n) > 0) & (jnp.arange(n) < n // 2)
    st = jt.begin_subscribe_many(st, mask)
    st = jt.run_steps(st, 3 * int(np.ceil(np.log2(n))) + 8)
    assert bool(st.joined[mask].all())
    st = jt.publish_many(st, jnp.arange(4, dtype=jnp.int32))
    mesh = jmesh(WORLD)
    kw = dict(replicated=jt.TREE_REPLICATED_FIELDS, peer_dim=jt.TREE_PEER_DIMS)
    st = jshard(st, mesh, **kw)
    st = sharded_fn(lambda s: jt.step(s), mesh, st, **kw)(st)
    st = sharded_fn(lambda s: jt.run_steps(s, 8), mesh, st, **kw)(st)
    assert int(np.asarray(st.out_len).sum()) > 0
    return _named_leaves(st)


@pytest.fixture(scope="module")
def fault_reference():
    """The 2,048-peer fault run on the reference, unsharded."""
    import jax.numpy as jnp

    from go_libp2p_pubsub_tpu.models.treecast import TreeCast as JTC

    jt, params, opts = _jax_tree_state(FAULT_PARAMS)
    model = JTC(params, opts)
    delay, drop, kill, leave = _fault_plan()
    st = jt.init_state(params, opts, root=0, seed=5)
    st = jt.set_link_profile(st, jnp.asarray(delay), jnp.asarray(drop))
    st = jt.begin_subscribe_many(st, jnp.ones(FAULT_N, bool))
    recs = []
    st, rec = model.rollout(st, FAULT_STEPS[0], record=True)
    recs.append(rec)
    st = jt.publish_many(st, jnp.arange(16, dtype=jnp.int32))
    st, rec = model.rollout(st, FAULT_STEPS[1], record=True)
    recs.append(rec)
    st = st._replace(alive=st.alive & ~jnp.asarray(kill),
                     leaving=st.leaving | jnp.asarray(leave))
    st, rec = model.rollout(st, FAULT_STEPS[2], record=True)
    recs.append(rec)
    return _named_leaves(st), [{k: np.asarray(v) for k, v in r.items()}
                               for r in recs]


def _assert_records(want, got, what):
    for i, (a, b) in enumerate(zip(want, got)):
        assert set(a) == set(b), what
        for k in a:
            np.testing.assert_array_equal(_norm(b[k]), _norm(a[k]),
                                          err_msg=f"{what} rollout {i}: {k}")


# -- the multitopic family ----------------------------------------------------


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "allgather"])
@pytest.mark.parametrize("case", list(MT_CASES))
def test_sharded_multitopic_equals_reference_and_unsharded(
        ranks, mt_reference, mt_unsharded, case, ring):
    ref, plain = mt_reference[case], mt_unsharded[case]
    for r, rank in enumerate(ranks):
        got = rank["mt"][(case, ring)]
        what = f"{case} ring={ring} rank {r}"
        _assert_leaves(ref["init"], got["init"], what + " init")
        _assert_leaves(ref["state"], got["state"], what)
        _assert_leaves(plain["state"], got["state"], what + " unsharded")


@pytest.mark.parametrize("case", list(MT_CASES))
def test_sharded_multitopic_flight_and_delivery_stats(
        ranks, mt_reference, mt_unsharded, case):
    for ring in (True, False):
        for rank in ranks:
            got = rank["mt"][(case, ring)]
            for want in (mt_reference[case], mt_unsharded[case]):
                # The port's caller adds ``step``; the reference's sample
                # carries it.
                flight = dict(want["flight"])
                step = flight.pop("step", got["state"]["step"])
                assert int(step) == int(got["state"]["step"])
                assert set(got["flight"]) == set(flight)
                for k, a in flight.items():
                    np.testing.assert_array_equal(
                        _norm(got["flight"][k]), _norm(a), err_msg=k)
                for a, b in zip(want["stats"], got["stats"]):
                    np.testing.assert_array_equal(_norm(b), _norm(a))


def test_sharded_multitopic_px_rewired_the_shared_adjacency(ranks):
    """The PX case really rewires: its run forms edges the initial graph
    lacked, so the sharded PX site (and the edge-liveness regather after
    it) is exercised; the bit-identity case forms none."""
    for ring in (True, False):
        px = ranks[0]["mt"][("px", ring)]
        grown = px["state"]["nbr_valid"].sum() - px["init"]["nbr_valid"].sum()
        assert grown > 0, "PX never formed a new edge"
        bw = ranks[0]["mt"][("bitwise", ring)]
        assert (bw["state"]["nbr_valid"] == bw["init"]["nbr_valid"]).all()


# -- the tree family ----------------------------------------------------------


def test_sharded_tree_dry_run_equals_reference_sharded_fn(
        ranks, dry_reference):
    for r, rank in enumerate(ranks):
        _assert_leaves(dry_reference, rank["dry"], f"dry run rank {r}")
    assert ranks[0]["dry"]["out_len"].sum() > 0


def test_sharded_tree_under_faults_equals_unsharded_and_reference(
        ranks, fault_reference):
    ref_state, ref_recs = fault_reference
    plain_state, plain_recs = fault_run(TreeCast(SimParams(**FAULT_PARAMS),
                                                 device="cpu"))
    _assert_leaves(ref_state, plain_state, "unsharded port")
    _assert_records(ref_recs, plain_recs, "unsharded port")
    for r, rank in enumerate(ranks):
        state, recs = rank["fault"]
        _assert_leaves(ref_state, state, f"faults rank {r}")
        _assert_records(ref_recs, recs, f"faults rank {r}")
        _assert_records(plain_recs, recs, f"faults rank {r} vs unsharded")
    # The drop draw fired: some forwarded copies were lost on the edges.
    delivered = int(plain_recs[2]["msgs_delivered_total"][-1])
    members = int(plain_recs[2]["peers_joined"][-1])
    assert 0 < delivered < 16 * members


def test_sharded_join_step_equals_unsharded_where_segment_rank_wraps(ranks):
    from go_libp2p_pubsub_torch.ops.graphs import segment_rank

    whole = _wrap_whole()
    target, mask = whole.join_target, whole.join_target >= 0
    n = WRAP_N
    # The composite key key * (n + 1) + pos leaves int32 inside one
    # target's segment ...
    assert WRAP_SPLIT_KEY * (n + 1) < 2**31 <= WRAP_SPLIT_KEY * (n + 1) + n
    assert ((target == WRAP_SPLIT_KEY).sum()) > 0
    # ... and the wrapped ranks are not the exact ones.
    key = np.where(mask.numpy(), target.numpy(), n).astype(np.int64)
    order = np.lexsort((np.arange(n), key))
    exact = np.zeros(n, np.int64)
    sk = key[order]
    start = np.maximum.accumulate(np.where(
        np.r_[True, sk[1:] != sk[:-1]], np.arange(n), 0))
    exact[order] = np.arange(n) - start
    wrapped = segment_rank(target, mask).numpy()
    assert (wrapped[mask.numpy()] != exact[mask.numpy()]).any()
    plain = wrap_step(None)
    for r, rank in enumerate(ranks):
        for f in ("parent", "children", "joined", "join_target"):
            np.testing.assert_array_equal(rank["wrap"][f], plain[f],
                                          err_msg=f"rank {r}: {f}")
        _assert_leaves(plain, rank["wrap"], f"wrap rank {r}")
    admitted = plain["joined"] & ~whole.joined.numpy()
    assert admitted.sum() > 0


# -- the mesh primitives and the error cases ----------------------------------


def test_sharded_replay_cut_in_the_drain_is_the_whole_runs_prefix(ranks):
    hdr = TT.header(REPLAY["n"])
    whole, _ = TT.run(TT.PortEngine(hdr, device="cpu"), hdr)
    cut, _ = TT.run(TT.PortEngine(hdr, device="cpu"), hdr, until="drain",
                    cut_steps=REPLAY["cut"])
    for rank in ranks:
        got = rank["replay"]
        assert list(got["phases"]) == ["join", "drain"]
        assert TT.mismatches(got, dict(hdr, **cut)) == {}
        assert TT.mismatches(got, dict(hdr, **whole), phases=["join"]) == {}
        drain = got["phases"]["drain"]["record"]
        for ch, want in whole["phases"]["drain"]["record"].items():
            assert drain[ch]["data"] == want["data"][:REPLAY["cut"]], ch
    # The cut carries messages: queues still full, deliveries under way.
    backlog = drain["queue_backlog"]["data"]
    delivered = drain["msgs_delivered_total"]["data"]
    assert min(backlog) > 0 and delivered[-1] > delivered[0]


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_drop_index_window_keeps_the_whole_tables_winners(blocks):
    """A window's indices are the whole table's that fall in it, shifted:
    the last-wins rule is per cell, so a rank that sizes its table to its
    own block picks the winners the whole table does."""
    buf, rows, cols, _vals = _scatter_inputs()
    n, c = buf.shape
    t = torch.from_numpy
    whole = drop_index(buf.shape, t(rows), t(cols)).numpy()
    span = n // blocks * c
    for b in range(blocks):
        lo = b * span
        got = drop_index(buf.shape, t(rows), t(cols), lo=lo,
                         span=span).numpy()
        inside = (whole >= lo) & (whole < lo + span)
        np.testing.assert_array_equal(got, np.where(inside, whole - lo, span))


def test_cross_rank_scatter_drop_equals_unsharded_scatter(ranks):
    buf, rows, cols, vals = _scatter_inputs()
    t = torch.from_numpy
    want = tree_ops._scatter_drop(
        t(buf), drop_index(buf.shape, t(rows), t(cols)),
        t(vals)).numpy()
    # Rank 3's cell (5, 1) came last, over ranks 0-2's writes of it.
    assert want[5, 1] == vals[22]
    n = SCATTER["n"]
    ok = (rows >= 0) & (rows < n)
    added = np.zeros(n, np.int64)
    np.add.at(added, rows[ok], vals[ok])
    for rank in ranks:
        p = rank["prims"]
        np.testing.assert_array_equal(p["scatter"], want)
        np.testing.assert_array_equal(p["added"], added)
        np.testing.assert_array_equal(p["flags"], buf[:, 0] > 0)
        np.testing.assert_array_equal(p["wide"], buf)


def test_sharded_families_error_cases(ranks):
    errs = ranks[0]["errors"]
    assert "must divide" in errs["indivisible"]
    assert errs["tree_other_n"].startswith("ValueError: mesh is over")
    assert errs["mt_other_n"].startswith("ValueError: mesh is over")
    assert "is not the model's" in errs["tree_other_device"]
    assert "is not the model's" in errs["mt_other_device"]
    assert errs["tree_rollout_events"].startswith("NotImplementedError")
    assert errs["mt_rollout_events"].startswith("NotImplementedError")
    # No quiet fallback: a model or mesh asks for the CPU explicitly.
    for name in ("tree_default_device", "mt_default_device",
                 "mesh_default_device"):
        if torch.cuda.is_available():
            assert errs[name] is None or "is not the model's" in errs[name]
        else:
            assert "CUDA is not available" in errs[name], name
