"""The port's sharded rollout against the JAX package's.

- ``GossipSub(peer_uid=)`` (placement relabeling, unsharded) equals the
  reference's leaf for leaf, flight record included, on the fixture of
  ``tests/test_placement.py``'s bit-identity test.
- A 4-rank gloo group, spawned once for the module
  (``parallel.mesh.run_ranks``; the ranks import neither JAX nor this
  module's reference side, and get only numpy), runs
  ``ShardedGossipSub(placement="bfs")`` with and without the split-gather
  ring; each equals the reference's ``ShardedGossipSub`` on a 4-device
  mesh of the conftest's virtual CPU devices: the placement, every
  physical leaf, the flight channels, ``delivery_stats`` and a kill by
  canonical ids.  The same group checks ``ring_gather_rows`` at R = 1, 2
  and 4 (sub-groups), the sharded wrappers' plain versions against the
  unsharded functions, and the reference's error cases.
- The row-gather draws equal the whole draw's rows and ``jax.random``'s.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from go_libp2p_pubsub_torch.models.gossipsub import (
    GossipSub as TG, build_topology_local,
)
from go_libp2p_pubsub_torch.ops import rng
from go_libp2p_pubsub_torch.parallel import gossip_sharded as tsh
from go_libp2p_pubsub_torch.parallel.mesh import make_mesh, run_ranks
from go_libp2p_pubsub_torch.parallel.placement import (
    partition_bfs, relabel_topology,
)

N, K, DEG, M, STEPS = 256, 16, 8, 32, 16
MODEL = dict(n_slots=K, conn_degree=DEG, msg_window=M, heartbeat_steps=4)
PUBLISHES = [(3, 0, True), (177, 1, True), (50, 2, True)]
KILL = [3, 9]
WORLD = 4


def _topology():
    return build_topology_local(np.random.default_rng(5), N, K, DEG,
                                spread=12)


def _plan(split):
    return dict(n_peers=N, model=MODEL, topology=_topology(),
                placement="bfs", split_gather=split, seed=0,
                publishes=PUBLISHES, steps=STEPS, kill=KILL)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- what every rank runs (no JAX here) -------------------------------------


def _ring_cases(table, idx):
    """ring_gather_rows on sub-groups of 1, 2 and 4 ranks: each member's
    block of the gathered rows, or None outside the group."""
    out = {}
    for world in (1, 2, 4):
        group = dist.new_group(list(range(world)), backend="gloo")
        if dist.get_rank() >= world:
            out[world] = None
            continue
        pm = make_mesh(table.shape[0], device="cpu",
                       group=group).using_ring(True)
        out[world] = pm.gather(pm.local(torch.from_numpy(table)),
                               pm.local(torch.from_numpy(idx))).numpy()
    return out


def _errors():
    from go_libp2p_pubsub_torch.parallel.gossip_sharded import (
        ShardedGossipSub,
    )

    msgs = {}
    for name, fn in (
        ("indivisible", lambda: make_mesh(250, device="cpu")),
        ("placement", lambda: ShardedGossipSub(
            16, make_mesh(16, device="cpu"), placement="metis", n_slots=8,
            conn_degree=4)),
        ("default_device", lambda: make_mesh(16)),
    ):
        try:
            msgs[name] = str(fn().device)
        except (ValueError, RuntimeError) as e:
            msgs[name] = str(e)
    return msgs


def _window_is_peer_count(device):
    """msg_window == n_peers: the metadata stays whole on every rank."""
    pm = make_mesh(16, device=device)
    sg = tsh.ShardedGossipSub(16, pm, n_slots=8, conn_degree=4,
                              msg_window=16)
    st = sg.init(0)
    st = sg.publish(st, 0, 0, True)
    st = sg.run(st, 8)
    return {"msg_valid": tuple(st.msg_valid.shape),
            "have_w": tuple(st.have_w.shape), "step": st.step,
            "state": sg.gather_state(st)}


def _rank_main(device, plans, table, idx):
    return {
        "runs": [tsh.run_plan(device, p) for p in plans],
        "ring": _ring_cases(table, idx),
        "errors": _errors(),
        "window": _window_is_peer_count(device),
    }


# -- the parent: JAX reference and comparisons --------------------------------


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
            out[prefix + name] = _norm(v)
    return out


@pytest.fixture(scope="module")
def ring_input():
    r = np.random.default_rng(0)
    table = r.integers(-2**31, 2**31, (64, 3)).astype(np.int32)
    idx = r.integers(-9, 75, (64, 5)).astype(np.int64)   # out of range too
    return table, idx


@pytest.fixture(scope="module")
def ranks(ring_input):
    """One 4-rank gloo group for the module: both gather modes."""
    return run_ranks(_rank_main, WORLD, backend="gloo", device="cpu",
                     timeout=240.0,
                     args=([_plan(True), _plan(False)], *ring_input))


@pytest.fixture(scope="module")
def reference():
    """The JAX package's sharded run on a 4-device mesh, ring and
    monolithic gathers."""
    import jax.numpy as jnp

    from go_libp2p_pubsub_tpu.parallel.gossip_sharded import (
        ShardedGossipSub as JS,
    )

    topo = _topology()
    out = {}
    for split in (True, False):
        sg = JS(n_peers=N, n_devices=WORLD, placement="bfs",
                split_gather=split, use_pallas=False,
                builder=lambda rng_, n_, k_, d_: topo, **MODEL)
        st = sg.init(0)
        for src, slot, ok in PUBLISHES:
            st = sg.publish(st, src, jnp.int32(slot), jnp.bool_(ok))
        st, rec = sg.rollout(st, STEPS, record=True)
        mask = np.zeros(N, bool)
        mask[KILL] = True
        out[split] = dict(
            perm=sg.perm, report=sg.placement_report,
            state=_named_leaves(st),
            record={k: np.asarray(v) for k, v in rec.items()},
            stats=[np.asarray(x) for x in sg.delivery_stats(st)],
            alive=np.asarray(sg.kill_peers(st, mask).alive),
        )
    return out


def _assert_same_run(ref, port, what):
    np.testing.assert_array_equal(port["perm"], ref["perm"])
    assert port["placement_report"] == ref["report"], what
    state = {k: _norm(v) for k, v in port["state"].items()}
    assert state.keys() == ref["state"].keys(), what
    for name, a in ref["state"].items():
        b = state[name]
        assert a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(b, a.astype(b.dtype) if name == "step"
                                      else a, err_msg=f"{what}: {name}")
    assert set(port["record"]) == set(ref["record"]), what
    for name, a in ref["record"].items():
        np.testing.assert_array_equal(_norm(port["record"][name]), _norm(a),
                                      err_msg=f"{what}: record {name}")
    for a, b in zip(ref["stats"], port["stats"]):
        np.testing.assert_array_equal(_norm(b), _norm(a), err_msg=what)
    np.testing.assert_array_equal(port["alive_after_kill"], ref["alive"])


@pytest.mark.parametrize("split", [True, False], ids=["ring", "allgather"])
def test_four_rank_gloo_rollout_equals_reference(ranks, reference, split):
    run = ranks[0]["runs"][0 if split else 1]
    _assert_same_run(reference[split], run, f"split={split}")
    # Every rank holds the same whole-run views.
    for other in ranks[1:]:
        o = other["runs"][0 if split else 1]
        for name, a in run["state"].items():
            np.testing.assert_array_equal(o["state"][name], a)
        assert o["placement_report"] == run["placement_report"]
    assert run["staged"]["bytes"] == 0          # CPU tensors: no staging


def test_sharded_wrappers_plain_versions_equal_unsharded(ranks):
    for rank in ranks:
        for run in rank["runs"]:
            assert run["wrappers"] == {"propagate_sharded": True,
                                       "exchange_select_sharded": True}


def test_ring_gather_rows_equals_clipped_index(ranks, ring_input):
    table, idx = ring_input
    want = table[np.clip(idx, 0, table.shape[0] - 1)]
    for world in (1, 2, 4):
        blocks = [r["ring"][world] for r in ranks[:world]]
        np.testing.assert_array_equal(np.concatenate(blocks), want,
                                      err_msg=f"R={world}")
        assert all(r["ring"][world] is None for r in ranks[world:])


def test_reference_error_cases(ranks):
    from go_libp2p_pubsub_tpu.parallel.gossip_sharded import (
        ShardedGossipSub as JS,
    )

    errs = ranks[0]["errors"]
    assert "must divide" in errs["indivisible"]
    with pytest.raises(ValueError, match="divide"):
        JS(n_peers=250, n_devices=8, n_slots=16, conn_degree=8)
    with pytest.raises(ValueError) as je:
        JS(n_peers=16, n_devices=2, placement="metis", n_slots=8,
           conn_degree=4)
    assert errs["placement"] == str(je.value)


def test_mesh_and_ranks_default_to_the_card(ranks):
    """A mesh asks for the CPU explicitly: by default it takes the current
    card (and raises where there is none), and ``run_ranks`` starts one
    rank a card over NCCL."""
    import inspect

    got = ranks[0]["errors"]["default_device"]
    if torch.cuda.is_available():
        assert got.startswith("cuda:")
    else:
        assert "CUDA is not available" in got
    params = inspect.signature(run_ranks).parameters
    assert params["backend"].default == "nccl"
    assert params["device"].default == "cuda:{rank}"


def test_unclassified_field_and_indivisible_classification():
    from go_libp2p_pubsub_torch.models.multitopic import (
        MultiTopicGossipSub, multitopic_state_shardings,
    )

    st = TG(n_peers=16, n_slots=8, conn_degree=4, msg_window=8,
            device="cpu").init(0)
    dims = tsh.gossip_state_shardings(st, 16, 4)
    assert dims["have_w"] == 0 and dims["msg_valid"] is None
    with pytest.raises(ValueError, match="divide"):
        tsh.gossip_state_shardings(st, 16, 3)
    orig = tsh._PEER_DIM_FIELDS
    tsh._PEER_DIM_FIELDS = orig - {"mesh"}
    try:
        with pytest.raises(ValueError, match="mesh"):
            tsh.gossip_state_shardings(st, 16, 2)
    finally:
        tsh._PEER_DIM_FIELDS = orig
    mt = MultiTopicGossipSub(n_topics=2, n_peers=16, n_slots=8,
                             conn_degree=4, msg_window=16, device="cpu")
    mst = mt.init(0)
    mdims = multitopic_state_shardings(mst, 16, 4)
    assert mdims["have_w"] == 1 and mdims["nbrs"] == 0
    assert mdims["keys"] is None and mdims["msg_valid"] is None
    with pytest.raises(ValueError, match="expected dim"):
        multitopic_state_shardings(mst, 32, 4)


def test_msg_window_equal_to_peer_count_not_missharded(ranks):
    """msg_window == n_peers: the [M] metadata is whole on every rank, the
    peer planes are split, and the run equals the unsharded model."""
    for rank in ranks:
        w = rank["window"]
        assert w["msg_valid"] == (16,) and w["have_w"] == (4, 1)
        assert w["step"] == 8
    gs = TG(n_peers=16, n_slots=8, conn_degree=4, msg_window=16,
            device="cpu")
    st = gs.init(0)
    st = gs.publish(st, 0, 0, True)
    st, _ = gs.rollout(st, 8, record=False)
    ref = _named_leaves(st)
    got = {k: _norm(v) for k, v in ranks[0]["window"]["state"].items()}
    for name, a in ref.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_unsharded_peer_uid_equals_reference():
    """``GossipSub(peer_uid=perm)`` over the BFS-relabeled topology (the
    physical model the sharded runs build) against the reference's, from
    each package's own init: every leaf and record channel."""
    import jax.numpy as jnp

    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG

    nbrs, rev, valid, outbound = _topology()
    perm, _ = partition_bfs(nbrs, valid, WORLD)
    rtopo = relabel_topology(nbrs, rev, valid, outbound, perm)
    builder = lambda rng_, n_, k_, d_: rtopo  # noqa: E731
    jm = JG(n_peers=N, use_pallas=False, builder=builder, peer_uid=perm,
            **MODEL)
    tm = TG(n_peers=N, builder=builder, peer_uid=perm, device="cpu", **MODEL)
    js, ts = jm.init(0), tm.init(0)
    inv = np.argsort(perm)
    for src, slot, ok in PUBLISHES:
        js = jm.publish(js, jnp.int32(int(inv[src])), jnp.int32(slot),
                        jnp.bool_(ok))
        ts = tm.publish(ts, int(inv[src]), slot, ok)
    js, jrec = jm.rollout(js, STEPS, record=True)
    ts, trec = tm.rollout(ts, STEPS, record=True)
    ref, port = _named_leaves(js), _named_leaves(ts)
    assert ref.keys() == port.keys()
    for name in ref:
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    for name, a in jrec.items():
        np.testing.assert_array_equal(_norm(trec[name].numpy()), _norm(a),
                                      err_msg=name)
    np.testing.assert_array_equal(port["gcounters.ip_group"], perm)
    assert tm != TG(n_peers=N, builder=builder, device="cpu", **MODEL)
    with pytest.raises(ValueError, match="permutation"):
        TG(n_peers=N, peer_uid=np.zeros(N, np.int64), device="cpu")


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 1e-3), (-2.0, 3.0)])
def test_row_gather_uniform_equals_full_draw_and_jax(lo, hi):
    import jax

    key = rng.PRNGKey(13)
    rows = torch.from_numpy(np.random.default_rng(1).permutation(300)[:77])
    full = rng.uniform(key, (300, 16), lo, hi)
    part = rng.uniform_rows(key, rows, (16,), lo, hi)
    np.testing.assert_array_equal(part.numpy().view(np.int32),
                                  full[rows].numpy().view(np.int32))
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(13), (300, 16),
                                        minval=lo, maxval=hi))
    np.testing.assert_array_equal(part.numpy().view(np.int32),
                                  ref[rows.numpy()].view(np.int32))
    from go_libp2p_pubsub_torch.ops.gossip import uniform_by_uid

    np.testing.assert_array_equal(
        uniform_by_uid(key, (77, 16), rows, lo, hi).numpy().view(np.int32),
        ref[rows.numpy()].view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 256), (3, 1000), (-7, 70001)])
def test_row_gather_randint_equals_full_draw_and_jax(lo, hi):
    import jax

    key = rng.PRNGKey(5)
    rows = torch.from_numpy(np.random.default_rng(2).permutation(120)[:40])
    part = rng.randint(key, (40, 3, 4), lo, hi, rows=rows)
    np.testing.assert_array_equal(
        part.numpy(), rng.randint(key, (120, 3, 4), lo, hi)[rows].numpy())
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (120, 3, 4),
                                        lo, hi))
    np.testing.assert_array_equal(part.numpy(), ref[rows.numpy()])
