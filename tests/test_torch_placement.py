"""The port's placement module against the JAX package's.

``go_libp2p_pubsub_torch/parallel/placement.py`` is a numpy copy of the
reference's ``parallel/placement.py``: every function is pinned to its
original source, and both compute the same permutations, relabeled
topologies, edge cuts and reports on fixed graphs, including the
sharded bench's own 204,800-peer mesh (host-side only), where the BFS
placement must cut at least half of a random placement's cross-shard
edges (the counterpart of ``tests/test_placement.py``'s margin test).
"""

import inspect

import numpy as np
import pytest

from go_libp2p_pubsub_tpu.models import gossipsub as jgs
from go_libp2p_pubsub_tpu.parallel import placement as jpl
from go_libp2p_pubsub_torch.models import gossipsub as tgs
from go_libp2p_pubsub_torch.parallel import placement as tpl

FUNCTIONS = ("_edge_list", "_csr", "partition_bfs", "random_placement",
             "relabel_topology", "edge_cut", "placement_report")
CUT_REDUCTION_MARGIN = 0.50


@pytest.mark.parametrize("name", FUNCTIONS)
def test_functions_are_pinned_to_their_originals(name):
    assert inspect.getsource(getattr(tpl, name)) == inspect.getsource(
        getattr(jpl, name))


def _graphs():
    rng = np.random.default_rng
    local = tgs.build_topology_local(rng(5), 256, 16, 8, spread=12)
    loop = tgs.build_topology(rng(1), 200, 16, 8)
    fast = tgs.build_topology_fast(rng(2), 512, 32, 12)
    # Dead slots: a mask narrower than nbr_valid.
    killed = (loop[0], loop[1], loop[2] & (rng(3).random((200, 16)) < 0.7),
              loop[3])
    return {"local": local, "loop": loop, "fast": fast, "masked": killed}


@pytest.mark.parametrize("graph", ["local", "loop", "fast", "masked"])
def test_placement_equals_reference(graph):
    nbrs, rev, valid, outbound = _graphs()[graph]
    n = nbrs.shape[0]
    for shards in (1, 2, 4, 8):
        perm, inv = tpl.partition_bfs(nbrs, valid, shards)
        jperm, jinv = jpl.partition_bfs(nbrs, valid, shards)
        np.testing.assert_array_equal(perm, jperm)
        np.testing.assert_array_equal(inv, jinv)
        assert tpl.placement_report(nbrs, valid, shards, perm, seed=4) == \
            jpl.placement_report(nbrs, valid, shards, jperm, seed=4)
        assert tpl.edge_cut(nbrs, valid, shards) == jpl.edge_cut(
            nbrs, valid, shards)
    rperm, rinv = tpl.random_placement(n, seed=9)
    jrperm, jrinv = jpl.random_placement(n, seed=9)
    np.testing.assert_array_equal(rperm, jrperm)
    np.testing.assert_array_equal(rinv, jrinv)
    for p in (perm, rperm):
        for a, b in zip(tpl.relabel_topology(nbrs, rev, valid, outbound, p),
                        jpl.relabel_topology(nbrs, rev, valid, outbound, p)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    # The start peer and an indivisible shard count, as the reference.
    np.testing.assert_array_equal(
        tpl.partition_bfs(nbrs, valid, 2, start=7)[0],
        jpl.partition_bfs(nbrs, valid, 2, start=7)[0])
    with pytest.raises(ValueError) as te:
        tpl.partition_bfs(nbrs, valid, 3 if n % 3 else 7)
    with pytest.raises(ValueError) as je:
        jpl.partition_bfs(nbrs, valid, 3 if n % 3 else 7)
    assert str(te.value) == str(je.value)


def test_bench_mesh_cut_reduction_margin():
    """The sharded bench's mesh (``bench.SHARDED_SCALE``: 204,800 peers,
    32 slots, degree 16, topology seed 0, 8 shards), built by the port:
    the same graph as the reference's builder, the same BFS permutation
    and report, and at least a 50% cut reduction against random."""
    import bench

    cfg = bench.SHARDED_SCALE
    args = (cfg["n_peers"], cfg["n_slots"], cfg["degree"])
    topo = tgs.build_topology_local(np.random.default_rng(cfg["topo_seed"]),
                                    *args)
    jtopo = jgs.build_topology_local(np.random.default_rng(cfg["topo_seed"]),
                                     *args)
    for a, b in zip(topo, jtopo):
        np.testing.assert_array_equal(a, np.asarray(b))
    nbrs, valid = topo[0], topo[2]
    perm, _ = tpl.partition_bfs(nbrs, valid, cfg["n_devices"])
    rep = tpl.placement_report(nbrs, valid, cfg["n_devices"], perm,
                               seed=cfg["topo_seed"])
    jperm, _ = jpl.partition_bfs(nbrs, valid, cfg["n_devices"])
    np.testing.assert_array_equal(perm, jperm)
    assert rep == jpl.placement_report(nbrs, valid, cfg["n_devices"], jperm,
                                       seed=cfg["topo_seed"])
    assert rep["cut_reduction_vs_random"] >= CUT_REDUCTION_MARGIN, rep
    assert rep["cross_shard_edges"] < rep["cross_shard_edges_random"]
    assert rep["total_edges"] > 0
