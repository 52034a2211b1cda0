"""The plain reference's parts on their own, on the CPU.

The reference imports nothing of the program; these tests may, to hold
the two to the same published conventions (``jax.random``'s threefry
draws) and to show the reference's rules on hand-made states.

Run from the repository's root: ``python -m pytest pubsub_bench/tests -q``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pubsub_bench.harness import inputs  # noqa: E402
from pubsub_bench.reference import compare, rng  # noqa: E402
from pubsub_bench.reference.gossipsub import Network  # noqa: E402

# Threefry-2x32, 20 rounds: known answers of the Random123 distribution
# (kat_vectors): counter words, key words -> output words.
KNOWN_ANSWERS = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6b200159, 0x99ba4efe)),
    ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
     (0x1cb996fc, 0xbb002be7)),
    ((0x243f6a88, 0x85a308d3), (0x13198a2e, 0x03707344),
     (0xc4923a9c, 0x483df7a0)),
]


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS)
def test_threefry_known_answers(ctr, key, want):
    k = torch.tensor(key, dtype=torch.int64)
    x0, x1 = rng.threefry2x32(k, torch.tensor([ctr[0]]),
                              torch.tensor([ctr[1]]))
    assert (int(x0[0]), int(x1[0])) == want


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 77, 2**32 - 1])
def test_draws_equal_the_programs(seed):
    from go_libp2p_pubsub_torch.ops import rng as prog

    key = rng.key_of_seed(seed)
    pkey = prog.PRNGKey(seed)
    assert np.array_equal(key.numpy(), pkey.numpy().astype(np.int64)
                          & 0xFFFFFFFF)
    for a, b in zip(rng.split(key, 6), prog.split(pkey, 6).unbind(0)):
        assert np.array_equal(a.numpy(), b.numpy().astype(np.int64)
                              & 0xFFFFFFFF)
    assert torch.equal(rng.uniform(key, (37, 16)), prog.uniform(pkey,
                                                                (37, 16)))
    assert torch.equal(rng.uniform(key, (5, 32), maxval=1e-3),
                       prog.uniform(pkey, (5, 32), maxval=1e-3))


def _config(**over):
    with open(os.path.join(ROOT, "pubsub_bench", "configs",
                           "gossipsub_v11_100k.json")) as f:
        cfg = json.load(f)
    cfg.update(dict(n_peers=64, n_slots=8, conn_degree=4, msg_window=32),
               **over)
    return cfg


def test_pick_keeps_the_largest_draws_ties_to_the_lower_slot():
    net = Network(_config(), "cpu")
    draw = torch.tensor([[0.5, 0.9, 0.9, 0.1], [0.3, 0.2, 0.1, 0.0]])
    ok = torch.tensor([[True, True, True, True], [True, False, True, True]])
    got = net.pick(draw, ok, torch.tensor([2, 5]))
    assert got.tolist() == [[False, True, True, False],
                            [True, False, True, True]]
    assert net.pick(draw, ok, 1).tolist() == [[False, True, False, False],
                                              [True, False, False, False]]


def test_caps_cut_whole_words():
    sets = torch.zeros(1, 96, dtype=torch.bool)
    sets[0, :10] = sets[0, 40:45] = sets[0, 70] = True
    assert Network.cap_per_word(sets, 15).sum() == 15
    assert Network.cap_per_word(sets, 14).sum() == 10   # the second word
    assert Network.cap_per_word(sets, 9).sum() == 0     # not even the first


def test_lower_median_and_binned_quantiles():
    vals = torch.tensor([[3.0, 1.0, 2.0, 9.0], [5.0, 0.0, 0.0, 0.0]])
    mask = torch.tensor([[True, True, True, True],
                         [False, False, False, False]])
    med = Network.lower_median(vals, mask)
    assert med[0] == 2.0 and med[1] == float("inf")
    v = torch.arange(128, dtype=torch.float64)
    qs, width = Network.binned_quantiles(v, torch.ones(128, dtype=torch.bool),
                                         (0.1, 0.5, 0.9))
    assert width == 1.0 and [float(q) for q in qs] == [12.0, 63.0, 114.0]
    v[3] = float("-inf")
    qs, width = Network.binned_quantiles(v, torch.ones(128, dtype=torch.bool),
                                         (0.5,))
    assert float(qs[0]) == float("-inf") and width == 0


def test_a_publish_floods_valid_messages_only():
    cfg = _config()
    net = Network(cfg, "cpu")
    graph = inputs.topology(3, cfg["n_peers"], cfg["n_slots"],
                            cfg["conn_degree"])
    st = net.start(graph, 5)
    src = 7
    net.publish(st, src, 4, True)
    net.publish(st, src, 5, False)
    wired = graph[0][src][graph[2][src]]
    assert st["gossip_pend"][wired, 4].all()
    assert st["gossip_pend"][:, 4].sum() == len(wired)
    assert not st["gossip_pend"][:, 5].any()
    assert st["have"][src, 5] and st["first_step"][src, 5] == 0
    net.propagate(st)
    assert st["have"][wired, 4].all() and not st["have"][:, 5].sum() > 1


def test_the_comparison_reads_packed_words_and_narrow_ids():
    words = np.array([[np.int32(-2**31) | 5, 1]], dtype=np.int32)
    bits = compare.unpack_words(words, 40)
    assert bits[0, [0, 2, 31, 32]].all() and bits.sum() == 4
    got = {"a": np.array([1, 2]), "f": np.array([1.0, -np.inf])}
    want = {"a": np.array([1, 3]), "f": np.array([1.0 + 1e-6, -np.inf])}
    judged = compare.judge(got, want)
    assert judged["mismatches"] == {"a": 1}
    assert judged["float_gap"] == pytest.approx(1e-6 / (1.0 + 1e-6))
    want["f"] = np.array([1.0, 0.0])
    assert compare.judge(got, want)["mismatches"] == {"a": 1, "f": 1}
