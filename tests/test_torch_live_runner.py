"""The port's live scenario runner against the JAX package's.

``scenario/live_runner.py`` is a copy of the reference's (pinned below),
over the port's ``scenario/compiler`` seeded substreams.  Both packages
classify every canon campaign the same way (live, sim), and the runner's
record synthesis and orphan count give the same channels on fixed
inputs.  Under ``slow``: the reference's four 16-host live acceptance
campaigns through the port, each graded PASS by the spec's own SLO.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from go_libp2p_pubsub_torch import scenario as tscen
from go_libp2p_pubsub_torch.scenario import compiler as tcomp
from go_libp2p_pubsub_torch.scenario import live_runner as tlr
from go_libp2p_pubsub_tpu import scenario as jscen
from go_libp2p_pubsub_tpu.scenario import compiler as jcomp
from go_libp2p_pubsub_tpu.scenario import live_runner as jlr
from test_torch_wire import REPO, assert_copy


def test_module_is_a_copy_of_the_reference():
    # The docstring's opening clause dates the scenario engine in the
    # reference's development history; the port's names the engine.
    with open(os.path.join(REPO, "go_libp2p_pubsub_tpu",
                           "scenario/live_runner.py")) as f:
        line = f.read().split("\n")[2]
    _, sep, tail = line.partition(" gave adversity campaigns")
    assert sep
    assert_copy("scenario/live_runner.py",
                substitutions=[(line, "The scenario engine" + sep + tail)])


def test_scenario_exports_the_live_runner():
    assert sorted(tscen.__all__) == sorted(jscen.__all__)
    assert tscen.sim_supported is tlr.sim_supported
    assert tscen.live_supported is tlr.live_supported
    assert tscen.run_live_scenario is tlr.run_live_scenario
    assert tscen.LivePlaneError is tlr.LivePlaneError


def test_compiler_substreams_match_the_reference():
    assert (tcomp._TAG_CHURN, tcomp._TAG_LINK) == (
        jcomp._TAG_CHURN, jcomp._TAG_LINK)
    for seed, tag, idx in ((43, tcomp._TAG_CHURN, 0), (47, tcomp._TAG_LINK, 2)):
        assert np.array_equal(tcomp._rng(seed, tag, idx).random(16),
                              jcomp._rng(seed, tag, idx).random(16))
    for args in ((0, None, 48), (12, 40, 64), (5, 99, 10)):
        assert tcomp._window(*args) == jcomp._window(*args)
    for mod in (tcomp, jcomp):
        with pytest.raises(ValueError):
            mod._window(-3, 99, 10)


@pytest.mark.parametrize("name", sorted(jscen.CANON))
def test_canon_classification_matches_the_reference(name):
    ts, js = tscen.build(name), jscen.build(name)
    assert tscen.live_supported(ts) == jscen.live_supported(js)
    assert tscen.sim_supported(ts) == jscen.sim_supported(js)


def test_canon_counts():
    specs = tscen.build_all(None)
    assert len(specs) == 26
    live_only = sorted(s.name for s in specs if not tscen.sim_supported(s)
                       and tscen.live_supported(s))
    assert live_only == ["live_partition_heal", "root_kill_failover"]
    # Every campaign runs on some plane of the port.
    assert all(tscen.sim_supported(s) or tscen.live_supported(s)
               or tscen.streaming_supported(s) for s in specs)


def test_unsupported_spec_rejected():
    spec = next(s for s in tscen.build_all(None)
                if not tscen.live_supported(s))
    with pytest.raises(ValueError):
        tscen.run_live_scenario(spec)


# -- record synthesis on fixed inputs ----------------------------------------------


def _members(lr, seed):
    """Fixed generations: survivors, a killed member, a rejoined slot."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in range(1, 9):
        gens = []
        alive_from = 0
        for g in range(1 + (p % 3 == 0)):
            end = None if g == (p % 3 == 0) else int(rng.integers(8, 20))
            receipts = {i: float(1.0 + 0.05 * (2 * i) + rng.uniform(0, 0.2))
                        for i in range(12) if rng.random() > 0.1}
            gens.append(lr._Member(peer=p, host=None, sub=None,
                                   alive_from=alive_from, end_step=end,
                                   killed=end is not None,
                                   receipts=receipts))
            alive_from = (end or 0) + 1
        out[p] = gens
    return out


@pytest.mark.parametrize("family", ["gossipsub", "treecast"])
@pytest.mark.parametrize("seed", [0, 1])
def test_synthesize_record_matches_the_reference(family, seed):
    T, dt, t0 = 32, 0.05, 1.0
    pub_step_of = [2 * i for i in range(12)]
    pub_wall = [t0 + dt * s for s in pub_step_of]
    alive = np.full(T, 8, np.int64)
    orphaned = np.zeros(T, np.int64)
    orphaned[10:13] = [2, 1, 1]
    recs = []
    for scen, lr in ((tscen, tlr), (jscen, jlr)):
        spec = scen.ScenarioSpec(name="fixed", family=family, n_steps=T,
                                 seed=seed)
        recs.append(lr._synthesize_record(
            spec, _members(lr, seed), pub_step_of, pub_wall, t0, dt, T,
            alive, orphaned))
    assert sorted(recs[0]) == sorted(recs[1])
    for k in recs[1]:
        assert recs[0][k].dtype == recs[1][k].dtype, k
        assert np.array_equal(recs[0][k], recs[1][k]), k
    if family == "gossipsub":
        assert 0.0 < recs[0]["delivery_frac"][-1] < 1.0


def _node(is_root=False, closed=False, parent=None):
    ps = None if parent is None else SimpleNamespace(closed=parent == "dead")
    return SimpleNamespace(
        sub=SimpleNamespace(sub=SimpleNamespace(node=SimpleNamespace(
            is_root=is_root, closed=closed, parent_stream=ps))))


def test_count_orphans_matches_the_reference():
    nodes = {1: _node(parent="live"), 2: _node(parent="dead"),
             3: _node(is_root=True), 4: None, 5: _node(parent=None),
             6: _node(closed=True, parent="dead"), 7: _node(parent="live")}
    counts = [lr._count_orphans({}, nodes.get, 9) for lr in (tlr, jlr)]
    assert counts[0] == counts[1] == 2


# -- slow: the live acceptance campaigns at 16 hosts ---------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", ["degraded_links", "churn_10pct",
                                  "root_kill_failover",
                                  "live_partition_heal"])
def test_live_acceptance_campaign_passes(name):
    spec = tscen.build(name)
    res = tscen.run_live_scenario(spec, n_hosts=16)
    assert res.verdict.passed, res.verdict.to_dict()
    if name in ("degraded_links", "churn_10pct"):
        assert res.record["delivery_frac"][-1] >= 0.99
    if name == "root_kill_failover":
        assert res.record["final_epoch"][-1] >= 1
        assert res.record["epoch_spread"][-1] == 0
        assert res.heal_s is not None and res.heal_s > 0
    if name == "live_partition_heal":
        assert res.record["epoch_spread"][-1] == 0
        assert res.record["duplicate_deliveries"][-1] == 0
