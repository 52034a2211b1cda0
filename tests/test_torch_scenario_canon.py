"""The canon on the port: every sim-supported ``gossipsub`` campaign of the
JAX package's canon, and the treecast campaign ``tree_churn_heal``, run
through the port's ``scenario.run_scenario`` on the CPU and through the
reference's, must lower to the same event rows and give the same
verdict, the same flight record (exact, through the trace encoding) and
the same final state, leaf for leaf."""

import numpy as np
import pytest

from go_libp2p_pubsub_tpu import scenario as jscn
from go_libp2p_pubsub_torch import scenario as tscn

from test_torch_scenario import (
    assert_same_events, assert_same_record, assert_same_state)

SIM_GOSSIPSUB = [name for name in jscn.CANON
                 if jscn.build(name).family == "gossipsub"
                 and jscn.sim_supported(jscn.build(name))]
# Campaigns whose event and attack kinds another tier-1 case already
# covers (kills by partition_heal, publishes by steady_state, cold-boot
# by cold_boot_eclipse, link delay by self_promo_ihave): slow, to keep
# the file's tier-1 time near a minute at -n 6.
COVERED = ("churn_10pct", "flash_crowd", "fuzz_regression_cold_boot",
           "degraded_links")


def test_the_canon_has_fourteen_sim_gossipsub_campaigns():
    assert len(SIM_GOSSIPSUB) == 14


@pytest.mark.parametrize("name", [
    pytest.param(name, marks=pytest.mark.slow) if name in COVERED else name
    for name in SIM_GOSSIPSUB])
def test_canon_campaign_matches_reference(name):
    ref = jscn.run_scenario(jscn.build(name))
    out = tscn.run_scenario(tscn.build(name), device="cpu")
    assert_same_events(ref.compiled.events, out.compiled.events, name)
    assert out.compiled.n_publishes == ref.compiled.n_publishes
    if ref.compiled.attackers is None:
        assert out.compiled.attackers is None
    else:
        np.testing.assert_array_equal(out.compiled.attackers,
                                      ref.compiled.attackers)
    assert out.verdict.to_dict() == ref.verdict.to_dict()
    assert_same_record(ref.record, out.record, name)
    assert_same_state(ref.final_state, out.final_state, name)


def test_tree_churn_heal_matches_reference():
    name = "tree_churn_heal"
    assert jscn.build(name).family == "treecast"
    ref = jscn.run_scenario(jscn.build(name))
    out = tscn.run_scenario(tscn.build(name), device="cpu")
    assert_same_state(ref.compiled.state, out.compiled.state, name + " init")
    assert_same_events(ref.compiled.events, out.compiled.events, name)
    assert out.compiled.n_publishes == ref.compiled.n_publishes
    assert out.compiled.attackers is None and out.compiled.target is None
    assert out.verdict.to_dict() == ref.verdict.to_dict()
    assert out.verdict.passed
    assert_same_record(ref.record, out.record, name)
    assert_same_state(ref.final_state, out.final_state, name)
