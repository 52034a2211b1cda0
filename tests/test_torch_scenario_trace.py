"""The composite campaign's committed trace: a 48-round attack campaign at
100,000 peers that the JAX package ran and saved, committed in the port as
data (``go_libp2p_pubsub_torch/scenario/traces/``) for the port to replay
on the card.

The tier-1 tests check that the file parses, holds the spec below and a
48-round record in every channel, and that ``replay_trace`` runs an
already compiled copy of a trace's spec; the ``slow`` one regenerates the
file with the JAX package (about 45 s of CPU) and asserts it is the
committed file byte for byte.  To rewrite it after a deliberate change of the reference:

    JAX_PLATFORMS=cpu python tests/test_torch_scenario_trace.py --write
"""

import json
import os
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from go_libp2p_pubsub_torch.scenario import campaign  # noqa: E402
from go_libp2p_pubsub_torch.scenario.spec import (  # noqa: E402
    SLO, AttackWave, ChurnPhase, LinkWindow, ScenarioSpec, Workload)

N = 100_000


def reference_spec(n: int = N) -> ScenarioSpec:
    """The composite campaign: every event kind the gossipsub lowering
    emits, at the headline geometry (32 slots, degree 16, 128 messages)."""
    return ScenarioSpec(
        name=f"campaign_{n}", family="gossipsub", n_steps=48, seed=0,
        model=dict(n_peers=n, n_slots=32, conn_degree=16, msg_window=128,
                   heartbeat_steps=8,
                   score_params={
                       "invalid_message_deliveries_weight": -30.0,
                       "ip_colocation_factor_weight": -1.0,
                       "ip_colocation_factor_threshold": 1.0,
                       "mesh_message_deliveries_weight": -1.0,
                       "mesh_message_deliveries_threshold": 1.5,
                       "mesh_message_deliveries_activation_s": 3.0}),
        workloads=[Workload(kind="constant", start=2, stop=42, every=1),
                   Workload(kind="burst", start=6, n_msgs=16)],
        churn=[ChurnPhase(start=8, stop=32, every=4,
                          kills_per_event=n // 100, rejoin_after=8),
               ChurnPhase(start=12, stop=36, every=8,
                          kills_per_event=n // 200, graceful=True,
                          rejoin_after=8)],
        links=[LinkWindow(start=10, stop=30, delay=2, frac=0.25)],
        attacks=[AttackWave(kind="sybil", n_attackers=8),
                 AttackWave(kind="spam", n_attackers=8, start=4, stop=36,
                            spam_every=8),
                 AttackWave(kind="eclipse", target=5, start=4,
                            graft_spam=True),
                 AttackWave(kind="self_promo_ihave", n_attackers=4, start=2,
                            stop=44, spam_every=8)],
        slo=SLO(min_delivery_frac=0.90, max_p99=10.0, max_capture_frac=0.35,
                min_final_target_honest_edges=1))


def write_reference_trace(path: str) -> None:
    """Run the campaign on the JAX package (CPU) and save its trace."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from go_libp2p_pubsub_tpu import scenario as jscn

    spec = jscn.ScenarioSpec.from_dict(reference_spec().to_dict())
    jscn.save_trace(path, jscn.run_scenario(spec))


def test_committed_trace_parses_and_names_the_campaign():
    doc = campaign.load_trace()
    assert doc["trace_version"] == 1
    assert doc["spec"] == reference_spec().to_dict()
    assert campaign.campaign_spec().to_dict() == reference_spec().to_dict()
    assert doc["n_publishes"] == 112
    assert set(doc["verdict"]) == {"scenario", "passed", "criteria"}
    flight = doc["flight"]
    assert {"delivery_frac", "lat_hist", "attacker_capture_frac",
            "attacker_score_mean", "attacker_global_score",
            "target_honest_mesh_edges", "step"} <= set(flight)
    for name, ch in flight.items():
        assert ch["shape"][0] == 48 and len(ch["data"]) == 48, name


@pytest.mark.parametrize("n", [256, 2000])
def test_scaled_spec_changes_only_width_and_kill_shares(n):
    small = campaign.campaign_spec(n)
    want = reference_spec(n).to_dict()
    assert small.to_dict() == want


def test_replay_runs_a_compiled_copy_of_the_traces_spec():
    """``replay_trace(compiled=)`` replays on the given compiled campaign
    (no second compile) and refuses one of another spec."""
    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.scenario.runner import trace_document

    spec = scenario.build("steady_state")
    doc = json.loads(json.dumps(trace_document(
        scenario.run_scenario(spec, device="cpu"))))
    comp = scenario.compile_scenario(spec, device="cpu")
    result, matched, mismatched = scenario.replay_trace(
        doc, device="cpu", compiled=comp)
    assert matched and mismatched == []
    assert result.compiled is comp
    assert result.verdict.to_dict() == doc["verdict"]
    other = scenario.compile_scenario(scenario.build("flash_crowd"),
                                      device="cpu")
    with pytest.raises(ValueError):
        scenario.replay_trace(doc, device="cpu", compiled=other)


@pytest.mark.slow
def test_committed_trace_is_what_the_jax_package_writes():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "campaign.trace.json")
        write_reference_trace(path)
        with open(path, "rb") as f, open(campaign.TRACE_PATH, "rb") as g:
            assert f.read() == g.read()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_scenario_trace.py --write")
    write_reference_trace(campaign.TRACE_PATH)
    print(json.dumps(campaign.load_trace()["verdict"]))
