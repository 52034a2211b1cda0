"""Scenario fuzzer: seeded random search for SLO-red configs.

Samples the ATTACK/ENVIRONMENT side of the :class:`ScenarioSpec` space
(wave kind + timing + size, churn, link windows, workload cadence) against
a STANDING defense parameterization and a standing SLO, runs each sample
through the sim runner, and reports every red verdict.  The search is a
pure function of ``--seed``: every draw comes from
``np.random.default_rng([seed, _TAG_FUZZ, index])``, so a trajectory is
reproducible bit-for-bit and a red config can be re-derived from its
index alone.

The search space covers all three planes (``--plane``, r14):

- ``sim`` (default): attack campaigns against the scored defense;
- ``streaming``: serving-plane chaos — backpressure policy x workload
  shape x fault stage (engine crash, verifier crash, producer stall,
  clock skew) x snapshot cadence, graded by the conservation +
  exactly-once SLOs.  A red here is a fragile SERVING config (e.g. a
  snapshot period too slow for the crash point loses accepted messages);
- ``live``: socket-plane campaigns (churn, link delay windows) over small
  host counts.  The sampled trajectory is deterministic; verdicts on this
  plane inherit the live canon's wall-clock sensitivity.

``--search defense`` (sim plane only) inverts the hunt: instead of
sampling attacks against a fixed defense, it samples SCORE-PARAMETER
configurations and grades each against a fixed battery of canon attack
campaigns — hunting for fragile defense configs, not strong attacks
(ROADMAP item 4's leftover).  Every defense draw comes from
``np.random.default_rng([seed, _TAG_DEFENSE, index])``.

A red config can then be SHRUNK (``--shrink``): greedy coordinate descent
over a fixed mutation schedule (drop churn, drop links, fewer attackers,
shorter campaign, sparser spam), keeping each mutation only while the
verdict stays red — the fixed point is a minimal reproducer, written as a
replayable ScenarioSpec JSON (``--save-red``) for
``go_libp2p_pubsub_torch.tools.scenario_run --spec``.

Usage (``F = python -m go_libp2p_pubsub_torch.tools.scenario_fuzz``)::

    F --budget 40 --seed 0
    F --budget 40 --seed 0 --defense hardened
    F --budget 40 --seed 0 --shrink --save-red red.json
    F --budget 5 --seed 0 --json                     # smoke
    F --plane streaming --budget 10 --seed 0
    F --search defense --budget 5 --seed 0
    F --budget 5 --seed 0 --device cpu               # on the CPU

Exit code 0 when the hunt completes (red findings are the OUTPUT, not a
failure); 1 on usage errors; 2 without a card for ``--device cuda``.
Campaigns run on ``--device`` (the live plane on the host).  A failure
of the device itself is raised, never graded as an invalid spec.

The first hunt this tool ran (budget 40, seed 0, standing defense) went
27/40 red and sample 0 itself was the find: the cold-boot mesh monopoly.
With P3 at its shipped default (disabled), a score-less adversary that
owns a target's mesh slot from boot keeps a clean standing for the whole
campaign — no deficit evidence ever accrues, so ``final_attacker_score``
stays at +0.08 against the -0.25 SLO bound.  The shrinker reduced it to
ONE attacker, no churn, no links; the committed replay at
``tests/golden/fuzz_red_cold_boot.json`` is that fixed point re-windowed
(attack runs to the final step, workload stops 4 rounds early) so the
final-step grade lands inside the attack window rather than after a
decay tail.  Its fixed twin — the SAME spec under ``HARDENED_DEFENSE``
(P3 enabled) — is the ``fuzz_regression_cold_boot`` canon scenario:
attacker buried at -7.67, target back to 3 honest edges, green on the
same standing SLO.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from typing import Callable, List, Optional

import numpy as np

from .. import scenario
from ..scenario.defense import (
    HARDENED_DEFENSE, PROMOTED_DEFENSE, STANDING_DEFENSE, defense_digest,
)
from ..scenario.spec import (
    SLO, AttackWave, ChurnPhase, LinkWindow, ScenarioSpec, Workload,
)
from . import device_error, device_failure

# Fuzzer substream tag — disjoint from the compiler's per-component tags
# (1..4 in scenario/compiler.py), so a fuzzed spec's own lowering draws
# never alias the search's draws.
_TAG_FUZZ = 5
# Defense-search substream: disjoint from _TAG_FUZZ so the same seed can
# run both hunts without aliased draws.
_TAG_DEFENSE = 6

# The named defense registry lives in scenario/defense.py (r21): the
# standing (pre-taxonomy) config, the hand-hardened cold-boot fix, and
# whatever the last co-evolution run promoted (falls back to hardened
# when no promotion artifact is committed).
DEFENSES = {
    "standing": STANDING_DEFENSE,
    "hardened": HARDENED_DEFENSE,
    "promoted": PROMOTED_DEFENSE,
}

# One fixed mesh for the whole search: every sample shares the model
# shapes, so the rollout jit cache carries across the budget.
_FUZZ_MESH = dict(n_peers=64, n_slots=16, conn_degree=8, msg_window=128)

_N_STEPS = 48
_TARGET = 5

# Attack kinds the sim plane lowers (everything in spec.ATTACK_KINDS).
_KINDS = (
    "sybil", "eclipse", "spam", "promise_spam", "graft_spam",
    "cold_boot_eclipse", "covert_flash", "score_farm", "self_promo_ihave",
    "partition_flood",
)


def standing_slo(has_attack: bool, targeted: bool) -> SLO:
    """The invariant grade every sample is held to: deliveries hold, the
    adversary's standing is buried, no honest peer pays collateral damage,
    and a targeted victim keeps at least one honest mesh edge."""
    kw = dict(min_delivery_frac=0.90)
    if has_attack:
        kw.update(
            max_capture_frac=0.35,
            max_final_attacker_score=-0.25,
            min_final_honest_score=-2.0,
        )
    if targeted:
        kw.update(min_final_target_honest_edges=1)
    return SLO(**kw)


def sample_spec(seed: int, index: int, defense: dict) -> ScenarioSpec:
    """Draw one scenario from the search space (pure in (seed, index))."""
    rng = np.random.default_rng([seed, _TAG_FUZZ, index])
    hb = int(rng.choice([2, 4]))
    model = dict(_FUZZ_MESH, heartbeat_steps=hb, score_params=dict(defense))

    workloads = [Workload(
        kind="constant", start=2, stop=int(rng.integers(36, 45)),
        every=int(rng.choice([2, 4])),
    )]

    kind = str(rng.choice(_KINDS))
    start = int(rng.integers(0, 8))
    stop = int(rng.integers(start + 16, min(start + 33, _N_STEPS)))
    kw = dict(kind=kind, start=start, stop=stop)
    if kind in ("eclipse", "cold_boot_eclipse"):
        kw["target"] = _TARGET
    if kind != "eclipse":
        kw["n_attackers"] = int(rng.integers(2, 6))
    if kind in ("spam", "score_farm", "self_promo_ihave", "partition_flood"):
        kw["spam_every"] = int(rng.choice([2, 4]))
    elif kind in ("covert_flash", "graft_spam", "eclipse"):
        kw["spam_every"] = int(rng.choice([0, 2, 4]))
    if kind == "graft_spam":
        kw["graft_spam"] = True
    if kind == "covert_flash":
        kw["defect_step"] = int(rng.integers(start, (start + stop) // 2 + 1))
    if kind == "score_farm":
        kw["farm_steps"] = int(rng.integers(4, max(5, (stop - start) // 2)))
    if kind == "partition_flood":
        kw["stop"] = min(stop, 36)
        kw["flood_offset"] = int(rng.integers(0, 5))
        kw["partition_frac"] = float(rng.uniform(0.1, 0.3))

    churn = []
    if rng.random() < 0.35:
        c0 = int(rng.integers(4, 16))
        churn.append(ChurnPhase(
            start=c0, stop=c0 + int(rng.integers(8, 24)),
            every=int(rng.choice([4, 8])), kills_per_event=1,
            graceful=bool(rng.random() < 0.3),
        ))
    links = []
    if rng.random() < 0.35:
        l0 = int(rng.integers(0, 12))
        links.append(LinkWindow(
            start=l0, stop=l0 + int(rng.integers(12, 32)),
            delay=int(rng.integers(1, 4)),
            frac=float(rng.uniform(0.1, 0.6)),
        ))

    return ScenarioSpec(
        name=f"fuzz_s{seed}_i{index:04d}",
        family="gossipsub",
        n_steps=_N_STEPS,
        seed=int(rng.integers(0, 2**31 - 1)),
        model=model,
        workloads=workloads,
        attacks=[AttackWave(**kw)],
        churn=churn,
        links=links,
        slo=standing_slo(True, kind in ("eclipse", "cold_boot_eclipse")),
        description=f"fuzzed {kind} campaign (search seed {seed}, "
                    f"index {index})",
    )


# One fixed serving mesh for the streaming hunt, for the same reason as
# _FUZZ_MESH: every sample shares the model value, so the resident chunk
# compiles once per (chunk_steps, pub_width) across the whole budget.
_STREAM_FUZZ_MESH = dict(
    n_topics=2, n_peers=32, n_slots=16, conn_degree=4, msg_window=64,
    heartbeat_steps=4,
)
_STREAM_N_STEPS = 32
_STREAM_CHUNK_STEPS = 8

# Fixed hybrid serving mesh (r16): same compile-sharing rationale.  Single
# topic by construction (the hybrid plane is T = 1), small enough that the
# GF(256) decode fold stays cheap on CPU hunts.
_HYBRID_FUZZ_MESH = dict(
    n_peers=32, n_slots=8, conn_degree=6, msg_window=16,
    heartbeat_steps=4, gen_size=4, switch_hi=0.35, switch_lo=0.15,
)


def streaming_standing_slo(capacity: int, has_crash: bool) -> SLO:
    """The serving-plane invariant grade: conservation exact, delivery
    exactly-once, backlog bounded by the ring, and — when a crash is
    staged — recovery bounded and lossless."""
    kw = dict(
        min_delivery_frac=0.90,
        max_queue_depth=capacity,
        max_silent_drops=0,
        max_lost_after_restart=0,
        max_duplicate_deliveries=0,
    )
    if has_crash:
        kw.update(max_recovery_s=60.0)
    return SLO(**kw)


def sample_streaming_spec(
    seed: int, index: int, defense: Optional[dict] = None
) -> ScenarioSpec:
    """Draw one serving-plane chaos scenario (pure in (seed, index)).

    The fragility axes are policy x load shape x fault stage x snapshot
    cadence.  ``snapshot_every=2`` with a crash on an odd chunk is a
    deliberately reachable red: the unsnapshotted chunk's messages are
    lost, and ``max_lost_after_restart=0`` says so.  Block-policy loads
    are capacity-matched so a single-threaded hunt never parks in the
    ring's blocking push."""
    rng = np.random.default_rng([seed, _TAG_FUZZ, index])
    # Hybrid-plane draw (r16): a quarter of the hunt runs the adaptive
    # coded family under a degraded-link window — crash faults landing
    # inside the window are the crash-MID-GENERATION trajectories (partial
    # decode ranks in the snapshot).
    hybrid = bool(rng.random() < 0.25)
    policy = str(rng.choice(["block", "drop_oldest", "reject"]))
    capacity = int(rng.choice([8, 12, 16]))

    workloads = []
    per_chunk = 0
    for topic in range(1 if hybrid else int(rng.integers(1, 3))):
        every = int(rng.choice([2, 4]))
        workloads.append(Workload(
            kind="constant", topic=topic, start=topic,
            stop=_STREAM_N_STEPS, every=every,
        ))
        per_chunk += _STREAM_CHUNK_STEPS // every
    if policy != "block" and rng.random() < 0.4:
        workloads.append(Workload(
            kind="burst", topic=0, start=int(rng.integers(0, 8)),
            n_msgs=int(rng.integers(8, 25)),
        ))

    streaming = {
        "streaming_only": True,
        "chunk_steps": _STREAM_CHUNK_STEPS,
        "capacity": capacity,
        "policy": policy,
    }
    fault = str(rng.choice(
        ["none", "crash", "verifier", "stall", "skew"],
        p=[0.15, 0.30, 0.20, 0.20, 0.15],
    ))
    n_chunks = _STREAM_N_STEPS // _STREAM_CHUNK_STEPS
    deferred = 0
    if fault == "crash":
        streaming["crash_at_chunk"] = int(rng.integers(1, n_chunks))
        streaming["snapshot_every"] = int(rng.choice([1, 2]))
    elif fault == "verifier":
        streaming["verifier_crash_at_chunk"] = int(rng.integers(1, n_chunks))
    elif fault == "stall":
        start = int(rng.integers(2, 12))
        steps = int(rng.integers(4, 13))
        streaming["producer_stall"] = {"start": start, "steps": steps}
        deferred = sum(
            1 for w in workloads if w.kind == "constant"
            for t in range(start, start + steps)
            if t >= w.start and (t - w.start) % w.every == 0
        )
    elif fault == "skew":
        streaming["clock_skew"] = {
            "at_chunk": int(rng.integers(1, n_chunks)),
            "skew_s": float(rng.choice([-2.0, -0.5, 0.5, 2.0])),
        }
    if hybrid:
        # Always degraded: the last traffic chunk stays clean so the drain
        # finishes whatever the estimator's switch latency left pending.
        lo_start = int(rng.integers(0, 2))
        if rng.random() < 0.35:
            # Hysteresis-oscillation attack (r21): the adversary flips the
            # link lossy/clean every period_chunks across the whole window,
            # straddling the switch_hi/switch_lo band to force worst-of-
            # both behavior out of the eager<->coded estimator.
            streaming["loss_oscillate"] = {
                "start_chunk": lo_start,
                "stop_chunk": int(rng.integers(lo_start + 2, n_chunks + 1)),
                "period_chunks": int(rng.choice([1, 2])),
                "delay": int(rng.choice([1, 2, 3])),
            }
        else:
            streaming["loss"] = {
                "start_chunk": lo_start,
                "stop_chunk": int(rng.integers(lo_start + 1, n_chunks)),
                "delay": int(rng.choice([1, 2, 3])),
            }
    if policy == "block":
        # No blocking stalls in a single-threaded hunt: one flush's worth
        # of pushes (a group, doubled by the verifier retry window, plus
        # any stall-deferred flood) must fit the ring.
        need = per_chunk * (2 if fault == "verifier" else 1) + deferred
        if need > capacity:
            streaming["capacity"] = capacity = need

    return ScenarioSpec(
        name=f"fuzz_stream_s{seed}_i{index:04d}",
        family="hybrid" if hybrid else "multitopic",
        n_steps=_STREAM_N_STEPS,
        seed=int(rng.integers(0, 2**31 - 1)),
        model=dict(_HYBRID_FUZZ_MESH if hybrid else _STREAM_FUZZ_MESH),
        workloads=workloads,
        streaming=streaming,
        slo=streaming_standing_slo(capacity, fault == "crash"),
        description=f"fuzzed serving chaos: {fault} fault, {policy} "
                    f"policy{', degraded hybrid' if hybrid else ''} "
                    f"(search seed {seed}, index {index})",
    )


def sample_live_spec(
    seed: int, index: int, defense: Optional[dict] = None
) -> ScenarioSpec:
    """Draw one socket-plane campaign (pure in (seed, index)): small host
    counts, churn and link-delay windows — the components the live runner
    lowers.  Verdicts inherit the live plane's wall-clock sensitivity."""
    rng = np.random.default_rng([seed, _TAG_FUZZ, index])
    n_hosts = int(rng.choice([4, 5, 6]))
    n_steps = int(rng.integers(16, 25))
    workloads = [Workload(
        kind="constant", start=2, stop=n_steps - 2,
        every=int(rng.choice([2, 4])),
    )]
    churn = []
    if rng.random() < 0.4:
        c0 = int(rng.integers(4, 8))
        churn.append(ChurnPhase(
            start=c0, stop=min(c0 + int(rng.integers(4, 9)), n_steps - 4),
            every=4, kills_per_event=1, graceful=True,
        ))
    links = []
    if rng.random() < 0.4:
        l0 = int(rng.integers(2, 8))
        links.append(LinkWindow(
            start=l0, stop=min(l0 + int(rng.integers(4, 10)), n_steps - 2),
            delay=1, frac=float(rng.uniform(0.2, 0.5)),
        ))
    return ScenarioSpec(
        name=f"fuzz_live_s{seed}_i{index:04d}",
        family="gossipsub",
        n_steps=n_steps,
        seed=int(rng.integers(0, 2**31 - 1)),
        workloads=workloads,
        churn=churn,
        links=links,
        live={"n_hosts": n_hosts},
        slo=SLO(min_delivery_frac=0.80),
        description=f"fuzzed live campaign, {n_hosts} hosts "
                    f"(search seed {seed}, index {index})",
    )


SAMPLERS = {
    "sim": sample_spec,
    "streaming": sample_streaming_spec,
    "live": sample_live_spec,
}


# ---------------------------------------------------------------------------
# defense-parameter search (sim plane)
# ---------------------------------------------------------------------------

# Canon attack campaigns every sampled defense must survive.  Chosen to
# cover the three standing-failure axes the taxonomy PR measured: score
# starvation from boot, reputation built then spent, and raw spam volume.
DEFENSE_BATTERY = ("cold_boot_eclipse", "covert_flash", "spam_flood")


def full_battery():
    """EVERY sim-plane canon attack campaign — the promotion gate (r21).

    The quick 3-campaign battery is a search heuristic; a config headed
    for the shipped default must survive the whole canon.  Computed from
    the canon registry, so newly added attack scenarios join the gate
    automatically.
    """
    return tuple(
        name for name, builder in scenario.CANON.items()
        if (lambda s: s.attacks and not s.live_only
            and not s.streaming_only)(builder())
    )


def sample_defense(seed: int, index: int) -> dict:
    """Draw one score-parameter configuration (pure in (seed, index)).

    Log-uniform over the penalty weights (their useful range spans decades)
    with each optional penalty independently enabled, so the search reaches
    both over-tuned hammers and defenses with a whole axis missing — the
    fragile configs this mode hunts."""
    rng = np.random.default_rng([seed, _TAG_DEFENSE, index])
    defense = {
        "invalid_message_deliveries_weight":
            -float(10.0 ** rng.uniform(0.0, 2.0)),
    }
    if rng.random() < 0.8:
        defense["ip_colocation_factor_weight"] = (
            -float(10.0 ** rng.uniform(-1.0, 1.0))
        )
        defense["ip_colocation_factor_threshold"] = float(rng.integers(1, 5))
    if rng.random() < 0.5:
        defense["mesh_message_deliveries_weight"] = (
            -float(10.0 ** rng.uniform(-1.0, 0.5))
        )
        defense["mesh_message_deliveries_threshold"] = (
            float(rng.uniform(0.5, 4.0))
        )
        defense["mesh_message_deliveries_activation_s"] = (
            float(rng.choice([2.0, 3.0, 5.0, 8.0]))
        )
    if rng.random() < 0.5:
        defense["behaviour_penalty_weight"] = (
            -float(10.0 ** rng.uniform(-1.0, 1.0))
        )
    return defense


def grade_defense(defense: dict, battery=DEFENSE_BATTERY, device="cuda"):
    """Grade one defense config against the canon battery.

    Returns (status, [(campaign, status, failed-criteria), ...]): red when
    ANY battery campaign goes red under this defense — a fragile config
    finding, the mirror image of the attack hunt."""
    results = []
    worst = "green"
    for name in battery:
        spec = scenario.CANON[name]()
        spec = dataclasses.replace(
            spec,
            name=f"{spec.name}@defense",
            model=dict(spec.model, score_params=dict(defense)),
        )
        status, _, failed = _grade(spec, device=device)
        results.append((name, status, failed))
        if status == "red":
            worst = "red"
        elif status == "invalid" and worst != "red":
            worst = "invalid"
    return worst, results


def _digest(spec: ScenarioSpec) -> str:
    return hashlib.sha256(spec.to_json().encode()).hexdigest()[:12]


def _digest_obj(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode()
    ).hexdigest()[:12]


_RUNNERS = {
    "sim": lambda spec, device: scenario.run_scenario(spec, device=device),
    "streaming": lambda spec, device: scenario.run_streaming_scenario(
        spec, device=device),
    "live": lambda spec, device: scenario.run_live_scenario(spec),
}


def _grade(spec: ScenarioSpec, plane: str = "sim", device="cuda"):
    """Run one spec on ``device`` -> (status, verdict | None,
    failed-criteria names).

    "invalid" means the spec failed compile-time validation — a boundary
    of the search space, not a defense failure.  A failure of the device
    (``device_failure``) is not the spec's, and propagates.
    """
    try:
        res = _RUNNERS[plane](spec, device)
    except (ValueError, RuntimeError) as e:
        if device_failure(e):
            raise
        return "invalid", None, [str(e).splitlines()[0][:80]]
    v = res.verdict
    failed = [c.name for c in v.criteria if not c.passed]
    return ("green" if v.passed else "red"), v, failed


# ---------------------------------------------------------------------------
# shrinking
# ---------------------------------------------------------------------------

def _mutations(spec: ScenarioSpec, plane: str = "sim") -> List[ScenarioSpec]:
    """Candidate simplifications, most aggressive first.  Invalid
    candidates are fine — the shrink loop grades and discards them."""
    out: List[ScenarioSpec] = []
    rep = dataclasses.replace
    if plane == "streaming":
        # Serving-plane shrink axis: drop fault stages one at a time, then
        # thin the workload — the minimal red names the one fault + load
        # shape that actually breaks the config.
        cfg = dict(spec.streaming or {})
        for key in ("clock_skew", "producer_stall", "loss", "loss_oscillate",
                    "compare_eager",
                    "verifier_crash_at_chunk", "crash_at_chunk"):
            if key in cfg:
                smaller = {
                    k: v for k, v in cfg.items()
                    if k != key and not (
                        key == "crash_at_chunk" and k == "snapshot_every"
                    )
                }
                out.append(rep(spec, streaming=smaller))
        if len(spec.workloads) > 1:
            out.append(rep(spec, workloads=spec.workloads[:-1]))
        for wl in spec.workloads[:1]:
            if wl.kind == "constant" and wl.every < 8:
                out.append(rep(spec, workloads=(
                    [dataclasses.replace(wl, every=wl.every * 2)]
                    + spec.workloads[1:]
                )))
        return out
    if spec.churn:
        out.append(rep(spec, churn=[]))
    if spec.links:
        out.append(rep(spec, links=[]))
    if spec.n_steps > 24:
        out.append(rep(spec, n_steps=spec.n_steps - 8))
    if spec.attacks:
        w = spec.attacks[0]
        if w.kind != "eclipse" and w.n_attackers > 1:
            out.append(rep(spec, attacks=[
                dataclasses.replace(w, n_attackers=w.n_attackers - 1)
            ]))
        if w.spam_every and w.spam_every < 8:
            out.append(rep(spec, attacks=[
                dataclasses.replace(w, spam_every=w.spam_every * 2)
            ]))
        if w.stop is not None and w.stop - w.start > 16:
            out.append(rep(spec, attacks=[
                dataclasses.replace(w, stop=w.stop - 8)
            ]))
    for wl in (spec.workloads or []):
        if wl.every < 8:
            out.append(rep(spec, workloads=[
                dataclasses.replace(wl, every=wl.every * 2)
            ]))
        break
    return out


def shrink(
    spec: ScenarioSpec,
    log: Callable[[str], None],
    plane: str = "sim",
    device="cuda",
) -> ScenarioSpec:
    """Greedy coordinate descent: apply any mutation that stays red until
    none does.  Deterministic — the mutation schedule is fixed."""
    current = spec
    improved = True
    while improved:
        improved = False
        for cand in _mutations(current, plane):
            status, _, failed = _grade(cand, plane, device)
            if status == "red":
                log(f"  shrink kept: {_describe_delta(current, cand)} "
                    f"(still red on {', '.join(failed)})")
                current = cand
                improved = True
                break
    return current


def _describe_delta(old: ScenarioSpec, new: ScenarioSpec) -> str:
    if old.churn and not new.churn:
        return "drop churn"
    if old.links and not new.links:
        return "drop links"
    if (old.streaming or {}) != (new.streaming or {}):
        gone = set(old.streaming or {}) - set(new.streaming or {})
        return f"drop fault {'/'.join(sorted(gone))}" if gone \
            else "streaming config"
    if old.n_steps != new.n_steps:
        return f"n_steps {old.n_steps}->{new.n_steps}"
    if len(old.workloads) != len(new.workloads):
        return f"workloads {len(old.workloads)}->{len(new.workloads)}"
    if old.attacks and new.attacks:
        ow, nw = old.attacks[0], new.attacks[0]
        if ow.n_attackers != nw.n_attackers:
            return f"n_attackers {ow.n_attackers}->{nw.n_attackers}"
        if ow.spam_every != nw.spam_every:
            return f"spam_every {ow.spam_every}->{nw.spam_every}"
        if ow.stop != nw.stop:
            return f"attack stop {ow.stop}->{nw.stop}"
    if old.workloads and new.workloads \
            and old.workloads[0].every != new.workloads[0].every:
        return (f"workload every {old.workloads[0].every}->"
                f"{new.workloads[0].every}")
    return "mutation"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _spec_kind(spec: ScenarioSpec, plane: str) -> str:
    """Short trajectory label: attack kind (sim), staged fault (streaming),
    or the host count (live)."""
    if spec.attacks:
        return spec.attacks[0].kind
    if plane == "streaming":
        cfg = spec.streaming or {}
        for key, label in (
            ("crash_at_chunk", "engine_crash"),
            ("verifier_crash_at_chunk", "verifier_crash"),
            ("producer_stall", "producer_stall"),
            ("clock_skew", "clock_skew"),
            ("loss", "degraded_links"),
            ("loss_oscillate", "oscillating_loss"),
        ):
            if key in cfg:
                if key == "crash_at_chunk" and (
                    "loss" in cfg or "loss_oscillate" in cfg
                ):
                    return "crash_mid_generation"
                return label
        return "no_fault"
    if plane == "live":
        return f"live/{(spec.live or {}).get('n_hosts', '?')}h"
    return "none"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--budget", type=int, default=40,
                    help="number of specs to sample and run (default 40)")
    ap.add_argument("--seed", type=int, default=0,
                    help="search seed; the whole trajectory is a pure "
                    "function of it (default 0)")
    ap.add_argument("--plane", choices=sorted(SAMPLERS), default="sim",
                    help="which runner to fuzz: sim (attack campaigns), "
                    "streaming (serving-plane faults), live (multi-host)")
    ap.add_argument("--search", choices=("attack", "defense"),
                    default="attack",
                    help="attack: hunt red campaign configs; defense: hunt "
                    "fragile score-parameter configs (sim plane only)")
    ap.add_argument("--defense", choices=sorted(DEFENSES), default="standing",
                    help="standing score config to fuzz against "
                    "(attack search, sim plane)")
    ap.add_argument("--battery", choices=("quick", "full"), default="quick",
                    help="defense-search battery: quick (3 campaigns, the "
                    "search heuristic) or full (every canon attack — the "
                    "promotion gate)")
    ap.add_argument("--shrink", action="store_true",
                    help="minimize the first red config found "
                    "(attack search)")
    ap.add_argument("--save-red", metavar="PATH",
                    help="write the (minimized, with --shrink) first red "
                    "spec as replayable JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the trajectory as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the campaigns run (default cuda; cpu runs "
                    "them on the CPU)")
    args = ap.parse_args(argv)
    if args.budget < 1:
        ap.error("--budget must be >= 1")
    if args.search == "defense" and args.plane != "sim":
        ap.error("--search defense is a score-parameter hunt; it only "
                 "exists on the sim plane")
    err = None if args.plane == "live" else device_error(args.device)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2

    if args.search == "defense":
        battery = (
            DEFENSE_BATTERY if args.battery == "quick" else full_battery()
        )
        trajectory = []
        first_fragile = None
        for i in range(args.budget):
            defense = sample_defense(args.seed, i)
            worst, results = grade_defense(defense, battery=battery,
                                           device=args.device)
            entry = {
                "index": i,
                "digest": defense_digest(defense),
                "status": worst,
                "defense": defense,
                "campaigns": [
                    {"name": name, "status": status, "failed": failed}
                    for name, status, failed in results
                ],
            }
            trajectory.append(entry)
            if not args.json:
                broke = [c["name"] for c in entry["campaigns"]
                         if c["status"] != "green"]
                extra = f"  [{', '.join(broke)}]" if broke else ""
                print(f"{i:4d}  {entry['digest']}  {worst:<8}{extra}")
            if worst == "red" and first_fragile is None:
                first_fragile = entry
        n_red = sum(e["status"] == "red" for e in trajectory)
        n_inv = sum(e["status"] == "invalid" for e in trajectory)
        summary = {
            "seed": args.seed,
            "budget": args.budget,
            "search": "defense",
            "battery": args.battery,
            "red": n_red,
            "green": args.budget - n_red - n_inv,
            "invalid": n_inv,
        }
        if first_fragile is not None:
            summary["first_fragile_digest"] = first_fragile["digest"]
        if args.json:
            print(json.dumps(
                {"summary": summary, "trajectory": trajectory}, indent=2
            ))
        else:
            print(f"\n{n_red} fragile / {summary['green']} robust / "
                  f"{n_inv} invalid over {args.budget} defense configs "
                  f"(seed {args.seed})")
        return 0

    sampler = SAMPLERS[args.plane]
    defense = DEFENSES[args.defense] if args.plane == "sim" else None
    # Every red report names the exact config it was red AGAINST (r21
    # satellite): an archived red is meaningless without its defense.
    ddig = None if defense is None else defense_digest(defense)
    trajectory = []
    first_red: Optional[ScenarioSpec] = None
    for i in range(args.budget):
        spec = sampler(args.seed, i, defense)
        status, verdict, failed = _grade(spec, args.plane, args.device)
        entry = {
            "index": i,
            "digest": _digest(spec),
            "kind": _spec_kind(spec, args.plane),
            "status": status,
            "failed": failed,
        }
        if ddig is not None:
            entry["defense_digest"] = ddig
        trajectory.append(entry)
        if not args.json:
            extra = f"  [{', '.join(failed)}]" if failed else ""
            print(f"{i:4d}  {entry['digest']}  "
                  f"{entry['kind']:<18} {status:<8}{extra}")
        if status == "red" and first_red is None:
            first_red = spec

    n_red = sum(e["status"] == "red" for e in trajectory)
    n_inv = sum(e["status"] == "invalid" for e in trajectory)
    summary = {
        "seed": args.seed,
        "budget": args.budget,
        "plane": args.plane,
        "defense": args.defense if args.plane == "sim" else None,
        "defense_digest": ddig,
        "red": n_red,
        "green": args.budget - n_red - n_inv,
        "invalid": n_inv,
    }

    minimized = None
    if first_red is not None and args.shrink:
        if not args.json:
            print(f"\nshrinking first red ({first_red.name}):")
        minimized = shrink(
            first_red, (lambda m: None) if args.json else print,
            plane=args.plane, device=args.device,
        )
        summary["minimized_digest"] = _digest(minimized)
    if args.save_red:
        red_out = minimized if minimized is not None else first_red
        if red_out is None:
            print("no red config found; nothing to save", file=sys.stderr)
            return 1
        if ddig is not None:
            # Replay artifacts carry their provenance: which defense this
            # spec is red against, and which search found it.
            red_out = dataclasses.replace(red_out, meta=dict(
                red_out.meta or {},
                defense=args.defense,
                defense_digest=ddig,
                found_by="scenario_fuzz",
                search_seed=args.seed,
            ))
        with open(args.save_red, "w") as f:
            f.write(red_out.to_json())
        summary["saved"] = args.save_red

    if args.json:
        print(json.dumps(
            {"summary": summary, "trajectory": trajectory}, indent=2
        ))
    else:
        tail = f"defense {args.defense}" if args.plane == "sim" \
            else f"plane {args.plane}"
        print(f"\n{summary['red']} red / {summary['green']} green / "
              f"{summary['invalid']} invalid over {args.budget} samples "
              f"(seed {args.seed}, {tail})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
