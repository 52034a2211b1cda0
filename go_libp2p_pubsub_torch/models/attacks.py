"""Attack traces: scripted adversary scenarios over the GossipSub model.

The JAX package's ``models/attacks.py`` in the port.  Each runner lowers
its campaign to an ``ops.schedule.GossipEvents`` schedule and executes it
in the model's ``rollout_events``; the declarative form of the same
campaigns lives in ``scenario.canon``.  The runners that build their own
model take the model's keyword arguments, ``device`` among them (the card
by default).

Each runner returns ``(final_state, report)`` where ``report`` maps metric
name -> per-step array (host numpy): the flight-recorder channels plus the
adversary-standing series (``attacker_mesh_edges``,
``attacker_score_mean``, ``honest_score_min``, and per-scenario extras).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import ScoreParams
from ..ops import schedule as sched
from ..ops.graphs import decode_index_plane
from .gossipsub import GossipState, GossipSub

_METRICS = ("attacker_mesh_edges", "attacker_score_mean", "honest_score_min")


def run_with_metrics(
    gs: GossipSub,
    st: GossipState,
    n_steps: int,
    attackers,
) -> Tuple[GossipState, Dict[str, np.ndarray]]:
    """Roll ``n_steps`` collecting the defense time series each step
    (adversary mesh occupancy and score standing; a host loop)."""
    att_np = (attackers.cpu().numpy() if isinstance(attackers, torch.Tensor)
              else np.asarray(attackers, bool))
    att = (gs._stage(att_np), gs._stage(np.flatnonzero(att_np)))
    rounds = []
    for _ in range(n_steps):
        st = gs.step(st)
        rounds.append(gs._campaign_record(gs._widen_indices(st), att, None))
    series = gs._finish_record(
        {k: torch.stack([r[k] for r in rounds]) for k in rounds[0]})
    return st, {k: series[k] for k in _METRICS}


def _run_events(
    gs: GossipSub,
    st: GossipState,
    events,
    attackers,
    target=None,
) -> Tuple[GossipState, Dict[str, np.ndarray]]:
    """One ``rollout_events`` -> (final state, host-numpy report)."""
    return gs.rollout_events(
        st, events, attackers=attackers, target=target, record=True,
    )


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def invalid_spam_attack(
    gs: GossipSub,
    st: GossipState,
    n_attackers: int,
    n_rounds: int = 6,
    steps_per_round: int = 4,
    seed: int = 0,
) -> Tuple[GossipState, Dict[str, np.ndarray], torch.Tensor]:
    """Attackers (peers 0..n_attackers-1) publish invalid messages each
    round; honest traffic continues from random publishers."""
    if n_attackers > gs.m // 2:
        raise ValueError(
            f"n_attackers ({n_attackers}) exceeds the publishable window "
            f"(msg_window // 2 = {gs.m // 2}); grow msg_window or shrink "
            "the attacker set — clamping silently would model a smaller "
            "attack than reported"
        )
    attackers = np.arange(gs.n) < n_attackers
    rng = np.random.default_rng(seed)
    n_steps = n_rounds * steps_per_round
    events = sched.empty_gossip_events(n_steps, gs.n, n_attackers + 1)
    slot = 0
    for r in range(n_rounds):
        t = r * steps_per_round
        # Every attacker seeds one invalid message; one honest publish too.
        for a in range(n_attackers):
            sched.add_publish(
                events, t, {"src": a, "slot": slot % gs.m, "valid": False}
            )
            slot += 1
        sched.add_publish(
            events, t,
            {"src": int(rng.integers(n_attackers, gs.n)),
             "slot": slot % gs.m, "valid": True},
        )
        slot += 1
    st, report = _run_events(gs, st, events, attackers)
    return st, report, gs._t(attackers)


def sybil_colocation_attack(
    gs: GossipSub,
    st: GossipState,
    n_sybils: int,
    n_steps: int = 32,
) -> Tuple[GossipState, Dict[str, np.ndarray], torch.Tensor]:
    """Sybil identities (peers 0..n_sybils-1) share one colocation group;
    the P6 penalty (``ops/scoring.colocation_penalty``) is the defense."""
    attackers = np.arange(gs.n) < n_sybils
    group = st.gcounters.ip_group.clone()
    group[:n_sybils] = 0
    st = st._replace(gcounters=st.gcounters._replace(ip_group=group))
    events = sched.empty_gossip_events(n_steps, gs.n)
    st, report = _run_events(gs, st, events, attackers)
    return st, report, gs._t(attackers)


def eclipse_attempt(
    gs: GossipSub,
    st: GossipState,
    target: int,
    n_rounds: int = 8,
    msgs_per_round: int = 2,
    seed: int = 0,
) -> Tuple[GossipState, Dict[str, np.ndarray], torch.Tensor]:
    """The target's entire converged mesh turns adversarial and goes silent
    (receives but never relays): an eclipse — the target's data-plane view
    is fully attacker-controlled.  With P3 (mesh-delivery deficit) enabled
    in the model's score params and honest background traffic flowing, the
    silent slots build delivery deficits, get pruned (and held out by the
    prune backoff), and honest grafts restore the target's connectivity.

    Each round publishes ``msgs_per_round`` valid messages from random
    honest peers, then advances one heartbeat period with attacker relay
    suppressed on BOTH data planes: their fresh words are zeroed after
    every step (the schedule's ``silence`` channel — no eager relay) AND
    they are marked ``gossip_mute`` (no gossip service either — a mute peer
    advertises but never answers IWANTs; every ask it attracts charges its
    P7 behaviour penalty).  Attackers stay alive and scoreable throughout.
    """
    n, k = gs.n, gs.k
    nbrs_np = decode_index_plane(st.nbrs).cpu().numpy()
    mesh_np = st.mesh.cpu().numpy()
    att_ids = sorted(
        {int(nbrs_np[target, s]) for s in range(k) if mesh_np[target, s]}
    )
    attackers = np.zeros((n,), bool)
    attackers[att_ids] = True
    honest_ids = np.array(
        [i for i in range(n) if i not in att_ids and i != target]
    )
    rng = np.random.default_rng(seed)
    n_steps = n_rounds * gs.heartbeat_steps
    events = sched.empty_gossip_events(n_steps, n, msgs_per_round)
    # First-class promise-breaking: the heartbeat's IWANT selection skips
    # serving from muted peers and charges their P7 directly — no state
    # surgery on advertisement snapshots needed (r3 verdict item 6).
    events.mute_on[0] |= attackers
    events.silence[:] |= attackers[None, :]
    slot = 0
    for r in range(n_rounds):
        t = r * gs.heartbeat_steps
        for _ in range(msgs_per_round):
            sched.add_publish(
                events, t,
                {"src": int(rng.choice(honest_ids)),
                 "slot": slot % gs.m, "valid": True},
            )
            slot += 1
    st, report = _run_events(gs, st, events, attackers, target=target)
    return st, report, gs._t(attackers)


def gossip_promise_spam_attack(
    n_peers: int = 64,
    n_attackers: int = 8,
    n_rounds: int = 10,
    seed: int = 0,
    **model_kwargs,
) -> Tuple[GossipSub, GossipState, Dict[str, np.ndarray], torch.Tensor]:
    """Advertise-heavily, serve-nothing spammers vs IWANT promise tracking.

    Attackers participate normally in the mesh and in IHAVE emission — they
    receive honest traffic and advertise it — but never answer an IWANT
    (``gossip_mute``).  Every ask they attract is a broken promise charged
    to their P7 behaviour penalty at the heartbeat (the spec's gossip
    promise tracking via the followup timeout, collapsed to the heartbeat
    in the lockstep model).  The squared P7 term must push their global
    score negative with NO manual advertisement muting, while honest peers
    accrue zero penalty and honest traffic still delivers.

    A short heartbeat period keeps messages mid-flight at heartbeat time so
    IHAVE/IWANT traffic actually flows (with long periods the eager push
    saturates possession first and nobody wants anything).
    """

    model_kwargs.setdefault("heartbeat_steps", 2)
    sp = model_kwargs.pop("score_params", ScoreParams())
    gs = GossipSub(n_peers=n_peers, score_params=sp, **model_kwargs)
    st = gs.init(seed=seed)
    attackers = np.arange(n_peers) < n_attackers
    rng = np.random.default_rng(seed)
    n_steps = n_rounds * gs.heartbeat_steps
    events = sched.empty_gossip_events(n_steps, n_peers, 3)
    events.mute_on[0] |= attackers
    slot = 0
    for r in range(n_rounds):
        t = r * gs.heartbeat_steps
        # Honest publishes only: the attack is pure gossip-service abuse.
        for _ in range(3):
            sched.add_publish(
                events, t,
                {"src": int(rng.integers(n_attackers, n_peers)),
                 "slot": slot % gs.m, "valid": True},
            )
            slot += 1
    st, report = _run_events(gs, st, events, attackers)
    return gs, st, report, gs._t(attackers)


def backoff_spam_attack(
    n_peers: int = 64,
    n_attackers: int = 6,
    n_rounds: int = 8,
    seed: int = 0,
    **model_kwargs,
) -> Tuple[GossipSub, GossipState, Dict[str, np.ndarray], torch.Tensor]:
    """GRAFT flooders vs the P7 behaviour penalty.

    Attackers spam invalid messages (so honest meshes prune them, starting
    prune-backoff countdowns) AND re-graft straight through the backoff
    window every heartbeat (``graft_spammers``).  Every refused attempt
    charges their ``behaviour_penalty``; the squared P7 term must push their
    score negative and keep them out of honest meshes even after the P4
    spam evidence has decayed away.

    Constructs its own model (the spammer set is constructor-bound — see
    ``GossipSub.graft_spammers``).  Returns (model, final_state, report,
    attacker_mask); the report adds ``attacker_behaviour_penalty`` and
    ``attacker_global_score`` to the standard defense series.
    """

    attackers_np = np.arange(n_peers) < n_attackers
    sp = model_kwargs.pop("score_params", ScoreParams())
    gs = GossipSub(
        n_peers=n_peers,
        score_params=sp,
        graft_spammers=attackers_np,
        **model_kwargs,
    )
    st = gs.init(seed=seed)
    rng = np.random.default_rng(seed)
    n_steps = n_rounds * gs.heartbeat_steps
    events = sched.empty_gossip_events(n_steps, n_peers, n_attackers + 1)
    slot = 0
    for r in range(n_rounds):
        t = r * gs.heartbeat_steps
        # Attacker spam earns the prunes; one honest publish keeps honest
        # P2 credit flowing.
        for a in range(n_attackers):
            sched.add_publish(
                events, t, {"src": a, "slot": slot % gs.m, "valid": False}
            )
            slot += 1
        sched.add_publish(
            events, t,
            {"src": int(rng.integers(n_attackers, n_peers)),
             "slot": slot % gs.m, "valid": True},
        )
        slot += 1
    st, report = _run_events(gs, st, events, attackers_np)
    return gs, st, report, gs._t(attackers_np)
