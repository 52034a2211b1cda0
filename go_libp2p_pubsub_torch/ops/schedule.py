"""Device-resident event schedules: a campaign timeline as scan ``xs``.

(The JAX package's ``ops/schedule.py``, copied into the port.  The port's
``GossipSub.rollout_events`` is a host loop over these numpy rows: each
step's row decides on the host which events apply, and only rows that
carry an event reach the device.  The text below is the reference's.)

The fault/attack machinery historically drove rollouts from the host —
``utils.faults.run_with_faults`` segments a rollout at every event step and
``models/attacks.py`` interleaved publishes with per-round scans, one host
round-trip per event.  The scenario engine (``scenario/``) lowers a whole
campaign to the per-step tensors defined here instead: every event kind
becomes a ``[T, ...]`` array consumed as the ``xs`` of the model's single
``lax.scan`` rollout, so a 1000-step adversity campaign compiles once and
runs with zero host involvement mid-scan.

Conventions shared by every schedule:

- leading axis is the step index (the scan axis);
- boolean masks mean "apply this event to these peers at this step";
- integer "set" tensors use ``-1`` as the no-change / empty sentinel
  (``delay`` rows, publish ``src``/``topic``/msg-id slots);
- publish slots are a fixed per-step budget ``P`` (``pub_src.shape[1]``):
  the compiler packs each step's publishes into the first slots and pads
  with ``-1``.  ``P`` is a compile-time shape, so pick the max publishes
  any single step needs, not the campaign total.

The structures are pure data (NamedTuples of arrays) so they live in ops/;
the application logic is each model's ``rollout_events`` and the lowering
logic is ``scenario/compiler.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GossipEvents(NamedTuple):
    """Per-step event schedule for the single-topic GossipSub rollout.

    Applied in a fixed order before the round's ``step`` (kills, revives,
    subscription deltas, mute deltas, delay sets, publishes) except
    ``silence``, which squelches the eager plane AFTER the step (the
    eclipse adversary's receive-but-never-relay behavior).
    """

    kill: np.ndarray      # bool[T, N] abrupt death at step t
    revive: np.ndarray    # bool[T, N] peers coming back (partition heal /
    #                       churn-with-rejoin); the mesh re-grafts them at
    #                       the next heartbeat
    sub_off: np.ndarray   # bool[T, N] graceful leave: unsubscribe (PRUNEs
    #                       mesh edges immediately, peer stays alive)
    sub_on: np.ndarray    # bool[T, N] (re)subscribe
    mute_on: np.ndarray   # bool[T, N] become a gossip promise-breaker
    mute_off: np.ndarray  # bool[T, N] stop being one
    promo_on: np.ndarray  # bool[T, N] become a self-promoter: IHAVEs
    #                       advertise only self-originated ids (the crafted
    #                       gossip of the self_promo_ihave adversary)
    promo_off: np.ndarray  # bool[T, N] stop self-promoting
    delay: np.ndarray     # i32[T, N] set ingress gossip delay; -1 = keep
    silence: np.ndarray   # bool[T, N] zero the peer's fresh words after the
    #                       step (no eager relay this round)
    pub_src: np.ndarray   # i32[T, P] publisher per publish slot; -1 = empty
    pub_slot: np.ndarray  # i32[T, P] window slot per publish
    pub_valid: np.ndarray  # bool[T, P] validation verdict per publish


class TreeEvents(NamedTuple):
    """Per-step event schedule for the TreeCast rollout."""

    kill: np.ndarray      # bool[T, N] abrupt death (no Part)
    leave: np.ndarray     # bool[T, N] graceful leave (Part to parent)
    sub: np.ndarray       # bool[T, N] begin the join walk (rejoin/churn-in)
    pub_msg: np.ndarray   # i32[T, P] message ids enqueued at the root;
    #                       NO_MSG (-1) = empty slot


class MultiTopicEvents(NamedTuple):
    """Per-step event schedule for the multi-topic GossipSub rollout."""

    kill: np.ndarray       # bool[T, N]
    mute_on: np.ndarray    # bool[T, N]
    mute_off: np.ndarray   # bool[T, N]
    delay: np.ndarray      # i32[T, N]; -1 = keep
    pub_topic: np.ndarray  # i32[T, P] topic per publish slot; -1 = empty
    pub_src: np.ndarray    # i32[T, P]
    pub_slot: np.ndarray   # i32[T, P]
    pub_valid: np.ndarray  # bool[T, P]


def empty_gossip_events(n_steps: int, n: int, pub_width: int = 1) -> GossipEvents:
    """All-quiet schedule (host numpy; mutate in place, then run)."""
    z = lambda: np.zeros((n_steps, n), bool)
    return GossipEvents(
        kill=z(), revive=z(), sub_off=z(), sub_on=z(),
        mute_on=z(), mute_off=z(), promo_on=z(), promo_off=z(),
        delay=np.full((n_steps, n), -1, np.int32),
        silence=z(),
        pub_src=np.full((n_steps, pub_width), -1, np.int32),
        pub_slot=np.zeros((n_steps, pub_width), np.int32),
        pub_valid=np.zeros((n_steps, pub_width), bool),
    )


def empty_tree_events(n_steps: int, n: int, pub_width: int = 1) -> TreeEvents:
    z = lambda: np.zeros((n_steps, n), bool)
    return TreeEvents(
        kill=z(), leave=z(), sub=z(),
        pub_msg=np.full((n_steps, pub_width), -1, np.int32),
    )


def empty_multitopic_events(
    n_steps: int, n: int, pub_width: int = 1
) -> MultiTopicEvents:
    z = lambda: np.zeros((n_steps, n), bool)
    return MultiTopicEvents(
        kill=z(), mute_on=z(), mute_off=z(),
        delay=np.full((n_steps, n), -1, np.int32),
        pub_topic=np.full((n_steps, pub_width), -1, np.int32),
        pub_src=np.full((n_steps, pub_width), -1, np.int32),
        pub_slot=np.zeros((n_steps, pub_width), np.int32),
        pub_valid=np.zeros((n_steps, pub_width), bool),
    )


def add_publish(events, step: int, entry: dict) -> None:
    """Pack one publish into the first free slot of ``events`` at ``step``.

    ``entry`` maps publish-field suffixes to values (e.g. ``{"src": 3,
    "slot": 7, "valid": True}`` for gossip, plus ``"topic"`` for
    multitopic, or ``{"msg": 5}`` for tree).  Raises when the step's
    publish budget (the static ``P`` shape) is full — the compiler sizes
    ``P`` to the busiest step, so overflow here is a lowering bug.
    """
    occupancy = events.pub_src if hasattr(events, "pub_src") else events.pub_msg
    row = occupancy[step]
    free = np.nonzero(row < 0)[0]
    if len(free) == 0:
        raise ValueError(
            f"publish budget overflow at step {step}: all "
            f"{row.shape[0]} per-step publish slots are taken"
        )
    i = free[0]
    for name, value in entry.items():
        field = "pub_msg" if name == "msg" else f"pub_{name}"
        getattr(events, field)[step, i] = value
