"""Fault injection: scheduled failures as data, not test plumbing.

The reference injects faults by literally killing hosts mid-test
(``hosts[1].Close()``, ``pubsub_test.go:178``) or closing a subscription for
a graceful ``Part`` (``pubsub_test.go:301``), and its failure *detection* is
scattered across read-EOF / write-error / Part paths (SURVEY.md §5.3).  In
the array engines liveness is already a mask tensor, so a fault campaign is
just a schedule of mask edits applied at chosen steps — deterministic,
replayable, and identical between the treecast and gossipsub engines.

Also provides the attack-trace generators behind BASELINE.json config (d):
sybil IP-colocation groups and eclipse (targeted mesh capture) campaigns for
the peer-scoring subsystem.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of fault events over a rollout.

    ``kills[t]``  — bool[N] peers abruptly dead at the *start* of step t
                    (no Part; detection is lazy, like ``subtree.go:333-336``).
    ``leaves[t]`` — bool[N] peers requesting graceful leave at step t
                    (tree engine only; the ``Part`` path, ``subtree.go:78-98``).
    """

    kills: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    leaves: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    @staticmethod
    def _as_mask(peers, n: int) -> np.ndarray:
        """``peers`` (index list or bool mask) -> validated bool[n].

        Rejects out-of-range indices (negative ones would silently wrap in
        fancy indexing — a plan targeting peer ``n`` or ``-1`` is a bug in
        the caller, not a request for the last row) and bool masks whose
        length disagrees with ``n``.
        """
        peers = np.asarray(peers)
        if peers.size == 0:
            return np.zeros(n, bool)
        if peers.dtype == bool:
            if peers.shape != (n,):
                raise ValueError(
                    f"bool peer mask has shape {peers.shape}, expected ({n},)"
                )
            return peers.copy()
        if peers.size and not np.issubdtype(peers.dtype, np.integer):
            raise TypeError(
                f"peers must be integer indices or a bool mask, got dtype "
                f"{peers.dtype}"
            )
        if peers.size and (peers.min() < 0 or peers.max() >= n):
            bad = peers[(peers < 0) | (peers >= n)]
            raise ValueError(
                f"peer indices {bad.tolist()} out of range [0, {n})"
            )
        m = np.zeros(n, bool)
        m[peers] = True
        return m

    def kill_at(self, step: int, peers, n: int) -> "FaultPlan":
        mask = self._as_mask(peers, n)
        prev = self.kills.get(step)
        if prev is not None and prev.shape != (n,):
            raise ValueError(
                f"step {step} already has a kill mask for n={prev.shape[0]}, "
                f"cannot extend it with n={n}"
            )
        self.kills[step] = mask if prev is None else (prev | mask)
        return self

    def leave_at(self, step: int, peers, n: int) -> "FaultPlan":
        mask = self._as_mask(peers, n)
        prev = self.leaves.get(step)
        if prev is not None and prev.shape != (n,):
            raise ValueError(
                f"step {step} already has a leave mask for n={prev.shape[0]}, "
                f"cannot extend it with n={n}"
            )
        self.leaves[step] = mask if prev is None else (prev | mask)
        return self

    def event_steps(self) -> List[int]:
        return sorted(set(self.kills) | set(self.leaves))

    def liveness_timeline(self, n_steps: int, n: int) -> np.ndarray:
        """bool[T, N]: expected alive mask at each step under this plan
        (kills only — graceful leavers stay alive).  The oracle tests assert
        engine state against."""
        alive = np.ones(n, bool)
        out = np.empty((n_steps, n), bool)
        for t in range(n_steps):
            if t in self.kills:
                alive &= ~self.kills[t]
            out[t] = alive
        return out


def run_with_faults(
    st,
    n_steps: int,
    run_fn: Callable,
    plan: FaultPlan,
    kill_fn: Callable,
    leave_fn: Optional[Callable] = None,
):
    """Drive ``run_fn(st, k)`` for ``n_steps``, applying plan events.

    LEGACY host-segmented path: the scenario engine lowers the same plan to
    device event tensors instead (``scenario.ScenarioSpec.from_fault_plan``
    -> one un-segmented ``rollout_events`` scan).  Kept for callers that
    need custom ``kill_fn`` semantics or un-lowered state edits between
    segments.

    The rollout is segmented at event steps: scan between events (device
    speed), apply mask edits at the boundary (one tiny host round-trip per
    event).  Works for both engines:

    - tree:   ``run_with_faults(st, T, tree_ops.run_steps, plan,
               lambda s, m: s._replace(alive=s.alive & ~m),
               lambda s, m: s._replace(leaving=s.leaving | m))``
    - gossip: ``run_with_faults(st, T, gs.run, plan, gs.kill_peers)``
    """
    import torch

    def on_device(mask):
        return torch.as_tensor(mask, device=st.alive.device)

    events = [t for t in plan.event_steps() if t < n_steps]
    cursor = 0
    for t in events:
        if t > cursor:
            st = run_fn(st, t - cursor)
            cursor = t
        if t in plan.kills:
            st = kill_fn(st, on_device(plan.kills[t]))
        if t in plan.leaves:
            if leave_fn is None:
                raise ValueError("plan has leaves but no leave_fn given")
            st = leave_fn(st, on_device(plan.leaves[t]))
    if n_steps > cursor:
        st = run_fn(st, n_steps - cursor)
    return st


# ---------------------------------------------------------------------------
# attack-trace generators (BASELINE config (d))
# ---------------------------------------------------------------------------

def sybil_ip_groups(
    n: int, n_sybils: int, group: int = 0, honest_unique: bool = True
) -> np.ndarray:
    """i32[N] IP-group ids where peers [0, n_sybils) share one group.

    Feeds ``ScoreParams.ip_colocation_factor_*`` (the P6 penalty): colocated
    sybils score quadratically negative and fall below the graft threshold.
    """
    if honest_unique:
        groups = np.arange(n, dtype=np.int32)
    else:
        groups = np.zeros(n, np.int32)
    groups[:n_sybils] = group
    return groups


def eclipse_campaign(
    rng: np.random.Generator,
    n: int,
    target: int,
    n_attackers: int,
    start_step: int,
    n_steps: int,
    churn_every: int = 8,
) -> Tuple[np.ndarray, FaultPlan]:
    """An eclipse attempt on ``target``: attackers [n-n_attackers, n) plus a
    kill schedule that churns the target's honest neighbors so attackers can
    occupy the vacated mesh slots.

    Returns (attacker_mask bool[N], plan).  The scoring defense under test:
    behaviour/invalid penalties must keep attacker scores below the graft
    threshold so the mesh refills from honest peers instead.
    """
    attackers = np.zeros(n, bool)
    attackers[n - n_attackers:] = True
    plan = FaultPlan()
    honest = np.array([p for p in range(n) if not attackers[p] and p != target])
    for i, t in enumerate(range(start_step, start_step + n_steps, churn_every)):
        victims = rng.choice(honest, size=min(2, len(honest)), replace=False)
        plan.kill_at(t, victims, n)
    return attackers, plan
