"""TreeCast -- the flagship v0-parity model, in PyTorch.

Port of the JAX package's ``models/treecast.py``: the reference's
single-rooted dissemination tree (``subtree.go``) packaged as a model --
state init, the lockstep ``forward`` step, recorded rollouts and a
demo-state builder -- on ``device`` (the card by default; raises without
one).

Differences of form from the reference: ``rollout`` and ``rollout_events``
are Python loops over :func:`ops.tree.step` (no ``lax.scan``), each
``lax.cond`` of the event application is a host ``if`` on the schedule's
numpy row, and the rows that carry an event are copied to the device
once, before the first step.  The flight record (one ``tree_metrics``
sample a step) stays on the device until the last step and is then read
to the host once, as the port's ``GossipSub.rollout_events`` reads its
record.  Nothing inside either loop reads the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SimParams, TreeOpts
from ..ops import tree as tree_ops
from ..ops.schedule import TreeEvents
from ..ops.tree import TreeState
from ..utils.metrics import tree_metrics
from .gossipsub import record_to_host, resolve_device


class TreeCast:
    """Data-parallel dissemination-tree pubsub over ``max_peers`` rows."""

    def __init__(self, params: Optional[SimParams] = None,
                 opts: Optional[TreeOpts] = None, device="cuda"):
        self.params = params or SimParams()
        self.opts = opts or TreeOpts()
        self.device = resolve_device(device)

    # Value semantics: the model is a pure function of its two frozen param
    # sets (and, in the port, its device).
    def __eq__(self, other):
        return (
            type(other) is type(self)
            and (self.params, self.opts, str(self.device))
            == (other.params, other.opts, str(other.device))
        )

    def __hash__(self):
        return hash((type(self), self.params, self.opts, str(self.device)))

    def init(self, root: int = 0) -> TreeState:
        return tree_ops.init_state(self.params, self.opts, root=root,
                                   device=self.device)

    @staticmethod
    def forward(state: TreeState) -> TreeState:
        """One lockstep network transition -- the hot path."""
        return tree_ops.step(state)

    def _finish(self, state: TreeState,
                rounds: List[Dict[str, torch.Tensor]]
                ) -> Dict[str, np.ndarray]:
        """Per-step device samples -> [n_steps] host channels, read once."""
        if not rounds:
            return {name: np.zeros(0, np.int32)
                    for name in tree_metrics(state)}
        stacked = {name: torch.stack([r[name] for r in rounds])
                   for name in rounds[0]}
        return record_to_host(stacked, self.device)

    def rollout(self, state: TreeState, n_steps: int, record: bool = True):
        """``n_steps`` lockstep transitions -> (final state, flight record).

        With ``record=True`` each step adds the ``tree_metrics`` sample, and
        the record comes back as [n_steps] host numpy channels, read once
        after the last step; ``record=False`` returns None for it."""
        rounds = []
        for _ in range(n_steps):
            state = tree_ops.step(state)
            if record:
                rounds.append(tree_metrics(state))
        return state, (self._finish(state, rounds) if record else None)

    def _stage(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows -> the device without a host sync (a pinned buffer and
        an asynchronous copy on a card)."""
        t = torch.from_numpy(np.array(rows))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def rollout_events(self, state: TreeState, events: TreeEvents,
                       record: bool = True):
        """Run a whole event schedule (``ops.schedule.TreeEvents``, host
        numpy) -> (final state, flight record | None).

        Kills, graceful leaves, join walks and root publishes at step t
        apply, in that order, before step t's transition."""
        n_steps = int(events.kill.shape[0])
        fires = {
            "kill": events.kill.any(axis=1),
            "leave": events.leave.any(axis=1),
            "sub": events.sub.any(axis=1),
            "pub_msg": (events.pub_msg >= 0).any(axis=1),
        }
        staged = {}
        for name, mask in fires.items():
            at = np.flatnonzero(mask)
            if at.size:
                rows = self._stage(getattr(events, name)[at])
                staged[name] = dict(zip(at.tolist(), rows.unbind(0)))
        rounds = []
        for t in range(n_steps):
            if fires["kill"][t]:
                state = state._replace(alive=state.alive & ~staged["kill"][t])
            if fires["leave"][t]:
                state = state._replace(
                    leaving=state.leaving | staged["leave"][t])
            if fires["sub"][t]:
                state = tree_ops.begin_subscribe_many(state, staged["sub"][t])
            if fires["pub_msg"][t]:
                state = tree_ops.publish_many(state, staged["pub_msg"][t])
            state = tree_ops.step(state)
            if record:
                rounds.append(tree_metrics(state))
        return state, (self._finish(state, rounds) if record else None)

    def build_demo_state(self, n_peers: int, n_msgs: int = 4) -> TreeState:
        """A small joined tree with queued traffic, for compile checks and
        benches: the join walk runs host-side (each subscribe is a few
        steps, read back each step), then ``n_msgs`` root publishes."""
        if n_peers > self.params.max_peers:
            raise ValueError("n_peers exceeds SimParams.max_peers")
        st = self.init(root=0)
        for p in range(1, n_peers):
            st = tree_ops.begin_subscribe(st, p)
            for _ in range(4 * n_peers):
                if bool(st.joined[p]):
                    break
                st = tree_ops.step(st)
        for m in range(n_msgs):
            st = tree_ops.publish(st, m)
        return st


def entry_fn_and_args(
    n_peers: int = 16, params: Optional[SimParams] = None, device="cuda",
) -> Tuple[callable, Tuple[TreeState]]:
    """(forward, example args) for a smoke check of the entry point."""
    model = TreeCast(params or SimParams(max_peers=max(16, n_peers)),
                     device=device)
    state = model.build_demo_state(n_peers)
    return TreeCast.forward, (state,)
