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

Sharded (``mesh=``, a ``parallel.mesh.PeerMesh`` over ``max_peers``; the
JAX package's ``dryrun_multichip`` tree family): one process a rank, each
holding the block of rows ``[row0, row0 + B)`` (placement is the
identity: the reference shards the tree by contiguous blocks).  ``init``
builds the whole state on the host and cuts it (``shard_state`` over
``TREE_REPLICATED_FIELDS`` / ``TREE_PEER_DIMS``); ``rollout`` steps with
``ops.tree.step(pm=)`` and reduces its record over the ranks once.
Every rank of the group makes the same calls, and the run equals the
unsharded one bit for bit, leaf for leaf.  ``rollout_events`` runs
unsharded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SimParams, TreeOpts
from ..ops import tree as tree_ops
from ..ops.schedule import TreeEvents
from ..ops.tree import TreeState
from ..parallel.mesh import shard_state
from ..utils.metrics import reduce_tree_metrics, tree_metrics
from .gossipsub import record_to_host, resolve_device


class TreeCast:
    """Data-parallel dissemination-tree pubsub over ``max_peers`` rows."""

    def __init__(self, params: Optional[SimParams] = None,
                 opts: Optional[TreeOpts] = None, device="cuda", mesh=None):
        self.params = params or SimParams()
        self.opts = opts or TreeOpts()
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.n != self.params.max_peers:
                raise ValueError(
                    f"mesh is over {mesh.n} peers, model has "
                    f"{self.params.max_peers}")
            if mesh.device != self.device:
                raise ValueError(
                    f"mesh device {mesh.device} is not the model's "
                    f"{self.device}")
        self.mesh = mesh

    # Value semantics: the model is a pure function of its two frozen param
    # sets (and, in the port, its device).
    def __eq__(self, other):
        return (
            type(other) is type(self)
            and self._key() == other._key()
        )

    def __hash__(self):
        return hash((type(self),) + self._key())

    def _key(self):
        pm = self.mesh
        return (self.params, self.opts, str(self.device),
                None if pm is None else (pm.rank, pm.world))

    def init(self, root: int = 0, seed: int = 0) -> TreeState:
        """A fresh tree holding only ``root`` (sharded: this rank's block
        of the whole state, built on the host)."""
        if self.mesh is None:
            return tree_ops.init_state(self.params, self.opts, root=root,
                                       seed=seed, device=self.device)
        whole = tree_ops.init_state(self.params, self.opts, root=root,
                                    seed=seed, device="cpu")
        return shard_state(whole, self.mesh,
                           replicated=tree_ops.TREE_REPLICATED_FIELDS,
                           peer_dim=tree_ops.TREE_PEER_DIMS)

    def gather_state(self, state: TreeState) -> Dict[str, np.ndarray]:
        """Every leaf of the whole state as host numpy (sharded: the
        blocks all-gathered; a collective, so every rank calls it)."""
        if self.mesh is None:
            return {name: getattr(state, name).cpu().numpy()
                    for name in state._fields}
        return self.mesh.gather_canonical(state, tree_ops.TREE_PEER_DIMS)

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
        if self.mesh is not None:
            stacked = reduce_tree_metrics(stacked, self.mesh)
        return record_to_host(stacked, self.device)

    def rollout(self, state: TreeState, n_steps: int, record: bool = True):
        """``n_steps`` lockstep transitions -> (final state, flight record).

        With ``record=True`` each step adds the ``tree_metrics`` sample, and
        the record comes back as [n_steps] host numpy channels, read once
        after the last step; ``record=False`` returns None for it.
        Sharded, each step's sample is the block's, and the record crosses
        ranks once, at the end (``reduce_tree_metrics``)."""
        rounds = []
        for _ in range(n_steps):
            state = tree_ops.step(state, pm=self.mesh)
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
        apply, in that order, before step t's transition.  Unsharded."""
        if self.mesh is not None:
            raise NotImplementedError(
                "rollout_events runs unsharded (mesh=None)")
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
        if self.mesh is not None:
            raise NotImplementedError(
                "build_demo_state runs unsharded (mesh=None)")
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
