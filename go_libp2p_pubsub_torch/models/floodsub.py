"""FloodSub -- the dense baseline model, in PyTorch.

Port of the JAX package's ``models/floodsub.py``: every message floods
over every connection edge (no mesh, no gossip), the delivery upper bound
and bandwidth worst case against which GossipSub's mesh is judged (the
first BASELINE.json config, "in-process 10-peer floodsub broadcast").
State is a subset of the GossipSub layout (same adjacency, built by the
loop builder ``build_topology`` from the seed); the round is one
gather-or.  The state's ``step`` is a host ``int``, as in the port's
``GossipState``, so no round reads the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.graphs import decode_index_plane, safe_gather
from .gossipsub import _nanquantile_int, build_topology, resolve_device


class FloodState(NamedTuple):
    nbrs: torch.Tensor        # i32[N, K]
    nbr_valid: torch.Tensor   # bool[N, K]
    alive: torch.Tensor       # bool[N]
    have: torch.Tensor        # bool[N, M]
    fresh: torch.Tensor       # bool[N, M]
    first_step: torch.Tensor  # i32[N, M]
    msg_valid: torch.Tensor   # bool[M]
    msg_birth: torch.Tensor   # i32[M]
    msg_used: torch.Tensor    # bool[M] ever published
    step: int


class FloodSub:
    """Flooding router over ``n_peers`` rows on ``device`` (the card by
    default; raises without one)."""

    def __init__(self, n_peers: int = 1024, n_slots: int = 32,
                 conn_degree: int = 16, msg_window: int = 128,
                 device="cuda"):
        self.n, self.k, self.m = n_peers, n_slots, msg_window
        self.conn_degree = conn_degree
        self.device = resolve_device(device)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _window(self):
        """The message-window leaves of a fresh state."""
        n, m, dev = self.n, self.m, self.device
        return dict(
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            have=torch.zeros((n, m), dtype=torch.bool, device=dev),
            fresh=torch.zeros((n, m), dtype=torch.bool, device=dev),
            first_step=torch.full((n, m), -1, dtype=torch.int32, device=dev),
            msg_valid=torch.zeros(m, dtype=torch.bool, device=dev),
            msg_birth=torch.zeros(m, dtype=torch.int32, device=dev),
            msg_used=torch.zeros(m, dtype=torch.bool, device=dev),
            step=0,
        )

    def init(self, seed: int = 0) -> FloodState:
        rng_np = np.random.default_rng(seed)
        nbrs, _, valid, _ = build_topology(rng_np, self.n, self.k,
                                           self.conn_degree)
        return FloodState(
            nbrs=self._t(decode_index_plane(nbrs), torch.int32),
            nbr_valid=self._t(valid),
            **self._window(),
        )

    def publish(self, st, src: int, slot: int, valid):
        """Seed a message at peer ``src`` in window ``slot`` (recycling the
        slot for every peer); ``valid`` is its validation verdict."""
        src, slot = int(src), int(slot)
        have, fresh = st.have.clone(), st.fresh.clone()
        first_step = st.first_step.clone()
        # Element stores go through ``fill_``: an indexed assignment of a
        # Python scalar would copy it from the host.
        for plane in (have, fresh):
            plane[:, slot].fill_(False)
            plane[src, slot].fill_(True)
        first_step[:, slot].fill_(-1)
        first_step[src, slot].fill_(st.step)
        msg_valid, msg_birth = st.msg_valid.clone(), st.msg_birth.clone()
        msg_used = st.msg_used.clone()
        msg_valid[slot].fill_(bool(valid))
        msg_birth[slot].fill_(st.step)
        msg_used[slot].fill_(True)
        return st._replace(
            have=have, fresh=fresh, first_step=first_step,
            msg_valid=msg_valid, msg_birth=msg_birth, msg_used=msg_used,
        )

    def _relay(self, st, edge_ok: torch.Tensor, jidx: torch.Tensor):
        """Receipts over the ``edge_ok`` [N, K] edges from last round's
        fresh planes -> the next state."""
        arrived = (edge_ok[:, :, None] & st.fresh[jidx.long()]).any(dim=1)
        new = arrived & ~st.have & st.alive[:, None]
        return st._replace(
            have=st.have | (new & st.msg_valid[None, :]),
            fresh=new & st.msg_valid[None, :],
            first_step=torch.where(new & (st.first_step < 0), st.step,
                                   st.first_step),
            step=st.step + 1,
        )

    def step(self, st: FloodState) -> FloodState:
        """Flood round: every peer relays last round's receipts on ALL
        edges."""
        j = torch.clamp(st.nbrs, 0, self.n - 1)
        edge_ok = st.nbr_valid & safe_gather(st.alive, st.nbrs, False)
        return self._relay(st, edge_ok, j)

    def run(self, st, n_steps: int):
        for _ in range(n_steps):
            st = self.step(st)
        return st

    def delivery_stats(self, st) -> Tuple[torch.Tensor, torch.Tensor]:
        """Delivery fraction + p50 latency over published VALID messages
        only (invalid messages stamp first_step at receive-and-reject time
        and must not pollute the latency median)."""
        alive_n = torch.clamp(st.alive.sum(dtype=torch.int32), min=1)
        counted = st.msg_used & st.msg_valid
        frac = torch.where(
            counted,
            (st.have & st.alive[:, None]).sum(dim=0, dtype=torch.int32)
            / alive_n,
            torch.nan,
        )
        lat = st.first_step - st.msg_birth[None, :]
        return frac, _nanquantile_int(
            lat, (st.first_step >= 0) & counted[None, :], 0.5)
