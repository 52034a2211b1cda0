"""RandomSub -- gossip-by-sampling, the third upstream router family.

Port of the JAX package's ``models/randomsub.py``: each round every peer
draws a fresh keyed sample of ``emit`` live connection slots (``top_mask``
over threefry uniforms, bit for bit with the reference's draws) and relays
last round's receipts over exactly those edges.  The choice is read
target-side through the reverse index (``chosen[nbrs[i,s], rev[i,s]]``),
so the round is a gather.  The upstream sample size is
``max(D, sqrt(topic size))`` capped by the slot count; at 100,000 peers
and 32 slots that is the slot count, which equals flooding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import rng
from ..ops.graphs import decode_index_plane, safe_gather, top_mask
from .floodsub import FloodSub
from .gossipsub import build_topology


class RandomSubState(NamedTuple):
    nbrs: torch.Tensor        # i32[N, K]
    rev: torch.Tensor         # i32[N, K]
    nbr_valid: torch.Tensor   # bool[N, K]
    alive: torch.Tensor       # bool[N]
    have: torch.Tensor        # bool[N, M]
    fresh: torch.Tensor       # bool[N, M]
    first_step: torch.Tensor  # i32[N, M]
    msg_valid: torch.Tensor   # bool[M]
    msg_birth: torch.Tensor   # i32[M]
    msg_used: torch.Tensor    # bool[M]
    key: torch.Tensor         # int32[2] threefry key (per-round draws)
    step: int


class RandomSub(FloodSub):
    """RandomSub router: per-round random-sample relay.

    Inherits :class:`FloodSub`'s ``publish``, ``run`` and
    ``delivery_stats``; only the construction (rev + PRNG key) and the
    relay step (sampled instead of dense) differ.  The per-round emission
    is ``max(d, ceil(sqrt(n_peers)))`` capped by the slot count, or
    ``emit`` when given.
    """

    def __init__(self, n_peers: int = 1024, n_slots: int = 32,
                 conn_degree: int = 16, msg_window: int = 128,
                 d: int = 6, emit: Optional[int] = None, device="cuda"):
        super().__init__(n_peers, n_slots, conn_degree, msg_window, device)
        self.emit = (
            min(max(d, math.isqrt(n_peers - 1) + 1), n_slots)
            if emit is None else min(emit, n_slots)
        )

    def init(self, seed: int = 0) -> RandomSubState:
        rng_np = np.random.default_rng(seed)
        nbrs, rev, valid, _ = build_topology(
            rng_np, self.n, self.k, self.conn_degree)
        return RandomSubState(
            nbrs=self._t(decode_index_plane(nbrs), torch.int32),
            rev=self._t(decode_index_plane(rev), torch.int32),
            nbr_valid=self._t(valid),
            key=rng.PRNGKey(seed, device=self.device),
            **self._window(),
        )

    def kill_peers(self, st: RandomSubState, mask) -> RandomSubState:
        return st._replace(alive=st.alive & ~torch.as_tensor(
            mask, device=self.device).to(torch.bool))

    def step(self, st: RandomSubState) -> RandomSubState:
        """One round: every peer relays last round's receipts to a FRESH
        random sample of ``emit`` live connections."""
        n, k = self.n, self.k
        kdraw, knext = rng.split(st.key, 2).unbind(0)
        edge_live = st.nbr_valid & safe_gather(st.alive, st.nbrs, False)
        r = rng.uniform(kdraw, (n, k))
        chosen = top_mask(torch.where(edge_live, r, -torch.inf), self.emit)
        jidx = torch.clamp(st.nbrs, 0, n - 1).long()
        ridx = torch.clamp(st.rev, 0, k - 1).long()
        towards_me = chosen[jidx, ridx] & edge_live
        return self._relay(st, towards_me, jidx)._replace(key=knext)
