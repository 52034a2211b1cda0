"""GossipSub -- the scalable mesh model, in PyTorch.

Port of the JAX package's ``models/gossipsub.py``: a single-topic
GossipSub v1.1-shaped simulator with a static neighbor-slot adjacency, a
mesh maintained by heartbeats, eager push plus lazy IHAVE/IWANT gossip,
and peer scores fed by delivery attribution.  Message windows are
bit-packed into int32 words (``ops/bitpack.py``).

The eager-push round runs kernel K1 and the heartbeat's IHAVE/IWANT
exchange runs kernel K2 (``ops/cuda_gossip.py``) whenever the state lies
on a CUDA device; on the CPU the kernels' plain versions run.  Everything
else is plain tensor code.

Differences of form from the reference, none of which changes a bit of
state:

- The state's ``step`` is a host ``int``.  The heartbeat schedule and the
  opportunistic-graft ticks are functions of it, so the host takes those
  branches with a plain ``if`` and a round never reads the device.
- The reference's data-dependent ``lax.cond`` sites (the PX cache
  refresh, the self-promotion advertise view) are ``torch.where`` over
  both branches, which agree whenever the cheap branch applies.
- Methods are eager functions of the state; ``rollout`` is a Python loop
  that keeps the int32 index view for its whole length (the reference
  widens and narrows every round; the values are the same).

This slice covers the closed loop (init, publish, kill_peers, step,
rollout with the flight recorder, delivery_stats).  The scenario event
path, the other ``set_*`` mutators, per-edge delay, direct peering,
placement relabeling and the sharded path are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import GossipSubParams, ScoreParams
from ..ops import bitpack
from ..ops import cuda_gossip
from ..ops import histogram as hist_ops
from ..ops import rng
from ..ops import scoring as scoring_ops
from ..ops.bitpack import as_mask
from ..ops.fma import fma
from ..ops.gossip import heartbeat_mesh, uniform_by_uid
from ..ops.gossip_packed import exchange_prep
from ..ops.graphs import (
    decode_index_plane,
    encode_index_plane,
    index_dtype,
    narrow_index_plane,
    safe_gather,
    top_mask,
    torch_dtype,
)
from ..ops.px import px_rewire
from ..ops.scoring import GlobalCounters, TopicCounters, segment_sum

FLIGHT_HIST_BINS = 32
_AGE_CAP = (2**31 - 1) // 2


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class GossipState(NamedTuple):
    """Single-topic mesh state (the reference's ``GossipState``, field for
    field).  N peers, K slots, M-message window packed into W int32 words.
    ``nbrs``/``rev`` are stored narrow (``ops.graphs.index_dtype``)."""

    nbrs: torch.Tensor          # [N, K] remote peer id (narrow storage)
    rev: torch.Tensor           # [N, K] remote's slot back to me (narrow)
    nbr_valid: torch.Tensor     # bool[N, K]
    outbound: torch.Tensor      # bool[N, K] I dialed this edge
    alive: torch.Tensor         # bool[N]
    subscribed: torch.Tensor    # bool[N]
    edge_live: torch.Tensor     # bool[N, K] nbr_valid & alive[nbrs]
    nbr_sub: torch.Tensor       # bool[N, K] cached subscribed[nbrs]
    mesh: torch.Tensor          # bool[N, K]
    fanout: torch.Tensor        # bool[N, K]
    fanout_age: torch.Tensor    # int32[N]
    backoff: torch.Tensor       # int32[N, K]
    counters: TopicCounters
    gcounters: GlobalCounters
    scores: torch.Tensor        # f32[N, K] cached neighbor scores
    have_w: torch.Tensor        # int32[N, W] possession
    fresh_w: torch.Tensor       # int32[N, W] first-received last round
    gossip_pend_w: torch.Tensor  # int32[N, W] transfers landing next round
    iwant_pend_w: torch.Tensor   # int32[N, W] IWANT grants (two rounds out)
    gossip_mute: torch.Tensor   # bool[N] promise-breakers
    self_promo: torch.Tensor    # bool[N] IHAVE self-promoters
    gossip_delay: torch.Tensor  # int32[N] ingress latency of the pend fold
    pend_hold: torch.Tensor     # int32[N]
    edge_delay: torch.Tensor    # int32[N, K] (per-edge delay: not ported)
    fresh_hist: torch.Tensor    # int32[N, 0, W] (per-edge delay: not ported)
    first_step: torch.Tensor    # int32[N, M] first-receipt step, -1 = never
    msg_valid: torch.Tensor     # bool[M]
    msg_birth: torch.Tensor     # int32[M]
    msg_active: torch.Tensor    # bool[M]
    msg_used: torch.Tensor      # bool[M]
    key: torch.Tensor           # int32[2] threefry key (uint32 bit patterns)
    step: int                   # round counter, owned by the host


# -- host-side topology builders (numpy copies of the reference's) ---------


def build_topology(
    rng_np: np.random.Generator, n: int, k: int, degree: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Random ~degree-regular undirected graph in neighbor-slot form ->
    (nbrs, rev, nbr_valid, outbound), index planes in narrow storage."""
    if degree >= k:
        raise ValueError(f"degree ({degree}) must be < slot count k ({k})")
    nbrs = np.full((n, k), -1, np.int64)
    rev = np.full((n, k), -1, np.int64)
    outbound = np.zeros((n, k), bool)
    used = np.zeros(n, np.int64)
    adj = [set() for _ in range(n)]
    for _ in range(degree):
        perm = rng_np.permutation(n)
        for a in range(0, n - 1, 2):
            i, j = int(perm[a]), int(perm[a + 1])
            if j in adj[i] or used[i] >= k or used[j] >= k:
                continue
            si, sj = used[i], used[j]
            nbrs[i, si], nbrs[j, sj] = j, i
            rev[i, si], rev[j, sj] = sj, si
            outbound[i, si] = True
            adj[i].add(j)
            adj[j].add(i)
            used[i] += 1
            used[j] += 1
    return (
        encode_index_plane(nbrs, n),
        encode_index_plane(rev, k),
        nbrs >= 0,
        outbound,
    )


def build_topology_fast(
    rng_np: np.random.Generator, n: int, k: int, degree: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized builder for large N: a union of ``degree`` random
    pairings admitted with NumPy set ops (duplicate edges dropped)."""
    if degree >= k:
        raise ValueError(f"degree ({degree}) must be < slot count k ({k})")
    if degree == 0:
        empty = np.full((n, k), -1, np.int64)
        return (
            encode_index_plane(empty, n),
            encode_index_plane(empty, k),
            empty >= 0,
            np.zeros((n, k), bool),
        )
    pairs = []
    for _ in range(degree):
        perm = rng_np.permutation(n).astype(np.int64)
        a, b = perm[0 : n - 1 : 2], perm[1:n:2]
        pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], 1))
    e = np.unique(np.concatenate(pairs, 0), axis=0)
    dialer = np.where(
        rng_np.integers(0, 2, len(e)).astype(bool), e[:, 0], e[:, 1]
    )
    return _assign_slots(e, dialer, n, k)


def _assign_slots(
    e: np.ndarray, dialer: np.ndarray, n: int, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deduped undirected edge list -> slot form; edges overflowing k on
    either endpoint are dropped, rev pointers paired by edge id."""
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_s = np.arange(len(src_s)) - starts[src_s]
    ok_s = slot_s < k
    eid = np.concatenate([np.arange(len(e)), np.arange(len(e))])[order]
    ok_edge = np.ones(len(e), bool)
    np.logical_and.at(ok_edge, eid, ok_s)
    keep = ok_edge[eid]
    src_s, dst_s, slot_s, eid = src_s[keep], dst_s[keep], slot_s[keep], eid[keep]
    counts = np.bincount(src_s, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_s = np.arange(len(src_s)) - starts[src_s]
    nbrs = np.full((n, k), -1, np.int64)
    rev = np.full((n, k), -1, np.int64)
    outbound = np.zeros((n, k), bool)
    nbrs[src_s, slot_s] = dst_s
    outbound[src_s, slot_s] = dialer[eid] == src_s
    o2 = np.lexsort((src_s, eid))
    rev_sorted = np.empty(len(src_s), np.int64)
    rev_sorted[o2] = slot_s[o2].reshape(-1, 2)[:, ::-1].reshape(-1)
    rev[src_s, slot_s] = rev_sorted
    return (
        encode_index_plane(nbrs, n),
        encode_index_plane(rev, k),
        nbrs >= 0,
        outbound,
    )


def compute_edge_live(nbr_valid, nbrs, alive) -> torch.Tensor:
    """bool[N, K]: slot is wired AND its remote peer is alive (takes the
    narrow storage form or the int32 view of ``nbrs``)."""
    return nbr_valid & safe_gather(alive, decode_index_plane(nbrs), False)


def seed_message(
    have_w, fresh_w, gossip_pend_w, iwant_pend_w, first_step,
    msg_valid, msg_birth, msg_active, msg_used,
    src: int, slot: int, valid, step: int,
):
    """Window-slot recycle + seed: clear the slot's bit for ALL peers (in
    both pend planes too, or a stale transfer of the old message would
    deliver the new one), then stamp the publisher.  Returns the nine
    updated window leaves in argument order."""
    word, bit = divmod(int(slot), bitpack.WORD)
    clear = ~bitpack.as_int32_bits(1 << bit)

    def cleared(plane):
        plane = plane.clone()
        plane[:, word] &= clear
        return plane

    have_w, fresh_w = cleared(have_w), cleared(fresh_w)
    have_w[src, word] |= ~clear
    fresh_w[src, word] |= ~clear
    first_step = first_step.clone()
    first_step[:, slot] = -1
    first_step[src, slot] = step
    msg_valid, msg_birth = msg_valid.clone(), msg_birth.clone()
    msg_active, msg_used = msg_active.clone(), msg_used.clone()
    msg_valid[slot] = valid
    msg_birth[slot] = step
    msg_active[slot] = True
    msg_used[slot] = True
    return (
        have_w, fresh_w, cleared(gossip_pend_w), cleared(iwant_pend_w),
        first_step, msg_valid, msg_birth, msg_active, msg_used,
    )


def _seq_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of f32[N, K] accumulated left to right, the order in which
    the reference's XLA CPU reduction adds (so the sums are bit-equal)."""
    acc = x[:, 0].clone()
    for s in range(1, x.shape[1]):
        acc = acc + x[:, s]
    return acc


def _nanquantile_int(lat: torch.Tensor, mask: torch.Tensor, q: float):
    """``jnp.nanquantile`` (linear) of the masked values, as the reference
    computes it: sort, rank ``q * (count - 1)`` in f32, and the weighted
    sum of the two straddling order statistics contracted into one fused
    multiply-add, as XLA's CPU backend contracts it."""
    a = torch.where(mask, lat.to(torch.float32), torch.inf).reshape(-1)
    a = torch.sort(a).values
    count = mask.sum().to(torch.float32)
    qq = (count - 1.0) * q
    low, high = torch.floor(qq), torch.ceil(qq)
    high_w = qq - low
    low_w = 1.0 - high_w
    low_i = torch.clamp(torch.minimum(low, count - 1.0), min=0.0).long()
    high_i = torch.clamp(torch.minimum(high, count - 1.0), min=0.0).long()
    lo_v, hi_v = a[low_i], a[high_i]
    out = fma(hi_v, high_w, lo_v * low_w)
    return torch.where(count > 0, out, torch.nan)


class GossipSub:
    """Single-topic GossipSub simulator; state lives on ``device``
    (default ``"cuda"``, which raises when no card is present)."""

    def __init__(
        self,
        n_peers: int = 1024,
        n_slots: int = 32,
        conn_degree: int = 16,
        msg_window: int = 128,
        params: Optional[GossipSubParams] = None,
        score_params: Optional[ScoreParams] = None,
        heartbeat_steps: int = 8,
        fused_prologue: Optional[bool] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n = n_peers
        self.k = n_slots
        self.m = msg_window
        self.w = bitpack.n_words(msg_window)
        self.conn_degree = conn_degree
        self.idx_dtype = index_dtype(n_peers)
        self.rev_dtype = index_dtype(n_slots)
        self.params = params or GossipSubParams()
        self.score_params = score_params or ScoreParams()
        self.heartbeat_steps = heartbeat_steps
        self.fused_prologue = True if fused_prologue is None else bool(
            fused_prologue)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def build_graph(self, seed: int = 0):
        """Connection topology -> (nbrs, rev, nbr_valid, outbound) tensors
        (the loop builder up to 4096 peers, the vectorized one above)."""
        rng_np = np.random.default_rng(seed)
        builder = build_topology if self.n <= 4096 else build_topology_fast
        nbrs, rev, valid, outbound = builder(
            rng_np, self.n, self.k, self.conn_degree)
        nbrs = encode_index_plane(nbrs, self.n, dtype=self.idx_dtype)
        rev = encode_index_plane(rev, self.k, dtype=self.rev_dtype)
        return (
            self._t(nbrs, torch_dtype(self.idx_dtype)),
            self._t(rev, torch_dtype(self.rev_dtype)),
            self._t(valid),
            self._t(outbound),
        )

    def init(self, seed: int = 0,
             subscribed: Optional[np.ndarray] = None) -> GossipState:
        """Fresh state after 3 warmup heartbeats; ``subscribed`` masks topic
        membership (default: every peer)."""
        nbrs, rev, valid, outbound = self.build_graph(seed)
        n, k, m, w = self.n, self.k, self.m, self.w
        dev = self.device
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        alive0 = torch.ones(n, dtype=torch.bool, device=dev)
        sub0 = alive0.clone() if subscribed is None else self._t(
            subscribed, torch.bool)
        st = GossipState(
            nbrs=nbrs,
            rev=rev,
            nbr_valid=valid,
            outbound=outbound,
            alive=alive0,
            subscribed=sub0,
            edge_live=compute_edge_live(valid, nbrs, alive0),
            nbr_sub=valid & safe_gather(sub0, decode_index_plane(nbrs), False),
            mesh=zeros((n, k), torch.bool),
            fanout=zeros((n, k), torch.bool),
            fanout_age=torch.full((n,), _AGE_CAP, dtype=torch.int32,
                                  device=dev),
            backoff=zeros((n, k), torch.int32),
            counters=TopicCounters.zeros(n, k, device=dev),
            gcounters=GlobalCounters.zeros(n, device=dev),
            scores=zeros((n, k), torch.float32),
            have_w=zeros((n, w), torch.int32),
            fresh_w=zeros((n, w), torch.int32),
            gossip_pend_w=zeros((n, w), torch.int32),
            iwant_pend_w=zeros((n, w), torch.int32),
            gossip_mute=zeros(n, torch.bool),
            self_promo=zeros(n, torch.bool),
            gossip_delay=zeros(n, torch.int32),
            pend_hold=zeros(n, torch.int32),
            edge_delay=zeros((n, k), torch.int32),
            fresh_hist=zeros((n, 0, w), torch.int32),
            first_step=torch.full((n, m), -1, dtype=torch.int32, device=dev),
            msg_valid=zeros(m, torch.bool),
            msg_birth=zeros(m, torch.int32),
            msg_active=zeros(m, torch.bool),
            msg_used=zeros(m, torch.bool),
            key=rng.PRNGKey(seed, device=dev),
            step=0,
        )
        return self._warmup(st)

    # -- narrow index storage <-> int32 view --------------------------------

    def _widen_indices(self, st: GossipState) -> GossipState:
        return st._replace(
            nbrs=decode_index_plane(st.nbrs), rev=decode_index_plane(st.rev))

    def _narrow_indices(self, st: GossipState) -> GossipState:
        return st._replace(
            nbrs=narrow_index_plane(st.nbrs, torch_dtype(self.idx_dtype)),
            rev=narrow_index_plane(st.rev, torch_dtype(self.rev_dtype)),
        )

    def _warmup(self, st: GossipState) -> GossipState:
        st = self._widen_indices(st)
        for _ in range(3):
            st = self._heartbeat(st)
        return self._narrow_indices(st)

    # -- views ----------------------------------------------------------------

    def have_bool(self, st: GossipState) -> torch.Tensor:
        """Unpacked possession view bool[N, M]."""
        return bitpack.unpack(st.have_w, self.m)

    # -- events -------------------------------------------------------------

    def publish(self, st: GossipState, src: int, slot: int,
                valid) -> GossipState:
        """Seed a message at peer ``src`` in window ``slot`` (recycling the
        slot); ``valid`` (bool or bool tensor) is its validation verdict.
        With ``flood_publish`` the message is offered to every connected
        topic peer above ``publish_threshold`` (landing next round through
        the pend fold); otherwise a non-subscribed publisher tops up and
        uses its fanout set."""
        p, sp = self.params, self.score_params
        n, k, dev = self.n, self.k, self.device
        src, slot = int(src), int(slot)
        (have_w, fresh_w, pend_w, iwant_pend_w, first_step,
         mv, mb, ma, mu) = seed_message(
            st.have_w, st.fresh_w, st.gossip_pend_w, st.iwant_pend_w,
            st.first_step, st.msg_valid, st.msg_birth, st.msg_active,
            st.msg_used, src, slot, valid, st.step,
        )
        kpub, knext = rng.split(st.key, 2).unbind(0)
        eligible = (
            st.edge_live[src]
            & st.nbr_sub[src]
            & (st.scores[src] >= sp.publish_threshold)
        )
        fanout, fanout_age = st.fanout, st.fanout_age
        if p.flood_publish:
            targets = eligible
        else:
            cur = st.fanout[src] & eligible
            want = torch.clamp(p.d - cur.sum(), 0, p.d).to(torch.int32)
            r = rng.uniform(kpub, (1, k))
            add = top_mask(
                torch.where((eligible & ~cur)[None, :], r, -torch.inf),
                want[None], kmax=p.d,
            )[0]
            newf = cur | add
            is_sub = st.subscribed[src]
            targets = torch.where(is_sub, False, newf)
            fanout = st.fanout.clone()
            fanout[src] = torch.where(is_sub, st.fanout[src], newf)
            fanout_age = st.fanout_age.clone()
            fanout_age[src] = torch.where(is_sub, st.fanout_age[src], 0)
        # Offered copies land next round through the pend fold; valid-only.
        # A receiver with ingress latency arms its hold only when idle and
        # empty, and only when a bit was actually placed.
        word, bit = divmod(slot, bitpack.WORD)
        bm = torch.zeros(self.w, dtype=torch.int32, device=dev)
        if isinstance(valid, torch.Tensor):
            valid = valid.to(device=dev, dtype=torch.bool)
            bm[word] = torch.where(valid, bitpack.as_int32_bits(1 << bit), 0)
        elif valid:
            bm[word] = bitpack.as_int32_bits(1 << bit)
        rows = torch.where(targets, decode_index_plane(st.nbrs[src]), n).long()
        rows_c = torch.clamp(rows, 0, n - 1)
        gathered = pend_w[rows_c]                                # [K, W]
        ext = torch.cat([pend_w, pend_w.new_zeros((1, self.w))])
        ext[rows] = gathered | bm[None, :]
        pend_w = ext[:n]
        cur_hold = st.pend_hold[rows_c]
        arm = (cur_hold <= 0) & (gathered == 0).all(dim=-1) & valid
        hold_ext = torch.cat([st.pend_hold, st.pend_hold.new_zeros(1)])
        hold_ext[rows] = torch.where(arm, st.gossip_delay[rows_c], cur_hold)
        return st._replace(
            have_w=have_w, fresh_w=fresh_w, gossip_pend_w=pend_w,
            iwant_pend_w=iwant_pend_w, pend_hold=hold_ext[:n],
            first_step=first_step, msg_valid=mv, msg_birth=mb,
            msg_active=ma, msg_used=mu, fanout=fanout,
            fanout_age=fanout_age, key=knext,
        )

    def kill_peers(self, st: GossipState, mask: torch.Tensor) -> GossipState:
        """Abrupt peer failure (bool[N] mask); the mesh self-heals at the
        next heartbeat."""
        alive = st.alive & ~torch.as_tensor(mask, device=self.device)
        return st._replace(
            alive=alive,
            edge_live=compute_edge_live(st.nbr_valid, st.nbrs, alive),
        )

    # -- transition ---------------------------------------------------------

    def seen_ttl_steps(self) -> int:
        """Rounds after which a receipt falls out of the seen-cache dedup."""
        p = self.params
        return (
            max(1, round(p.seen_ttl_s / p.heartbeat_interval_s))
            * self.heartbeat_steps
        )

    def fanout_ttl_heartbeats(self) -> int:
        """Heartbeats of publish silence after which fanout ages out."""
        p = self.params
        return max(1, round(p.fanout_ttl_s / p.heartbeat_interval_s))

    def gossip_window_masks(self, st: GossipState):
        """(have_scrubbed int32[N, W], gossip_w int32[W]): the seen-TTL
        scrubbed possession the IWANT dedups against, and the packed
        advertisable window (valid & active & within history_gossip)."""
        p = self.params
        age = st.step - st.msg_birth
        seen_expired = st.msg_used & (age > self.seen_ttl_steps())
        have_scrubbed = st.have_w & ~bitpack.pack(seen_expired)
        gossip_age_ok = age <= p.history_gossip * self.heartbeat_steps
        gossip_w = bitpack.pack(st.msg_valid & st.msg_active & gossip_age_ok)
        return have_scrubbed, gossip_w

    def fanout_maintenance(
        self, key, fanout, fanout_age, subscribed, alive, edge_eligible,
        scores,
    ):
        """One heartbeat of fanout upkeep -> (fanout bool[N, K], age
        int32[N]): age out after ``fanout_ttl_s`` of publish silence, drop
        dead or below-threshold peers, top back up to D while active."""
        p, sp = self.params, self.score_params
        age = torch.clamp(fanout_age + 1, max=_AGE_CAP)
        factive = (age <= self.fanout_ttl_heartbeats()) & ~subscribed & alive
        feligible = edge_eligible & (scores >= sp.publish_threshold)
        fkeep = fanout & feligible
        fwant = torch.where(
            factive, torch.clamp(p.d - fkeep.sum(dim=1), 0, p.d), 0
        ).to(torch.int32)
        fadd = top_mask(
            torch.where(
                feligible & ~fkeep,
                uniform_by_uid(key, (self.n, self.k), None),
                -torch.inf,
            ),
            fwant,
            kmax=p.d,
        )
        return torch.where(factive[:, None], fkeep | fadd, False), age

    def _heartbeat(self, st: GossipState) -> GossipState:
        p, sp = self.params, self.score_params
        n, k = self.n, self.k
        khb, kgossip, kiwant, kfan, kpx, knext = rng.split(st.key, 6).unbind(0)

        # Fused prologue: one clipped (jidx, ridx) pair shared by scores,
        # mesh and PX; px_rewire reuses heartbeat_mesh's bitfield gather.
        edge_idx = (
            (torch.clamp(st.nbrs, 0, n - 1), torch.clamp(st.rev, 0, k - 1))
            if self.fused_prologue else None
        )

        c = scoring_ops.tick_mesh_clocks(
            st.counters, st.mesh, p.heartbeat_interval_s)
        c = scoring_ops.decay_topic_counters(c, sp)
        g = scoring_ops.decay_global_counters(st.gcounters, sp)
        scores = scoring_ops.neighbor_scores(
            c, g, st.nbrs, st.nbr_valid, sp,
            jidx=None if edge_idx is None else edge_idx[0],
        )

        part = st.alive & st.subscribed
        edge_ok = st.edge_live & st.nbr_sub
        hb_idx = st.step // self.heartbeat_steps
        do_og = (hb_idx % p.opportunistic_graft_ticks) == 0

        hb_out = heartbeat_mesh(
            khb, st.mesh, scores, st.nbrs, st.rev, edge_ok, part, p,
            st.backoff, st.outbound, do_og,
            og_threshold=sp.opportunistic_graft_threshold,
            edge_idx=edge_idx,
            with_px_offer=self.fused_prologue,
        )
        new_mesh, grafted, pruned, backoff, bo_violations = hb_out[:5]
        px_offer_ok = hb_out[5] if self.fused_prologue else None
        c = scoring_ops.on_prune(c, pruned, sp)
        c = scoring_ops.on_graft(c, grafted)
        g = g._replace(behaviour_penalty=g.behaviour_penalty + bo_violations)

        px = px_rewire(
            kpx, st.nbrs, st.rev, st.nbr_valid, st.outbound, backoff,
            new_mesh, pruned, scores, st.alive, sp.accept_px_threshold,
            edge_idx=edge_idx,
            offer_ok=px_offer_ok,
        )
        # The reference refreshes the adjacency caches under lax.cond when a
        # PX edge formed; both branches agree otherwise.
        rewired = px.connected.any()
        edge_live = torch.where(
            rewired, compute_edge_live(px.nbr_valid, px.nbrs, st.alive),
            st.edge_live)
        nbr_sub = torch.where(
            rewired, px.nbr_valid & safe_gather(st.subscribed, px.nbrs, False),
            st.nbr_sub)

        have_w, gossip_w = self.gossip_window_masks(st)

        # IHAVE/IWANT collapsed at the heartbeat: grants land two rounds
        # later through iwant_pend_w -> gossip_pend_w.  Self-promoters
        # advertise only ids they originated.
        serve_ok = ~safe_gather(st.gossip_mute, px.nbrs, True)
        gossip_edges = edge_live & nbr_sub
        origin = bitpack.pack(
            (st.first_step == st.msg_birth[None, :]) & st.msg_used[None, :])
        adv_src = torch.where(
            st.self_promo[:, None], st.have_w & origin, st.have_w)
        # gossip_packed.gossip_exchange_packed with its select run by K2.
        x = exchange_prep(
            kgossip, kiwant, adv_src, new_mesh, px.nbrs, px.rev,
            gossip_edges, part, scores, gossip_w, p, sp.gossip_threshold,
            serve_ok,
        )
        iwant_pend_w, broken_p = cuda_gossip.exchange_select(
            x.jidx_p, x.adv_ok_p, x.accept_p, x.serve_p, x.rows, have_w,
            part, p.max_ihave_length, p.max_iwant_length,
        )
        broken = broken_p.gather(1, x.inv.long())
        # P7: broken promises charge the advertiser (by remote id).
        promise_ids = torch.where(px.nbr_valid, px.nbrs, n).reshape(-1)
        promise_viol = segment_sum(broken.reshape(-1), promise_ids, n + 1)[:n]
        g = g._replace(behaviour_penalty=g.behaviour_penalty + promise_viol)

        fanout, age = self.fanout_maintenance(
            kfan, st.fanout, st.fanout_age, st.subscribed, st.alive,
            edge_live & nbr_sub, scores,
        )

        expired = st.msg_active & (
            st.step - st.msg_birth > p.history_length * self.heartbeat_steps
        )
        dead_w = bitpack.pack(expired)
        return st._replace(
            nbrs=px.nbrs,
            rev=px.rev,
            nbr_valid=px.nbr_valid,
            outbound=px.outbound,
            edge_live=edge_live,
            nbr_sub=nbr_sub,
            mesh=new_mesh,
            fanout=fanout,
            fanout_age=age,
            backoff=px.backoff,
            counters=c,
            gcounters=g,
            scores=scores,
            have_w=have_w,
            gossip_pend_w=st.gossip_pend_w & ~dead_w[None, :],
            iwant_pend_w=iwant_pend_w,
            msg_active=st.msg_active & ~expired,
            key=knext,
        )

    def _propagate(self, st: GossipState, with_receipts: bool = False):
        # Fold due gossip/flood transfers into this round's receipts (they
        # relay next round), then the eager push over the graylist-gated
        # mesh (kernel K1 on CUDA).
        ready = st.pend_hold <= 0
        ready_w = as_mask(ready)[:, None]
        gossip_new = (
            st.gossip_pend_w & ready_w & ~st.have_w & as_mask(st.alive)[:, None]
        )
        held_w = st.gossip_pend_w & ~ready_w
        have_w = st.have_w | gossip_new

        relay_mesh = st.mesh & (
            st.scores >= self.score_params.graylist_threshold)
        valid_w = bitpack.pack(st.msg_valid & st.msg_active)
        # IDONTWANT suppression sees the receiver's pre-fold possession.
        idontwant = self.params.idontwant
        idw = st.have_w if idontwant else None
        if idontwant and self.params.idontwant_wire_lag:
            idw = st.have_w & ~st.fresh_w
        out = cuda_gossip.propagate(
            relay_mesh, st.nbrs, st.edge_live, st.alive, have_w,
            st.fresh_w, valid_w, idontwant=idontwant, idw_have_w=idw,
        )
        # One stamping pass for both receipt sources (same step).
        stamped = (
            bitpack.unpack(gossip_new | out.new_w, self.m)
            & (st.first_step < 0)
        )
        first_step = torch.where(stamped, st.step, st.first_step)
        c = st.counters._replace(
            first_message_deliveries=st.counters.first_message_deliveries
            + out.fmd_inc,
            mesh_message_deliveries=st.counters.mesh_message_deliveries
            + out.mmd_inc,
            invalid_message_deliveries=st.counters.invalid_message_deliveries
            + out.invalid_inc,
        )
        pend_next = held_w | st.iwant_pend_w
        incoming = (pend_next != 0).any(dim=1)
        pend_hold = torch.where(
            ready,
            torch.where(incoming, st.gossip_delay, 0),
            st.pend_hold - 1,
        ).to(torch.int32)
        nxt = st._replace(
            have_w=out.have_w,
            fresh_w=out.fresh_w | gossip_new,
            first_step=first_step,
            counters=c,
            gossip_pend_w=pend_next,
            iwant_pend_w=torch.zeros_like(st.iwant_pend_w),
            pend_hold=pend_hold,
        )
        if not with_receipts:
            return nxt
        # Flight-recorder tap: receipts stamped this round, per message,
        # masked the way the latency histogram counts them.
        counted = (
            stamped
            & (st.alive & st.subscribed)[:, None]
            & (st.msg_used & st.msg_valid)[None, :]
        )
        return nxt, counted.sum(dim=0, dtype=torch.int32)

    def _step_wide(self, st: GossipState, with_receipts: bool = False):
        """One round on the int32 index view; the heartbeat schedule is
        taken on the host from ``st.step``."""
        out = self._propagate(st, with_receipts)
        st, per_msg = out if with_receipts else (out, None)
        if st.step % self.heartbeat_steps == self.heartbeat_steps - 1:
            st = self._heartbeat(st)
        st = st._replace(step=st.step + 1)
        return (st, per_msg) if with_receipts else st

    def step(self, st: GossipState) -> GossipState:
        """One network round: eager push, plus a heartbeat every
        ``heartbeat_steps`` rounds."""
        return self._narrow_indices(self._step_wide(self._widen_indices(st)))

    def step_recorded(self, st: GossipState):
        """``step`` plus the flight recorder's tap: (next state, int32[M]
        receipts first stamped this round)."""
        st, per_msg = self._step_wide(self._widen_indices(st), True)
        return self._narrow_indices(st), per_msg

    def rollout(self, st: GossipState, n_steps: int, record: bool = True):
        """``n_steps`` rounds -> (final state, flight record | None).

        With ``record`` every round adds the sample of
        :meth:`flight_record_round`; each channel comes back stacked with a
        leading [n_steps] axis.  The cumulative latency histogram is seeded
        from the stamp table and advanced by each round's new receipts.
        Nothing inside the loop reads the device."""
        st = self._widen_indices(st)
        if not record:
            for _ in range(n_steps):
                st = self._step_wide(st)
            return self._narrow_indices(st), None
        hist = hist_ops.latency_histogram_seed(
            st.first_step, st.msg_birth, st.msg_used & st.msg_valid,
            st.alive & st.subscribed, FLIGHT_HIST_BINS,
        )
        rounds: List[Dict[str, torch.Tensor]] = []
        first = st.step + 1
        for _ in range(n_steps):
            stamp = st.step
            st, per_msg = self._step_wide(st, with_receipts=True)
            hist = hist + hist_ops.latency_histogram_increment(
                per_msg, st.msg_birth, st.msg_used & st.msg_valid,
                stamp, FLIGHT_HIST_BINS,
            )
            rounds.append(self.flight_record_round(st, hist))
        record_ys = {
            name: torch.stack([r[name] for r in rounds]) for name in rounds[0]
        } if rounds else {}
        record_ys["step"] = torch.arange(first, first + n_steps,
                                         dtype=torch.int32, device=self.device)
        return self._narrow_indices(st), record_ys

    def flight_record_round(self, st: GossipState,
                            lat_hist: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One round's telemetry as device scalars plus the int32[B]
        cumulative latency histogram (``step`` is added by ``rollout``).
        Score quantiles are over each peer's mean live-neighbor score."""
        part = st.alive & st.subscribed
        part_n = torch.clamp(part.sum(dtype=torch.int32), min=1)
        in_window = st.msg_used & st.msg_valid
        n_msgs = torch.clamp(in_window.sum(dtype=torch.int32), min=1)
        mesh_deg = (st.mesh & st.nbr_valid).sum(dim=1, dtype=torch.int32)
        deg_alive = torch.where(part, mesh_deg, 0)
        live_slots = torch.clamp(
            st.nbr_valid.sum(dim=1, dtype=torch.int32), min=1)
        peer_score = _seq_row_sum(
            torch.where(st.nbr_valid, st.scores, 0.0)) / live_slots
        score_q = hist_ops.binned_quantiles(peer_score, part, (0.1, 0.5, 0.9))
        return {
            "peers_alive": st.alive.sum(dtype=torch.int32),
            "delivery_frac": lat_hist.sum(dtype=torch.int32) / (part_n * n_msgs),
            "mesh_degree_mean": deg_alive.sum(dtype=torch.int32) / part_n,
            "mesh_degree_max": mesh_deg.max(),
            "score_p10": score_q[0],
            "score_p50": score_q[1],
            "score_p90": score_q[2],
            "gossip_pending": bitpack.popcount(
                st.gossip_pend_w).sum(dtype=torch.int32),
            "lat_hist": lat_hist,
        }

    # -- metrics ------------------------------------------------------------

    def delivery_stats(self, st: GossipState):
        """(frac f32[M], p50, p99): per-message delivery fraction over
        alive+subscribed peers (from ``first_step``, so the seen-cache TTL
        never un-counts a delivery) and latency percentiles in rounds."""
        part = st.alive & st.subscribed
        part_n = part.sum(dtype=torch.int32)
        delivered = ((st.first_step >= 0) & part[:, None]).sum(
            dim=0, dtype=torch.int32)
        frac = torch.where(
            st.msg_used & st.msg_valid,
            delivered / torch.clamp(part_n, min=1),
            torch.nan,
        )
        lat = torch.where(
            st.first_step >= 0, st.first_step - st.msg_birth[None, :], -1)
        valid_lat = (
            (lat >= 0)
            & st.msg_used[None, :]
            & st.msg_valid[None, :]
            & part[:, None]
        )
        p50 = _nanquantile_int(lat, valid_lat, 0.5)
        p99 = _nanquantile_int(lat, valid_lat, 0.99)
        return frac, p50, p99
