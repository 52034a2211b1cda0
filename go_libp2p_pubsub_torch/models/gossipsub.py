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

- ``rollout_events`` is a host loop over a numpy event schedule: each
  ``lax.cond`` of the reference's event application is a host ``if`` on
  the step's row, and only the rows that carry an event reach the device
  (once, before the first round).  Its record is read to the host once,
  after the last round, where the two adversary score means are added in
  XLA's order (``_finish_record``).

Covered: the closed loop (init, publish, kill_peers, step, rollout with
the flight recorder, delivery_stats) and the scenario event path (the
``set_*`` mutators, ``graft_spammers``, per-edge delay with
``max_edge_delay``/``set_edge_delay``, ``rollout_events``) and direct
peering (``direct_edges``).  Placement relabeling and the sharded path
are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import GossipSubParams, ScoreParams
from ..ops import bitpack
from ..ops import cuda_gossip
from ..ops import histogram as hist_ops
from ..ops import reduce_order
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
from ..ops.schedule import GossipEvents
from ..ops.scoring import GlobalCounters, TopicCounters, segment_sum

FLIGHT_HIST_BINS = 32
_AGE_CAP = (2**31 - 1) // 2
# GossipEvents fields whose rows go to the device (publishes stay host ints).
_EVENT_ROWS = ("kill", "revive", "sub_off", "sub_on", "mute_on", "mute_off",
               "promo_on", "promo_off", "delay", "silence")


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
    edge_delay: torch.Tensor    # int32[N, K] per-edge eager-path delay
    fresh_hist: torch.Tensor    # int32[N, D, W] fresh planes of the last D
    #                             rounds (D = max_edge_delay + 1, or 0)
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


def build_topology_local(
    rng_np: np.random.Generator, n: int, k: int, degree: int,
    spread: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Locality-structured ~degree-regular graph: each peer's edges land
    within ring distance ``spread`` (default n // 32) of it, then every id
    is relabeled through a random permutation so the locality is invisible
    to id order."""
    if degree >= k:
        raise ValueError(f"degree ({degree}) must be < slot count k ({k})")
    if degree == 0 or n < 4:
        empty = np.full((n, k), -1, np.int64)
        return (
            encode_index_plane(empty, n),
            encode_index_plane(empty, k),
            empty >= 0,
            np.zeros((n, k), bool),
        )
    if spread is None:
        spread = max(4, n // 32)
    spread = int(min(spread, max(1, n // 2 - 1)))
    src = np.tile(np.arange(n, dtype=np.int64), degree // 2)
    if degree % 2:
        src = np.concatenate(
            [src, rng_np.choice(n, n // 2, replace=False).astype(np.int64)]
        )
    delta = rng_np.integers(1, spread + 1, size=src.shape[0])
    sign = np.where(rng_np.integers(0, 2, src.shape[0]) > 0, 1, -1)
    dst = (src + delta * sign) % n
    e = np.stack([np.minimum(src, dst), np.maximum(src, dst)], 1)
    e = np.unique(e[src != dst], axis=0)
    sigma = rng_np.permutation(n).astype(np.int64)
    e = np.sort(np.stack([sigma[e[:, 0]], sigma[e[:, 1]]], 1), axis=1)
    dialer = np.where(
        rng_np.integers(0, 2, len(e)).astype(bool), e[:, 0], e[:, 1]
    )
    return _assign_slots(e, dialer, n, k)


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
    # Element stores of Python scalars go through ``fill_``: an indexed
    # assignment would copy the scalar from the host and synchronise.
    first_step = first_step.clone()
    first_step[:, slot] = -1
    first_step[src, slot].fill_(step)
    msg_valid, msg_birth = msg_valid.clone(), msg_birth.clone()
    msg_active, msg_used = msg_active.clone(), msg_used.clone()
    if isinstance(valid, torch.Tensor):
        msg_valid[slot] = valid
    else:
        msg_valid[slot].fill_(bool(valid))
    msg_birth[slot].fill_(step)
    msg_active[slot].fill_(True)
    msg_used[slot].fill_(True)
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


def record_to_host(record: Dict[str, torch.Tensor], device: torch.device
                   ) -> Dict[str, np.ndarray]:
    """Device channels -> host numpy: asynchronous copies into pinned
    buffers, then one wait on an event behind them."""
    if device.type != "cuda":
        return {name: v.numpy() for name, v in record.items()}
    host = {name: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for name, v in record.items()}
    for name, v in record.items():
        host[name].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return {name: v.numpy() for name, v in host.items()}


class _StagedEvents:
    """A schedule's event rows on the model's device: for each field, only
    the rows of the steps where it fires, copied once; and the valid
    publishes' sources of each step (histogram bin 0)."""

    def __init__(self, model: "GossipSub", events: GossipEvents):
        self._rows: Dict[str, Tuple[Dict[int, int], torch.Tensor]] = {}
        for name in _EVENT_ROWS:
            plane = getattr(events, name)
            on = (plane >= 0).any(axis=1) if name == "delay" else plane.any(
                axis=1)
            steps = np.flatnonzero(on)
            if steps.size:
                self._rows[name] = (
                    {int(t): j for j, t in enumerate(steps)},
                    model._stage(plane[steps]))
        counted = (events.pub_src >= 0) & events.pub_valid
        self._pubs: Dict[int, Tuple[int, int]] = {}
        srcs = events.pub_src[counted]
        starts = np.concatenate([[0], np.cumsum(counted.sum(axis=1))])
        for t in np.flatnonzero(counted.any(axis=1)):
            self._pubs[int(t)] = (int(starts[t]), int(starts[t + 1]))
        self._srcs = model._stage(srcs.astype(np.int64)) if srcs.size else None

    def row(self, name: str, t: int) -> torch.Tensor:
        index, rows = self._rows[name]
        return rows[index[t]]

    def publishers(self, t: int) -> Optional[torch.Tensor]:
        span = self._pubs.get(t)
        return None if span is None else self._srcs[span[0]:span[1]]


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
        builder=None,
        graft_spammers: Optional[np.ndarray] = None,
        max_edge_delay: int = 0,
        direct_edges: Optional[np.ndarray] = None,
        index_dtype_override=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n = n_peers
        self.k = n_slots
        self.m = msg_window
        self.w = bitpack.n_words(msg_window)
        self.conn_degree = conn_degree
        # Narrow index storage by default; ``index_dtype_override=np.int32``
        # forces the wide storage (the reference's identity-test arm).
        if index_dtype_override is None:
            self.idx_dtype = index_dtype(n_peers)
            self.rev_dtype = index_dtype(n_slots)
        else:
            dt = np.dtype(index_dtype_override)
            if dt.kind == "u" and n_peers + 1 > np.iinfo(dt).max:
                raise ValueError(
                    f"index_dtype_override={dt.name} cannot hold "
                    f"n + 1 = {n_peers + 1} (max {np.iinfo(dt).max})")
            self.idx_dtype = self.rev_dtype = dt
        self.params = params or GossipSubParams()
        self.score_params = score_params or ScoreParams()
        self.heartbeat_steps = heartbeat_steps
        self.fused_prologue = True if fused_prologue is None else bool(
            fused_prologue)
        self.builder = builder  # explicit topology builder (seed pinning)
        # Per-edge eager-path delay ceiling: > 0 carries a (D + 1)-plane
        # fresh history per peer; 0 keeps the ideal fabric.
        if max_edge_delay < 0:
            raise ValueError("max_edge_delay must be >= 0")
        self.max_edge_delay = max_edge_delay
        # Peers (bool[N]) that GRAFT through their own prune backoff; their
        # refused attempts accrue the P7 behaviour penalty.
        self.graft_spammers = None if graft_spammers is None else self._t(
            np.asarray(graft_spammers, bool))
        # Direct (explicit) peering, go-gossipsub's WithDirectPeers: a
        # symmetric bool[N, K] slot mask of always-forward edges.  They
        # relay every round regardless of mesh membership or the remote's
        # score (graylist bypass) and stay out of mesh maintenance, gossip
        # and fanout.  As in the reference (a documented deviation), copies
        # arriving over them still feed the per-slot delivery counters.
        if direct_edges is None:
            self.direct_edges = None
        else:
            de = np.asarray(direct_edges, bool)
            if de.shape != (n_peers, n_slots):
                raise ValueError(
                    f"direct_edges must be [N={n_peers}, K={n_slots}]")
            self.direct_edges = self._t(de)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # Value semantics (the reference's ``_config_key``): equal configs on
    # one device are one model, so caches keyed on the model (the streaming
    # engine's prepared chunk programs) survive a fresh, equal instance.  A
    # builder without a ``config_key`` falls back to identity.
    def _config_key(self):
        builder_key = getattr(self.builder, "config_key", None)
        if self.builder is not None and builder_key is None:
            return id(self)
        return (
            builder_key, type(self), str(self.device), self.n, self.k, self.m,
            self.conn_degree, self.params, self.score_params,
            self.heartbeat_steps, self.max_edge_delay, self.fused_prologue,
            str(self.idx_dtype), str(self.rev_dtype),
            None if self.graft_spammers is None
            else bytes(self.graft_spammers.cpu().numpy()),
            None if self.direct_edges is None
            else bytes(np.packbits(self.direct_edges.cpu().numpy())),
        )

    def __eq__(self, other):
        return (type(other) is type(self)
                and self._config_key() == other._config_key())

    def __hash__(self):
        return hash(self._config_key())

    def build_graph(self, seed: int = 0):
        """Connection topology -> (nbrs, rev, nbr_valid, outbound) tensors
        (the loop builder up to 4096 peers, the vectorized one above)."""
        rng_np = np.random.default_rng(seed)
        builder = self.builder or (
            build_topology if self.n <= 4096 else build_topology_fast)
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
        if self.direct_edges is not None:
            # Direct peering is mutual: the mask must sit on wired slots and
            # be symmetric over the slot pairing.
            de = self.direct_edges.cpu().numpy()
            nv = valid.cpu().numpy()
            if (de & ~nv).any():
                raise ValueError("direct_edges marks an unwired slot")
            jn = np.clip(decode_index_plane(nbrs).cpu().numpy(), 0, n - 1)
            rv = np.clip(decode_index_plane(rev).cpu().numpy(), 0, k - 1)
            if (de != (de[jn, rv] & nv)).any():
                raise ValueError(
                    "direct_edges must be symmetric over the slot pairing")
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
            fresh_hist=zeros(
                (n, self.max_edge_delay + 1 if self.max_edge_delay else 0, w),
                torch.int32),
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
        # Direct peers are covered by the always-forward path; go's Publish
        # never selects them into flood/fanout targets.
        if self.direct_edges is not None:
            eligible = eligible & ~self.direct_edges[src]
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
            bm[word].fill_(bitpack.as_int32_bits(1 << bit))
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
        # Per-edge delay: the history mirrors fresh_w's mutations -- the
        # recycled slot leaves every plane and the publisher's bit enters
        # the plane delay-0 edges read next round (valid or not).
        fresh_hist = st.fresh_hist
        if self.max_edge_delay:
            cur = (st.step - 1) % (self.max_edge_delay + 1)
            fresh_hist = fresh_hist.clone()
            fresh_hist[:, :, word] &= ~bitpack.as_int32_bits(1 << bit)
            fresh_hist[src, cur, word] |= bitpack.as_int32_bits(1 << bit)
        return st._replace(
            have_w=have_w, fresh_w=fresh_w, gossip_pend_w=pend_w,
            iwant_pend_w=iwant_pend_w, pend_hold=hold_ext[:n],
            fresh_hist=fresh_hist,
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

    def set_gossip_delay(self, st: GossipState, delay) -> GossipState:
        """Per-peer ingress gossip latency (int32[N] extra rounds pending
        gossip/flood transfers wait before folding); zeros restore the
        ideal one-round fabric."""
        return st._replace(gossip_delay=torch.as_tensor(
            delay, device=self.device).to(torch.int32))

    def set_edge_delay(self, st: GossipState, delay) -> GossipState:
        """Per-edge eager-path ingress latency (int32[N, K]: extra rounds a
        copy spends crossing from ``nbrs[i, s]`` into i), addressed by the
        receiver's slot.  Needs ``max_edge_delay >= max(delay)``."""
        d = (delay.cpu().numpy() if isinstance(delay, torch.Tensor)
             else np.asarray(delay))
        if d.max(initial=0) > self.max_edge_delay:
            raise ValueError(
                f"edge delay {int(d.max())} exceeds this model's "
                f"max_edge_delay={self.max_edge_delay}; rebuild the model "
                f"with a larger ceiling"
            )
        if d.min(initial=0) < 0:
            raise ValueError("edge delays must be >= 0")
        return st._replace(edge_delay=self._t(d, torch.int32))

    def set_gossip_mute(self, st: GossipState, mask) -> GossipState:
        """Mark peers (bool[N]) as promise-breakers: they advertise IHAVEs
        but never serve the IWANTs; every ask charges their P7."""
        return st._replace(gossip_mute=torch.as_tensor(
            mask, device=self.device).to(torch.bool))

    def set_self_promo(self, st: GossipState, mask) -> GossipState:
        """Mark peers (bool[N]) as IHAVE self-promoters: they advertise only
        the ids they originated."""
        return st._replace(self_promo=torch.as_tensor(
            mask, device=self.device).to(torch.bool))

    def set_subscribed(self, st: GossipState, sub) -> GossipState:
        """Change topic membership (bool[N]): unsubscribing prunes the
        peer's mesh edges at once, subscribing drops its fanout state."""
        return self._subscribe(st, torch.as_tensor(
            sub, device=self.device).to(torch.bool))

    def _subscribe(self, st: GossipState, sub: torch.Tensor) -> GossipState:
        nbr_sub = st.nbr_valid & safe_gather(
            sub, decode_index_plane(st.nbrs), False)
        return st._replace(
            subscribed=sub,
            nbr_sub=nbr_sub,
            mesh=st.mesh & sub[:, None] & nbr_sub,
            fanout=st.fanout & ~sub[:, None],
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
        # Direct edges never join the mesh and carry no IHAVE/IWANT.
        if self.direct_edges is not None:
            edge_ok = edge_ok & ~self.direct_edges
        hb_idx = st.step // self.heartbeat_steps
        do_og = (hb_idx % p.opportunistic_graft_ticks) == 0

        hb_out = heartbeat_mesh(
            khb, st.mesh, scores, st.nbrs, st.rev, edge_ok, part, p,
            st.backoff, st.outbound, do_og,
            og_threshold=sp.opportunistic_graft_threshold,
            ignore_backoff=self.graft_spammers,
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
        if self.direct_edges is not None:
            gossip_edges = gossip_edges & ~self.direct_edges
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

        # Fanout excludes direct edges (go's getPeers filter).
        fanout_edges = edge_live & nbr_sub
        if self.direct_edges is not None:
            fanout_edges = fanout_edges & ~self.direct_edges
        fanout, age = self.fanout_maintenance(
            kfan, st.fanout, st.fanout_age, st.subscribed, st.alive,
            fanout_edges, scores,
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

    def _propagate(self, st: GossipState, with_receipts: bool = False,
                   eager_edge_ok: Optional[torch.Tensor] = None,
                   ingress_ok: Optional[torch.Tensor] = None):
        # Fold due gossip/flood transfers into this round's receipts (they
        # relay next round), then the eager push over the graylist-gated
        # mesh (kernel K1 on CUDA).
        #
        # The hybrid's hooks (models/hybrid.py), where the reference places
        # them: ``eager_edge_ok`` bool[N, K] narrows the relay mask K1 reads
        # (coded edges do not eager-push); ``ingress_ok`` bool[N] is a
        # per-receiver loss gate that drops a closed receiver's whole
        # data-plane ingress (the pend fold and K1's arrivals, which are
        # masked after the kernel).  Both None: the operations of the plain
        # model.
        ready = st.pend_hold <= 0
        ready_w = as_mask(ready)[:, None]
        gossip_new = (
            st.gossip_pend_w & ready_w & ~st.have_w & as_mask(st.alive)[:, None]
        )
        if ingress_ok is not None:
            gossip_new = gossip_new & as_mask(ingress_ok)[:, None]
        held_w = st.gossip_pend_w & ~ready_w
        have_w = st.have_w | gossip_new

        relay_mesh = st.mesh & (
            st.scores >= self.score_params.graylist_threshold)
        # Direct edges always relay (graylist bypass, mesh-independent),
        # gated by the RECEIVER's subscription (relay_mesh is receiver-
        # indexed); K1 still masks dead remotes through edge_live.
        if self.direct_edges is not None:
            relay_mesh = relay_mesh | (
                self.direct_edges & st.subscribed[:, None])
        if eager_edge_ok is not None:
            relay_mesh = relay_mesh & eager_edge_ok
        valid_w = bitpack.pack(st.msg_valid & st.msg_active)
        # Per-edge delay: each edge reads its sender's fresh plane from
        # edge_delay rounds back, (step - 1 - d) mod D of the history.
        dpl = self.max_edge_delay + 1
        fresh_src = None
        if self.max_edge_delay:
            jrows = torch.clamp(st.nbrs, 0, self.n - 1)
            plane = torch.remainder(st.step - 1 - st.edge_delay, dpl)
            fresh_src = st.fresh_hist.reshape(self.n * dpl, self.w)[
                (jrows * dpl + plane).long()]
        # IDONTWANT suppression sees the receiver's pre-fold possession; the
        # reference turns it off under per-edge delay.
        idontwant = self.params.idontwant and not self.max_edge_delay
        idw = st.have_w if idontwant else None
        if idontwant and self.params.idontwant_wire_lag:
            idw = st.have_w & ~st.fresh_w
        out = cuda_gossip.propagate(
            relay_mesh, st.nbrs, st.edge_live, st.alive, have_w,
            st.fresh_w, valid_w, fresh_src=fresh_src, idontwant=idontwant,
            idw_have_w=idw,
        )
        if ingress_ok is not None:
            # A closed receiver's eager arrivals are dropped: no possession,
            # no relay, no score credit.  ``have_w`` going into K1 already
            # holds the gated pend fold, so possession rebuilds exactly.
            iok_w = as_mask(ingress_ok)[:, None]
            iok_f = ingress_ok.to(torch.float32)[:, None]
            out = out._replace(
                have_w=have_w | (out.new_w & iok_w & valid_w),
                fresh_w=out.fresh_w & iok_w,
                new_w=out.new_w & iok_w,
                fmd_inc=out.fmd_inc * iok_f,
                mmd_inc=out.mmd_inc * iok_f,
                invalid_inc=out.invalid_inc * iok_f,
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
        new_fresh = out.fresh_w | gossip_new
        fresh_hist = st.fresh_hist
        if self.max_edge_delay:
            # This round's plane enters the history at step mod D.
            fresh_hist = fresh_hist.clone()
            fresh_hist[:, st.step % dpl] = new_fresh
        nxt = st._replace(
            have_w=out.have_w,
            fresh_w=new_fresh,
            fresh_hist=fresh_hist,
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

    # -- scenario engine ----------------------------------------------------

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the model's device without a host sync
        (a pinned buffer and an asynchronous copy on a card)."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @staticmethod
    def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Min of ``x`` over ``mask``; NaN when the mask is empty."""
        lo = torch.where(mask, x, torch.inf).min()
        return torch.where(mask.any(), lo, torch.nan)

    def _apply_events(self, st: GossipState, ev: GossipEvents,
                      row) -> GossipState:
        """Apply one step's rows of a ``GossipEvents`` schedule (host numpy)
        in the reference's order: liveness, subscription, mute, self-promo,
        delay, publishes.  Each test of whether a kind fires is a host
        ``if`` on the numpy row; ``row(name)`` gives the row staged on the
        device.  ``silence`` acts after the step."""
        def delta(cur, off, on):
            if getattr(ev, off).any():
                cur = cur & ~row(off)
            if getattr(ev, on).any():
                cur = cur | row(on)
            return cur

        if ev.kill.any() or ev.revive.any():
            alive = delta(st.alive, "kill", "revive")
            st = st._replace(
                alive=alive,
                edge_live=compute_edge_live(st.nbr_valid, st.nbrs, alive))
        if ev.sub_off.any() or ev.sub_on.any():
            st = self._subscribe(st, delta(st.subscribed, "sub_off", "sub_on"))
        if ev.mute_on.any() or ev.mute_off.any():
            st = st._replace(
                gossip_mute=delta(st.gossip_mute, "mute_off", "mute_on"))
        if ev.promo_on.any() or ev.promo_off.any():
            st = st._replace(
                self_promo=delta(st.self_promo, "promo_off", "promo_on"))
        if (ev.delay >= 0).any():
            d = row("delay")
            st = st._replace(
                gossip_delay=torch.where(d >= 0, d, st.gossip_delay))
        for src, slot, valid in zip(ev.pub_src, ev.pub_slot, ev.pub_valid):
            if src >= 0:
                st = self.publish(st, int(src), min(max(int(slot), 0),
                                                    self.m - 1), bool(valid))
        return st

    def _campaign_record(self, st: GossipState, att: Optional[Tuple[
            torch.Tensor, torch.Tensor]], target: Optional[int]
    ) -> Dict[str, torch.Tensor]:
        """One round's adversary-standing channels (wide index view);
        ``att`` is the attackers' (bool[N] mask, int64 ids) on the device.

        The two score means are sums over masks the reference adds in XLA's
        order, so the round records their entries instead and
        :meth:`_finish_record` adds them in that order on the host:
        ``_score_idx``/``_score_vals`` (each attacker's slot in its
        neighbors' rows, found through ``rev``; -1 where unwired),
        ``_score_count`` (the mask's size, which checks the pairing) and
        ``_gscore_idx``/``_gscore_vals`` (the attackers' global scores)."""
        rec: Dict[str, torch.Tensor] = {}
        n, k = self.n, self.k
        attackers = None if att is None else att[0]
        if att is not None:
            ids = att[1]
            nbrs_c = torch.clamp(st.nbrs, 0, n - 1).long()
            att_slot = st.nbr_valid & attackers[nbrs_c]
            honest = ~attackers & st.alive
            honest_mesh = st.mesh & st.nbr_valid & honest[:, None]
            captured = (st.mesh & att_slot & honest[:, None]).sum(
                dtype=torch.int32)
            rec["attacker_mesh_edges"] = captured
            rec["attacker_capture_frac"] = captured.to(torch.float32) / (
                torch.clamp(honest_mesh.sum(dtype=torch.int32), min=1).to(
                    torch.float32))
            i, s = nbrs_c[ids], torch.clamp(st.rev[ids], 0, k - 1).long()
            paired = (st.nbr_valid[ids] & st.nbr_valid[i, s]
                      & (st.nbrs[i, s] == ids[:, None]))
            rec["_score_idx"] = torch.where(paired, i * k + s, -1).reshape(-1)
            rec["_score_vals"] = st.scores[i, s].reshape(-1)
            rec["_score_count"] = att_slot.sum(dtype=torch.int32)
            rec["_gscore_idx"] = ids
            rec["_gscore_vals"] = scoring_ops.global_score(
                st.gcounters, self.score_params)[ids]
            rec["honest_score_min"] = self.masked_min(
                st.scores,
                st.nbr_valid & ~att_slot & torch.isfinite(st.scores))
            bp = st.gcounters.behaviour_penalty
            # max over the attackers with initial 0.0: 0 when empty.
            rec["attacker_behaviour_penalty"] = torch.clamp(
                torch.where(attackers, bp, -torch.inf).max(), min=0.0)
            rec["honest_behaviour_penalty_max"] = torch.where(
                ~attackers, bp, 0.0).max()
        if target is not None:
            tgt_edges = st.mesh[target] & st.nbr_valid[target]
            if attackers is not None:
                tgt_edges = tgt_edges & ~attackers[
                    torch.clamp(st.nbrs[target], 0, n - 1).long()]
            rec["target_honest_mesh_edges"] = tgt_edges.sum(dtype=torch.int32)
        return rec

    def _to_host(self, record: Dict[str, torch.Tensor]
                 ) -> Dict[str, np.ndarray]:
        return record_to_host(record, self.device)

    def _finish_record(self, record: Dict[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
        """Per-round device channels with the adversary's mask entries ->
        the reference's flight record (host numpy), the adversary score
        means added in the reference's XLA order (``ops/reduce_order``).
        Raises if a round's mask entries do not cover the mask (the slot
        pairing broke)."""
        host = self._to_host(record)
        out = {name: v for name, v in host.items() if not name.startswith("_")}
        if "_score_idx" not in host:
            return out
        means, gmeans = [], []
        for t, (idx, vals, cnt) in enumerate(zip(
                host["_score_idx"], host["_score_vals"],
                host["_score_count"])):
            sel = idx >= 0
            if sel.sum() != cnt or np.unique(idx[sel]).size != sel.sum():
                raise RuntimeError(
                    f"round {t}: the attackers' paired slots ({sel.sum()}) "
                    f"do not cover the attacker-slot mask ({cnt})")
            means.append(reduce_order.masked_mean(
                (self.n, self.k), idx[sel], vals[sel], int(cnt)))
        for ids, vals in zip(host["_gscore_idx"], host["_gscore_vals"]):
            gmeans.append(reduce_order.masked_mean(
                (self.n,), ids, vals, ids.size))
        out["attacker_score_mean"] = np.array(means, np.float32)
        out["attacker_global_score"] = np.array(gmeans, np.float32)
        return out

    def rollout_events(self, st: GossipState, events: GossipEvents,
                       attackers=None, target: Optional[int] = None,
                       record: bool = True):
        """Run a whole event schedule (``ops.schedule.GossipEvents``, host
        numpy) -> (final state, flight record | None).

        Events at step t apply before round t (``_apply_events``);
        ``silence`` zeroes the silenced peers' fresh words after it.  The
        rows that carry an event are copied to the device once, before the
        first round, and every branch is taken on the host from the numpy
        rows, so no round reads the device.  With ``record`` each round
        adds :meth:`flight_record_round` plus the adversary channels of
        :meth:`_campaign_record` (when ``attackers`` bool[N] / ``target``
        are given), and in-campaign publishers' own receipts enter the
        latency histogram at bin 0.  The record comes back as host numpy
        channels, the reference's set, read once after the last round.
        ``silence`` assumes the ideal fabric (the compiler rejects it under
        ``max_edge_delay``)."""
        n_steps = int(events.kill.shape[0])
        rows = _StagedEvents(self, events)
        att = None
        if attackers is not None:
            att_np = (attackers.cpu().numpy() if isinstance(
                attackers, torch.Tensor) else np.asarray(attackers, bool))
            att = (self._stage(att_np), self._stage(np.flatnonzero(att_np)))
        st = self._widen_indices(st)
        hist = None
        if record:
            hist = hist_ops.latency_histogram_seed(
                st.first_step, st.msg_birth, st.msg_used & st.msg_valid,
                st.alive & st.subscribed, FLIGHT_HIST_BINS,
            )
        rounds: List[Dict[str, torch.Tensor]] = []
        first = st.step + 1
        for t in range(n_steps):
            ev = GossipEvents(*(plane[t] for plane in events))
            st = self._apply_events(st, ev, lambda name: rows.row(name, t))
            if not record:
                st = self._step_wide(st)
            else:
                pubs = rows.publishers(t)
                if pubs is not None:
                    counted = (st.alive[pubs] & st.subscribed[pubs]).sum(
                        dtype=torch.int32)
                    hist = torch.cat([hist[:1] + counted, hist[1:]])
                stamp = st.step
                st, per_msg = self._step_wide(st, with_receipts=True)
                hist = hist + hist_ops.latency_histogram_increment(
                    per_msg, st.msg_birth, st.msg_used & st.msg_valid,
                    stamp, FLIGHT_HIST_BINS,
                )
            if ev.silence.any():
                st = st._replace(fresh_w=torch.where(
                    rows.row("silence", t)[:, None], 0, st.fresh_w))
            if record:
                rec = self.flight_record_round(st, hist)
                rec.update(self._campaign_record(st, att, target))
                rounds.append(rec)
        if not record:
            return self._narrow_indices(st), None
        record_ys = {
            name: torch.stack([r[name] for r in rounds]) for name in rounds[0]
        } if rounds else {}
        record_ys["step"] = torch.arange(first, first + n_steps,
                                         dtype=torch.int32, device=self.device)
        return self._narrow_indices(st), self._finish_record(record_ys)

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
