"""RLNC -- coded gossip by random linear network coding, in PyTorch.

Port of the JAX package's ``models/rlnc.py``.  A published message is a
*generation* of ``gen_size`` source fragments; every round each holder
forwards over each live edge a fresh random GF(256) combination of what
it holds for a generation, and a receiver delivers the moment its decode
basis reaches full rank, from any ``gen_size`` independent fragments.
State is one structured elimination basis per (peer, generation)
(``ops.gf256.rref_insert``; u8[N, G, Kg, Kg]) plus the topology,
liveness and window planes of GossipSub, so the flight recorder, the
scenario event path and ``delivery_stats`` apply unchanged.

The reference's documented semantics are kept as they are: every live
edge relays (there is no mesh), the score channels record 0.0,
``gossip_delay`` d is ingress *decimation* (a peer accepts fragments only
when ``step % (d + 1) == 0``; fragments sent in between are lost, not
held), ``gossip_mute`` peers receive but never emit, and event
``silence`` suppresses a peer's emissions for the following round.

Differences of form, none of which changes a bit of state:

- ``step`` is a host ``int`` (as in the port's ``GossipSub``): the
  decimation gate is a device op on it, and no round reads the device.
- The coefficient draw of a round (u8[N, K, G, Kg], 1.64G elements at
  100,000 peers and the bench's widths) is taken in blocks of senders:
  the threefry counters are flat element indices, so a block of rows
  draws the reference's bits (``ops.rng.randint``'s ``row_offset``), and
  each block is combined with its senders' bases before the next is
  drawn.  Receivers then gather one in-slot at a time.  The peak memory
  is the coded fragments (one byte per element) plus one block's draw.
- ``rollout``/``rollout_events`` are host loops; the event rows are
  staged on the device once (``models.gossipsub._StagedEvents``) and
  each ``lax.cond`` of the reference's event application is a host
  ``if`` on the numpy row.  ``rollout_events``' record comes back as
  host numpy, read once after the last round.

``peer_uid`` (placement relabeling) keys the coefficient draw on
canonical identity, as the reference's does (``gf256.coeffs_by_uid``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import gf256
from ..ops import histogram as hist_ops
from ..ops import rng
from ..ops.graphs import (
    decode_index_plane,
    encode_index_plane,
    index_dtype,
    torch_dtype,
)
from ..ops.schedule import GossipEvents
from .gossipsub import (
    FLIGHT_HIST_BINS,
    _nanquantile_int,
    _StagedEvents,
    build_topology,
    build_topology_fast,
    compute_edge_live,
    record_to_host,
    resolve_device,
)

# Coefficient elements drawn at once (one block of senders): a block's
# threefry temporaries (int64 counters, int32 rounds) hold a few GB at most.
DRAW_BLOCK_ELEMS = 1 << 26


def draw_block(n_slots: int, g: int, kg: int) -> int:
    """Senders whose coefficients are drawn at once (``DRAW_BLOCK_ELEMS``
    elements, at least one sender)."""
    return max(1, DRAW_BLOCK_ELEMS // (n_slots * g * kg))


def encode(key: torch.Tensor, basis: torch.Tensor, n_slots: int,
           use_mxu: bool = False,
           uid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every sender's coded fragment per (out-slot, generation):
    u8[N, K, G, Kg] = ``gf_combine(coeffs, basis[:, None])`` with
    ``coeffs = coeffs_by_uid(key, (N, K, G, Kg), uid)`` (the reference's
    encode), drawn and combined :func:`draw_block` senders at a time."""
    n, g, kg = basis.shape[0], basis.shape[1], basis.shape[2]
    combine = gf256.gf_combine_mxu if use_mxu else gf256.gf_combine
    out = torch.empty((n, n_slots, g, kg), dtype=torch.uint8,
                      device=basis.device)
    block = draw_block(n_slots, g, kg)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        coeffs = gf256.coeffs_by_uid(key, (r1 - r0, n_slots, g, kg),
                                     uid, row_offset=r0)
        out[r0:r1] = combine(coeffs, basis[r0:r1, None])
    return out


def fold(basis: torch.Tensor, frag: torch.Tensor, flat_idx: torch.Tensor,
         ok: torch.Tensor) -> torch.Tensor:
    """Receivers fold their in-edge fragments into their bases, one in-slot
    at a time (the reference's ``fori_loop`` over K of the vmapped
    ``rref_insert``): slot s of peer i carries ``frag.view(N*K, G,
    Kg)[flat_idx[i, s]]`` where ``ok[i, s, g]``, else the zero vector (a
    no-op insert, so masking is dropping)."""
    n, k = flat_idx.shape
    flat = frag.reshape(n * k, frag.shape[2], frag.shape[3])
    for s in range(k):
        inc = torch.where(ok[:, s, :, None], flat[flat_idx[:, s]], 0)
        basis = gf256.rref_insert(basis, inc.to(torch.uint8))[0]
    return basis


class RLNCState(NamedTuple):
    """Coded-gossip state (the reference's ``RLNCState``, field for field):
    N peers, K slots, G generations in the window, Kg fragments each."""

    nbrs: torch.Tensor        # [N, K] remote peer id (narrow storage)
    rev: torch.Tensor         # [N, K] remote's slot back to me (narrow)
    nbr_valid: torch.Tensor   # bool[N, K]
    alive: torch.Tensor       # bool[N]
    subscribed: torch.Tensor  # bool[N]
    edge_live: torch.Tensor   # bool[N, K] nbr_valid & alive[nbrs]
    basis: torch.Tensor       # u8[N, G, Kg, Kg] pivot-slot decode bases
    first_step: torch.Tensor  # int32[N, G] full-rank stamp, -1 = never
    msg_valid: torch.Tensor   # bool[G]
    msg_birth: torch.Tensor   # int32[G]
    msg_active: torch.Tensor  # bool[G]
    msg_used: torch.Tensor    # bool[G]
    gossip_mute: torch.Tensor   # bool[N] receive-only peers
    gossip_delay: torch.Tensor  # int32[N] ingress decimation period
    silenced: torch.Tensor      # bool[N] emissions suppressed this round
    key: torch.Tensor           # int32[2] threefry key
    step: int                   # round counter, owned by the host


class RLNC:
    """Single-topic coded-gossip simulator; state lives on ``device``
    (default ``"cuda"``, which raises when no card is present)."""

    def __init__(
        self,
        n_peers: int = 1024,
        n_slots: int = 32,
        conn_degree: int = 16,
        msg_window: int = 64,
        gen_size: int = 8,
        builder=None,
        peer_uid: Optional[np.ndarray] = None,
        use_mxu: Optional[bool] = None,
        index_dtype_override=None,
        device="cuda",
    ):
        if gen_size < 1:
            raise ValueError("gen_size must be >= 1")
        if gen_size > 255:
            raise ValueError("gen_size must be <= 255 (GF(256) coefficients)")
        self.device = resolve_device(device)
        # The bit-plane matmul form is an optional arm; the table form is
        # the default (the reference's choice off a TPU).
        self.use_mxu = bool(use_mxu)
        self.n = n_peers
        self.k = n_slots
        self.m = msg_window
        self.gen_size = gen_size
        self.conn_degree = conn_degree
        self.builder = builder
        # Canonical id of each physical row under a placement relabeling
        # (``parallel/placement``): the coefficient draw follows it.
        if peer_uid is None:
            self.peer_uid = None
        else:
            pu = np.asarray(peer_uid)
            if pu.shape != (n_peers,):
                raise ValueError(f"peer_uid must be [N={n_peers}]")
            if not np.array_equal(np.sort(pu), np.arange(n_peers)):
                raise ValueError("peer_uid must be a permutation of 0..N-1")
            self.peer_uid = self._t(pu.astype(np.int32))
        if index_dtype_override is None:
            self.idx_dtype = index_dtype(n_peers)
            self.rev_dtype = index_dtype(n_slots)
        else:
            dt = np.dtype(index_dtype_override)
            if dt.kind == "u" and n_peers + 1 > np.iinfo(dt).max:
                raise ValueError(
                    f"index_dtype_override {dt.name} cannot hold "
                    f"n_peers + 1 = {n_peers + 1}")
            self.idx_dtype = self.rev_dtype = dt

    def _config_key(self):
        builder_key = getattr(self.builder, "config_key", None)
        if self.builder is not None and builder_key is None:
            return id(self)
        return (builder_key, type(self), str(self.device), self.n, self.k,
                self.m, self.gen_size, self.conn_degree, self.use_mxu,
                str(self.idx_dtype), str(self.rev_dtype),
                None if self.peer_uid is None
                else bytes(self.peer_uid.cpu().numpy()))

    def __eq__(self, other):
        return (type(other) is type(self)
                and self._config_key() == other._config_key())

    def __hash__(self):
        return hash(self._config_key())

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the model's device without a host sync."""
        t = torch.from_numpy(np.array(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def build_graph(self, seed: int = 0):
        """Topology -> (nbrs, rev, nbr_valid): GossipSub's builder and draw
        order, so an equal (n, k, degree, seed) gives GossipSub's graph."""
        rng_np = np.random.default_rng(seed)
        builder = self.builder or (
            build_topology if self.n <= 4096 else build_topology_fast)
        nbrs, rev, valid, _outbound = builder(
            rng_np, self.n, self.k, self.conn_degree)
        return (
            self._t(encode_index_plane(nbrs, self.n, dtype=self.idx_dtype),
                    torch_dtype(self.idx_dtype)),
            self._t(encode_index_plane(rev, self.k, dtype=self.rev_dtype),
                    torch_dtype(self.rev_dtype)),
            self._t(valid),
        )

    def init(self, seed: int = 0,
             subscribed: Optional[np.ndarray] = None) -> RLNCState:
        """Fresh state (no warmup: there is no mesh)."""
        nbrs, rev, valid = self.build_graph(seed)
        n, m, kg, dev = self.n, self.m, self.gen_size, self.device
        alive0 = torch.ones(n, dtype=torch.bool, device=dev)
        sub0 = alive0.clone() if subscribed is None else self._t(
            subscribed, torch.bool)
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        return RLNCState(
            nbrs=nbrs, rev=rev, nbr_valid=valid, alive=alive0,
            subscribed=sub0,
            edge_live=compute_edge_live(valid, nbrs, alive0),
            basis=zeros((n, m, kg, kg), torch.uint8),
            first_step=torch.full((n, m), -1, dtype=torch.int32, device=dev),
            msg_valid=zeros(m, torch.bool),
            msg_birth=zeros(m, torch.int32),
            msg_active=zeros(m, torch.bool),
            msg_used=zeros(m, torch.bool),
            gossip_mute=zeros(n, torch.bool),
            gossip_delay=zeros(n, torch.int32),
            silenced=zeros(n, torch.bool),
            key=rng.PRNGKey(seed, device=dev),
            step=0,
        )

    # -- views ----------------------------------------------------------------

    def rank(self, st: RLNCState) -> torch.Tensor:
        """int32[N, G] decode rank per (peer, generation)."""
        return gf256.gf_rank(st.basis)

    # -- events ---------------------------------------------------------------

    def publish(self, st: RLNCState, src: int, slot: int,
                valid) -> RLNCState:
        """Seed a generation at ``src`` in window ``slot`` (recycling it):
        the publisher holds the identity basis and stamps its own receipt;
        every other basis of the slot is cleared.  A generation that failed
        validation never enters relay (``msg_active`` False)."""
        src, slot = int(src), int(slot)
        kg = self.gen_size
        basis = st.basis.clone()
        basis[:, slot] = 0
        basis[src, slot] = torch.eye(kg, dtype=torch.uint8,
                                     device=self.device)
        first_step = st.first_step.clone()
        first_step[:, slot] = -1
        first_step[src, slot].fill_(st.step)
        mv, mb = st.msg_valid.clone(), st.msg_birth.clone()
        ma, mu = st.msg_active.clone(), st.msg_used.clone()
        if isinstance(valid, torch.Tensor):
            mv[slot] = valid
            ma[slot] = valid
        else:
            mv[slot].fill_(bool(valid))
            ma[slot].fill_(bool(valid))
        mb[slot].fill_(st.step)
        mu[slot].fill_(True)
        return st._replace(basis=basis, first_step=first_step, msg_valid=mv,
                           msg_birth=mb, msg_active=ma, msg_used=mu)

    def kill_peers(self, st: RLNCState, mask) -> RLNCState:
        alive = st.alive & ~torch.as_tensor(mask, device=self.device)
        return st._replace(
            alive=alive,
            edge_live=compute_edge_live(st.nbr_valid, st.nbrs, alive))

    def set_gossip_delay(self, st: RLNCState, delay) -> RLNCState:
        """Per-peer ingress decimation: a delay-d peer accepts fragments
        every (d+1)-th round; the others are lost."""
        return st._replace(gossip_delay=torch.as_tensor(
            delay, device=self.device).to(torch.int32))

    def set_gossip_mute(self, st: RLNCState, mask) -> RLNCState:
        """Mark peers (bool[N]) receive-only: they decode but never emit."""
        return st._replace(gossip_mute=torch.as_tensor(
            mask, device=self.device).to(torch.bool))

    def set_subscribed(self, st: RLNCState, sub) -> RLNCState:
        """Change topic membership; non-members neither emit nor accept."""
        return st._replace(subscribed=torch.as_tensor(
            sub, device=self.device).to(torch.bool))

    # -- transition -----------------------------------------------------------

    def _step_core(self, st: RLNCState) -> Tuple[RLNCState, torch.Tensor]:
        """One coded round -> (new state, int32[G] new receipts): encode
        at every eligible holder, fold at every receiver, stamp the bases
        that just reached full rank."""
        n, k, kg = self.n, self.k, self.gen_size
        key_c, key_n = rng.split(st.key, 2).unbind(0)
        rank = gf256.gf_rank(st.basis)                              # [N, G]
        can_send = (
            (rank > 0)
            & (st.alive & st.subscribed & ~st.gossip_mute
               & ~st.silenced)[:, None]
            & (st.msg_active & st.msg_used)[None, :]
        )
        frag = encode(key_c, st.basis, k, self.use_mxu, self.peer_uid)
        j = torch.clamp(decode_index_plane(st.nbrs), 0, n - 1).long()
        flat_idx = j * k + torch.clamp(decode_index_plane(st.rev), 0, k - 1)
        accept = (st.alive & st.subscribed
                  & (torch.remainder(st.step, st.gossip_delay + 1) == 0))
        ok = can_send[j] & (st.edge_live & accept[:, None])[:, :, None]
        basis = fold(st.basis, frag, flat_idx, ok)
        done_new = (gf256.gf_rank(basis) == kg) & (st.first_step < 0)
        first_step = torch.where(done_new, st.step, st.first_step)
        per_msg = done_new.sum(dim=0, dtype=torch.int32)
        return (st._replace(basis=basis, first_step=first_step, key=key_n,
                            step=st.step + 1), per_msg)

    def step(self, st: RLNCState) -> RLNCState:
        return self._step_core(st)[0]

    def step_recorded(self, st: RLNCState):
        """(state, int32[G] receipts stamped this round)."""
        return self._step_core(st)

    def run(self, st: RLNCState, n_steps: int) -> RLNCState:
        return self.rollout(st, n_steps, record=False)[0]

    def _hist_seed(self, st: RLNCState) -> torch.Tensor:
        return hist_ops.latency_histogram_seed(
            st.first_step, st.msg_birth, st.msg_used & st.msg_valid,
            st.alive & st.subscribed, FLIGHT_HIST_BINS)

    def _advance(self, st: RLNCState, hist: torch.Tensor):
        stamp = st.step
        st2, per_msg = self._step_core(st)
        hist = hist + hist_ops.latency_histogram_increment(
            per_msg, st2.msg_birth, st2.msg_used & st2.msg_valid, stamp,
            FLIGHT_HIST_BINS)
        return st2, hist

    @staticmethod
    def _stack(rounds: List[Dict[str, torch.Tensor]]):
        return {name: torch.stack([r[name] for r in rounds])
                for name in rounds[0]} if rounds else {}

    def rollout(self, st: RLNCState, n_steps: int, record: bool = True):
        """``n_steps`` coded rounds -> (final state, record | None): the
        record's channels are device tensors with a leading [n_steps]
        axis, the cumulative latency histogram carried as in GossipSub's
        rollout.  Nothing inside the loop reads the device."""
        if not record:
            for _ in range(n_steps):
                st = self.step(st)
            return st, None
        hist = self._hist_seed(st)
        rounds = []
        for _ in range(n_steps):
            st, hist = self._advance(st, hist)
            rounds.append(self.flight_record_round(st, hist))
        return st, self._stack(rounds)

    # -- scenario engine ------------------------------------------------------

    def _apply_events(self, st: RLNCState, ev: GossipEvents, row,
                      quiet: torch.Tensor) -> RLNCState:
        """One step's rows of a ``GossipEvents`` schedule in the reference's
        order (liveness, subscription, mute, delay, silence, publishes);
        each kind's test is a host ``if`` on the numpy row, ``row(name)``
        the row staged on the device.  ``silence`` is set every step (the
        staged row where it fires, ``quiet`` elsewhere)."""
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
            st = st._replace(subscribed=delta(st.subscribed, "sub_off",
                                              "sub_on"))
        if ev.mute_on.any() or ev.mute_off.any():
            st = st._replace(
                gossip_mute=delta(st.gossip_mute, "mute_off", "mute_on"))
        if (ev.delay >= 0).any():
            d = row("delay")
            st = st._replace(
                gossip_delay=torch.where(d >= 0, d, st.gossip_delay))
        st = st._replace(
            silenced=row("silence") if ev.silence.any() else quiet)
        for src, slot, valid in zip(ev.pub_src, ev.pub_slot, ev.pub_valid):
            if src >= 0:
                st = self.publish(st, int(src), min(max(int(slot), 0),
                                                    self.m - 1), bool(valid))
        return st

    def rollout_events(self, st: RLNCState, events: GossipEvents,
                       record: bool = True):
        """Run a whole ``GossipEvents`` schedule (host numpy) -> (final
        state, host flight record | None).  Events at step t apply before
        round t; in-campaign publishers' own receipts enter the latency
        histogram at bin 0, as in GossipSub's ``rollout_events``."""
        n_steps = int(events.kill.shape[0])
        rows = _StagedEvents(self, events)
        quiet = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        hist = self._hist_seed(st) if record else None
        rounds = []
        for t in range(n_steps):
            ev = GossipEvents(*(plane[t] for plane in events))
            st = self._apply_events(st, ev, lambda name: rows.row(name, t),
                                    quiet)
            if not record:
                st = self.step(st)
                continue
            pubs = rows.publishers(t)
            if pubs is not None:
                counted = (st.alive[pubs] & st.subscribed[pubs]).sum(
                    dtype=torch.int32)
                hist = torch.cat([hist[:1] + counted, hist[1:]])
            st, hist = self._advance(st, hist)
            rounds.append(self.flight_record_round(st, hist))
        if not record:
            return st, None
        return st, record_to_host(self._stack(rounds), self.device)

    # -- flight recorder ------------------------------------------------------

    def flight_record_round(self, st: RLNCState, lat_hist: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
        """One round's telemetry, GossipSub's channel set: ``mesh_degree_*``
        are live-edge degrees, ``score_p*`` 0.0, ``gossip_pending`` the
        decode backlog (basis rows held for generations not yet at full
        rank)."""
        part = st.alive & st.subscribed
        part_n = torch.clamp(part.sum(dtype=torch.int32), min=1)
        in_window = st.msg_used & st.msg_valid
        n_msgs = torch.clamp(in_window.sum(dtype=torch.int32), min=1)
        deg = st.edge_live.sum(dim=1, dtype=torch.int32)
        deg_alive = torch.where(part, deg, 0)
        rank = gf256.gf_rank(st.basis)
        backlog = torch.where(
            (rank < self.gen_size) & st.msg_active[None, :], rank, 0
        ).sum(dtype=torch.int32)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return {
            "step": torch.full((), st.step, dtype=torch.int32,
                               device=self.device),
            "peers_alive": st.alive.sum(dtype=torch.int32),
            "delivery_frac": lat_hist.sum(dtype=torch.int32) / (
                part_n * n_msgs),
            "mesh_degree_mean": deg_alive.sum(dtype=torch.int32) / part_n,
            "mesh_degree_max": deg.max(),
            "score_p10": zero,
            "score_p50": zero,
            "score_p90": zero,
            "gossip_pending": backlog,
            "lat_hist": lat_hist,
        }

    # -- metrics --------------------------------------------------------------

    def delivery_stats(self, st: RLNCState):
        """(frac f32[G], p50, p99): per-generation delivery fraction and
        decode-latency percentiles in rounds (GossipSub's arithmetic)."""
        part = st.alive & st.subscribed
        part_n = part.sum(dtype=torch.int32)
        delivered = ((st.first_step >= 0) & part[:, None]).sum(
            dim=0, dtype=torch.int32)
        frac = torch.where(st.msg_used & st.msg_valid,
                           delivered / torch.clamp(part_n, min=1), torch.nan)
        lat = torch.where(st.first_step >= 0,
                          st.first_step - st.msg_birth[None, :], -1)
        valid_lat = ((lat >= 0) & st.msg_used[None, :]
                     & st.msg_valid[None, :] & part[:, None])
        return (frac, _nanquantile_int(lat, valid_lat, 0.5),
                _nanquantile_int(lat, valid_lat, 0.99))
