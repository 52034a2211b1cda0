"""Adaptive coded gossip: per-edge eager <-> RLNC switching, in PyTorch.

Port of the JAX package's ``models/hybrid.py``.  :class:`HybridGossipSub`
embeds a full single-topic :class:`GossipSub` and adds a coded plane over
the same topology:

- ``ops/loss_estimator.py`` keeps a per-edge loss EWMA from
  expected-vs-observed receipts, latched with hysteresis;
- clean edges run the eager + IHAVE/IWANT machinery unchanged (kernel K1
  for the push through ``GossipSub._propagate``'s hooks, K2 in the
  heartbeat); edges whose estimate crosses ``switch_hi`` leave the eager
  relay mask and carry GF(256) RLNC fragments instead (generation =
  window slot, ``gen_size`` fragments, pivot-slot bases folded by
  ``gf256.rref_insert``);
- a decode that completes merges back into the gossip plane as a first
  receipt (possession, ``first_step`` and a fresh bit, so the decoded
  message relays on over clean edges).

Loss model, as the reference's: per-receiver ingress decimation
(``ingress_loss[i] = d``: data-plane ingress only when ``step % (d + 1)
== 0``, everything else lost) ANDed with a Bernoulli gate
(``ingress_loss_p``, its own key chain).  With both at 0 the estimate
stays 0.0, no edge is coded, and the rollout equals plain GossipSub leaf
for leaf (the coded plane's keys are folds of the seed, not splits of the
gossip chain).

Serving plane: the model speaks the streaming engine's dialect
(``MultiTopicEvents`` with ``t = 1``; ``delay`` rows set
``ingress_loss``), with value ``__eq__``/``__hash__``,
``stream_model_key``, ``stream_digest``, ``stream_deliver_steps``,
``stream_chunk`` (a chunk with the reference's flight tail) and
``decode_rank_summary`` (checkpoint meta).

Differences of form, none of which changes a bit of state:

- The reference gates the coded fold with ``lax.cond(coded.any(), ...)``.
  A Python ``if`` on that device scalar would wait for the card every
  round, so the port computes the coded branch every round and selects its
  three results (possession/fresh/stamps, bases, receipts) with
  ``torch.where`` on the 0-d predicate: the skipped branch returns its
  inputs, so the selection is the cond's result bit for bit.
- The heartbeat runs on the host's schedule of ``step`` (the port's
  GossipSub owns ``step`` on the host).
- ``loss_ewma_mean`` is summed in XLA's CPU order
  (``ops/reduce_order.xla_sum``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import GossipSubParams, ScoreParams
from ..ops import bitpack
from ..ops import gf256
from ..ops import histogram as hist_ops
from ..ops import loss_estimator as loss_ops
from ..ops import reduce_order
from ..ops import rng
from ..ops.schedule import MultiTopicEvents
from .gossipsub import (
    FLIGHT_HIST_BINS,
    GossipState,
    GossipSub,
    compute_edge_live,
    record_to_host,
)
from .multitopic import _StagedRows
from .rlnc import encode, fold


class HybridState(NamedTuple):
    """The embedded gossip state plus the coded plane (the reference's
    ``HybridState``, field for field)."""

    gossip: GossipState
    loss_ewma: torch.Tensor       # f32[N, K] per-edge loss estimate
    coded: torch.Tensor           # bool[N, K] edges on the coded plane
    basis: torch.Tensor           # u8[N, M, Kg, Kg] decode bases
    ingress_loss: torch.Tensor    # int32[N] decimation period (0 = lossless)
    key_coded: torch.Tensor       # int32[2] coded plane's key
    ingress_loss_p: torch.Tensor  # f32[N] Bernoulli per-round drop prob
    key_loss: torch.Tensor        # int32[2] Bernoulli gate's key


class HybridGossipSub:
    """Single-topic adaptive eager/RLNC hybrid; state lives on ``device``
    (default ``"cuda"``, which raises when no card is present)."""

    t = 1

    def __init__(
        self,
        n_peers: int = 1024,
        n_slots: int = 32,
        conn_degree: int = 16,
        msg_window: int = 64,
        heartbeat_steps: int = 8,
        gen_size: int = 4,
        switch_hi: float = 0.35,
        switch_lo: float = 0.15,
        ewma_alpha: float = 0.25,
        params: Optional[GossipSubParams] = None,
        score_params: Optional[ScoreParams] = None,
        builder=None,
        peer_uid: Optional[np.ndarray] = None,
        use_mxu: Optional[bool] = None,
        index_dtype_override=None,
        device="cuda",
    ):
        if not (1 <= gen_size <= 255):
            raise ValueError(f"gen_size must be in [1, 255], got {gen_size}")
        if not (0.0 <= switch_lo < switch_hi):
            raise ValueError(
                f"need 0 <= switch_lo < switch_hi, got "
                f"lo={switch_lo} hi={switch_hi}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        # The embedded eager plane on the ideal fabric (no per-edge delay,
        # no direct peering), as in the reference; a placement's
        # ``peer_uid`` keys its draws and the coded plane's coefficients.
        self.gs = GossipSub(
            n_peers=n_peers, n_slots=n_slots, conn_degree=conn_degree,
            msg_window=msg_window, params=params, score_params=score_params,
            heartbeat_steps=heartbeat_steps, builder=builder,
            index_dtype_override=index_dtype_override, peer_uid=peer_uid,
            device=device,
        )
        self.device = self.gs.device
        self.gen_size = gen_size
        self.switch_hi = float(switch_hi)
        self.switch_lo = float(switch_lo)
        self.ewma_alpha = float(ewma_alpha)
        self.use_mxu = bool(use_mxu)

    # -- engine surface (the MultiTopicGossipSub dialect, T = 1) ------------

    @property
    def n(self) -> int:
        return self.gs.n

    @property
    def k(self) -> int:
        return self.gs.k

    @property
    def m(self) -> int:
        return self.gs.m

    @property
    def w(self) -> int:
        return self.gs.w

    @property
    def heartbeat_steps(self) -> int:
        return self.gs.heartbeat_steps

    def _config_key(self):
        return (type(self), self.gs._config_key(), self.gen_size,
                self.switch_hi, self.switch_lo, self.ewma_alpha, self.use_mxu)

    def __eq__(self, other):
        return (type(other) is type(self)
                and self._config_key() == other._config_key())

    def __hash__(self):
        return hash(self._config_key())

    def stream_model_key(self) -> str:
        """Config fingerprint for streaming-engine checkpoint meta (the
        reference's string, so snapshots cross between the packages)."""
        return (
            f"hybrid t=1 n={self.n} k={self.k} m={self.m} w={self.w} "
            f"hb={self.heartbeat_steps} kg={self.gen_size} "
            f"hi={self.switch_hi} lo={self.switch_lo}"
        )

    # -- lifecycle ----------------------------------------------------------

    def init(self, seed: int = 0,
             subscribed: Optional[np.ndarray] = None) -> HybridState:
        g = self.gs.init(seed, subscribed)
        n, k, m, kg, dev = self.n, self.k, self.m, self.gen_size, self.device
        seed_key = rng.PRNGKey(seed, device=dev)
        return HybridState(
            gossip=g,
            loss_ewma=torch.zeros((n, k), dtype=torch.float32, device=dev),
            coded=torch.zeros((n, k), dtype=torch.bool, device=dev),
            basis=torch.zeros((n, m, kg, kg), dtype=torch.uint8, device=dev),
            ingress_loss=torch.zeros(n, dtype=torch.int32, device=dev),
            # Folds of the seed key, not splits of the gossip chain.
            key_coded=rng.fold_in(seed_key, 0xC0DE),
            ingress_loss_p=torch.zeros(n, dtype=torch.float32, device=dev),
            key_loss=rng.fold_in(seed_key, 0x1055),
        )

    def set_ingress_loss(self, st: HybridState, delay) -> HybridState:
        """Every peer's decimation period (a scalar or an int32[N]); 0
        restores the lossless fabric."""
        d = torch.as_tensor(delay, device=self.device).to(torch.int32)
        return st._replace(
            ingress_loss=torch.broadcast_to(d, (self.n,)).contiguous())

    def set_ingress_loss_p(self, st: HybridState, p) -> HybridState:
        """Every peer's Bernoulli round-drop probability (a scalar or an
        f32[N]); 0.0 restores the lossless fabric."""
        if isinstance(p, (int, float)) and not 0.0 <= p < 1.0:
            raise ValueError(f"ingress_loss_p must be in [0, 1), got {p}")
        pv = torch.as_tensor(p, device=self.device).to(torch.float32)
        return st._replace(
            ingress_loss_p=torch.broadcast_to(pv, (self.n,)).contiguous())

    def publish(self, st: HybridState, src: int, slot: int,
                valid) -> HybridState:
        """Publish on both planes: the gossip seed, and the generation's
        identity basis at the publisher (valid publishes only)."""
        src, slot = int(src), int(slot)
        g = self.gs.publish(st.gossip, src, slot, valid)
        eye = torch.eye(self.gen_size, dtype=torch.uint8, device=self.device)
        if isinstance(valid, torch.Tensor):
            eye = eye * valid.to(device=self.device, dtype=torch.uint8)
        elif not valid:
            eye = torch.zeros_like(eye)
        basis = st.basis.clone()
        basis[:, slot] = 0
        basis[src, slot] = eye
        return st._replace(gossip=g, basis=basis)

    # -- one round (gossip state in the int32 index view) -------------------

    def _widen(self, st: HybridState) -> HybridState:
        return st._replace(gossip=self.gs._widen_indices(st.gossip))

    def _narrow(self, st: HybridState) -> HybridState:
        return st._replace(gossip=self.gs._narrow_indices(st.gossip))

    def _step_core(self, st: HybridState, with_receipts: bool = False):
        """One round before the heartbeat and the step increment: the gated
        eager push, the coded fold and decode merge, and the estimator.
        Returns ``(state, per_msg | None)``."""
        g = st.gossip
        n, k, m, kg = self.n, self.k, self.m, self.gen_size
        # Ingress gate: decimation AND the Bernoulli draw (its key splits
        # every round, so the stream is independent of the loss values).
        kl, kln = rng.split(st.key_loss, 2).unbind(0)
        accept = ((torch.remainder(g.step, st.ingress_loss + 1) == 0)
                  & (rng.uniform(kl, (n,)) >= st.ingress_loss_p))
        # The estimator's expected plane, before the round mutates the
        # state: while the window carries live traffic every eager-eligible
        # or coded live edge is expected to deliver.
        j = torch.clamp(g.nbrs, 0, n - 1).long()
        relay_mesh = g.mesh & (
            g.scores >= self.gs.score_params.graylist_threshold)
        gen_live = g.msg_valid & g.msg_active & g.msg_used
        send_gen = (gf256.gf_rank(st.basis) > 0) & gen_live[None, :]
        expected = g.edge_live & gen_live.any() & (relay_mesh | st.coded)

        # Eager plane (K1): coded edges out of the relay mask, closed
        # receivers' ingress dropped.
        out = self.gs._propagate(g, with_receipts=with_receipts,
                                 eager_edge_ok=~st.coded, ingress_ok=accept)
        g2, per_msg = out if with_receipts else (out, None)

        # Coded plane.  The key splits outside the reference's cond; the
        # branch is computed every round and selected below.
        kc, kcn = rng.split(st.key_coded, 2).unbind(0)
        frag = encode(kc, st.basis, k, self.use_mxu, self.gs.peer_uid)
        flat_idx = j * k + torch.clamp(g2.rev, 0, k - 1)
        ok_edge = (st.coded & g2.edge_live & accept[:, None]
                   & (g2.alive & g2.subscribed)[:, None])
        ok = ok_edge[:, :, None] & (send_gen & ~g2.gossip_mute[:, None])[j]
        basis = fold(st.basis, frag, flat_idx, ok)
        # A completed decode is a first receipt (exactly once per peer and
        # message): possession, fresh, and the latency stamp.
        done = ((gf256.gf_rank(basis) == kg) & gen_live[None, :]
                & (g2.first_step < 0))
        done_w = bitpack.pack(done)
        coded_any = st.coded.any()
        g3 = g2._replace(
            have_w=torch.where(coded_any, g2.have_w | done_w, g2.have_w),
            fresh_w=torch.where(coded_any, g2.fresh_w | done_w, g2.fresh_w),
            first_step=torch.where(coded_any & done, g2.step, g2.first_step),
        )
        basis = torch.where(coded_any, basis, st.basis)
        if per_msg is not None:
            per_coded = (done & (g2.alive & g2.subscribed)[:, None]).sum(
                dim=0, dtype=torch.int32)
            per_msg = per_msg + torch.where(coded_any, per_coded, 0)

        est = loss_ops.update(
            loss_ops.LossEstimate(st.loss_ewma, st.coded),
            expected, accept[:, None],
            self.ewma_alpha, self.switch_hi, self.switch_lo)
        nxt = st._replace(gossip=g3, loss_ewma=est.loss_ewma,
                          coded=est.coded, basis=basis, key_coded=kcn,
                          key_loss=kln)
        return nxt, per_msg

    def _finish_round(self, st: HybridState) -> HybridState:
        """The heartbeat on its schedule, then the step increment."""
        g = st.gossip
        if g.step % self.heartbeat_steps == self.heartbeat_steps - 1:
            g = self.gs._heartbeat(g)
        return st._replace(gossip=g._replace(step=g.step + 1))

    def step(self, st: HybridState) -> HybridState:
        st, _ = self._step_core(self._widen(st))
        return self._narrow(self._finish_round(st))

    def step_recorded(self, st: HybridState):
        """``step`` plus the receipts stamped this round (eager and coded),
        int32[M]."""
        st, per_msg = self._step_core(self._widen(st), with_receipts=True)
        return self._narrow(self._finish_round(st)), per_msg

    # -- rollouts -----------------------------------------------------------

    def _hist_seed(self, st: HybridState) -> torch.Tensor:
        g = st.gossip
        return hist_ops.latency_histogram_seed(
            g.first_step, g.msg_birth, g.msg_used & g.msg_valid,
            g.alive & g.subscribed, FLIGHT_HIST_BINS)

    def _advance(self, st: HybridState, hist: torch.Tensor):
        """One recorded round on the wide view -> (state, histogram)."""
        stamp = st.gossip.step
        st, per_msg = self._step_core(st, with_receipts=True)
        hist = hist + hist_ops.latency_histogram_increment(
            per_msg, st.gossip.msg_birth,
            st.gossip.msg_used & st.gossip.msg_valid, stamp, FLIGHT_HIST_BINS)
        return self._finish_round(st), hist

    def _stacked(self, rounds, first: int) -> Dict[str, torch.Tensor]:
        rec = {name: torch.stack([r[name] for r in rounds])
               for name in rounds[0]} if rounds else {}
        rec["step"] = torch.arange(first, first + len(rounds),
                                   dtype=torch.int32, device=self.device)
        return rec

    def rollout(self, st: HybridState, n_steps: int, record: bool = True):
        """``n_steps`` rounds -> (final state, record | None); the record's
        channels are device tensors with a leading [n_steps] axis (the
        carried histogram of GossipSub's rollout).  Nothing inside the loop
        reads the device."""
        st = self._widen(st)
        if not record:
            for _ in range(n_steps):
                st = self._finish_round(self._step_core(st)[0])
            return self._narrow(st), None
        hist = self._hist_seed(st)
        first = st.gossip.step + 1
        rounds = []
        for _ in range(n_steps):
            st, hist = self._advance(st, hist)
            rounds.append(self.flight_record_round(st, hist))
        return self._narrow(st), self._stacked(rounds, first)

    def _apply_events(self, st: HybridState, ev: MultiTopicEvents,
                      row) -> HybridState:
        """One step's rows in the reference's order: kill, mute, delay
        (which sets ``ingress_loss``), publishes (``pub_topic`` clipped
        into the single topic).  Each kind's test is a host ``if``."""
        g = st.gossip
        if ev.kill.any():
            alive = g.alive & ~row("kill")
            g = g._replace(alive=alive, edge_live=compute_edge_live(
                g.nbr_valid, g.nbrs, alive))
        if ev.mute_on.any() or ev.mute_off.any():
            mute = g.gossip_mute
            if ev.mute_off.any():
                mute = mute & ~row("mute_off")
            if ev.mute_on.any():
                mute = mute | row("mute_on")
            g = g._replace(gossip_mute=mute)
        st = st._replace(gossip=g)
        if (ev.delay >= 0).any():
            d = row("delay")
            st = st._replace(
                ingress_loss=torch.where(d >= 0, d, st.ingress_loss))
        for src, topic, slot, valid in zip(ev.pub_src, ev.pub_topic,
                                           ev.pub_slot, ev.pub_valid):
            if src >= 0 and topic >= 0:
                st = self.publish(st, int(src), min(max(int(slot), 0),
                                                    self.m - 1), bool(valid))
        return st

    def _run_events(self, st: HybridState, events: MultiTopicEvents,
                    record: bool, rows=None):
        """The event loop on the wide view -> (wide final state, per-round
        record dicts, first recorded step)."""
        n_steps = int(events.kill.shape[0])
        rows = rows if rows is not None else _StagedRows(self, events)
        st = self._widen(st)
        first = st.gossip.step + 1
        hist = self._hist_seed(st) if record else None
        rounds: List[Dict[str, torch.Tensor]] = []
        for t in range(n_steps):
            ev = MultiTopicEvents(*(plane[t] for plane in events))
            st = self._apply_events(st, ev, lambda name: rows.row(name, t))
            if not record:
                st = self._finish_round(self._step_core(st)[0])
                continue
            # Publisher self-receipts land in bin 0 (GossipSub's rule).
            g = st.gossip
            pubs = [int(s) for s, tp, v in zip(ev.pub_src, ev.pub_topic,
                                               ev.pub_valid)
                    if s >= 0 and tp >= 0 and v]
            if pubs:
                counted = torch.stack([g.alive[s] & g.subscribed[s]
                                       for s in pubs]).sum(dtype=torch.int32)
                hist = torch.cat([hist[:1] + counted, hist[1:]])
            st, hist = self._advance(st, hist)
            rounds.append(self.flight_record_round(st, hist))
        return st, rounds, first

    def rollout_events(self, st: HybridState, events: MultiTopicEvents,
                       record: bool = True, rows=None):
        """Run a ``MultiTopicEvents`` schedule (host numpy, T = 1) ->
        (final state, host flight record | None).  ``kill``/``mute_*`` hit
        the embedded gossip state, ``delay`` rows set ``ingress_loss``
        (decimation), publishes seed both planes.  The event rows go to the
        device once (``rows`` supplies them already staged)."""
        st, rounds, first = self._run_events(st, events, record, rows)
        if not record:
            return self._narrow(st), None
        return self._narrow(st), record_to_host(
            self._stacked(rounds, first), self.device)

    def stream_chunk(self, st: HybridState, events: MultiTopicEvents,
                     rows=None) -> Tuple[HybridState, Dict[str, torch.Tensor]]:
        """One streaming-engine chunk: ``rollout_events`` with the record
        on, returning the last round's channels as device tensors (the
        reference engine's flight tail, ``step`` included)."""
        st, rounds, first = self._run_events(st, events, True, rows)
        tail = dict(rounds[-1])
        tail["step"] = torch.full((), first + len(rounds) - 1,
                                  dtype=torch.int32, device=self.device)
        return self._narrow(st), tail

    # -- flight recorder / views --------------------------------------------

    def flight_record_round(self, st: HybridState,
                            lat_hist: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The embedded GossipSub's channels plus the coded-edge count and
        the mean loss estimate over wired slots."""
        rec = self.gs.flight_record_round(st.gossip, lat_hist)
        wired = st.gossip.nbr_valid
        rec["coded_edges"] = (st.coded & wired).sum(dtype=torch.int32)
        rec["loss_ewma_mean"] = reduce_order.xla_sum(
            torch.where(wired, st.loss_ewma, 0.0)) / torch.clamp(
                wired.sum(dtype=torch.int32), min=1)
        return rec

    def delivery_stats(self, st: HybridState):
        return self.gs.delivery_stats(st.gossip)

    def stream_digest(self, st: HybridState) -> Dict[str, torch.Tensor]:
        """Per-slot completion counters in the engine's [T=1, ...] shapes,
        counted from ``first_step`` (which the coded merge stamps too)."""
        g = st.gossip
        part = g.alive & g.subscribed
        delivered = ((g.first_step >= 0) & part[:, None]).sum(
            dim=0, dtype=torch.int32)
        return {
            "delivered": delivered[None, :],
            "participants": part.sum(dtype=torch.int32)[None],
            "msg_used": g.msg_used[None, :],
            "msg_valid": g.msg_valid[None, :],
            "msg_birth": g.msg_birth[None, :],
            "step": g.step,
        }

    def stream_deliver_steps(self, st: HybridState, chunk_steps: int,
                             completion_frac: float) -> torch.Tensor:
        """int32[1, M]: the round of the chunk that just ran at which the
        count of participants with ``first_step <= round`` first reached
        ``max(1, completion_frac * participants)``; the chunk's first round
        when it was crossed before, -1 where it has not been."""
        g = st.gossip
        part = g.alive & g.subscribed
        target = torch.clamp((completion_frac * part.sum(
            dtype=torch.int32).to(torch.float32)).to(torch.int32), min=1)
        valid = (g.first_step >= 0) & part[:, None]
        cand = torch.arange(g.step - chunk_steps, g.step, dtype=torch.int32,
                            device=self.device)
        counts = torch.stack([
            (valid & (g.first_step <= int(c))).sum(dim=0, dtype=torch.int32)
            for c in range(g.step - chunk_steps, g.step)])       # [S, M]
        crossed = counts >= target
        first = torch.argmax(crossed.to(torch.uint8), dim=0)
        return torch.where(crossed.any(dim=0), cand[first], -1)[None, :]

    def decode_rank_summary(self, st: HybridState) -> Dict[str, int]:
        """Host-side decode progress for checkpoint meta: (peer, generation)
        bases mid-decode and fully decoded over live generations."""
        g = st.gossip
        rank = gf256.gf_rank(st.basis).cpu().numpy()
        live = (g.msg_used & g.msg_valid & g.msg_active).cpu().numpy()[None, :]
        return {
            "partial": int(((rank > 0) & (rank < self.gen_size) & live).sum()),
            "full": int(((rank == self.gen_size) & live).sum()),
        }
