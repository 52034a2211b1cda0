"""Multi-topic GossipSub: T independent meshes over one shared topology.

Port of the JAX package's ``models/multitopic.py``.  Everything keyed by
topic carries a leading ``T`` axis; the connection topology (``nbrs``/
``rev``/``nbr_valid``/``outbound``), liveness, the global score counters
and the cached aggregate score are shared.  A neighbor's score is the sum
of its per-topic components over all topics plus the global components
(the v1.1 aggregation rule), and subscription is a per-(topic, peer) mask
folded into the topic's liveness view.

Where the reference ``jax.vmap``s the single-topic round over topics, the
port loops over the topics in topic order:

- ``_propagate`` builds each topic's single-topic ``GossipState`` and runs
  the single-topic ``GossipSub._propagate`` on it, so kernel K1 launches
  ``T`` times a round on a card;
- ``_heartbeat`` runs each topic's mesh maintenance and its IHAVE/IWANT
  exchange (``exchange_prep`` + kernel K2 + un-permute), so K2 launches
  ``T`` times a heartbeat; PX threads the shared adjacency through the
  topics in order, as the reference's ``lax.scan`` does.

Differences of form from the reference, none of which changes a bit of
state: ``step`` is a host ``int`` (the heartbeat schedule and the
opportunistic-graft ticks are host branches); the ``edge_live`` refresh
after PX is a ``torch.where`` over both of the reference's ``lax.cond``
branches; ``rollout_events`` is a host loop whose event tests are ``if``s
on the numpy rows.  The sharded path (``multitopic_state_shardings``) is
not ported.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import GossipSubParams, ScoreParams
from ..ops import bitpack
from ..ops import cuda_gossip
from ..ops import histogram as hist_ops
from ..ops import rng
from ..ops import scoring as scoring_ops
from ..ops.gossip import heartbeat_mesh
from ..ops.gossip_packed import exchange_prep
from ..ops.graphs import decode_index_plane, safe_gather, top_mask
from ..ops.px import px_rewire
from ..ops.schedule import MultiTopicEvents
from ..ops.scoring import GlobalCounters, TopicCounters, segment_sum
from .gossipsub import (
    _AGE_CAP,
    FLIGHT_HIST_BINS,
    GossipState,
    GossipSub,
    _nanquantile_int,
)

# MultiTopicEvents fields whose rows go to the device (publishes stay host
# ints).
EVENT_ROWS = ("kill", "mute_on", "mute_off", "delay")


class MultiTopicState(NamedTuple):
    """The reference's ``MultiTopicState``, field for field.  Packed words
    and the keys are int32 bit patterns; ``nbrs``/``rev`` are stored narrow
    (``ops.graphs.index_dtype``)."""

    # shared
    nbrs: torch.Tensor          # [N, K] remote peer id (narrow storage)
    rev: torch.Tensor           # [N, K] remote's slot back to me (narrow)
    nbr_valid: torch.Tensor     # bool[N, K]
    outbound: torch.Tensor      # bool[N, K] I dialed this edge
    alive: torch.Tensor         # bool[N]
    subscribed: torch.Tensor    # bool[T, N]
    edge_live: torch.Tensor     # bool[T, N, K] valid & remote alive+subscribed
    gcounters: GlobalCounters   # per-peer [N]
    scores: torch.Tensor        # f32[N, K] aggregate (cached at heartbeat)
    # per-topic (leading T)
    mesh: torch.Tensor          # bool[T, N, K]
    fanout: torch.Tensor        # bool[T, N, K] non-subscribed publishers
    fanout_age: torch.Tensor    # int32[T, N]
    backoff: torch.Tensor       # int32[T, N, K]
    counters: TopicCounters     # f32[T, N, K] leaves
    have_w: torch.Tensor        # int32[T, N, W]
    fresh_w: torch.Tensor       # int32[T, N, W]
    gossip_pend_w: torch.Tensor  # int32[T, N, W]
    iwant_pend_w: torch.Tensor   # int32[T, N, W]
    gossip_mute: torch.Tensor   # bool[N] promise-breakers (every topic)
    gossip_delay: torch.Tensor  # int32[N] ingress gossip latency (links)
    pend_hold: torch.Tensor     # int32[T, N]
    first_step: torch.Tensor    # int32[T, N, M]
    msg_valid: torch.Tensor     # bool[T, M]
    msg_birth: torch.Tensor     # int32[T, M]
    msg_active: torch.Tensor    # bool[T, M]
    msg_used: torch.Tensor      # bool[T, M]
    keys: torch.Tensor          # int32[T, 2] per-topic threefry keys
    step: int                   # round counter, owned by the host


def edge_live_stack(nbr_valid, nbrs, topic_alive) -> torch.Tensor:
    """bool[T, N, K]: slot wired and its remote alive in the topic (the
    reference's ``vmap(compute_edge_live)`` over ``topic_alive[T, N]``)."""
    wide = decode_index_plane(nbrs)
    remote = topic_alive[:, torch.clamp(wide, 0, nbr_valid.shape[0] - 1).long()]
    return nbr_valid[None] & (wide >= 0)[None] & remote


def fires(name: str, plane: np.ndarray) -> np.ndarray:
    """bool[T]: the steps where event row ``name`` acts (a delay row where
    any entry is >= 0, the others where any is set)."""
    return (plane >= 0).any(axis=1) if name == "delay" else plane.any(axis=1)


class _StagedRows:
    """A schedule's device-bound event rows: for each field, only the rows
    of the steps where it fires, copied to the device once."""

    def __init__(self, model: "MultiTopicGossipSub", events: MultiTopicEvents):
        self._rows = {}
        for name in EVENT_ROWS:
            plane = getattr(events, name)
            steps = np.flatnonzero(fires(name, plane))
            if steps.size:
                self._rows[name] = (
                    {int(t): j for j, t in enumerate(steps)},
                    model.gs._stage(plane[steps]))

    def row(self, name: str, t: int) -> torch.Tensor:
        index, rows = self._rows[name]
        return rows[index[t]]


class MultiTopicGossipSub:
    """T-topic GossipSub simulator sharing one connection graph; state
    lives on ``device`` (default ``"cuda"``, which raises without a card)."""

    def __init__(
        self,
        n_topics: int = 4,
        n_peers: int = 1024,
        n_slots: int = 32,
        conn_degree: int = 16,
        msg_window: int = 128,
        params: Optional[GossipSubParams] = None,
        score_params: Optional[ScoreParams] = None,
        heartbeat_steps: int = 8,
        index_dtype_override=None,
        device="cuda",
    ):
        self.t = n_topics
        self.gs = GossipSub(
            n_peers=n_peers, n_slots=n_slots, conn_degree=conn_degree,
            msg_window=msg_window, params=params, score_params=score_params,
            heartbeat_steps=heartbeat_steps,
            index_dtype_override=index_dtype_override, device=device,
        )
        self.device = self.gs.device
        self.n, self.k, self.m, self.w = (
            self.gs.n, self.gs.k, self.gs.m, self.gs.w)
        self.params = self.gs.params
        self.score_params = self.gs.score_params
        self.heartbeat_steps = heartbeat_steps
        self._consts: Optional[Dict[str, torch.Tensor]] = None

    # Value semantics (the reference's): the model is (n_topics, the inner
    # single-topic config), so caches keyed on it survive an equal instance.
    def __eq__(self, other):
        return (type(other) is type(self)
                and (self.t, self.gs) == (other.t, other.gs))

    def __hash__(self):
        return hash((type(self), self.t, self.gs))

    def _constants(self) -> Dict[str, torch.Tensor]:
        """The per-topic ``GossipState``'s fixed leaves, allocated once:
        no per-edge delay, no self-promoters, all neighbors subscribed (the
        topic liveness already masks them), inactive fanout age."""
        if self._consts is None:
            n, k, w, dev = self.n, self.k, self.w, self.device
            self._consts = dict(
                ones_nk=torch.ones((n, k), dtype=torch.bool, device=dev),
                inactive_age=torch.full((n,), _AGE_CAP, dtype=torch.int32,
                                        device=dev),
                no_edge_delay=torch.zeros((n, k), dtype=torch.int32,
                                          device=dev),
                no_hist=torch.zeros((n, 0, w), dtype=torch.int32, device=dev),
                no_promo=torch.zeros(n, dtype=torch.bool, device=dev),
            )
        return self._consts

    # -- construction -------------------------------------------------------

    def init(self, seed: int = 0,
             subscribed: Optional[np.ndarray] = None) -> MultiTopicState:
        """Fresh state after 3 warmup heartbeats; ``subscribed`` (bool[T,
        N]) masks topic membership (default: every peer in every topic)."""
        nbrs, rev, nbr_valid, outbound = self.gs.build_graph(seed)
        t, n, k, m, w, dev = self.t, self.n, self.k, self.m, self.w, self.device
        if subscribed is None:
            subscribed = np.ones((t, n), bool)
        subscribed = np.asarray(subscribed)
        if subscribed.shape != (t, n):
            raise ValueError(f"subscribed must be [T={t}, N={n}]")
        sub = self.gs._t(subscribed, torch.bool)
        alive0 = torch.ones(n, dtype=torch.bool, device=dev)

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        st = MultiTopicState(
            nbrs=nbrs,
            rev=rev,
            nbr_valid=nbr_valid,
            outbound=outbound,
            alive=alive0,
            subscribed=sub,
            edge_live=edge_live_stack(nbr_valid, nbrs, alive0[None] & sub),
            gcounters=GlobalCounters.zeros(n, device=dev),
            scores=zeros((n, k), torch.float32),
            mesh=zeros((t, n, k), torch.bool),
            fanout=zeros((t, n, k), torch.bool),
            fanout_age=torch.full((t, n), _AGE_CAP, dtype=torch.int32,
                                  device=dev),
            backoff=zeros((t, n, k), torch.int32),
            counters=TopicCounters(*(zeros((t, n, k), torch.float32)
                                     for _ in TopicCounters._fields)),
            have_w=zeros((t, n, w), torch.int32),
            fresh_w=zeros((t, n, w), torch.int32),
            gossip_pend_w=zeros((t, n, w), torch.int32),
            iwant_pend_w=zeros((t, n, w), torch.int32),
            gossip_mute=zeros(n, torch.bool),
            gossip_delay=zeros(n, torch.int32),
            pend_hold=zeros((t, n), torch.int32),
            first_step=torch.full((t, n, m), -1, dtype=torch.int32,
                                  device=dev),
            msg_valid=zeros((t, m), torch.bool),
            msg_birth=zeros((t, m), torch.int32),
            msg_active=zeros((t, m), torch.bool),
            msg_used=zeros((t, m), torch.bool),
            keys=rng.fold_in(rng.PRNGKey(seed, device=dev),
                             torch.arange(t, device=dev)),
            step=0,
        )
        return self._warmup(st)

    # Narrow index storage <-> the int32 view every round consumes.
    def _widen_indices(self, st: MultiTopicState) -> MultiTopicState:
        return st._replace(nbrs=decode_index_plane(st.nbrs),
                           rev=decode_index_plane(st.rev))

    def _narrow_indices(self, st: MultiTopicState) -> MultiTopicState:
        g = self.gs._narrow_indices(st)
        return st._replace(nbrs=g.nbrs, rev=g.rev)

    def _warmup(self, st: MultiTopicState) -> MultiTopicState:
        st = self._widen_indices(st)
        for _ in range(3):
            st = self._heartbeat(st)
        return self._narrow_indices(st)

    # -- events -------------------------------------------------------------

    def publish(self, st: MultiTopicState, topic: int, src: int, slot: int,
                valid) -> MultiTopicState:
        """Seed a message at ``src`` in ``topic``'s window ``slot`` (the
        slot recycled in that topic's planes only), with the single-topic
        first-hop rules: flood-publish to above-``publish_threshold`` topic
        peers, or fanout for a non-subscribed publisher when flooding is
        off.  ``valid`` is a host bool (the validation verdict)."""
        p, sp = self.params, self.score_params
        n, k, w = self.n, self.k, self.w
        topic, src, slot, valid = int(topic), int(src), int(slot), bool(valid)
        word, bit = divmod(slot, bitpack.WORD)
        bitv = bitpack.as_int32_bits(1 << bit)

        def cleared(plane):
            plane = plane.clone()
            plane[topic, :, word] &= ~bitv
            return plane

        have_w, fresh_w = cleared(st.have_w), cleared(st.fresh_w)
        pend_w, iwant_w = cleared(st.gossip_pend_w), cleared(st.iwant_pend_w)
        have_w[topic, src, word] |= bitv
        fresh_w[topic, src, word] |= bitv
        # Element stores of Python scalars go through ``fill_``: an indexed
        # assignment would copy the scalar from the host and synchronise.
        first_step = st.first_step.clone()
        first_step[topic, :, slot].fill_(-1)
        first_step[topic, src, slot].fill_(st.step)
        mv, mb = st.msg_valid.clone(), st.msg_birth.clone()
        ma, mu = st.msg_active.clone(), st.msg_used.clone()
        mv[topic, slot].fill_(valid)
        mb[topic, slot].fill_(st.step)
        ma[topic, slot].fill_(True)
        mu[topic, slot].fill_(True)
        # Advance the topic's key so back-to-back publishes within one step
        # draw fresh fanout randomness.
        kpub, knext = rng.split(st.keys[topic], 2).unbind(0)
        keys = st.keys.clone()
        keys[topic] = knext
        eligible = st.edge_live[topic, src] & (
            st.scores[src] >= sp.publish_threshold)
        fanout, fanout_age = st.fanout, st.fanout_age
        if p.flood_publish:
            targets = eligible
        else:
            cur = st.fanout[topic, src] & eligible
            want = torch.clamp(p.d - cur.sum(), 0, p.d).to(torch.int32)
            add = top_mask(
                torch.where((eligible & ~cur)[None, :],
                            rng.uniform(kpub, (1, k)), -torch.inf),
                want[None], kmax=p.d,
            )[0]
            newf = cur | add
            is_sub = st.subscribed[topic, src]
            targets = torch.where(is_sub, False, newf)
            fanout = st.fanout.clone()
            fanout[topic, src] = torch.where(is_sub, st.fanout[topic, src],
                                             newf)
            fanout_age = st.fanout_age.clone()
            fanout_age[topic, src] = torch.where(
                is_sub, st.fanout_age[topic, src], 0)
        # Offered copies land next round through the pend fold (valid
        # only); the hold arms only on an idle empty row that got a bit.
        rows = torch.where(targets, decode_index_plane(st.nbrs[src]), n).long()
        rows_c = torch.clamp(rows, 0, n - 1)
        pend_t = pend_w[topic]
        gathered = pend_t[rows_c]                                # [K, W]
        ext = torch.cat([pend_t, pend_t.new_zeros((1, w))])
        if valid:
            upd = gathered.clone()
            upd[:, word] |= bitv
        else:
            upd = gathered
        ext[rows] = upd
        pend_w[topic] = ext[:n]
        hold = st.pend_hold.clone()
        cur_hold = st.pend_hold[topic][rows_c]
        arm = (cur_hold <= 0) & (gathered == 0).all(dim=-1) & valid
        hold_ext = torch.cat([st.pend_hold[topic],
                              st.pend_hold.new_zeros(1)])
        hold_ext[rows] = torch.where(arm, st.gossip_delay[rows_c], cur_hold)
        hold[topic] = hold_ext[:n]
        return st._replace(
            have_w=have_w, fresh_w=fresh_w, gossip_pend_w=pend_w,
            iwant_pend_w=iwant_w, pend_hold=hold, first_step=first_step,
            msg_valid=mv, msg_birth=mb, msg_active=ma, msg_used=mu,
            fanout=fanout, fanout_age=fanout_age, keys=keys,
        )

    def set_gossip_delay(self, st: MultiTopicState, delay) -> MultiTopicState:
        """Shared per-peer ingress gossip latency (int32[N])."""
        return st._replace(gossip_delay=torch.as_tensor(
            delay, device=self.device).to(torch.int32))

    def set_gossip_mute(self, st: MultiTopicState, mask) -> MultiTopicState:
        """Mark peers (bool[N]) as promise-breakers in every topic."""
        return st._replace(gossip_mute=torch.as_tensor(
            mask, device=self.device).to(torch.bool))

    def kill_peers(self, st: MultiTopicState, mask) -> MultiTopicState:
        """Abrupt peer failure (bool[N]) in every topic."""
        alive = st.alive & ~torch.as_tensor(mask, device=self.device).to(
            torch.bool)
        return st._replace(alive=alive, edge_live=edge_live_stack(
            st.nbr_valid, st.nbrs, alive[None] & st.subscribed))

    # -- transition ---------------------------------------------------------

    def _topic_alive(self, st: MultiTopicState) -> torch.Tensor:
        """bool[T, N]: a peer takes part in a topic iff alive+subscribed."""
        return st.alive[None, :] & st.subscribed

    def _topic_state(self, st: MultiTopicState, t: int,
                     topic_alive: torch.Tensor) -> GossipState:
        """Topic ``t``'s single-topic ``GossipState`` (the reference's
        vmapped ``one`` assembles the same), shared leaves as they are."""
        c = self._constants()
        return GossipState(
            nbrs=st.nbrs, rev=st.rev, nbr_valid=st.nbr_valid,
            outbound=st.outbound, alive=topic_alive[t],
            subscribed=st.subscribed[t], edge_live=st.edge_live[t],
            nbr_sub=c["ones_nk"], mesh=st.mesh[t], fanout=st.fanout[t],
            fanout_age=c["inactive_age"], backoff=st.backoff[t],
            counters=TopicCounters(*(f[t] for f in st.counters)),
            gcounters=st.gcounters, scores=st.scores, have_w=st.have_w[t],
            fresh_w=st.fresh_w[t], gossip_pend_w=st.gossip_pend_w[t],
            iwant_pend_w=st.iwant_pend_w[t], gossip_mute=st.gossip_mute,
            self_promo=c["no_promo"], gossip_delay=st.gossip_delay,
            pend_hold=st.pend_hold[t], edge_delay=c["no_edge_delay"],
            fresh_hist=c["no_hist"], first_step=st.first_step[t],
            msg_valid=st.msg_valid[t], msg_birth=st.msg_birth[t],
            msg_active=st.msg_active[t], msg_used=st.msg_used[t],
            key=st.keys[t], step=st.step,
        )

    def _propagate(self, st: MultiTopicState) -> MultiTopicState:
        """One eager-push + pend-fold round in every topic: the
        single-topic round on each topic's state, in topic order (K1 runs
        once per topic on a card)."""
        topic_alive = self._topic_alive(st)
        outs = [self.gs._propagate(self._topic_state(st, t, topic_alive))
                for t in range(self.t)]

        def stack(name):
            return torch.stack([getattr(o, name) for o in outs])

        counters = TopicCounters(*(
            torch.stack([o.counters[i] for o in outs])
            for i in range(len(TopicCounters._fields))))
        return st._replace(
            counters=counters, have_w=stack("have_w"),
            fresh_w=stack("fresh_w"), gossip_pend_w=stack("gossip_pend_w"),
            iwant_pend_w=stack("iwant_pend_w"), pend_hold=stack("pend_hold"),
            first_step=stack("first_step"),
        )

    def _heartbeat(self, st: MultiTopicState) -> MultiTopicState:
        p, sp = self.params, self.score_params
        n, k, hb = self.n, self.k, self.heartbeat_steps

        # Tick + decay the topic counters per topic; decay globals once.
        cs = [
            scoring_ops.decay_topic_counters(scoring_ops.tick_mesh_clocks(
                TopicCounters(*(f[t] for f in st.counters)), st.mesh[t],
                p.heartbeat_interval_s), sp)
            for t in range(self.t)
        ]
        g = scoring_ops.decay_global_counters(st.gcounters, sp)

        # v1.1 aggregation: the topic components summed over topics (left
        # to right from a zero accumulator, the order of XLA's reduction
        # over T < 32), plus the remote's global components.
        total = torch.zeros((n, k), dtype=torch.float32, device=self.device)
        for c_t in cs:
            total = total + scoring_ops.topic_score(c_t, sp)
        remote = scoring_ops.global_score(g, sp)[
            torch.clamp(st.nbrs, 0, n - 1).long()]
        scores = torch.where(st.nbr_valid, total + remote, -torch.inf)

        topic_alive = self._topic_alive(st)
        do_og = ((st.step // hb) % p.opportunistic_graft_ticks) == 0
        fanout_ttl_hb = self.gs.fanout_ttl_heartbeats()
        age = st.step - st.msg_birth                              # [T, M]
        seen_expired = st.msg_used & (age > self.gs.seen_ttl_steps())
        gossip_ok = (st.msg_valid & st.msg_active
                     & (age <= p.history_gossip * hb))
        expired = st.msg_active & (age > p.history_length * hb)
        # One promise-breaker view of each slot's remote serves every topic.
        serve_ok = ~safe_gather(st.gossip_mute, st.nbrs, True)

        out: Dict[str, List[torch.Tensor]] = {}

        def put(**kw):
            for name, v in kw.items():
                out.setdefault(name, []).append(v)

        for t in range(self.t):
            khb, kgossip, kiwant, kfan, kpx, knext = rng.split(
                st.keys[t], 6).unbind(0)
            el, al = st.edge_live[t], topic_alive[t]
            new_mesh, grafted, pruned, bo2, bo_viol = heartbeat_mesh(
                khb, st.mesh[t], scores, st.nbrs, st.rev, el, al, p,
                st.backoff[t], st.outbound, do_og,
                og_threshold=sp.opportunistic_graft_threshold,
                ignore_backoff=self.gs.graft_spammers,
            )
            c2 = scoring_ops.on_graft(
                scoring_ops.on_prune(cs[t], pruned, sp), grafted)
            have_t = st.have_w[t]
            have2 = have_t & ~bitpack.pack(seen_expired[t])
            # gossip_packed.gossip_exchange_packed with its select run by K2:
            # the topic's possession advertises, the scrubbed one dedups.
            if min(p.d_lazy, k) <= 0:
                iwant_t = torch.zeros_like(have_t)
                broken_t = torch.zeros((n, k), dtype=torch.float32,
                                       device=self.device)
            else:
                x = exchange_prep(
                    kgossip, kiwant, have_t, new_mesh, st.nbrs, st.rev, el,
                    al, scores, bitpack.pack(gossip_ok[t]), p,
                    sp.gossip_threshold, serve_ok,
                )
                iwant_t, broken_p = cuda_gossip.exchange_select(
                    x.jidx_p, x.adv_ok_p, x.accept_p, x.serve_p, x.rows,
                    have2, al, p.max_ihave_length, p.max_iwant_length,
                )
                broken_t = broken_p.gather(1, x.inv.long())
            # Fanout upkeep for this topic's non-subscribed publishers.
            fage2 = torch.clamp(st.fanout_age[t] + 1, max=_AGE_CAP)
            factive = (fage2 <= fanout_ttl_hb) & ~st.subscribed[t] & st.alive
            feligible = el & (scores >= sp.publish_threshold)
            fkeep = st.fanout[t] & feligible
            fwant = torch.where(
                factive, torch.clamp(p.d - fkeep.sum(dim=1), 0, p.d), 0
            ).to(torch.int32)
            fadd = top_mask(
                torch.where(feligible & ~fkeep, rng.uniform(kfan, (n, k)),
                            -torch.inf),
                fwant, kmax=p.d,
            )
            put(mesh=new_mesh,
                fanout=torch.where(factive[:, None], fkeep | fadd, False),
                fanout_age=fage2, backoff=bo2, have_w=have2,
                gossip_pend_w=st.gossip_pend_w[t]
                & ~bitpack.pack(expired[t])[None, :],
                iwant_pend_w=iwant_t, keys=knext, bo_viol=bo_viol,
                broken=broken_t, pruned=pruned, kpx=kpx)
            put(**{f"c.{i}": v for i, v in enumerate(c2)})

        # P7 is global: backoff-violating GRAFTs and broken promises in any
        # topic accrue to the sender's one behaviour-penalty counter (broken
        # promises charged by remote id).  Both sums are integer-valued.
        broken = torch.stack(out["broken"]).sum(dim=0)
        promise_ids = torch.where(st.nbr_valid, st.nbrs, n).reshape(-1)
        promise_viol = segment_sum(broken.reshape(-1), promise_ids, n + 1)[:n]
        g = g._replace(
            behaviour_penalty=g.behaviour_penalty
            + torch.stack(out["bo_viol"]).sum(dim=0) + promise_viol)

        # PX on prune, serialized across topics in topic order: each call
        # rewires the shared adjacency the next topic's call sees.  Gossip
        # above ran on the pre-PX snapshot, as in the reference.
        nbrs2, rev2, nv2, ob2 = st.nbrs, st.rev, st.nbr_valid, st.outbound
        backoff, connected = [], []
        for t in range(self.t):
            px = px_rewire(
                out["kpx"][t], nbrs2, rev2, nv2, ob2, out["backoff"][t],
                out["mesh"][t], out["pruned"][t], scores, st.alive,
                sp.accept_px_threshold,
            )
            nbrs2, rev2, nv2, ob2 = px.nbrs, px.rev, px.nbr_valid, px.outbound
            backoff.append(px.backoff)
            connected.append(px.connected.any())
        # The reference regathers the liveness caches under lax.cond when a
        # PX edge formed; both branches agree otherwise.
        edge_live = torch.where(
            torch.stack(connected).any(),
            edge_live_stack(nv2, nbrs2, topic_alive), st.edge_live)
        return st._replace(
            nbrs=nbrs2, rev=rev2, nbr_valid=nv2, outbound=ob2,
            edge_live=edge_live,
            mesh=torch.stack(out["mesh"]),
            fanout=torch.stack(out["fanout"]),
            fanout_age=torch.stack(out["fanout_age"]),
            backoff=torch.stack(backoff),
            counters=TopicCounters(*(
                torch.stack(out[f"c.{i}"])
                for i in range(len(TopicCounters._fields)))),
            gcounters=g, scores=scores,
            have_w=torch.stack(out["have_w"]),
            gossip_pend_w=torch.stack(out["gossip_pend_w"]),
            iwant_pend_w=torch.stack(out["iwant_pend_w"]),
            msg_active=st.msg_active & ~expired,
            keys=torch.stack(out["keys"]),
        )

    def _step_wide(self, st: MultiTopicState) -> MultiTopicState:
        """One round on the int32 index view; the heartbeat schedule is
        taken on the host from ``st.step``."""
        st = self._propagate(st)
        if st.step % self.heartbeat_steps == self.heartbeat_steps - 1:
            st = self._heartbeat(st)
        return st._replace(step=st.step + 1)

    def step(self, st: MultiTopicState) -> MultiTopicState:
        """One network round in every topic, plus a heartbeat every
        ``heartbeat_steps`` rounds."""
        return self._narrow_indices(self._step_wide(self._widen_indices(st)))

    def run(self, st: MultiTopicState, n_steps: int) -> MultiTopicState:
        st = self._widen_indices(st)
        for _ in range(n_steps):
            st = self._step_wide(st)
        return self._narrow_indices(st)

    # -- scenario engine ----------------------------------------------------

    def flight_record_round(self, st: MultiTopicState
                            ) -> Dict[str, torch.Tensor]:
        """One round's telemetry across all topics as device scalars plus
        the int32[B] latency histogram, recounted from the stamp table
        (summed over topics); ``step`` is added by the caller."""
        topic_alive = self._topic_alive(st)                   # [T, N]
        in_window = st.msg_used & st.msg_valid                # [T, M]
        lat = st.first_step - st.msg_birth[:, None, :]
        counted = ((st.first_step >= 0) & topic_alive[:, :, None]
                   & in_window[:, None, :])
        seg = torch.where(counted, torch.clamp(lat, 0, FLIGHT_HIST_BINS - 1),
                          FLIGHT_HIST_BINS)
        hist = hist_ops._bin_counts(torch.ones_like(seg), seg,
                                    FLIGHT_HIST_BINS)
        expected = (topic_alive.sum(dim=1, dtype=torch.int32)
                    * in_window.sum(dim=1, dtype=torch.int32)).sum(
                        dtype=torch.int32)
        mesh_deg = (st.mesh & st.nbr_valid[None]).sum(dim=2,
                                                       dtype=torch.int32)
        part_total = torch.clamp(topic_alive.sum(dtype=torch.int32), min=1)
        return {
            "peers_alive": st.alive.sum(dtype=torch.int32),
            "delivery_frac": hist.sum(dtype=torch.int32)
            / torch.clamp(expected, min=1),
            "mesh_degree_mean": torch.where(topic_alive, mesh_deg, 0).sum(
                dtype=torch.int32) / part_total,
            "gossip_pending": bitpack.popcount(st.gossip_pend_w).sum(
                dtype=torch.int32),
            "lat_hist": hist,
        }

    def _apply_events(self, st: MultiTopicState, ev: MultiTopicEvents,
                     row) -> MultiTopicState:
        """Apply one step's rows of a ``MultiTopicEvents`` schedule (host
        numpy) in the reference's order: kills, mute, delay, publishes.
        Each test of whether a kind fires is a host ``if`` on the numpy
        row; ``row(name)`` gives the row staged on the device."""
        if ev.kill.any():
            alive = st.alive & ~row("kill")
            st = st._replace(alive=alive, edge_live=edge_live_stack(
                st.nbr_valid, st.nbrs, alive[None] & st.subscribed))
        if ev.mute_on.any() or ev.mute_off.any():
            mute = st.gossip_mute
            if ev.mute_off.any():
                mute = mute & ~row("mute_off")
            if ev.mute_on.any():
                mute = mute | row("mute_on")
            st = st._replace(gossip_mute=mute)
        if (ev.delay >= 0).any():
            d = row("delay")
            st = st._replace(
                gossip_delay=torch.where(d >= 0, d, st.gossip_delay))
        for topic, src, slot, valid in zip(ev.pub_topic, ev.pub_src,
                                           ev.pub_slot, ev.pub_valid):
            if src >= 0 and topic >= 0:
                st = self.publish(st, min(int(topic), self.t - 1), int(src),
                                  min(max(int(slot), 0), self.m - 1),
                                  bool(valid))
        return st

    def rollout_events(self, st: MultiTopicState, events: MultiTopicEvents,
                       record: bool = True, rows=None):
        """Run a whole event schedule (``ops.schedule.MultiTopicEvents``,
        host numpy) -> (final state, flight record | None).  Events at step
        t apply before round t.  The rows that carry an event are copied
        to the device once, before the first round (``rows`` supplies them
        already staged), and no round reads the device.  With ``record``
        each round adds :meth:`flight_record_round`; the record comes back
        as host numpy channels, read once after the last round."""
        n_steps = int(events.kill.shape[0])
        rows = rows if rows is not None else _StagedRows(self, events)
        st = self._widen_indices(st)
        rounds: List[Dict[str, torch.Tensor]] = []
        first = st.step + 1
        for t in range(n_steps):
            ev = MultiTopicEvents(*(plane[t] for plane in events))
            st = self._apply_events(st, ev, lambda name: rows.row(name, t))
            st = self._step_wide(st)
            if record:
                rounds.append(self.flight_record_round(st))
        st = self._narrow_indices(st)
        if not record:
            return st, None
        record_ys = {
            name: torch.stack([r[name] for r in rounds]) for name in rounds[0]
        } if rounds else {}
        record_ys["step"] = torch.arange(first, first + n_steps,
                                         dtype=torch.int32, device=self.device)
        return st, self.gs._to_host(record_ys)

    # -- views / metrics ----------------------------------------------------

    def have_bool(self, st: MultiTopicState) -> torch.Tensor:
        """bool[T, N, M] possession view."""
        return bitpack.unpack(st.have_w, self.m)

    def delivery_stats(self, st: MultiTopicState):
        """Per-topic (frac f32[T, M], p50 f32[T], p99 f32[T]) over
        subscribed+alive peers."""
        topic_alive = self._topic_alive(st)
        have = self.have_bool(st)
        alive_n = torch.clamp(topic_alive.sum(dim=1, dtype=torch.int32), min=1)
        delivered = (have & topic_alive[:, :, None]).sum(dim=1,
                                                         dtype=torch.int32)
        frac = torch.where(st.msg_used & st.msg_valid,
                           delivered / alive_n[:, None], torch.nan)
        lat = torch.where(st.first_step >= 0,
                          st.first_step - st.msg_birth[:, None, :], -1)
        ok = ((lat >= 0) & st.msg_used[:, None, :] & st.msg_valid[:, None, :]
              & topic_alive[:, :, None])
        p50 = torch.stack([_nanquantile_int(lat[t], ok[t], 0.5)
                           for t in range(self.t)])
        p99 = torch.stack([_nanquantile_int(lat[t], ok[t], 0.99)
                           for t in range(self.t)])
        return frac, p50, p99

    def stream_digest(self, st: MultiTopicState) -> Dict[str, torch.Tensor]:
        """Per-slot completion counters for the streaming engine (device
        tensors; ``step`` is the host int)."""
        topic_alive = self._topic_alive(st)
        have = self.have_bool(st)
        return {
            "delivered": (have & topic_alive[:, :, None]).sum(
                dim=1, dtype=torch.int32),                       # [T, M]
            "participants": topic_alive.sum(dim=1, dtype=torch.int32),
            "msg_used": st.msg_used,
            "msg_valid": st.msg_valid,
            "msg_birth": st.msg_birth,
            "step": st.step,
        }

    def stream_deliver_steps(self, st: MultiTopicState, chunk_steps: int,
                             completion_frac: float) -> torch.Tensor:
        """int32[T, M]: the round of the chunk that just ran at which the
        count of participants with ``first_step <= round`` first reached
        ``max(1, completion_frac * participants[t])``; the chunk's first
        round when it was crossed before, -1 where it has not been."""
        topic_alive = self._topic_alive(st)
        participants = topic_alive.sum(dim=1, dtype=torch.int32)
        targets = torch.clamp(
            (participants.to(torch.float32) * completion_frac).to(torch.int32),
            min=1)
        valid = (st.first_step >= 0) & topic_alive[:, :, None]
        cand = torch.arange(st.step - chunk_steps, st.step, dtype=torch.int32,
                            device=self.device)
        counts = torch.stack([
            (valid & (st.first_step <= int(c))).sum(dim=1, dtype=torch.int32)
            for c in range(st.step - chunk_steps, st.step)], dim=1)  # [T,S,M]
        crossed = counts >= targets[:, None, None]
        first = torch.argmax(crossed.to(torch.uint8), dim=1)
        return torch.where(crossed.any(dim=1), cand[first], -1)
