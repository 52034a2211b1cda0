"""A plain GossipSub v1.1 network on unpacked boolean planes.

The reference against which the closed loop's outputs are judged.  It is
written from the protocol (libp2p's gossipsub v1.0 and v1.1 specs) and
from the deployment's configuration, one peer's row of each plane at a
time in spirit, vectorised over peers: no packed words, no kernels, no
code of the program.  What the simulation fixes beyond the spec, it
fixes here as rules:

- Time is in rounds; a heartbeat closes every ``heartbeat_steps``-th
  round (after that round's propagation), and the state's ``step`` then
  advances.  A message is a slot of an M-message window.
- Possession is ``have`` [N, M]; ``fresh`` marks the first receipts of the
  last round, which mesh neighbours relay this round; ``pend`` holds
  copies offered by a flood publish or granted by an IWANT, which land
  at the start of the next round.  A peer keeps and relays a message only
  when it is valid; an invalid first arrival is still stamped.
- Every random choice is a float32 uniform draw (``reference/rng.py``)
  over the [N, K] slot plane under a key split from the state's key, and
  "pick c at random among eligible slots" keeps the c eligible slots of
  largest draw, ties to the lower slot.
- Peer scores are the spec's weighted sum, worked out exactly (float64)
  from the counters and rounded once to the state's float type; every
  counter update is one operation in that type.

A state is a dict of tensors.  ``float_dtype`` is the configuration's
float32; the control computes the same reference in bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from . import rng

AGE_CAP = (2**31 - 1) // 2      # a fanout age that never expires by itself
HIST_BINS = 32                  # latency bins of the flight record
SCORE_BINS = 128                # bins of the recorded score quantiles
NEG_INF = float("-inf")
CUBE_ELEMS = 1 << 24            # elements of one [rows, K, M] block


class Network:
    """One topic over ``n_peers`` peers, ``n_slots`` connection slots each,
    an ``msg_window``-message window; ``config`` is the configuration
    file's dict."""

    def __init__(self, config: dict, device, float_dtype=torch.float32):
        p, sp = config["params"], config["score_params"]
        if not p["flood_publish"] or p["idontwant"]:
            raise ValueError("the reference runs flood publishing without "
                             "IDONTWANT, as the configuration states")
        self.p, self.sp = p, sp
        self.n, self.k, self.m = (config["n_peers"], config["n_slots"],
                                  config["msg_window"])
        self.hb = config["heartbeat_steps"]
        self.dev = torch.device(device)
        self.F = float_dtype
        self.block = max(1, CUBE_ELEMS // (self.k * self.m))

    # -- helpers ------------------------------------------------------------

    def f(self, v) -> float:
        """A configuration number as a value of the state's float type."""
        return float(torch.tensor(float(v), dtype=self.F))

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.dev)

    def pick(self, draw: torch.Tensor, eligible: torch.Tensor, count
             ) -> torch.Tensor:
        """Per row, the ``count`` eligible slots of largest ``draw`` (ties
        to the lower slot); ``count`` an int or an int tensor [N]."""
        vals = torch.where(eligible, draw.double(), NEG_INF)
        order = torch.argsort(-vals, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        if not isinstance(count, torch.Tensor):
            count = torch.full((vals.shape[0],), int(count),
                               device=self.dev)
        return eligible & (rank < count[:, None])

    def remote(self, plane: torch.Tensor, st) -> torch.Tensor:
        """``plane`` read at each slot's other end: the remote peer's
        value at the slot that points back."""
        j = st["nbrs"].clamp(0, self.n - 1)
        r = st["rev"].clamp(0, self.k - 1)
        return plane[j, r]

    def at_nbrs(self, per_peer: torch.Tensor, nbrs, fill) -> torch.Tensor:
        """``per_peer[nbrs]``, ``fill`` where a slot is empty (-1)."""
        got = per_peer[nbrs.clamp(0, self.n - 1)]
        return torch.where(nbrs >= 0, got, fill)

    @staticmethod
    def cap_per_word(sets: torch.Tensor, max_len: int) -> torch.Tensor:
        """A message set [..., M] cut to whole 32-message words while the
        running count stays within ``max_len``."""
        m = sets.shape[-1]
        words = -(-m // 32)
        padded = torch.nn.functional.pad(sets, (0, words * 32 - m))
        grouped = padded.reshape(sets.shape[:-1] + (words, 32))
        running = torch.cumsum(grouped.sum(-1), dim=-1)
        keep = (running <= max_len)[..., None]
        return (grouped & keep).reshape(sets.shape[:-1] + (words * 32,))[
            ..., :m]

    # -- the state ----------------------------------------------------------

    def start(self, topology, seed: int) -> Dict[str, object]:
        """The state a run starts from: ``topology`` (nbrs, rev,
        nbr_valid, outbound; -1 marks an empty slot), every peer alive and
        subscribed, the key of ``seed``, then three heartbeats at step 0."""
        n, k, m, F = self.n, self.k, self.m, self.F
        nbrs, rev, valid, outbound = (torch.as_tensor(a, device=self.dev)
                                      for a in topology)
        nbrs, rev = nbrs.long(), rev.long()
        alive = torch.ones(n, dtype=torch.bool, device=self.dev)
        st = dict(
            nbrs=nbrs, rev=rev, nbr_valid=valid.bool(),
            outbound=outbound.bool(), alive=alive, subscribed=alive.clone(),
            mesh=self.zeros((n, k), torch.bool),
            fanout=self.zeros((n, k), torch.bool),
            fanout_age=torch.full((n,), AGE_CAP, dtype=torch.int64,
                                  device=self.dev),
            backoff=self.zeros((n, k), torch.int64),
            scores=self.zeros((n, k), F),
            have=self.zeros((n, m), torch.bool),
            fresh=self.zeros((n, m), torch.bool),
            gossip_pend=self.zeros((n, m), torch.bool),
            iwant_pend=self.zeros((n, m), torch.bool),
            gossip_mute=self.zeros(n, torch.bool),
            self_promo=self.zeros(n, torch.bool),
            gossip_delay=self.zeros(n, torch.int64),
            pend_hold=self.zeros(n, torch.int64),
            edge_delay=self.zeros((n, k), torch.int64),
            first_step=torch.full((n, m), -1, dtype=torch.int64,
                                  device=self.dev),
            msg_valid=self.zeros(m, torch.bool),
            msg_birth=self.zeros(m, torch.int64),
            msg_active=self.zeros(m, torch.bool),
            msg_used=self.zeros(m, torch.bool),
            key=rng.key_of_seed(seed, self.dev), step=0,
            app_score=self.zeros(n, F),
            ip_group=torch.arange(n, device=self.dev),
            behaviour_penalty=self.zeros(n, F),
        )
        for name in ("time_in_mesh", "first_message_deliveries",
                     "mesh_message_deliveries", "mesh_failure_penalty",
                     "invalid_message_deliveries", "mesh_time_active"):
            st[name] = self.zeros((n, k), F)
        self.refresh_edges(st)
        for _ in range(3):
            self.heartbeat(st)
        return st

    def refresh_edges(self, st) -> None:
        """A slot is live when wired to a live peer, and carries the topic
        when that peer subscribes."""
        st["edge_live"] = st["nbr_valid"] & self.at_nbrs(
            st["alive"], st["nbrs"], False)
        st["nbr_sub"] = st["nbr_valid"] & self.at_nbrs(
            st["subscribed"], st["nbrs"], False)

    # -- publish ------------------------------------------------------------

    def publish(self, st, src: int, slot: int, valid: bool) -> None:
        """Peer ``src`` publishes into window slot ``slot`` (the slot's old
        message leaves every plane), with its validation verdict.  Flood
        publishing offers a valid message to every live topic neighbour
        scored at or above the publish threshold; the copies land next
        round."""
        valid = bool(valid)
        for plane in ("have", "fresh", "gossip_pend", "iwant_pend"):
            st[plane][:, slot] = False
        st["have"][src, slot] = True
        st["fresh"][src, slot] = True
        st["first_step"][:, slot] = -1
        st["first_step"][src, slot] = st["step"]
        st["msg_valid"][slot] = valid
        st["msg_birth"][slot] = st["step"]
        st["msg_active"][slot] = True
        st["msg_used"][slot] = True
        st["key"] = rng.split(st["key"], 2)[1]
        targets = (st["edge_live"][src] & st["nbr_sub"][src]
                   & (st["scores"][src] >= self.f(
                       self.sp["publish_threshold"])))
        rows = st["nbrs"][src][targets]
        if valid and rows.numel():
            idle = (st["pend_hold"][rows] <= 0) & ~st["gossip_pend"][rows].any(1)
            st["pend_hold"][rows] = torch.where(
                idle, st["gossip_delay"][rows], st["pend_hold"][rows])
            st["gossip_pend"][rows, slot] = True

    # -- one round ----------------------------------------------------------

    def propagate(self, st) -> torch.Tensor:
        """One round: due offered copies land, then every peer relays last
        round's valid first receipts to its mesh neighbours whose score
        is at or above the graylist threshold.  Returns the receipts
        stamped this round per message, counted over participating peers
        and valid messages of the window."""
        n, F = self.n, self.F
        ready = st["pend_hold"] <= 0
        landed = (st["gossip_pend"] & ready[:, None] & ~st["have"]
                  & st["alive"][:, None])
        held = st["gossip_pend"] & ~ready[:, None]
        have = st["have"] | landed
        relay = (st["mesh"] & (st["scores"] >= self.f(
            self.sp["graylist_threshold"])) & st["edge_live"]
            & self.at_nbrs(st["alive"], st["nbrs"], False))
        valid = st["msg_valid"] & st["msg_active"]
        new = self.zeros(have.shape, torch.bool)
        first_valid = self.zeros((n, self.k), torch.int64)
        first_invalid = self.zeros((n, self.k), torch.int64)
        copies = self.zeros((n, self.k), torch.int64)
        for lo in range(0, n, self.block):
            hi = min(n, lo + self.block)
            j = st["nbrs"][lo:hi].clamp(0, n - 1)
            incoming = relay[lo:hi, :, None] & st["fresh"][j]  # [B, K, M]
            arrived = incoming.any(1)
            fresh_new = arrived & ~have[lo:hi] & st["alive"][lo:hi, None]
            first_slot = incoming.to(torch.uint8).argmax(1)     # [B, M]
            credit = torch.nn.functional.one_hot(
                first_slot, self.k).permute(0, 2, 1).bool() & fresh_new[
                :, None, :]
            first_valid[lo:hi] = (credit & valid).sum(2)
            first_invalid[lo:hi] = (credit & ~valid).sum(2)
            copies[lo:hi] = (incoming & valid).sum(2)
            new[lo:hi] = fresh_new
        stamped = (landed | new) & (st["first_step"] < 0)
        st["first_step"] = torch.where(stamped, st["step"], st["first_step"])
        st["have"] = have | (new & valid)
        st["fresh"] = (new & valid) | landed
        st["first_message_deliveries"] = (
            st["first_message_deliveries"] + first_valid.to(F))
        st["mesh_message_deliveries"] = (
            st["mesh_message_deliveries"] + copies.to(F))
        st["invalid_message_deliveries"] = (
            st["invalid_message_deliveries"] + first_invalid.to(F))
        st["gossip_pend"] = held | st["iwant_pend"]
        st["iwant_pend"] = torch.zeros_like(st["iwant_pend"])
        incoming_next = st["gossip_pend"].any(1)
        st["pend_hold"] = torch.where(
            ready, torch.where(incoming_next, st["gossip_delay"], 0),
            st["pend_hold"] - 1)
        part = st["alive"] & st["subscribed"]
        counted = (stamped & part[:, None]
                   & (st["msg_used"] & st["msg_valid"])[None, :])
        return counted.sum(0)

    # -- scores -------------------------------------------------------------

    def neighbour_scores(self, st) -> torch.Tensor:
        """The spec's score of each neighbour slot: the topic's P1-P4
        (time in mesh, first deliveries, the mesh delivery deficit, the
        mesh failure penalty, invalid deliveries) and the peer's P5-P7
        (application score, IP colocation, behaviour penalty), summed
        exactly and rounded once; -inf on an empty slot."""
        sp, f = self.sp, self.f
        d = lambda name: st[name].double()  # noqa: E731
        p1 = torch.clamp(d("time_in_mesh") / f(sp["time_in_mesh_quantum_s"]),
                         max=f(sp["time_in_mesh_cap"]))
        p2 = torch.clamp(d("first_message_deliveries"),
                         max=f(sp["first_message_deliveries_cap"]))
        deficit = torch.clamp(
            f(sp["mesh_message_deliveries_threshold"]) - torch.clamp(
                d("mesh_message_deliveries"),
                max=f(sp["mesh_message_deliveries_cap"])), min=0.0)
        active = st["mesh_time_active"] >= f(
            sp["mesh_message_deliveries_activation_s"])
        p3 = torch.where(active, deficit * deficit, 0.0)
        p4 = d("invalid_message_deliveries") ** 2
        topic = (f(sp["time_in_mesh_weight"]) * p1
                 + f(sp["first_message_deliveries_weight"]) * p2
                 + f(sp["mesh_message_deliveries_weight"]) * p3
                 + f(sp["mesh_failure_penalty_weight"])
                 * d("mesh_failure_penalty")
                 + f(sp["invalid_message_deliveries_weight"]) * p4)
        topic = torch.clamp(topic * f(sp["topic_weight"]),
                            max=f(sp["topic_score_cap"]))
        group_size = torch.bincount(st["ip_group"] % self.n,
                                    minlength=self.n).double()
        surplus = torch.clamp(
            group_size[st["ip_group"] % self.n]
            - f(sp["ip_colocation_factor_threshold"]), min=0.0)
        excess = torch.clamp(
            st["behaviour_penalty"].double()
            - f(sp["behaviour_penalty_threshold"]), min=0.0)
        peer = (f(sp["app_specific_weight"]) * st["app_score"].double()
                + f(sp["ip_colocation_factor_weight"]) * surplus ** 2
                + f(sp["behaviour_penalty_weight"]) * excess ** 2)
        total = topic + peer[st["nbrs"].clamp(0, self.n - 1)]
        return torch.where(st["nbr_valid"], total, NEG_INF).to(self.F)

    def decay(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        x = x * self.f(rate)
        return torch.where(x < self.f(self.sp["decay_to_zero"]),
                           torch.zeros_like(x), x)

    # -- the heartbeat --------------------------------------------------------

    def heartbeat(self, st) -> None:
        """Score upkeep, mesh maintenance, peer exchange, IHAVE/IWANT
        gossip, fanout upkeep and the message cache's expiry."""
        p, sp, f, F = self.p, self.sp, self.f, self.F
        n, k = self.n, self.k
        k_mesh, k_gossip, k_iwant, k_fanout, k_px, k_next = rng.split(
            st["key"], 6)
        # Scores: the mesh clocks tick, the counters decay.
        dt = f(p["heartbeat_interval_s"])
        for name in ("time_in_mesh", "mesh_time_active"):
            st[name] = torch.where(st["mesh"], st[name] + dt, st[name])
        for name, rate in (
                ("first_message_deliveries",
                 "first_message_deliveries_decay"),
                ("mesh_message_deliveries", "mesh_message_deliveries_decay"),
                ("mesh_failure_penalty", "mesh_failure_penalty_decay"),
                ("invalid_message_deliveries",
                 "invalid_message_deliveries_decay")):
            st[name] = self.decay(st[name], sp[rate])
        st["behaviour_penalty"] = self.decay(st["behaviour_penalty"],
                                             sp["behaviour_penalty_decay"])
        scores = self.neighbour_scores(st)
        part = st["alive"] & st["subscribed"]
        edge_ok = st["edge_live"] & st["nbr_sub"]
        mesh, grafted, pruned, backoff, charged, offer_ok = self.mesh_upkeep(
            st, k_mesh, scores, edge_ok, part)
        # The P3b penalty of a pruned slot that was active with a deficit,
        # and the mesh clocks of pruned and grafted slots restart.
        deficit = torch.clamp(
            f(sp["mesh_message_deliveries_threshold"]) - torch.clamp(
                st["mesh_message_deliveries"],
                max=f(sp["mesh_message_deliveries_cap"])), min=0.0)
        active = st["mesh_time_active"] >= f(
            sp["mesh_message_deliveries_activation_s"])
        st["mesh_failure_penalty"] = st["mesh_failure_penalty"] + torch.where(
            pruned & active, deficit * deficit, torch.zeros_like(deficit))
        for name in ("time_in_mesh", "mesh_time_active"):
            st[name] = torch.where(pruned | grafted, torch.zeros_like(
                st[name]), st[name])
        st["behaviour_penalty"] = st["behaviour_penalty"] + charged.to(F)
        old_have = st["have"]
        self.peer_exchange(st, k_px, mesh, pruned, backoff, scores, offer_ok)
        self.refresh_edges(st)
        # The message cache: seen ids expire after the seen TTL; ids within
        # the gossip history are advertised.
        age = st["step"] - st["msg_birth"]
        seen_ttl = max(1, round(p["seen_ttl_s"] / p["heartbeat_interval_s"])
                       ) * self.hb
        have_seen = old_have & ~(st["msg_used"] & (age > seen_ttl))[None, :]
        gossip_ok = (st["msg_valid"] & st["msg_active"]
                     & (age <= p["history_gossip"] * self.hb))
        pend, broken = self.gossip(st, k_gossip, k_iwant, mesh, scores, part,
                                   old_have & gossip_ok[None, :], have_seen)
        ids = torch.where(st["nbr_valid"], st["nbrs"], n).reshape(-1)
        promised = torch.zeros(n + 1, dtype=torch.int64, device=self.dev)
        promised.index_add_(0, ids, broken.reshape(-1))
        st["behaviour_penalty"] = st["behaviour_penalty"] + promised[:n].to(F)
        self.fanout_upkeep(st, k_fanout, scores)
        expired = st["msg_active"] & (
            st["step"] - st["msg_birth"] > p["history_length"] * self.hb)
        st.update(mesh=mesh, scores=scores, have=have_seen,
                  gossip_pend=st["gossip_pend"] & ~expired[None, :],
                  iwant_pend=pend, msg_active=st["msg_active"] & ~expired,
                  key=k_next)

    def mesh_upkeep(self, st, key, scores, edge_ok, part):
        """The spec's mesh maintenance.  A peer drops mesh links of
        negative score; above D_high it keeps D: the D_score best scored
        and a random rest, then swaps random inbound ones for outbound ones
        up to D_out.  Below D_low it grafts random non-negative, unbacked-
        off peers up to D, and random outbound ones up to D_out; on an
        opportunistic-graft tick, when its mesh's median score is below
        the threshold, up to the configured number of peers scored above
        that median.  A link stays when both ends keep it, and forms when
        one end grafts and the other scores it non-negative with no
        backoff on its side.  A pruned link backs off; a graft into the
        remote's backoff is charged to the grafter's behaviour penalty."""
        p, sp, f = self.p, self.sp, self.f
        n, k = self.n, self.k
        k_keep, k_graft, k_og = rng.split(key, 3)
        usable = edge_ok & part[:, None]
        keep = st["mesh"] & usable & (scores >= 0.0)
        degree = keep.sum(1)
        noise = rng.uniform(k_keep, (n, k), maxval=1e-3)
        noisy_score = (scores + noise).double()
        best = self.pick(noisy_score, keep, p["d_score"])
        rest = self.pick(noise, keep & ~best, max(p["d"] - p["d_score"], 0))
        chosen = best | rest
        out = st["outbound"]
        if p["d_out"] > 0:
            short = torch.clamp(p["d_out"] - (chosen & out).sum(1), 0,
                                p["d_out"])
            swappable = (rest & ~out).sum(1)
            add = self.pick(noise, keep & out & ~chosen,
                            torch.minimum(short, swappable))
            drop = self.pick(noise, rest & ~out, add.sum(1))
            chosen = (chosen | add) & ~drop
        keep = keep & torch.where((degree > p["d_hi"])[:, None], chosen, True)
        degree = keep.sum(1)
        score_ok = scores >= 0.0
        no_backoff = st["backoff"] <= 0
        cand = usable & ~keep & score_ok & no_backoff
        draw = rng.uniform(k_graft, (n, k))
        want = torch.where(degree < p["d_lo"],
                           torch.clamp(p["d"] - degree, min=0), 0)
        graft = self.pick(draw, cand, want)
        if p["d_out"] > 0:
            have_out = ((keep | graft) & out).sum(1)
            graft = graft | self.pick(
                draw, cand & out & ~graft,
                torch.clamp(p["d_out"] - have_out, 0, p["d_out"]))
        tick = (st["step"] // self.hb) % p["opportunistic_graft_ticks"] == 0
        if p["opportunistic_graft_peers"] > 0 and tick:
            median = self.lower_median(scores, keep)
            og = torch.where(median < f(sp["opportunistic_graft_threshold"]),
                             p["opportunistic_graft_peers"], 0)
            graft = graft | self.pick(
                rng.uniform(k_og, (n, k)),
                cand & ~graft & (scores > median[:, None]), og)
        keep_r, graft_r = self.remote(keep, st), self.remote(graft, st)
        score_ok_r = self.remote(score_ok, st)
        no_backoff_r = self.remote(no_backoff, st)
        mesh = st["mesh"]
        new_mesh = usable & (
            (mesh & keep & keep_r)
            | (~mesh & ((graft & score_ok_r & no_backoff_r)
                        | (graft_r & score_ok & no_backoff))))
        grafted, pruned = new_mesh & ~mesh, mesh & ~new_mesh
        backoff = torch.where(pruned, p["prune_backoff_heartbeats"],
                              torch.clamp(st["backoff"] - 1, min=0))
        charged = (graft & ~no_backoff_r).sum(1)
        return new_mesh, grafted, pruned, backoff, charged, score_ok_r

    @staticmethod
    def lower_median(values: torch.Tensor, mask: torch.Tensor):
        """Per row, the lower median of the masked values; +inf where none
        are masked."""
        count = mask.sum(1)
        ordered = torch.sort(torch.where(mask, values, float("inf")),
                             dim=1).values
        idx = torch.clamp((count - 1) // 2, 0, values.shape[1] - 1)
        med = ordered.gather(1, idx[:, None])[:, 0]
        return torch.where(count > 0, med, float("inf"))

    def peer_exchange(self, st, key, mesh, pruned, backoff, scores,
                      offer_ok) -> None:
        """PX on prune: a peer pruned by a neighbour that still scores it
        non-negatively, and that scores the pruner at or above the
        accept-PX threshold, dials one random mesh peer of its first such
        pruner, when it is not connected yet, both have a free slot, it is
        not itself being dialled, and it is the lowest-numbered dialler of
        that peer this heartbeat.  The new link takes each end's first
        free slot, dialled on the initiator's side, with no backoff."""
        n, k = self.n, self.k
        ids = torch.arange(n, device=self.dev)
        nbrs, valid = st["nbrs"], st["nbr_valid"]
        j_all = nbrs.clamp(0, n - 1)
        offer = (pruned & offer_ok & valid
                 & (scores >= self.f(self.sp["accept_px_threshold"])))
        first = offer.to(torch.uint8).argmax(1)
        pruner = j_all[ids, first]
        pruner_mesh = mesh[pruner]
        draw = rng.uniform(key, (n, k)).double()
        cand = torch.where(pruner_mesh, draw, NEG_INF).argmax(1)
        target = j_all[pruner, cand]
        free = (~valid).sum(1)
        linked = ((nbrs == target[:, None]) & valid).any(1)
        dial = (offer.any(1) & pruner_mesh.any(1) & st["alive"]
                & st["alive"][target] & (target != ids) & ~linked
                & (free > 0))
        dial = dial & ~dial[target] & (free[target] > 0)
        lowest = torch.full((n + 1,), n, dtype=torch.int64, device=self.dev)
        lowest.scatter_reduce_(0, torch.where(dial, target, n), ids,
                               reduce="amin")
        win = dial & (lowest[target] == ids)
        slot = (~valid).to(torch.uint8).argmax(1)
        i, t = ids[win], target[win]
        si, st_ = slot[i], slot[t]
        for plane in ("nbrs", "rev", "nbr_valid", "outbound"):
            st[plane] = st[plane].clone()
        backoff = backoff.clone()
        st["nbrs"][i, si], st["nbrs"][t, st_] = t, i
        st["rev"][i, si], st["rev"][t, st_] = st_, si
        st["nbr_valid"][i, si] = True
        st["nbr_valid"][t, st_] = True
        st["outbound"][i, si] = True
        st["outbound"][t, st_] = False
        backoff[i, si] = 0
        backoff[t, st_] = 0
        st["backoff"] = backoff

    def gossip(self, st, k_emit, k_order, mesh, scores, part, offered,
               have_seen):
        """IHAVE/IWANT at the heartbeat.  Each participating peer
        advertises its cached window (``offered`` [N, M]) to
        max(D_lazy, gossip_factor x eligible) random non-mesh topic
        neighbours scored at or above the gossip threshold; a receiver
        takes IHAVEs only from such neighbours, asks each id it has not
        seen of its first advertiser in a random order of its slots, and
        the grant lands two rounds later.  IHAVE and IWANT lists are cut
        to their maximum lengths in whole 32-id words.  An ask to a peer
        that does not serve breaks a promise.  Returns (granted [N, M],
        broken promises [N, K] by the receiver's slot)."""
        p, f = self.p, self.f
        n, k, m = self.n, self.k, self.m
        edges = st["edge_live"] & st["nbr_sub"]
        accept = edges & (scores >= f(self.sp["gossip_threshold"]))
        eligible = accept & ~mesh & part[:, None]
        d_lazy = min(p["d_lazy"], k)
        if d_lazy <= 0:
            return (self.zeros((n, m), torch.bool),
                    self.zeros((n, k), torch.int64))
        share = torch.ceil(f(p["gossip_factor"]) * eligible.sum(1).double())
        emit = torch.clamp(share.long(), min=d_lazy)
        chosen = self.pick(rng.uniform(k_emit, (n, k)), eligible, emit)
        towards_me = self.remote(chosen, st) & edges
        order = torch.argsort(rng.uniform(k_order, (n, k)), dim=1,
                              stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        serve = ~self.at_nbrs(st["gossip_mute"], st["nbrs"], True)
        granted = self.zeros((n, m), torch.bool)
        broken = self.zeros((n, k), torch.int64)
        for lo in range(0, n, self.block):
            hi = min(n, lo + self.block)
            j = st["nbrs"][lo:hi].clamp(0, n - 1)
            ihave = towards_me[lo:hi, :, None] & offered[j]
            ihave = self.cap_per_word(ihave, p["max_ihave_length"])
            want = (ihave & ~have_seen[lo:hi, None, :]
                    & accept[lo:hi, :, None])
            pri = torch.where(want, rank[lo:hi, :, None].to(torch.int16),
                              torch.iinfo(torch.int16).max)
            first = want & (pri == pri.min(1, keepdim=True).values)
            asked = self.cap_per_word(first, p["max_iwant_length"])
            ok = serve[lo:hi, :, None]
            granted[lo:hi] = (asked & ok).any(1) & part[lo:hi, None]
            broken[lo:hi] = (asked & ~ok).sum(2)
        return granted, broken

    def fanout_upkeep(self, st, key, scores) -> None:
        """A publisher outside the topic keeps up to D random fanout peers
        at or above the publish threshold while it published within the
        fanout TTL; a subscriber keeps none."""
        p, f = self.p, self.f
        age = torch.clamp(st["fanout_age"] + 1, max=AGE_CAP)
        ttl = max(1, round(p["fanout_ttl_s"] / p["heartbeat_interval_s"]))
        active = (age <= ttl) & ~st["subscribed"] & st["alive"]
        ok = (st["edge_live"] & st["nbr_sub"]
              & (scores >= f(self.sp["publish_threshold"])))
        kept = st["fanout"] & ok
        want = torch.where(active, torch.clamp(p["d"] - kept.sum(1), 0,
                                               p["d"]), 0)
        added = self.pick(rng.uniform(key, (self.n, self.k)), ok & ~kept,
                          want)
        st["fanout"] = torch.where(active[:, None], kept | added, False)
        st["fanout_age"] = age

    # -- a recorded rollout ---------------------------------------------------

    def rollout(self, st, rounds: int) -> Dict[str, torch.Tensor]:
        """``rounds`` rounds, each closed by a heartbeat when due, with the
        flight record of every round."""
        rec = []
        first = st["step"] + 1
        hist = self.latency_histogram(st)
        for _ in range(rounds):
            stamp = st["step"]
            per_msg = self.propagate(st)
            if st["step"] % self.hb == self.hb - 1:
                self.heartbeat(st)
            st["step"] += 1
            counted = st["msg_used"] & st["msg_valid"]
            bins = torch.clamp(stamp - st["msg_birth"], 0, HIST_BINS - 1)
            hist = hist + torch.bincount(bins[counted],
                                         weights=per_msg[counted].double(),
                                         minlength=HIST_BINS).long()
            rec.append(self.record_round(st, hist))
        out = {name: torch.stack([r[name] for r in rec]) for name in rec[0]}
        out["step"] = torch.arange(first, first + rounds, device=self.dev)
        return out

    def latency_histogram(self, st) -> torch.Tensor:
        """Receipts of valid window messages by participating peers, by
        latency in rounds (the last bin holds the tail)."""
        part = st["alive"] & st["subscribed"]
        counted = ((st["first_step"] >= 0) & part[:, None]
                   & (st["msg_used"] & st["msg_valid"])[None, :])
        lat = torch.clamp(st["first_step"] - st["msg_birth"][None, :], 0,
                          HIST_BINS - 1)
        return torch.bincount(lat[counted], minlength=HIST_BINS)

    def record_round(self, st, hist) -> Dict[str, torch.Tensor]:
        part = st["alive"] & st["subscribed"]
        window = (st["msg_used"] & st["msg_valid"]).sum().clamp(min=1)
        degree = (st["mesh"] & st["nbr_valid"]).sum(1)
        part_n = part.sum().clamp(min=1)
        slots = st["nbr_valid"].sum(1).clamp(min=1)
        peer_score = torch.where(st["nbr_valid"], st["scores"].double(),
                                 0.0).sum(1) / slots
        quantiles, width = self.binned_quantiles(peer_score, part,
                                                 (0.1, 0.5, 0.9))
        return {
            "peers_alive": st["alive"].sum(),
            "delivery_frac": hist.sum().double() / (part_n * window),
            "mesh_degree_mean": torch.where(part, degree, 0).sum().double()
            / part_n,
            "mesh_degree_max": degree.max(),
            **dict(zip(("score_p10", "score_p50", "score_p90"), quantiles)),
            "gossip_pending": st["gossip_pend"].sum(),
            "lat_hist": hist.clone(),
            "score_bin_width": width,
        }

    @staticmethod
    def binned_quantiles(values, mask, qs: Sequence[float]):
        """Approximate quantiles and their bin width: the masked values in
        128 equal bins over their [min, max], each quantile read as the
        lower edge of the first bin whose running count exceeds
        (count - 1) q.  An infinite or empty range puts every value in the
        first bin, so every quantile reads the minimum (width 0)."""
        zero = values.new_zeros((), dtype=torch.float64)
        v = values[mask]
        if v.numel() == 0:
            return [zero + float("nan") for _ in qs], zero
        lo, hi = v.min(), v.max()
        if not (torch.isfinite(lo) and torch.isfinite(hi)) or hi <= lo:
            return [lo.clone() for _ in qs], zero
        width = (hi - lo) / (SCORE_BINS - 1)
        bins = torch.clamp(torch.floor((v - lo) / width), 0,
                           SCORE_BINS - 1).long()
        running = torch.cumsum(torch.bincount(bins, minlength=SCORE_BINS), 0)
        out = []
        for q in qs:
            rank = (v.numel() - 1) * q
            idx = int(torch.nonzero(running > rank)[0])
            out.append(lo + idx * width)
        return out, width

    def delivery_stats(self, st):
        """Per message, the share of participating peers that received it
        (NaN outside the valid window), and the 50th and 99th percentile
        (linear, the rank (count - 1) q taken in the state's float type)
        of the receipts' latencies in rounds."""
        part = st["alive"] & st["subscribed"]
        part_n = part.sum().clamp(min=1)
        got = ((st["first_step"] >= 0) & part[:, None]).sum(0)
        frac = torch.where(st["msg_used"] & st["msg_valid"],
                           got.double() / part_n, float("nan"))
        lat = st["first_step"] - st["msg_birth"][None, :]
        counted = ((st["first_step"] >= 0) & (lat >= 0) & part[:, None]
                   & (st["msg_used"] & st["msg_valid"])[None, :])
        vals = torch.sort(lat[counted].double()).values
        return (frac, self.quantile(vals, 0.5),
                self.quantile(vals, 0.99))

    def quantile(self, sorted_vals: torch.Tensor, q: float):
        """The linear ``q`` quantile of sorted values; NaN when there are
        none."""
        count = sorted_vals.numel()
        if count == 0:
            return sorted_vals.new_full((), float("nan"))
        rank = float(torch.tensor(count - 1, dtype=self.F)
                     * torch.tensor(q, dtype=self.F))
        lo, hi = math.floor(rank), math.ceil(rank)
        lo, hi = min(lo, count - 1), min(hi, count - 1)
        w = rank - math.floor(rank)
        return sorted_vals[lo] * (1 - w) + sorted_vals[hi] * w
