"""A plain multi-topic GossipSub v1.1 network on unpacked boolean planes.

The reference against which the stream cells' outputs are judged: T
topics over one connection graph, written from libp2p's gossipsub v1.1
spec and the deployment's configuration.  Each topic is one
``reference/gossipsub.py`` ``Network`` in everything a topic owns (its
mesh, its message window, its counters, its key), and this module adds
what the topics share:

- one connection graph and one liveness; a slot carries topic t when its
  remote is alive and subscribed to t;
- the peer score of v1.1's aggregation: each topic's P1-P4 times the
  topic's weight, summed over the topics and capped at the topic score
  cap, plus the peer's P5-P7 once, worked out exactly (float64) from the
  counters and rounded once to the state's float type; it is cached at
  the heartbeat and serves every topic;
- one behaviour-penalty counter a peer: backoff-violating GRAFTs and
  broken promises of every topic charge it;
- each topic's keys: the seed's key folded with the topic's index
  (``jax.random.fold_in``: the threefry hash of the counter pair (0, t)).

What the simulation fixes beyond the spec, it fixes here as rules: a
heartbeat runs each topic's mesh maintenance, then each topic's
IHAVE/IWANT exchange (on the connection graph as the heartbeat found
it), then each topic's fanout upkeep, and last PX on prune, topic after
topic, each topic's dials seeing the links the topics before it formed.

It covers the paths the stream cells run and no others: every peer alive
and subscribed to every topic (so no fanout publish), flood publishing,
no IDONTWANT, nobody muted, no per-edge delay.  A state is a dict: the
shared planes, and under ``"topics"`` one dict a topic.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import rng
from .gossipsub import AGE_CAP, HIST_BINS, NEG_INF, Network

# A topic's own planes, by the names the comparison reads them under.
TOPIC_PLANES = (
    "subscribed", "edge_live", "mesh", "fanout", "fanout_age", "backoff",
    "time_in_mesh", "first_message_deliveries", "mesh_message_deliveries",
    "mesh_failure_penalty", "invalid_message_deliveries", "mesh_time_active",
    "have", "fresh", "gossip_pend", "iwant_pend", "pend_hold", "first_step",
    "msg_valid", "msg_birth", "msg_active", "msg_used",
)
SHARED_PLANES = (
    "nbrs", "rev", "nbr_valid", "outbound", "alive", "app_score", "ip_group",
    "behaviour_penalty", "scores", "gossip_mute", "gossip_delay",
)
COUNTERS = ("time_in_mesh", "first_message_deliveries",
            "mesh_message_deliveries", "mesh_failure_penalty",
            "invalid_message_deliveries")
# A topic's planes and vectors with a message axis (the last).
MSG_PLANES = ("have", "fresh", "gossip_pend", "iwant_pend", "first_step",
              "msg_valid", "msg_birth", "msg_active", "msg_used")


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the threefry hash of the counter pair
    (0, data) under ``key``."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    x0, x1 = rng.threefry2x32(key, zero, zero + (int(data) & rng.MASK))
    return torch.cat([x0, x1])


class MultiNetwork:
    """``n_topics`` topics over ``n_peers`` peers; ``config`` is the
    configuration file's dict."""

    def __init__(self, config: dict, device, float_dtype=torch.float32):
        self.net = Network(config, device, float_dtype)
        self.t = int(config["n_topics"])
        self.n, self.k, self.m = self.net.n, self.net.k, self.net.m
        self.hb = self.net.hb
        self.p, self.sp, self.F = self.net.p, self.net.sp, float_dtype
        self.dev = self.net.dev

    # -- the state ------------------------------------------------------------

    def start(self, topology, seed: int) -> Dict[str, object]:
        """The state a run starts from: ``topology`` (nbrs, rev,
        nbr_valid, outbound; -1 marks an empty slot), every peer alive and
        subscribed to every topic, topic t's key folded from the key of
        ``seed``, then three heartbeats at step 0."""
        n, k, m, F, dev = self.n, self.k, self.m, self.F, self.dev
        nbrs, rev, valid, outbound = (torch.as_tensor(a, device=dev)
                                      for a in topology)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        alive = torch.ones(n, dtype=torch.bool, device=dev)
        st = dict(nbrs=nbrs.long(), rev=rev.long(), nbr_valid=valid.bool(),
                  outbound=outbound.bool(), alive=alive,
                  app_score=zeros(n, F), ip_group=torch.arange(n, device=dev),
                  behaviour_penalty=zeros(n, F), scores=zeros((n, k), F),
                  gossip_mute=zeros(n, torch.bool),
                  gossip_delay=zeros(n, torch.int64), step=0)
        base = rng.key_of_seed(seed, dev)
        st["topics"] = [dict(
            subscribed=alive.clone(), mesh=zeros((n, k), torch.bool),
            fanout=zeros((n, k), torch.bool),
            fanout_age=torch.full((n,), AGE_CAP, dtype=torch.int64,
                                  device=dev),
            backoff=zeros((n, k), torch.int64),
            **{name: zeros((n, k), F)
               for name in (*COUNTERS, "mesh_time_active")},
            have=zeros((n, m), torch.bool), fresh=zeros((n, m), torch.bool),
            gossip_pend=zeros((n, m), torch.bool),
            iwant_pend=zeros((n, m), torch.bool),
            pend_hold=zeros(n, torch.int64),
            first_step=torch.full((n, m), -1, dtype=torch.int64, device=dev),
            msg_valid=zeros(m, torch.bool), msg_birth=zeros(m, torch.int64),
            msg_active=zeros(m, torch.bool), msg_used=zeros(m, torch.bool),
            key=fold_in(base, t)) for t in range(self.t)]
        self.refresh_edges(st)
        for _ in range(3):
            self.heartbeat(st)
        return st

    def refresh_edges(self, st) -> None:
        """A slot carries topic t when its remote is alive and subscribed
        to t."""
        for topic in st["topics"]:
            part = st["alive"] & topic["subscribed"]
            topic["edge_live"] = st["nbr_valid"] & self.net.at_nbrs(
                part, st["nbrs"], False)

    def view(self, st, t: int) -> Dict[str, object]:
        """Topic t as a single-topic ``Network`` state: the shared planes,
        the topic's own, its key and the round; a peer takes part in the
        topic when alive and subscribed to it."""
        topic = st["topics"][t]
        v = {name: st[name] for name in SHARED_PLANES}
        v.update(topic)
        v["alive"] = st["alive"] & topic["subscribed"]
        v["nbr_sub"] = st["nbr_valid"]
        v["step"] = st["step"]
        return v

    def keep(self, st, t: int, v) -> None:
        """Topic t's planes and key back from a view."""
        topic = st["topics"][t]
        for name in (*TOPIC_PLANES, "key"):
            if name in ("subscribed", "edge_live"):
                continue
            topic[name] = v[name]

    # -- publish and one round ------------------------------------------------

    def publish(self, st, topic: int, src: int, slot: int, valid: bool
                ) -> None:
        """Peer ``src`` publishes into ``topic``'s window slot ``slot``
        (the slot's old message leaves that topic's planes): the
        single-topic flood publish, with the aggregate score."""
        v = self.view(st, topic)
        self.net.publish(v, int(src), int(slot), bool(valid))
        self.keep(st, topic, v)

    def round(self, st) -> None:
        """One round in every topic (topic order), closed by a heartbeat
        when due; the round count then advances.  A topic's round runs on
        its messages in flight alone (a first receipt of last round to
        relay, or an offered or granted copy waiting): no other message
        lands, is relayed or adds to a counter."""
        for t in range(self.t):
            v = self.view(st, t)
            moving = (v["fresh"] | v["gossip_pend"] | v["iwant_pend"]).any(0)
            cols = torch.nonzero(moving)[:, 0]
            if cols.numel() == 0:           # any one still message will do
                cols = torch.zeros(1, dtype=torch.long, device=self.dev)
            sub = dict(v)
            for name in MSG_PLANES:
                sub[name] = v[name][..., cols]
            self.net.propagate(sub)
            for name in MSG_PLANES:
                whole = v[name].clone()
                whole[..., cols] = sub[name]
                v[name] = whole
            for name in ("pend_hold", *COUNTERS[1:]):
                v[name] = sub[name]
            self.keep(st, t, v)
        if st["step"] % self.hb == self.hb - 1:
            self.heartbeat(st)
        st["step"] += 1

    # -- the heartbeat --------------------------------------------------------

    def scores(self, st) -> torch.Tensor:
        """v1.1's score of each neighbour slot: each topic's P1-P4 times
        the topic weight, summed over the topics and capped at the topic
        score cap, plus the remote's P5-P7; exact, rounded once; -inf on
        an empty slot."""
        sp, f = self.sp, self.net.f
        topics = torch.zeros((self.n, self.k), dtype=torch.float64,
                             device=self.dev)
        for topic in st["topics"]:
            d = lambda name: topic[name].double()  # noqa: E731
            p1 = torch.clamp(d("time_in_mesh")
                             / f(sp["time_in_mesh_quantum_s"]),
                             max=f(sp["time_in_mesh_cap"]))
            p2 = torch.clamp(d("first_message_deliveries"),
                             max=f(sp["first_message_deliveries_cap"]))
            deficit = torch.clamp(
                f(sp["mesh_message_deliveries_threshold"]) - torch.clamp(
                    d("mesh_message_deliveries"),
                    max=f(sp["mesh_message_deliveries_cap"])), min=0.0)
            active = topic["mesh_time_active"] >= f(
                sp["mesh_message_deliveries_activation_s"])
            p3 = torch.where(active, deficit * deficit, 0.0)
            p4 = d("invalid_message_deliveries") ** 2
            topics = topics + f(sp["topic_weight"]) * (
                f(sp["time_in_mesh_weight"]) * p1
                + f(sp["first_message_deliveries_weight"]) * p2
                + f(sp["mesh_message_deliveries_weight"]) * p3
                + f(sp["mesh_failure_penalty_weight"])
                * d("mesh_failure_penalty")
                + f(sp["invalid_message_deliveries_weight"]) * p4)
        topics = torch.clamp(topics, max=f(sp["topic_score_cap"]))
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
        total = topics + peer[st["nbrs"].clamp(0, self.n - 1)]
        return torch.where(st["nbr_valid"], total, NEG_INF).to(self.F)

    def heartbeat(self, st) -> None:
        """Score upkeep, then each topic's mesh maintenance, IHAVE/IWANT
        exchange, fanout upkeep and message-cache expiry, then PX topic
        after topic."""
        p, sp, f, F = self.p, self.sp, self.net.f, self.F
        net, n = self.net, self.n
        keys = [rng.split(topic["key"], 6) for topic in st["topics"]]
        # Scores: each topic's mesh clocks tick and its counters decay; the
        # behaviour penalty decays once.
        dt = f(p["heartbeat_interval_s"])
        for topic in st["topics"]:
            for name in ("time_in_mesh", "mesh_time_active"):
                topic[name] = torch.where(topic["mesh"], topic[name] + dt,
                                          topic[name])
            for name in COUNTERS[1:]:
                topic[name] = net.decay(topic[name], sp[name + "_decay"])
        st["behaviour_penalty"] = net.decay(st["behaviour_penalty"],
                                            sp["behaviour_penalty_decay"])
        scores = self.scores(st)
        st["scores"] = scores
        charged = torch.zeros(n, dtype=torch.int64, device=self.dev)
        broken = torch.zeros_like(st["nbrs"])
        upkeep: List[tuple] = []
        for t, topic in enumerate(st["topics"]):
            k_mesh, k_gossip, k_iwant, k_fanout, k_px, k_next = keys[t]
            v = self.view(st, t)
            part = v["alive"]
            mesh, grafted, pruned, backoff, charged_t, offer_ok = \
                net.mesh_upkeep(v, k_mesh, scores, topic["edge_live"], part)
            charged = charged + charged_t
            # The P3b penalty of a pruned slot that was active with a
            # deficit, and the mesh clocks of pruned and grafted slots
            # restart.
            deficit = torch.clamp(
                f(sp["mesh_message_deliveries_threshold"]) - torch.clamp(
                    topic["mesh_message_deliveries"],
                    max=f(sp["mesh_message_deliveries_cap"])), min=0.0)
            active = topic["mesh_time_active"] >= f(
                sp["mesh_message_deliveries_activation_s"])
            topic["mesh_failure_penalty"] = (
                topic["mesh_failure_penalty"] + torch.where(
                    pruned & active, deficit * deficit,
                    torch.zeros_like(deficit)))
            for name in ("time_in_mesh", "mesh_time_active"):
                topic[name] = torch.where(pruned | grafted, torch.zeros_like(
                    topic[name]), topic[name])
            # The message cache: seen ids expire after the seen TTL; ids
            # within the gossip history are advertised.
            age = st["step"] - topic["msg_birth"]
            seen_ttl = max(1, round(p["seen_ttl_s"]
                                    / p["heartbeat_interval_s"])) * self.hb
            have_seen = topic["have"] & ~(
                topic["msg_used"] & (age > seen_ttl))[None, :]
            gossip_ok = (topic["msg_valid"] & topic["msg_active"]
                         & (age <= p["history_gossip"] * self.hb))
            pend, broken_t = net.gossip(v, k_gossip, k_iwant, mesh, scores,
                                        part, topic["have"]
                                        & gossip_ok[None, :], have_seen)
            broken = broken + broken_t
            net.fanout_upkeep(v, k_fanout, scores)
            expired = topic["msg_active"] & (
                age > p["history_length"] * self.hb)
            topic.update(
                mesh=mesh, have=have_seen, fanout=v["fanout"],
                fanout_age=v["fanout_age"],
                gossip_pend=topic["gossip_pend"] & ~expired[None, :],
                iwant_pend=pend, msg_active=topic["msg_active"] & ~expired,
                key=k_next)
            upkeep.append((k_px, mesh, pruned, backoff, offer_ok))
        ids = torch.where(st["nbr_valid"], st["nbrs"], n).reshape(-1)
        promised = torch.zeros(n + 1, dtype=torch.int64, device=self.dev)
        promised.index_add_(0, ids, broken.reshape(-1))
        st["behaviour_penalty"] = (st["behaviour_penalty"] + charged.to(F)
                                   + promised[:n].to(F))
        # PX on prune, topic after topic over the one connection graph.
        for t, (k_px, mesh, pruned, backoff, offer_ok) in enumerate(upkeep):
            v = {name: st[name] for name in ("nbrs", "rev", "nbr_valid",
                                             "outbound", "alive")}
            net.peer_exchange(v, k_px, mesh, pruned, backoff, scores,
                              offer_ok)
            for name in ("nbrs", "rev", "nbr_valid", "outbound"):
                st[name] = v[name]
            st["topics"][t]["backoff"] = v["backoff"]
        self.refresh_edges(st)

    # -- what the comparison reads --------------------------------------------

    def arrays(self, st, pre: str = "state.") -> Dict[str, np.ndarray]:
        """The state as host arrays by name: shared planes as they are,
        each topic plane stacked over the topics, the topics' keys as
        [T, 2]."""
        out = {pre + name: _host(st[name]) for name in SHARED_PLANES}
        for name in TOPIC_PLANES:
            out[pre + name] = np.stack([_host(topic[name])
                                        for topic in st["topics"]])
        out[pre + "keys"] = np.stack([_host(topic["key"])
                                      for topic in st["topics"]])
        out[pre + "step"] = np.asarray(st["step"])
        return out

    def digest(self, st) -> np.ndarray:
        """int[T, M]: the peers taking part in each topic that hold each
        slot's message."""
        return np.stack([_host((topic["have"] & (
            st["alive"] & topic["subscribed"])[:, None]).sum(0))
            for topic in st["topics"]])

    def flight_tail(self, st) -> Dict[str, np.ndarray]:
        """The last round's telemetry over every topic: live peers, the
        share of the expected receipts stamped (participants a topic times
        its valid window), the mean mesh degree of participants, the
        pending offered copies and the receipts by latency in rounds (the
        last bin holds the tail)."""
        hist = torch.zeros(HIST_BINS, dtype=torch.int64, device=self.dev)
        expected = deg = part_n = pending = 0
        for topic in st["topics"]:
            part = st["alive"] & topic["subscribed"]
            window = topic["msg_used"] & topic["msg_valid"]
            counted = ((topic["first_step"] >= 0) & part[:, None]
                       & window[None, :])
            lat = torch.clamp(topic["first_step"] - topic["msg_birth"][None],
                              0, HIST_BINS - 1)
            hist = hist + torch.bincount(lat[counted], minlength=HIST_BINS)
            expected += int(part.sum()) * int(window.sum())
            degree = (topic["mesh"] & st["nbr_valid"]).sum(1)
            deg += int(torch.where(part, degree, 0).sum())
            part_n += int(part.sum())
            pending += int(topic["gossip_pend"].sum())
        return {
            "peers_alive": np.asarray(int(st["alive"].sum())),
            "delivery_frac": np.asarray(int(hist.sum()) / max(expected, 1)),
            "mesh_degree_mean": np.asarray(deg / max(part_n, 1)),
            "gossip_pending": np.asarray(pending),
            "lat_hist": _host(hist),
        }


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)
