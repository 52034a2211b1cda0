"""Scenario compiler: lower a :class:`ScenarioSpec` to event tensors.

The JAX package's ``scenario/compiler.py`` for the ``gossipsub``,
``multitopic``, ``treecast``, ``rlnc`` and ``hybrid`` families, in the
port.  The lowering is
a pure host-side function of the spec: every random draw (churn
victims, workload publishers, link cohorts) comes from a
``np.random.default_rng([seed, tag, index])`` substream, so the same
spec always produces the same event tensors -- the foundation of
bit-for-bit replay, and what lets the port replay a trace the JAX package
wrote.  The output is a :class:`CompiledScenario`: the model on
``device``, its initialized (and possibly adversary-prepared) state, and
one ``ops.schedule.GossipEvents`` (``MultiTopicEvents`` for the
multitopic family, ``TreeEvents`` for treecast) of host numpy rows whose
leading axis is the step of the model's ``rollout_events``.  Multitopic
lowers only the ``spam``/``promise_spam``/``sybil`` attack kinds and
refuses graceful churn, fault leaves and rejoins, as the reference does;
rlnc lowers no attack wave (it has no mesh or score plane) and its link
windows install ingress decimation; the hybrid is streaming-only.

The state surgery of the attack waves (sybil ``ip_group``, the cold-boot
mesh and counter rewrite, the eclipse attacker draw) reads the state back
to numpy exactly as the reference does, and puts it back on the model's
device in the state's storage dtypes.

``compile_streaming_plan`` lowers a ``multitopic`` or ``hybrid`` spec for
the serving plane (a host publish timeline, the fault stages, the
controller ladder, and the hybrid's loss windows, oscillation, regimes
and eager twin), as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GossipSubParams, ScoreParams, SimParams, TreeOpts
from ..ops import schedule as sched
from ..ops.graphs import decode_index_plane
from .spec import ScenarioSpec

# Substream tags: each spec component draws from its own child stream, so
# adding/removing one component never shifts another's randomness.
_TAG_WORKLOAD, _TAG_CHURN, _TAG_LINK, _TAG_ATTACK = 1, 2, 3, 4


@dataclasses.dataclass
class CompiledScenario:
    """A spec lowered against a concrete model + initialized state."""

    spec: ScenarioSpec
    model: Any
    state: Any
    events: Any                       # ops.schedule.*Events (host numpy)
    attackers: Optional[np.ndarray]   # bool[N] union of wave attackers
    target: Optional[int]             # eclipse target (record channel)
    n_publishes: int


def _rng(seed: int, tag: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed, tag, index])


def _split_model_kwargs(spec: ScenarioSpec) -> Dict[str, Any]:
    kw = dict(spec.model)
    if "params" in kw:
        kw["params"] = GossipSubParams(**kw["params"])
    if "score_params" in kw:
        kw["score_params"] = ScoreParams(**kw["score_params"])
    return kw


def _check_family(spec: ScenarioSpec) -> None:
    if spec.family not in ("gossipsub", "multitopic", "treecast", "rlnc",
                           "hybrid"):
        raise ValueError(f"unknown scenario family {spec.family!r}")


def build_model(spec: ScenarioSpec, graft_spammers=None, device="cuda"):
    """Construct the spec's model on ``device`` (host side; no state yet)."""
    _check_family(spec)
    if spec.family == "multitopic":
        from ..models.multitopic import MultiTopicGossipSub

        if "topology" in spec.model:
            raise ValueError("model topology dicts are gossipsub-only")
        if graft_spammers is not None:
            raise ValueError("graft_spam waves are gossipsub-only")
        return MultiTopicGossipSub(device=device, **_split_model_kwargs(spec))
    if spec.family in ("rlnc", "hybrid"):
        if "topology" in spec.model:
            raise ValueError("model topology dicts are gossipsub-only")
        if graft_spammers is not None:
            raise ValueError("graft_spam waves are gossipsub-only")
        if spec.family == "rlnc":
            from ..models.rlnc import RLNC

            return RLNC(device=device, **dict(spec.model))
        from ..models.hybrid import HybridGossipSub

        return HybridGossipSub(device=device, **_split_model_kwargs(spec))
    if spec.family == "treecast":
        # Model kwargs split into SimParams / TreeOpts fields.
        from ..models.treecast import TreeCast

        kw = dict(spec.model)
        kw.pop("n_peers", None)
        sim_names = {f.name for f in dataclasses.fields(SimParams)}
        opt_names = {f.name for f in dataclasses.fields(TreeOpts)}
        sim_kw = {k: v for k, v in kw.items() if k in sim_names}
        opt_kw = {k: v for k, v in kw.items() if k in opt_names}
        unknown = set(kw) - sim_names - opt_names
        if unknown:
            raise ValueError(f"unknown treecast model keys: {sorted(unknown)}")
        return TreeCast(params=SimParams(**sim_kw), opts=TreeOpts(**opt_kw),
                        device=device)
    from ..models.gossipsub import GossipSub

    kw = _split_model_kwargs(spec)
    # Declarative topology: a {"kind": ...} dict lowered by scenario.realism
    # to a builder closure.
    topo = kw.pop("topology", None)
    if topo is not None:
        from .realism import topology_builder

        kw["builder"] = topology_builder(topo)
    return GossipSub(graft_spammers=graft_spammers, device=device, **kw)


# Both targeted kinds need the flight recorder's single target channel, so
# a scenario carries at most one of them.
_TARGETED_KINDS = ("eclipse", "cold_boot_eclipse")
# The taxonomy extension rides the gossipsub event tensors (promo/silence)
# and score surgery that the multitopic plane does not carry.
_GOSSIP_ONLY_KINDS = (
    "cold_boot_eclipse", "covert_flash", "score_farm", "self_promo_ihave",
    "partition_flood",
)


def _targeted_wave(spec: ScenarioSpec):
    waves = [a for a in spec.attacks if a.kind in _TARGETED_KINDS]
    if len(waves) > 1:
        raise ValueError(
            "at most one eclipse / cold_boot_eclipse wave per scenario"
        )
    return waves[0] if waves else None


def _window(start: int, stop: Optional[int], n_steps: int) -> Tuple[int, int]:
    stop = n_steps if stop is None else min(stop, n_steps)
    if not (0 <= start < n_steps) or stop <= start:
        raise ValueError(
            f"event window [{start}, {stop}) outside scenario [0, {n_steps})"
        )
    return start, stop


def compile_scenario(spec: ScenarioSpec, device="cuda") -> CompiledScenario:
    """Lower ``spec`` -> (model on ``device``, initialized state, events)."""
    _check_family(spec)
    if spec.family == "hybrid":
        # The hybrid's closed-sim surface speaks the streaming engine's
        # chunk dialect; its campaigns run through compile_streaming_plan.
        raise ValueError(
            "hybrid family is streaming-only (set "
            'streaming={"streaming_only": True, ...})'
        )
    if spec.family == "treecast":
        return _compile_tree(spec, device)
    return _compile_gossip_like(spec, device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _compile_gossip_like(spec: ScenarioSpec, device) -> CompiledScenario:
    T, multitopic = spec.n_steps, spec.family == "multitopic"
    rlnc = spec.family == "rlnc"
    if rlnc and spec.attacks:
        raise ValueError(
            "attack waves are not lowered for rlnc (no mesh/score plane "
            "to eclipse, spam or graft against)"
        )

    # -- model + state (eclipse needs the converged mesh, so init first;
    #    graft_spam rebinds the constructor and re-inits with the same seed,
    #    which reproduces the same topology and warmup mesh).
    model = build_model(spec, device=device)
    st = model.init(seed=spec.seed)
    n = model.n
    ecl = _targeted_wave(spec)
    target = ecl.target if ecl else None

    # Per-wave attacker masks (spam/mute lowering is wave-scoped) plus the
    # union the record channels and publisher draws exclude.
    attackers = np.zeros(n, bool)
    wave_att: List[np.ndarray] = []
    for w in spec.attacks:
        wa = np.zeros(n, bool)
        if multitopic and w.kind in _GOSSIP_ONLY_KINDS:
            raise ValueError(f"{w.kind} waves are gossipsub-only")
        if w.kind in _TARGETED_KINDS:
            if multitopic:
                raise ValueError("eclipse waves are gossipsub-only")
            nbrs = _host(decode_index_plane(st.nbrs))
            if not (0 <= w.target < n):
                raise ValueError(f"{w.kind} target {w.target} out of range")
            if w.kind == "eclipse":
                mesh = _host(st.mesh)
                att_ids = sorted(
                    {int(nbrs[w.target, s]) for s in range(model.k)
                     if mesh[w.target, s]}
                )
                if not att_ids:
                    raise ValueError(
                        "eclipse target has an empty mesh at init"
                    )
            else:  # cold_boot_eclipse: connected neighbors, slot order
                valid = _host(st.nbr_valid)
                conn = list(dict.fromkeys(
                    int(nbrs[w.target, s]) for s in range(model.k)
                    if valid[w.target, s]
                ))
                if len(conn) < w.n_attackers:
                    raise ValueError(
                        f"cold_boot_eclipse wants {w.n_attackers} "
                        f"monopolists but target {w.target} has only "
                        f"{len(conn)} connected neighbors"
                    )
                att_ids = conn[: w.n_attackers]
            wa[att_ids] = True
        else:
            if w.kind == "graft_spam" and multitopic:
                raise ValueError("graft_spam waves are gossipsub-only")
            wa[: w.n_attackers] = True
        wave_att.append(wa)
        attackers |= wa

    if any(w.graft_spam or w.kind == "graft_spam" for w in spec.attacks):
        model = build_model(spec, graft_spammers=attackers, device=device)
        st = model.init(seed=spec.seed)

    # Sybil colocation: attacker identities share one IP group (applied to
    # the state once -- P6 scores it from the next heartbeat on).
    if any(w.kind == "sybil" for w in spec.attacks):
        group = _host(st.gcounters.ip_group).copy()
        group[attackers] = int(group.min(initial=0))
        st = st._replace(gcounters=st.gcounters._replace(
            ip_group=torch.from_numpy(group).to(model.device)))

    # Cold-boot monopoly: rewrite the target's converged mesh so its ONLY
    # mesh edges are the monopolists (symmetric via nbrs/rev), and zero the
    # per-slot score counters on every edge the target touches -- the attack
    # lands before any P1/P2 history exists, on either side, so pruning the
    # silent monopolists must come from fresh deficit evidence alone.
    for ai, w in enumerate(spec.attacks):
        if w.kind != "cold_boot_eclipse":
            continue
        wa = wave_att[ai]
        mesh = _host(st.mesh).copy()
        nbrs = _host(decode_index_plane(st.nbrs))
        rev = _host(decode_index_plane(st.rev))
        valid = _host(st.nbr_valid)
        counters = [_host(f).copy() for f in st.counters]
        for s in range(model.k):
            if not valid[w.target, s]:
                continue
            j, r = int(nbrs[w.target, s]), int(rev[w.target, s])
            keep = bool(wa[j])
            mesh[w.target, s] = keep
            mesh[j, r] = keep
            for f in counters:
                f[w.target, s] = 0.0
                f[j, r] = 0.0
        st = st._replace(
            mesh=torch.from_numpy(mesh).to(model.device),
            counters=type(st.counters)(*(
                torch.from_numpy(f).to(model.device) for f in counters)),
        )

    # -- publish requests per step (src resolution deferred to the timeline
    #    walk so publishers are drawn from peers alive at that step).
    # request = (picker_rng | None, src | None, valid, topic)
    requests: List[List[tuple]] = [[] for _ in range(T)]
    for wi, w in enumerate(spec.workloads):
        start, stop = _window(w.start, w.stop, T)
        rng = _rng(spec.seed, _TAG_WORKLOAD, wi)
        if w.kind == "burst":
            steps = [start]
        else:
            steps = range(start, stop, w.every)
        for t in steps:
            for _ in range(w.n_msgs):
                requests[t].append((rng, w.src, w.valid, w.topic))
    for ai, w in enumerate(spec.attacks):
        ids = [int(a) for a in np.flatnonzero(wave_att[ai])]
        if w.kind == "covert_flash":
            start, stop = _window(w.start, w.stop, T)
            if not (start <= w.defect_step < stop):
                raise ValueError(
                    f"covert_flash defect_step {w.defect_step} outside the "
                    f"wave window [{start}, {stop})"
                )
            # Honest until the defect; invalid spam only after it.
            if w.spam_every:
                for t in range(w.defect_step, stop, w.spam_every):
                    for a in ids:
                        requests[t].append((None, a, False, 0))
        elif w.kind == "score_farm":
            start, stop = _window(w.start, w.stop, T)
            farm_end = start + w.farm_steps
            if farm_end >= stop:
                raise ValueError(
                    f"score_farm farm_steps {w.farm_steps} leaves no spam "
                    f"phase in the wave window [{start}, {stop})"
                )
            # Bank valid-delivery credit, then cash it in as spam cover.
            for t in range(start, farm_end, w.spam_every):
                for a in ids:
                    requests[t].append((None, a, True, 0))
            for t in range(farm_end, stop, w.spam_every):
                for a in ids:
                    requests[t].append((None, a, False, 0))
        elif w.kind == "self_promo_ihave":
            # Valid self-originated traffic feeds the crafted IHAVEs.
            start, stop = _window(w.start, w.stop, T)
            for t in range(start, stop, w.spam_every):
                for a in ids:
                    requests[t].append((None, a, True, 0))
        elif w.kind == "partition_flood":
            start, stop = _window(w.start, w.stop, T)
            flood = stop + w.flood_offset
            if flood >= T:
                raise ValueError(
                    f"partition_flood flood start {flood} is past the "
                    f"scenario end ({T} steps)"
                )
            for t in range(flood, T, w.spam_every):
                for a in ids:
                    requests[t].append((None, a, False, 0))
        elif w.spam_every or w.kind == "spam":
            every = w.spam_every if w.spam_every else 1
            start, stop = _window(w.start, w.stop, T)
            for t in range(start, stop, every):
                for a in ids:
                    requests[t].append((None, a, False, 0))

    n_publishes = sum(len(r) for r in requests)
    if n_publishes > model.m:
        raise ValueError(
            f"scenario publishes {n_publishes} messages but the window "
            f"holds {model.m}; grow msg_window (slot recycling would make "
            f"the flight recorder's delivery fraction unaccountable)"
        )
    pub_width = max(1, max((len(r) for r in requests), default=0))

    if multitopic:
        events = sched.empty_multitopic_events(T, n, pub_width)
    else:
        events = sched.empty_gossip_events(T, n, pub_width)

    # -- attack windows -> mute / silence / promo tensors (wave-scoped).
    for ai, w in enumerate(spec.attacks):
        wa = wave_att[ai]
        if w.kind in ("eclipse", "promise_spam", "cold_boot_eclipse"):
            start, stop = _window(w.start, w.stop, T)
            events.mute_on[start] |= wa
            if stop < T:
                events.mute_off[stop] |= wa
            if w.kind in _TARGETED_KINDS:
                events.silence[start:stop] |= wa[None, :]
        elif w.kind == "covert_flash":
            start, stop = _window(w.start, w.stop, T)
            # The mask drops at defect_step, not at wave start.
            events.mute_on[w.defect_step] |= wa
            if stop < T:
                events.mute_off[stop] |= wa
            events.silence[w.defect_step : stop] |= wa[None, :]
        elif w.kind == "self_promo_ihave":
            start, stop = _window(w.start, w.stop, T)
            # Crafted IHAVEs (self-originated ids only) + never serving the
            # IWANTs those ads attract.
            events.promo_on[start] |= wa
            events.mute_on[start] |= wa
            if stop < T:
                events.promo_off[stop] |= wa
                events.mute_off[stop] |= wa

    if not multitopic and not rlnc and events.silence.any() \
            and model.max_edge_delay:
        raise ValueError(
            "eclipse silence requires the ideal eager fabric "
            "(max_edge_delay == 0): squelching fresh_w would desync the "
            "per-edge fresh history"
        )

    # -- link-degradation windows -> delay set/restore rows.
    for li, w in enumerate(spec.links):
        start, stop = _window(w.start, w.stop, T)
        if w.peers is not None:
            cohort = np.asarray(w.peers, int)
            if cohort.size and (cohort.min() < 0 or cohort.max() >= n):
                raise ValueError(f"link window peers out of range [0, {n})")
        else:
            rng = _rng(spec.seed, _TAG_LINK, li)
            size = max(1, int(round(w.frac * n)))
            cohort = rng.choice(n, size=size, replace=False)
        row = events.delay[start].copy()
        row[cohort] = w.delay
        events.delay[start] = row
        if stop < T:
            row = events.delay[stop].copy()
            row[cohort] = np.where(events.delay[stop][cohort] < 0, 0,
                                   events.delay[stop][cohort])
            events.delay[stop] = row

    # -- timeline walk: churn + faults + publish src resolution, against a
    #    host mirror of liveness/subscription so victims and publishers are
    #    always drawn from peers actually present at that step.
    alive = np.ones(n, bool)
    subscribed = _host(st.subscribed).copy() if not multitopic else (
        _host(st.subscribed).any(axis=0))
    protected = attackers.copy()
    if target is not None:
        protected[target] = True
    protected[0] = True  # keep a stable publisher/root candidate

    churn_events: List[List[tuple]] = [[] for _ in range(T)]  # (phase, kind)
    for ci, ph in enumerate(spec.churn):
        start, stop = _window(ph.start, ph.stop, T)
        if ph.graceful and multitopic:
            raise ValueError("graceful churn is not lowered for multitopic")
        for t in range(start, stop, ph.every):
            churn_events[t].append(("phase", ci))
    if spec.faults:
        for t_str, ids in spec.faults.get("kills", {}).items():
            t = int(t_str)
            if 0 <= t < T:
                churn_events[t].append(("fault_kill", ids))
        for t_str, ids in spec.faults.get("leaves", {}).items():
            t = int(t_str)
            if 0 <= t < T:
                churn_events[t].append(("fault_leave", ids))
            if multitopic:
                raise ValueError("fault leaves are not lowered for multitopic")

    churn_rngs = [
        _rng(spec.seed, _TAG_CHURN, ci) for ci in range(len(spec.churn))
    ]
    churn_cursor = [0] * len(spec.churn)  # cycle index into explicit peers
    rejoin_at: List[List[tuple]] = [[] for _ in range(T + 1)]  # (ids, graceful)

    # partition_flood cohorts ride the fault/rejoin machinery (kill at
    # start, revive at stop) so the liveness mirror below stays correct for
    # victim and publisher draws — never raw kill/revive tensor writes.
    for ai, w in enumerate(spec.attacks):
        if w.kind != "partition_flood":
            continue
        start, stop = _window(w.start, w.stop, T)
        rng = _rng(spec.seed, _TAG_ATTACK, ai)
        pool = np.flatnonzero(~protected)
        size = min(max(1, int(round(w.partition_frac * n))), len(pool))
        if size == 0:
            raise ValueError(
                "partition_flood found no honest unprotected peers to cut"
            )
        cohort = np.sort(rng.choice(pool, size=size, replace=False)).tolist()
        churn_events[start].append(("fault_kill", cohort))
        rejoin_at[stop].append((cohort, False))

    slot = 0

    for t in range(T):
        # rejoins land before this step's new departures.
        for ids, graceful in rejoin_at[t]:
            ids = [i for i in ids if not alive[i] or not subscribed[i]]
            if not ids:
                continue
            if graceful:
                events.sub_on[t][ids] = True
                subscribed[ids] = True
            else:
                if multitopic:
                    raise ValueError(
                        "rejoin is not lowered for multitopic (no revive "
                        "event tensor)"
                    )
                events.revive[t][ids] = True
                alive[ids] = True
        for kind, payload in churn_events[t]:
            if kind == "phase":
                ci = payload
                ph = spec.churn[ci]
                if ph.peers is not None:
                    k0 = churn_cursor[ci]
                    victims = [
                        p for p in ph.peers[k0 : k0 + ph.kills_per_event]
                        if 0 <= p < n
                    ]
                    churn_cursor[ci] = k0 + ph.kills_per_event
                else:
                    pool = np.flatnonzero(alive & subscribed & ~protected)
                    take = min(ph.kills_per_event, len(pool))
                    victims = (
                        churn_rngs[ci].choice(pool, size=take, replace=False)
                        .tolist() if take else []
                    )
                if not victims:
                    continue
                if ph.graceful:
                    events.sub_off[t][victims] = True
                    subscribed[victims] = False
                else:
                    events.kill[t][victims] = True
                    alive[victims] = False
                if ph.rejoin_after is not None:
                    back = t + ph.rejoin_after
                    if back <= T - 1:
                        rejoin_at[back].append((victims, ph.graceful))
            elif kind == "fault_kill":
                ids = [i for i in payload if 0 <= i < n]
                events.kill[t][ids] = True
                alive[ids] = False
            else:  # fault_leave -> graceful semantics (unsubscribe)
                ids = [i for i in payload if 0 <= i < n]
                events.sub_off[t][ids] = True
                subscribed[ids] = False
        for rng, src, valid, topic in requests[t]:
            if src is None:
                pool = np.flatnonzero(alive & subscribed & ~attackers)
                if len(pool) == 0:
                    raise ValueError(
                        f"no eligible publisher alive at step {t}"
                    )
                src = int(rng.choice(pool))
            elif not (0 <= src < n):
                raise ValueError(f"publisher {src} out of range [0, {n})")
            entry = {"src": src, "slot": slot, "valid": bool(valid)}
            if multitopic:
                if not (0 <= topic < model.t):
                    raise ValueError(f"topic {topic} out of range")
                entry["topic"] = topic
            sched.add_publish(events, t, entry)
            slot += 1

    return CompiledScenario(
        spec=spec, model=model, state=st, events=events,
        attackers=attackers if attackers.any() else None,
        target=target, n_publishes=n_publishes,
    )


# ---------------------------------------------------------------------------
# treecast lowering
# ---------------------------------------------------------------------------


def _init_tree_state(model, spec: ScenarioSpec):
    """A fully joined tree of ``n_peers`` (batched join walk; the host reads
    the membership back after every step, as the reference does)."""
    from ..ops import tree as tree_ops

    n_peers = spec.model.get("n_peers", model.params.max_peers)
    if n_peers > model.params.max_peers:
        raise ValueError("n_peers exceeds max_peers")
    st = model.init(root=0)
    mask = np.zeros(model.params.max_peers, bool)
    mask[:n_peers] = True
    st = tree_ops.begin_subscribe_many(st, torch.from_numpy(mask).to(
        model.device))
    for _ in range(8 * n_peers):
        if bool(st.joined[:n_peers].all()):
            break
        st = tree_ops.step(st)
    else:
        raise RuntimeError("tree join walk did not converge")
    return st


def _compile_tree(spec: ScenarioSpec, device) -> CompiledScenario:
    T = spec.n_steps
    if spec.attacks:
        raise ValueError("attack waves are not lowered for treecast")
    if spec.links:
        raise ValueError("link windows are not lowered for treecast "
                         "(use set_link_profile on the state)")
    slo = spec.slo
    if any(v is not None for v in (
        slo.max_p50, slo.max_p99, slo.max_capture_frac,
        slo.max_final_attacker_mesh_edges, slo.min_final_target_honest_edges,
    )):
        raise ValueError(
            "latency/capture SLOs need the mesh flight recorder; the tree "
            "record grades delivery totals and orphan backlog"
        )

    model = build_model(spec, device=device)
    st = _init_tree_state(model, spec)
    n = model.params.max_peers
    n_peers = spec.model.get("n_peers", n)

    requests: List[int] = [0] * T
    for wi, w in enumerate(spec.workloads):
        start, stop = _window(w.start, w.stop, T)
        steps = [start] if w.kind == "burst" else range(start, stop, w.every)
        for t in steps:
            requests[t] += w.n_msgs
    n_publishes = sum(requests)
    if n_publishes > model.params.queue_cap:
        raise ValueError(
            f"{n_publishes} root publishes exceed queue_cap "
            f"{model.params.queue_cap}"
        )
    pub_width = max(1, max(requests, default=0))
    events = sched.empty_tree_events(T, n, pub_width)

    alive = np.zeros(n, bool)
    alive[:n_peers] = True
    protected = np.zeros(n, bool)
    protected[0] = True  # the root

    churn_events: List[List[tuple]] = [[] for _ in range(T)]
    for ci, ph in enumerate(spec.churn):
        start, stop = _window(ph.start, ph.stop, T)
        for t in range(start, stop, ph.every):
            churn_events[t].append(("phase", ci))
    if spec.faults:
        for t_str, ids in spec.faults.get("kills", {}).items():
            t = int(t_str)
            if 0 <= t < T:
                churn_events[t].append(("fault_kill", ids))
        for t_str, ids in spec.faults.get("leaves", {}).items():
            t = int(t_str)
            if 0 <= t < T:
                churn_events[t].append(("fault_leave", ids))

    churn_rngs = [
        _rng(spec.seed, _TAG_CHURN, ci) for ci in range(len(spec.churn))
    ]
    churn_cursor = [0] * len(spec.churn)
    rejoin_at: List[List[list]] = [[] for _ in range(T + 1)]
    msg_id = 0

    for t in range(T):
        for ids in rejoin_at[t]:
            ids = [i for i in ids if not alive[i]]
            if ids:
                events.sub[t][ids] = True
                alive[ids] = True
        for kind, payload in churn_events[t]:
            if kind == "phase":
                ci = payload
                ph = spec.churn[ci]
                if ph.peers is not None:
                    k0 = churn_cursor[ci]
                    victims = [
                        p for p in ph.peers[k0 : k0 + ph.kills_per_event]
                        if 0 <= p < n
                    ]
                    churn_cursor[ci] = k0 + ph.kills_per_event
                else:
                    pool = np.flatnonzero(alive & ~protected)
                    take = min(ph.kills_per_event, len(pool))
                    victims = (
                        churn_rngs[ci].choice(pool, size=take, replace=False)
                        .tolist() if take else []
                    )
                if not victims:
                    continue
                field = events.leave if ph.graceful else events.kill
                field[t][victims] = True
                alive[victims] = False
                if ph.rejoin_after is not None:
                    back = t + ph.rejoin_after
                    if back <= T - 1:
                        rejoin_at[back].append(victims)
            elif kind == "fault_kill":
                ids = [i for i in payload if 0 <= i < n]
                events.kill[t][ids] = True
                alive[ids] = False
            else:
                ids = [i for i in payload if 0 <= i < n]
                events.leave[t][ids] = True
                alive[ids] = False
        for _ in range(requests[t]):
            sched.add_publish(events, t, {"msg": msg_id})
            msg_id += 1

    return CompiledScenario(
        spec=spec, model=model, state=st, events=events,
        attackers=None, target=None, n_publishes=n_publishes,
    )


# ---------------------------------------------------------------------------
# streaming lowering (serving plane)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamingPlan:
    """A spec lowered for the serving plane: a host publish TIMELINE, not
    device event tensors.  The streaming runner replays ``timeline`` through
    the ingest ring into a resident :class:`~..serve.engine.StreamingEngine`;
    the device-side shapes are fixed by (chunk_steps, pub_width), never by
    the campaign length, which is what lets the stream be unbounded."""

    spec: ScenarioSpec
    timeline: List[List[tuple]]   # per step: [(topic, src, valid), ...]
    n_publishes: int
    chunk_steps: int
    capacity: int
    policy: str
    pub_width: int
    completion_frac: float
    # Chaos lowering (r14): validated fault stages for the runner to
    # inject at chunk boundaries, and the engine's snapshot period.
    faults: Dict[str, Any] = dataclasses.field(default_factory=dict)
    snapshot_every: int = 0
    # r16: hybrid plane — run an eager-forced twin over the same timeline
    # and report the p99 ingest->delivery ratio as a channel.
    compare_eager: bool = False
    # r20: self-tuning — normalized {"ladder": [(steps, width), ...],
    # "policy": {ControllerPolicy overrides}} when the spec asks for a
    # controller, and the self-tuned-vs-best-static A/B flag (one static
    # twin per ladder rung over the same timeline).
    controller: Optional[Dict[str, Any]] = None
    compare_static: bool = False


def compile_streaming_plan(spec: ScenarioSpec) -> StreamingPlan:
    """Lower ``spec`` for the streaming plane.

    Honest support matrix: only the ``multitopic`` and ``hybrid`` families
    have a resident engine, and the serving plane lowers WORKLOADS only —
    churn, attack and link windows mutate device event tensors mid-scan,
    which the fixed-shape resident chunk deliberately does not carry
    (publishes and, on the hybrid plane, the per-chunk ingress-loss stamp
    are the only per-chunk variables).  Requesting them raises rather than
    silently ignoring campaign components.
    """
    if spec.family not in ("multitopic", "hybrid"):
        raise ValueError(
            f"streaming plane requires the multitopic or hybrid family, "
            f"got {spec.family!r}"
        )
    if spec.churn or spec.attacks or spec.links or spec.faults:
        raise ValueError(
            "churn/attack/link/fault components are not lowered for the "
            "streaming plane (publishes are the only per-chunk variable)"
        )
    T = spec.n_steps
    n = int(spec.model.get("n_peers", 1024))
    # The hybrid is a single-topic plane (T = 1): workload topics clip to 0.
    n_topics = (
        1 if spec.family == "hybrid"
        else int(spec.model.get("n_topics", 4))
    )
    cfg = dict(spec.streaming or {})
    chunk_steps = int(cfg.get("chunk_steps", 8))
    capacity = int(cfg.get("capacity", 64))
    policy = str(cfg.get("policy", "block"))
    # Default pub_width lets ONE chunk drain a full ring: ceil(cap / steps).
    pub_width = int(cfg.get("pub_width", max(1, -(-capacity // chunk_steps))))
    completion_frac = float(cfg.get("completion_frac", 0.99))
    faults = _lower_streaming_faults(cfg, T, chunk_steps)
    controller = _lower_controller(cfg, chunk_steps, pub_width)
    compare_static = bool(cfg.get("compare_static", False))
    if compare_static and controller is None:
        raise ValueError(
            "compare_static needs a \"controller\" dict (the static twins "
            "are the ladder's rungs — nothing to compare without a ladder)"
        )
    compare_eager = bool(cfg.get("compare_eager", False))
    if (
        compare_eager or "loss" in faults or "loss_oscillate" in faults
    ) and spec.family != "hybrid":
        raise ValueError(
            "loss windows / compare_eager are hybrid-family features "
            "(only the hybrid model stamps per-chunk ingress loss)"
        )
    # A staged crash needs a snapshot to come back from; default to
    # every-chunk snapshots so the boundary crash loses nothing.
    snapshot_every = int(
        cfg.get("snapshot_every", 1 if "crash_at_chunk" in faults else 0)
    )
    if snapshot_every < 0:
        raise ValueError("snapshot_every must be >= 0")
    if "crash_at_chunk" in faults and snapshot_every == 0:
        raise ValueError(
            "crash_at_chunk needs snapshot_every >= 1 (nothing to restore "
            "from otherwise)"
        )

    timeline: List[List[tuple]] = [[] for _ in range(T)]
    for wi, w in enumerate(spec.workloads):
        start, stop = _window(w.start, w.stop, T)
        rng = _rng(spec.seed, _TAG_WORKLOAD, wi)
        if not (0 <= w.topic < n_topics):
            raise ValueError(f"topic {w.topic} out of range [0, {n_topics})")
        steps = [start] if w.kind == "burst" else range(start, stop, w.every)
        for t in steps:
            for _ in range(w.n_msgs):
                # No churn on this plane, so every peer is alive: publishers
                # draw uniformly (same per-workload substream discipline as
                # the sim compiler, so seeds reproduce bit-for-bit).
                src = int(rng.integers(n)) if w.src is None else w.src
                if not (0 <= src < n):
                    raise ValueError(f"publisher {src} out of range [0, {n})")
                timeline[t].append((w.topic, src, bool(w.valid)))

    if "producer_stall" in faults:
        # Stall-then-flood: the producer is wedged through the window, and
        # everything it would have published lands in one step at wake-up.
        stall = faults["producer_stall"]
        wake = stall["start"] + stall["steps"]
        deferred: List[tuple] = []
        for t in range(stall["start"], wake):
            deferred.extend(timeline[t])
            timeline[t] = []
        timeline[wake] = deferred + timeline[wake]

    return StreamingPlan(
        spec=spec,
        timeline=timeline,
        n_publishes=sum(len(r) for r in timeline),
        chunk_steps=chunk_steps,
        capacity=capacity,
        policy=policy,
        pub_width=pub_width,
        completion_frac=completion_frac,
        faults=faults,
        snapshot_every=snapshot_every,
        compare_eager=compare_eager,
        controller=controller,
        compare_static=compare_static,
    )


def _lower_controller(
    cfg: Dict[str, Any], chunk_steps: int, pub_width: int
) -> Optional[Dict[str, Any]]:
    """Validate the streaming dict's ``controller`` key: the geometry
    ladder must contain the spec's base geometry (the pre-warm contract),
    and policy overrides must name real :class:`ControllerPolicy` fields
    with values its validation accepts — both checked at compile time, so
    a bad spec fails before any engine warms."""
    if cfg.get("controller") is None:
        return None
    from ..serve.tuning import ControllerPolicy, validate_ladder

    ctl = dict(cfg["controller"])
    unknown = set(ctl) - {"ladder", "policy"}
    if unknown:
        raise ValueError(
            f"unknown controller keys {sorted(unknown)} "
            "(expected \"ladder\" and optional \"policy\")"
        )
    ladder_cfg = ctl.get("ladder")
    if not ladder_cfg:
        raise ValueError("controller needs a non-empty \"ladder\"")
    rungs = validate_ladder(
        [tuple(int(x) for x in g) for g in ladder_cfg],
        (chunk_steps, pub_width),
    )
    overrides = dict(ctl.get("policy") or {})
    try:
        ControllerPolicy(**overrides)
    except TypeError as e:
        raise ValueError(f"bad controller policy override: {e}") from None
    return {
        "ladder": [r.as_tuple() for r in rungs],
        "policy": overrides,
    }


def _lower_streaming_faults(
    cfg: Dict[str, Any], n_steps: int, chunk_steps: int
) -> Dict[str, Any]:
    """Validate the streaming dict's fault keys into StreamingPlan.faults.

    Chunk-indexed faults fire after that many TRAFFIC chunks (1-based, so
    ``crash_at_chunk=1`` kills the engine right after its first loaded
    chunk); they must land inside the campaign's chunk count.  Unknown
    behavior is rejected loudly, matching the sim compiler's posture."""
    n_chunks = -(-n_steps // chunk_steps)
    faults: Dict[str, Any] = {}
    for key in ("crash_at_chunk", "verifier_crash_at_chunk"):
        if cfg.get(key) is not None:
            at = int(cfg[key])
            if not (1 <= at <= n_chunks):
                raise ValueError(
                    f"{key}={at} outside the campaign's chunk range "
                    f"[1, {n_chunks}]"
                )
            faults[key] = at
    if cfg.get("producer_stall") is not None:
        st = dict(cfg["producer_stall"])
        start, steps = int(st.get("start", 0)), int(st.get("steps", 0))
        if steps < 1 or start < 0:
            raise ValueError("producer_stall needs start >= 0, steps >= 1")
        if start + steps >= n_steps:
            raise ValueError(
                f"producer_stall window [{start}, {start + steps}) must end "
                f"before the campaign's last step ({n_steps - 1}) so the "
                "deferred flood still publishes"
            )
        faults["producer_stall"] = {"start": start, "steps": steps}
    if cfg.get("clock_skew") is not None:
        sk = dict(cfg["clock_skew"])
        at = int(sk.get("at_chunk", 1))
        if not (1 <= at <= n_chunks):
            raise ValueError(
                f"clock_skew.at_chunk={at} outside the campaign's chunk "
                f"range [1, {n_chunks}]"
            )
        faults["clock_skew"] = {
            "at_chunk": at, "skew_s": float(sk.get("skew_s", 0.0)),
        }
    if cfg.get("loss") is not None:
        # Degraded-link window (r16, hybrid plane): chunks in
        # [start_chunk, stop_chunk) ingest with per-receiver decimation
        # ``delay`` stamped on the event tensors; the stamp resets to 0 at
        # stop_chunk so the drain (and any eager twin) runs on clean fabric.
        lw = dict(cfg["loss"])
        start = int(lw.get("start_chunk", 0))
        stop = int(lw.get("stop_chunk", n_chunks))
        delay = int(lw.get("delay", 1))
        if delay < 1:
            raise ValueError("loss.delay must be >= 1 (decimation period)")
        if not (0 <= start < stop <= n_chunks):
            raise ValueError(
                f"loss window [{start}, {stop}) outside the campaign's "
                f"chunk range [0, {n_chunks}]"
            )
        faults["loss"] = {
            "start_chunk": start, "stop_chunk": stop, "delay": delay,
        }
    if cfg.get("loss_oscillate") is not None:
        # r21 hysteresis-oscillation attack (hybrid plane): the adversary
        # flips the link between lossy (decimation ``delay``) and clean
        # every ``period_chunks`` chunks inside [start_chunk, stop_chunk),
        # starting lossy.  Tuned to straddle the hybrid's switch_hi /
        # switch_lo band, it tries to force worst-of-both behavior out of
        # the eager<->coded estimator (each flip lands just as the EWMA
        # crosses a threshold).
        ow = dict(cfg["loss_oscillate"])
        start = int(ow.get("start_chunk", 0))
        stop = int(ow.get("stop_chunk", n_chunks))
        period = int(ow.get("period_chunks", 1))
        delay = int(ow.get("delay", 1))
        if delay < 1:
            raise ValueError(
                "loss_oscillate.delay must be >= 1 (decimation period)"
            )
        if period < 1:
            raise ValueError("loss_oscillate.period_chunks must be >= 1")
        if not (0 <= start < stop <= n_chunks):
            raise ValueError(
                f"loss_oscillate window [{start}, {stop}) outside the "
                f"campaign's chunk range [0, {n_chunks}]"
            )
        if "loss" in faults:
            raise ValueError(
                "\"loss\" and \"loss_oscillate\" stamp the same ingress-"
                "delay lever — use one or the other"
            )
        faults["loss_oscillate"] = {
            "start_chunk": start, "stop_chunk": stop,
            "period_chunks": period, "delay": delay,
        }
    if cfg.get("loss_regimes") is not None:
        # r20 drifting-workload windows: STEP-keyed (not chunk-keyed) so
        # the same spec is fair across chunk geometries — a controller
        # switching rungs and a static twin see the loss start and stop at
        # the same timeline steps.  Windows must be ordered and disjoint.
        regimes: List[Dict[str, int]] = []
        for i, rw in enumerate(cfg["loss_regimes"]):
            rw = dict(rw)
            start = int(rw.get("start_step", 0))
            stop = int(rw.get("stop_step", n_steps))
            delay = int(rw.get("delay", 1))
            if delay < 1:
                raise ValueError(
                    f"loss_regimes[{i}].delay must be >= 1"
                )
            if not (0 <= start < stop <= n_steps):
                raise ValueError(
                    f"loss_regimes[{i}] window [{start}, {stop}) outside "
                    f"the campaign's step range [0, {n_steps}]"
                )
            if regimes and start < regimes[-1]["stop_step"]:
                raise ValueError(
                    f"loss_regimes[{i}] starts at step {start}, inside the "
                    f"previous window (ends {regimes[-1]['stop_step']}) — "
                    "windows must be ordered and disjoint"
                )
            regimes.append(
                {"start_step": start, "stop_step": stop, "delay": delay}
            )
        if "loss" in faults or "loss_oscillate" in faults:
            raise ValueError(
                "\"loss\"/\"loss_oscillate\" (chunk-keyed) and "
                "\"loss_regimes\" (step-keyed) stamp the same ingress-"
                "delay lever — use one or the other"
            )
        faults["loss_regimes"] = regimes
    return faults
