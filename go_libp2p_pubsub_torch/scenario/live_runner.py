"""Run a ScenarioSpec against the LIVE plane and grade the same SLOs.

The scenario engine gave adversity campaigns a declarative form and an SLO verdict — but
only for the device-compiled sim plane.  This module lowers the same
:class:`~.spec.ScenarioSpec` onto real sockets: link-delay windows become
:class:`~..net.chaos.ChaosTransport` policies, churn phases become host
kills / graceful Parts / rejoins, workloads become root publishes, and the
run is graded by the **same** :func:`~.slo.evaluate` thresholds the sim
runner uses.  ``tools/scenario_run.py --plane live`` is the CLI face: the
canon gets a second, socket-level verdict column.

Semantics mirrored from ``scenario.compiler`` so the two planes lower one
spec the same way:

- identical seeded substreams (``_rng(seed, tag, index)``) — the same spec
  kills the same victim indices and degrades the same link cohorts on both
  planes;
- rejoins land before the same step's departures; victims are drawn from
  peers alive AND subscribed AND not protected; peer 0 (the live root) is
  always protected;
- one scenario "step" is a wall-clock quantum (``step_s``, default 50 ms):
  link delays of ``d`` rounds become ``d * step_s`` chaos delays, and
  latency is graded in rounds by re-quantizing receipt times.

Deliberate differences (documented, not silent): the live tree has exactly
one publisher (the root), so workload ``src`` is ignored; attack waves and
the multitopic family have no live lowering and are rejected
(``live_supported`` lets callers filter); ``valid=False`` workloads are
rejected (the runner drives the unsigned plane).

Delivery accounting is scoped exactly like the reference's dropping tests
(``pubsub_test.go:152-204``): loss is charged only against peers that
survive to scenario end — a killed member's in-flight messages are its own
loss, but every survivor must receive every message published while it was
subscribed, including across repair windows.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..net.chaos import (
    ChaosTransport, LinkPolicy, install_partition, remove_partition,
)
from ..net.live import LiveNetwork, SyncHost, SyncSubscription
from . import slo as slo_mod
from .compiler import _TAG_CHURN, _TAG_LINK, _rng, _window
from .spec import ScenarioSpec

TOPIC = "scenario"


class LivePlaneError(RuntimeError):
    """The live plane failed to COME UP for a scenario (hosts, sockets,
    initial subscribes).  ``tools/scenario_run.py`` maps this to exit 2 —
    an infrastructure failure, distinct from a red verdict (exit 1)."""


@dataclasses.dataclass
class LiveScenarioResult:
    """One live-plane campaign: spec + verdict + synthesized record."""

    spec: ScenarioSpec
    verdict: "slo_mod.Verdict"
    record: Dict[str, np.ndarray]
    n_publishes: int
    chaos_trace: Dict[tuple, list]
    counters: Dict[str, float]
    seconds: float = 0.0
    # Failover time-to-heal: wall seconds from the root kill to the first
    # survivor observed promoted (None when the scenario kills no root).
    heal_s: Optional[float] = None
    # r19 cross-host tracing (trace_sample set): per-host span artifacts
    # (``obs-span-host/1``, one per host that ran a ledger), their merge
    # (``obs-span-merged/1``), and the merged propagation digest.  All None
    # when tracing was off.
    host_artifacts: Optional[List[dict]] = None
    merged_trace: Optional[dict] = None
    propagation: Optional[dict] = None


def live_supported(spec: ScenarioSpec) -> bool:
    """Can this spec be lowered onto the live plane?"""
    return (
        spec.family in ("gossipsub", "treecast")
        and not spec.attacks
        and all(w.valid for w in spec.workloads)
    )


def sim_supported(spec: ScenarioSpec) -> bool:
    """Can this spec be lowered onto the sim plane?  Live-only scenarios
    (root failover, socket-level partition heal) and streaming-only
    scenarios (unbounded ingest through the resident serving engine) have
    no closed-scan device lowering — the mirror image of
    :func:`live_supported` / ``streaming_runner.streaming_supported``."""
    return not spec.live_only and not spec.streaming_only


def _reject_unsupported(spec: ScenarioSpec) -> None:
    if spec.family == "multitopic":
        raise ValueError(
            "multitopic has no live lowering (the live plane runs one tree)"
        )
    if spec.attacks:
        raise ValueError(
            "attack waves are not lowered for the live plane (scoring/mesh "
            "defenses are sim-plane subsystems)"
        )
    if any(not w.valid for w in spec.workloads):
        raise ValueError(
            "valid=False workloads are not lowered for the live plane "
            "(the runner drives the unsigned tree)"
        )


@dataclasses.dataclass
class _Member:
    """One (peer-slot, generation): a live subscriber over some step window.

    A rejoin opens a NEW generation on the same slot — live hosts cannot be
    revived in place (a killed listener is gone), so the rejoined peer is a
    fresh host id occupying the same scenario-level identity.
    """

    peer: int
    host: SyncHost
    sub: SyncSubscription
    alive_from: int
    end_step: Optional[int] = None  # step it left/was killed (None = survivor)
    killed: bool = False
    receipts: Dict[int, float] = dataclasses.field(default_factory=dict)
    dups: int = 0  # same message index DELIVERED twice (dedup failure)
    stop: threading.Event = dataclasses.field(default_factory=threading.Event)
    thread: Optional[threading.Thread] = None


def _collect(member: _Member) -> None:
    """Collector thread: drain one member's deliveries with receipt times.
    A message index surfacing twice is a duplicate DELIVERY — the live
    plane's content-hash dedup failed — and is counted, not overwritten:
    the ``max_duplicate_deliveries`` SLO reads the sum."""
    while not member.stop.is_set():
        try:
            payload = member.sub.get(timeout=0.2)
        except (TimeoutError, asyncio.TimeoutError):
            continue
        except Exception:
            return  # subscription torn down mid-get (kill path)
        try:
            idx = int(payload.split(b":")[1])
        except (IndexError, ValueError):
            continue
        if idx in member.receipts:
            member.dups += 1
        else:
            member.receipts[idx] = time.monotonic()


def run_live_scenario(
    spec: ScenarioSpec,
    n_hosts: Optional[int] = None,
    step_s: Optional[float] = None,
    settle_s: Optional[float] = None,
    trace_out: Optional[str] = None,
    trace_sample: Optional[int] = None,
) -> LiveScenarioResult:
    """Lower ``spec`` onto a live tree under chaos and grade its SLOs.

    ``trace_out`` writes an ``obs-record-trace/1`` artifact from the
    synthesized flight record; the live plane steps on a real cadence, so
    the trace's time axis is seconds (``step_s`` per step).

    ``trace_sample`` (r19) turns on cross-host distributed tracing: every
    host runs its own :class:`~..obs.spans.SpanLedger` tracing the same
    deterministic 1-in-N message subset, the latency SLO is graded from
    span-exact propagation times instead of collector-thread receipt
    times, and — when ``trace_out`` is also given — the per-host ledgers
    plus their ``obs-span-merged/1`` merge land in a ``<trace_out
    stem>.spans/`` directory next to the record trace.
    """
    _reject_unsupported(spec)
    live_cfg = spec.live or {}
    n = int(n_hosts if n_hosts is not None else live_cfg.get("n_hosts", 16))
    dt = float(
        step_s if step_s is not None else live_cfg.get("step_ms", 50.0) / 1e3
    )
    if settle_s is None and "settle_s" in live_cfg:
        settle_s = float(live_cfg["settle_s"])
    if n < 2:
        raise ValueError("live scenario needs n_hosts >= 2 (root + 1)")
    T = spec.n_steps
    t_begin = time.monotonic()

    chaos = ChaosTransport(seed=spec.seed)
    # Repair must complete well inside one latency "round" budget but not
    # so eagerly that one slow adoption dial gives up: a handful of steps.
    repair_s = max(6 * dt, 0.3)
    net = LiveNetwork(repair_timeout_s=repair_s, chaos=chaos,
                      trace_sample=trace_sample)

    # -- plane bring-up (failures here are exit-2 material, not verdicts) --
    members: Dict[int, List[_Member]] = {}
    try:
        hosts = net.make_hosts(n)
        topic = hosts[0].new_topic(TOPIC)
        for p in range(1, n):
            sub = hosts[p].subscribe(hosts[0].id, TOPIC)
            m = _Member(peer=p, host=hosts[p], sub=sub, alive_from=0)
            m.thread = threading.Thread(target=_collect, args=(m,), daemon=True)
            m.thread.start()
            members[p] = [m]
    except Exception as e:
        net.shutdown()
        raise LivePlaneError(f"live plane failed to start: {e}") from e

    try:
        res = _drive(spec, net, chaos, hosts, topic, members, n, T, dt,
                     settle_s, t_begin)
        if trace_out is not None:
            from ..obs.export import build_record_artifact, write_json

            write_json(trace_out, build_record_artifact(
                plane="live", scenario=spec.name,
                verdict=res.verdict.to_dict(), record=res.record,
                time_per_step_s=dt,
            ))
            if res.merged_trace is not None:
                import os

                spans_dir = os.path.splitext(trace_out)[0] + ".spans"
                os.makedirs(spans_dir, exist_ok=True)
                for art in res.host_artifacts:
                    write_json(
                        os.path.join(spans_dir, f"host-{art['host']}.json"),
                        art,
                    )
                write_json(
                    os.path.join(spans_dir, "merged.json"), res.merged_trace
                )
        return res
    finally:
        for gens in members.values():
            for m in gens:
                m.stop.set()
        for gens in members.values():
            for m in gens:
                if m.thread is not None:
                    m.thread.join(timeout=2.0)
        net.shutdown()


def _drive(spec, net, chaos, hosts, topic, members, n, T, dt,
           settle_s, t_begin) -> LiveScenarioResult:
    # -- lowering: publish requests per step (compiler's workload walk; src
    #    is ignored — the live tree has one publisher, the root).
    requests: List[int] = []
    pub_steps: List[List[int]] = [[] for _ in range(T)]
    for w in spec.workloads:
        start, stop = _window(w.start, w.stop, T)
        steps = [start] if w.kind == "burst" else range(start, stop, w.every)
        for t in steps:
            for _ in range(w.n_msgs):
                pub_steps[t].append(len(requests))
                requests.append(t)

    # -- lowering: link windows -> chaos delay policies on the cohort's
    #    ingress (same substream as the compiler, so the same peer indices
    #    degrade on both planes).
    link_installs: List[List[Tuple[int, float]]] = [[] for _ in range(T)]
    link_removals: List[List[int]] = [[] for _ in range(T)]
    for li, w in enumerate(spec.links):
        start, stop = _window(w.start, w.stop, T)
        if w.peers is not None:
            cohort = [p for p in w.peers if 0 <= p < n]
        else:
            rng = _rng(spec.seed, _TAG_LINK, li)
            size = max(1, int(round(w.frac * n)))
            cohort = [int(p) for p in rng.choice(n, size=size, replace=False)]
        for p in cohort:
            link_installs[start].append((p, w.delay * dt))
            if stop < T:
                link_removals[stop].append(p)

    # -- lowering: churn timeline (compiler's walk, host mirrors and all).
    churn_events: List[List[tuple]] = [[] for _ in range(T)]
    for ci, ph in enumerate(spec.churn):
        start, stop = _window(ph.start, ph.stop, T)
        for t in range(start, stop, ph.every):
            churn_events[t].append(("phase", ci))
    if spec.faults:
        for t_str, ids in spec.faults.get("kills", {}).items():
            if 0 <= int(t_str) < T:
                churn_events[int(t_str)].append(("fault_kill", ids))
        for t_str, ids in spec.faults.get("leaves", {}).items():
            if 0 <= int(t_str) < T:
                churn_events[int(t_str)].append(("fault_leave", ids))
    churn_rngs = [
        _rng(spec.seed, _TAG_CHURN, ci) for ci in range(len(spec.churn))
    ]
    churn_cursor = [0] * len(spec.churn)
    rejoin_at: List[List[tuple]] = [[] for _ in range(T + 1)]

    alive = np.ones(n, bool)
    subscribed = np.ones(n, bool)
    protected = np.zeros(n, bool)
    protected[0] = True  # the root/publisher (compiler keeps slot 0 stable)
    subscribed[0] = False  # the root publishes, it does not subscribe

    peers_alive = np.zeros(T, np.int64)
    peers_orphaned = np.zeros(T, np.int64)

    def current(p: int) -> Optional[_Member]:
        gens = members.get(p)
        m = gens[-1] if gens else None
        return m if m is not None and m.end_step is None else None

    def depart(p: int, t: int, graceful: bool) -> None:
        m = current(p)
        if m is None:
            return
        m.end_step = t
        m.killed = not graceful
        m.stop.set()
        if graceful:
            m.sub.close()          # Part flows; host stays up
        else:
            m.host.close()         # abrupt: streams abort, no Part

    def rejoin(p: int, t: int, graceful: bool) -> None:
        prev = members[p][-1]
        host = prev.host if graceful else net.host()
        sub = host.subscribe(hosts[0].id, TOPIC)
        m = _Member(peer=p, host=host, sub=sub, alive_from=t)
        m.thread = threading.Thread(target=_collect, args=(m,), daemon=True)
        m.thread.start()
        members[p].append(m)

    # -- failover lowering (live-only adversities, spec.live) ---------------
    live_cfg = spec.live or {}
    kill_root_at = live_cfg.get("kill_root_at")  # step: abrupt root kill
    part_cfg = live_cfg.get("partition")  # {"start","stop","peers"}: blackhole
    root_dead = False
    t_kill: Optional[float] = None
    heal_s: Optional[float] = None
    promoted: Optional[_Member] = None
    pending_pubs: List[int] = []  # published while no root exists yet
    partition_sides: Optional[Tuple[List[str], List[str]]] = None

    def find_promoted() -> Optional[_Member]:
        for gens in members.values():
            for m in gens:
                if m.end_step is None and m.sub.sub.node.is_root:
                    return m
        return None

    def flush_pending(via: _Member) -> None:
        for idx in pending_pubs:
            via.sub.publish_message(pub_payloads[idx])
            pub_wall[idx] = time.monotonic()
        pending_pubs.clear()

    # -- the paced campaign loop -------------------------------------------
    t0 = time.monotonic()
    pub_payloads = [f"scn:{i}".encode() for i in range(len(requests))]
    # Actual publish wall times: latency is graded against the moment the
    # root's fan-out returned, not the nominal step, so a repair stall that
    # slips the pacing loop does not masquerade as delivery latency.
    pub_wall = [0.0] * len(requests)
    for t in range(T):
        target_t = t0 + t * dt
        while True:
            now = time.monotonic()
            if now >= target_t:
                break
            time.sleep(min(dt, target_t - now))
        if part_cfg is not None and t == int(part_cfg["start"]):
            # Blackhole + reset the minority cohort away from everyone else:
            # dials across the cut fail, the first write on any existing
            # cross-cut stream aborts it (both ends must DETECT the cut;
            # drop-only faults are silent).  Host ids are resolved at
            # install time so rejoined generations partition correctly.
            minority = set(int(p) for p in part_cfg["peers"])
            side_a = [
                m.host.id for p in sorted(minority)
                if (m := current(p)) is not None
            ]
            side_b = [hosts[0].id] + [
                m.host.id for p in range(1, n)
                if p not in minority and (m := current(p)) is not None
            ]
            partition_sides = (side_a, side_b)
            install_partition(chaos.table, side_a, side_b)
        if part_cfg is not None and t == int(part_cfg["stop"]) \
                and partition_sides is not None:
            remove_partition(chaos.table, *partition_sides)
            partition_sides = None
        if kill_root_at is not None and t == int(kill_root_at) \
                and not root_dead:
            hosts[0].close()  # abrupt: streams abort, no Part, no handover
            root_dead = True
            t_kill = time.monotonic()
        if root_dead and promoted is None:
            promoted = find_promoted()
            if promoted is not None:
                heal_s = time.monotonic() - t_kill
                flush_pending(promoted)
        for p, delay_s in link_installs[t]:
            m = current(p)
            if m is not None:
                chaos.table.set(LinkPolicy(delay_s=delay_s), dst=m.host.id)
        for p in link_removals[t]:
            for m in members.get(p, []):
                chaos.table.remove(dst=m.host.id)
        # rejoins land before this step's new departures (compiler order).
        for ids, graceful in rejoin_at[t]:
            ids = [i for i in ids if not alive[i] or not subscribed[i]]
            for p in ids:
                rejoin(p, t, graceful)
            if graceful:
                subscribed[ids] = True
            else:
                alive[ids] = True
                subscribed[ids] = True
        for kind, payload in churn_events[t]:
            if kind == "phase":
                ci = payload
                ph = spec.churn[ci]
                if ph.peers is not None:
                    k0 = churn_cursor[ci]
                    victims = [
                        p for p in ph.peers[k0:k0 + ph.kills_per_event]
                        if 0 < p < n  # never the live root
                    ]
                    churn_cursor[ci] = k0 + ph.kills_per_event
                else:
                    pool = np.flatnonzero(alive & subscribed & ~protected)
                    take = min(ph.kills_per_event, len(pool))
                    victims = (
                        churn_rngs[ci].choice(pool, size=take, replace=False)
                        .tolist() if take else []
                    )
                for p in victims:
                    depart(p, t, ph.graceful)
                if ph.graceful:
                    subscribed[victims] = False
                else:
                    alive[victims] = False
                if ph.rejoin_after is not None and victims:
                    back = t + ph.rejoin_after
                    if back <= T - 1:
                        rejoin_at[back].append((victims, ph.graceful))
            elif kind == "fault_kill":
                ids = [i for i in payload if 0 < i < n]
                for p in ids:
                    depart(p, t, graceful=False)
                alive[ids] = False
            else:  # fault_leave
                ids = [i for i in payload if 0 < i < n]
                for p in ids:
                    depart(p, t, graceful=True)
                subscribed[ids] = False
        for idx in pub_steps[t]:
            if not root_dead:
                topic.publish_message(pub_payloads[idx])
                pub_wall[idx] = time.monotonic()
            elif promoted is not None:
                promoted.sub.publish_message(pub_payloads[idx])
                pub_wall[idx] = time.monotonic()
            else:
                # The root is dead and no successor has promoted yet: the
                # workload buffers, exactly as a real publisher fronting
                # this tree would have to, and flushes on promotion.
                pending_pubs.append(idx)
        # per-step observability (the treecast channels the SLO reads).
        peers_alive[t] = (0 if root_dead else 1) + sum(
            1 for p in range(1, n)
            if alive[p] and subscribed[p] and current(p) is not None
        )
        peers_orphaned[t] = _count_orphans(members, current, n)

    # -- settle: let repairs finish and delayed copies drain ---------------
    settle = (
        settle_s if settle_s is not None
        else max(0.75, 10 * dt + max(
            [w.delay * dt for w in spec.links], default=0.0))
    )
    settle_deadline = time.monotonic() + settle
    if root_dead and promoted is None:
        # Promotion may land after the last step: poll for it through the
        # settle window so buffered publishes still flush and get graded.
        while time.monotonic() < settle_deadline:
            promoted = find_promoted()
            if promoted is not None:
                heal_s = time.monotonic() - t_kill
                flush_pending(promoted)
                break
            time.sleep(dt)
    time.sleep(max(0.0, settle_deadline - time.monotonic()))
    if T:
        peers_orphaned[T - 1] = _count_orphans(members, current, n)

    # -- cross-host span collection + merge (tracing on) -------------------
    host_artifacts = merged = propagation = None
    if net.trace_sample is not None:
        from ..obs.merge import build_host_span_artifact, merge_host_artifacts
        from ..obs.spans import live_span_key

        # Every SyncHost ever created — killed originals and rejoined
        # generations included: a dead host's ledger still holds the stamps
        # it recorded while alive, which is exactly what a real collector
        # would have scraped before the crash.
        host_artifacts = [
            build_host_span_artifact(sh.id, sh.ledger)
            for sh in net._sync_hosts if sh.ledger is not None
        ]
        merged = merge_host_artifacts(host_artifacts, scenario=spec.name)
        propagation = merged["propagation"]

    # -- synthesize the flight-record channels and grade -------------------
    n_pub = len(requests)
    record = _synthesize_record(
        spec, members, requests, pub_wall, t0, dt, T,
        peers_alive, peers_orphaned,
    )
    if merged is not None and spec.family == "gossipsub" and T:
        # Span-exact latency: re-grade the lat_hist channel from merged
        # end-to-end propagation times (origin publish stamp → subscriber
        # deliver stamp) instead of collector-thread receipt times.  The
        # traced subset is the deterministic 1-in-N sample; quantile SLOs
        # grade the sample.  Protoid survives promotion, so post-failover
        # publishes key identically.
        protoid = f"{hosts[0].id}/{TOPIC}"
        traced_keys = {
            live_span_key(protoid, pub_payloads[i]) for i in range(n_pub)
        }
        B = record["lat_hist"].shape[1]
        span_hist = np.zeros((T, B), np.int64)
        span_lats: List[float] = []
        for tr in merged["traces"]:
            if tr["key"] not in traced_keys or tr["publish"] is None:
                continue
            for d in tr["deliveries"]:
                recv_step = min(T - 1, max(0, int((d["t"] - t0) / dt)))
                lat = max(0, int(d["latency_s"] / dt))
                span_hist[recv_step, min(lat, B - 1)] += 1
                span_lats.append(d["latency_s"])
        if span_lats:
            record["lat_hist"] = np.cumsum(span_hist, axis=0)
            from ..utils.metrics import quantiles

            q = quantiles(span_lats, (0.5, 0.99))
            record["span_prop_p50_s"] = np.full(T, q["p50"], np.float64)
            record["span_prop_p99_s"] = np.full(T, q["p99"], np.float64)
    # Failover channels (family-agnostic; constant series read at [-1] by
    # slo.evaluate): the surviving members' epoch agreement and the total
    # duplicate deliveries across every generation.
    epochs = [
        m.sub.sub.node.epoch
        for p in range(1, n) if (m := current(p)) is not None
    ]
    record["final_epoch"] = np.full(
        max(T, 1), min(epochs) if epochs else 0, np.int64)
    record["epoch_spread"] = np.full(
        max(T, 1), (max(epochs) - min(epochs)) if epochs else 0, np.int64)
    record["duplicate_deliveries"] = np.full(
        max(T, 1),
        sum(m.dups for gens in members.values() for m in gens), np.int64)
    verdict = slo_mod.evaluate(spec, record, n_pub)
    if merged is not None:
        merged["verdict"] = verdict.to_dict()
    return LiveScenarioResult(
        spec=spec,
        verdict=verdict,
        record=record,
        n_publishes=n_pub,
        chaos_trace=chaos.trace(),
        counters=net.registry.counters(),
        seconds=round(time.monotonic() - t_begin, 3),
        heal_s=round(heal_s, 3) if heal_s is not None else None,
        host_artifacts=host_artifacts,
        merged_trace=merged,
        propagation=propagation,
    )


def _count_orphans(members, current, n: int) -> int:
    c = 0
    for p in range(1, n):
        m = current(p)
        if m is None:
            continue
        node = m.sub.sub.node
        if node.is_root:
            continue  # a promoted successor HAS no parent by design
        ps = node.parent_stream
        if not node.closed and (ps is None or ps.closed):
            c += 1
    return c


def _synthesize_record(
    spec: ScenarioSpec,
    members: Dict[int, List[_Member]],
    pub_step_of: List[int],
    pub_wall: List[float],
    t0: float,
    dt: float,
    T: int,
    peers_alive: np.ndarray,
    peers_orphaned: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Build the flight-record channels :func:`~.slo.evaluate` reads.

    Gossip-family channels: cumulative ``delivery_frac`` over the
    survivor-scoped expected pairs, and a cumulative latency histogram in
    ROUNDS (receipt wall time re-quantized to steps) matching the sim
    recorder's ``lat_hist`` shape.  Treecast channels: total receipts,
    per-step liveness, and the orphan count.
    """
    n_pub = len(pub_step_of)
    # Expected pairs: survivors only (end_step is None), messages published
    # while the generation was subscribed.
    pairs_expected: List[Tuple[_Member, int]] = []
    for gens in members.values():
        for m in gens:
            if m.end_step is not None:
                continue
            for i in range(n_pub):
                if pub_step_of[i] >= m.alive_from:
                    pairs_expected.append((m, i))

    # Receipt latency (rounds) per delivered pair, over ALL generations —
    # victims' pre-death receipts count toward the treecast totals.  Latency
    # is wall time since the publish's fan-out returned, quantized to steps.
    lat_rounds: List[Tuple[int, int, int]] = []  # (pub_step, recv_step, lat)
    for gens in members.values():
        for m in gens:
            for i, t_recv in m.receipts.items():
                recv_step = min(T - 1, max(0, int((t_recv - t0) / dt)))
                lat = max(0, int((t_recv - pub_wall[i]) / dt))
                lat_rounds.append((pub_step_of[i], recv_step, lat))

    record: Dict[str, np.ndarray] = {}
    if spec.family == "treecast":
        delivered_total = np.zeros(T, np.int64)
        for _, recv_step, _ in lat_rounds:
            delivered_total[recv_step] += 1
        record["msgs_delivered_total"] = np.cumsum(delivered_total)
        record["peers_alive"] = peers_alive
        record["peers_orphaned"] = peers_orphaned
        return record

    # gossipsub family: delivery_frac + lat_hist.
    B = max(T, 8)
    frac = np.ones(T, np.float64)
    hist = np.zeros((T, B), np.int64)
    exp_by_pubstep = np.zeros(T, np.int64)
    del_by_pubstep = np.zeros(T, np.int64)
    for m, i in pairs_expected:
        ps = pub_step_of[i]
        exp_by_pubstep[ps] += 1
        if i in m.receipts:
            del_by_pubstep[ps] += 1
    exp_c = np.cumsum(exp_by_pubstep)
    del_c = np.cumsum(del_by_pubstep)
    nonzero = exp_c > 0
    frac[nonzero] = del_c[nonzero] / exp_c[nonzero]
    for _, recv_step, lat in lat_rounds:
        hist[recv_step, min(lat, B - 1)] += 1
    record["delivery_frac"] = frac
    record["lat_hist"] = np.cumsum(hist, axis=0)
    return record
