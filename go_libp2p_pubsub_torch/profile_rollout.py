"""Where a recorded rollout's time goes on the card.

    python -m go_libp2p_pubsub_torch.profile_rollout [--peers 100000]
    python -m go_libp2p_pubsub_torch.profile_rollout --campaign
    python -m go_libp2p_pubsub_torch.profile_rollout --serve
    python -m go_libp2p_pubsub_torch.profile_rollout --phases [--device cpu]

Builds the headline closed loop's model (GossipSub, 32 slots, degree 16,
128-message window, seed 0, 128 publishes of which 4 invalid), runs one
warm ``rollout(24, record=True)``, then, from the same state each time:

- three unprofiled rollouts: wall time (host clock, ending in a
  synchronise);
- one rollout traced with CUDA activity only (no CPU operator tracing, so
  the host runs at nearly its unprofiled pace) and the program's spans
  recorded (``utils.trace.set_recorder``): its wall time, the device busy
  time (the union of its kernels' and copies' intervals on the card) and
  the idle share ``1 - busy / wall``, the kernel launches per round, the
  kernels that take the most time and the launches (in all and a round)
  and device time of the port's own kernels (``port_kernels``: K1, K2,
  the PRNG's threefry kernel and the recorder's latency histogram); the
  device time of the
  kernels launched inside each program span (``ranges``: a kernel counts
  in every span open on the host when its launch call ran, the launch
  found through the trace's correlation id; spans nest, so K1's time is
  also in ``round.propagate``'s and ``rollout``'s); and the device's idle
  gaps, each named by the innermost span open on the host at the gap's
  midpoint (``idle_by_span``: the total by span and the 10 longest);
- one rollout under ``torch.cuda.set_sync_debug_mode("warn")``: every
  operation that synchronises the host with the device, by message (a
  round must have none before it can be captured as a CUDA graph).

With ``--campaign`` the same readings are of the composite attack
campaign of ``scenario/traces/campaign_100000.trace.json`` (scaled to
``--peers``): its compiled state and event rows, and
``rollout_events(record=True)`` over its 48 rounds, whose spans add the
event application before each round (``round.events``, publishes
included) and the adversary channels (``round.campaign_record``).

With ``--serve`` the readings are of one serving chunk at ``--peers``:
the streaming engine of ``serve/stream_trace.py``'s configuration (2
topics, chunks of 8 rounds x 8 publishes), warmed, and each run pushes 8
messages to its ring and runs one ``run_chunk``.  Its spans are the
single-topic round each topic runs (``round.propagate``, one a topic a
round), the multi-topic ``round.heartbeat``, the recorder's recount of
the chunk's last round (``round.record``), the publishes (``publish``)
and the completion digest (``stream.digest``).

``--trace-out PATH`` writes the traced run's Chrome trace with the spans
on a track of their own (``utils.trace.add_spans_to_trace``).

Prints one JSON object.  Needs a CUDA card.

With ``--phases`` it prints instead the per-phase times of one round at
``--peers`` (the headline geometry, 32 publishes, 4 rounds in), as the
JAX package's ``bench.py`` ``phase_breakdown`` splits it: a whole
heartbeat cycle (``round_cycle``, divided by the heartbeat period into
``round_amortized``), ``propagate`` (K1) and ``heartbeat``, and the
heartbeat's parts re-run on the state it sees -- ``hb_scores``,
``hb_mesh``, ``hb_px``, the scores/mesh/PX prologue unfused and fused,
``hb_gossip`` (the IHAVE/IWANT exchange, K2) and ``hb_fanout`` (the
parts a rollout records as the spans ``heartbeat.scores`` ...
``heartbeat.fanout``).  Each is the mean of ``--reps`` runs after a warm
one, timed through ``utils.trace.StepTimer`` (host clock, ending in a
synchronise of the card); ``--trace-out`` writes the timer's Chrome
trace.  It runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import time
import warnings
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.gossipsub import GossipSub, resolve_device
from .ops import cuda_gossip
from .ops import rng as rng_ops
from .utils import trace

ROUNDS = 24
# span of the port kernel's entry -> its kernel's name in the trace
PORT_KERNELS = {"kernel.k1": "propagate_kernel",
                "kernel.k2": "exchange_kernel",
                "kernel.prng": "threefry_kernel",
                "kernel.hist": "latency_hist_kernel"}
IDLE_GAPS = 10


def _state(gs: GossipSub, n_msgs: int = 128, n_forged: int = 4):
    rng = np.random.default_rng(1)
    forged = set(rng.choice(n_msgs, size=n_forged, replace=False).tolist())
    st = gs.init(seed=0)
    for slot in range(n_msgs):
        st = gs.publish(st, int(rng.integers(gs.n)), slot, slot not in forged)
    return st


def _closed_loop(dev, n_peers: int):
    """(one recorded rollout, rounds) of the headline closed loop."""
    gs = GossipSub(n_peers=n_peers, n_slots=32, conn_degree=16,
                   msg_window=128, device=dev)
    st = _state(gs)
    return lambda: gs.rollout(st, ROUNDS, record=True), ROUNDS


def _campaign(dev, n_peers: int):
    """(one recorded ``rollout_events``, rounds) of the composite campaign
    at ``n_peers``."""
    from .scenario import compile_scenario
    from .scenario.campaign import campaign_spec

    comp = compile_scenario(campaign_spec(n_peers), device=dev)
    return lambda: comp.model.rollout_events(
        comp.state, comp.events, attackers=comp.attackers,
        target=comp.target, record=True), comp.spec.n_steps


def _serve(dev, n_peers: int):
    """(one loaded serving chunk, rounds) at ``n_peers``."""
    from .models.multitopic import MultiTopicGossipSub
    from .serve import IngestRing, StreamingEngine
    from .serve import stream_trace as S

    model = MultiTopicGossipSub(device=dev, **dict(S.CONFIG, n_peers=n_peers))
    ring = IngestRing(capacity=S.CAPACITY, policy="block")
    eng = StreamingEngine(model, ring, seed=0, **S.ENGINE)
    eng.warmup()
    pushed = [0]

    def run():
        for _ in range(S.ENGINE["pub_width"]):
            j = pushed[0]
            pushed[0] += 1
            ring.push(topic=j % model.t, payload=b"profile %d" % j,
                      publisher=(j * 7919) % n_peers)
        eng.run_chunk()
    return run, S.ENGINE["chunk_steps"]


def _timed(run) -> float:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _trace_events(prof):
    """A finished ``torch.profiler`` session -> (device events, launches):
    device events as (name, correlation id, start ns, end ns), kernels and
    copies alike; launches as {correlation id: host start ns} of the CUDA
    API calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunch...``)
    that queued them.  Stamps are on the profiler's host clock, the one
    program spans are stamped on."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if "cuda" in str(e.device_type()).lower():
            if e.duration_ns() > 0:
                device.append((e.name(), e.correlation_id(), e.start_ns(),
                               e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    return device, launches


def _range_device_ms(device, launches, spans) -> Dict[str, dict]:
    """Device ms of the kernels launched inside each program span: a
    kernel counts once in every span name open on the host at its launch
    call's stamp (the launch found by correlation id), and in none when
    the trace holds no launch call for it.  -> {span name: {device_ms,
    calls}}."""
    by_name: Dict[str, list] = defaultdict(list)
    for r in spans:
        if r is not None:
            by_name[r[0]].append((r[1], r[2]))
    timed = sorted((launches[c], (b - a) / 1e6) for _, c, a, b in device
                   if c in launches)
    stamps = [t for t, _ in timed]
    prefix = np.concatenate([[0.0], np.cumsum([ms for _, ms in timed])])
    ranges = {}
    for name, intervals in sorted(by_name.items()):
        ms = 0.0
        for a, b in _union(intervals):   # a kernel counts once a name
            ms += (prefix[bisect.bisect_right(stamps, b)]
                   - prefix[bisect.bisect_left(stamps, a)])
        ranges[name] = {"device_ms": float(ms), "calls": len(intervals)}
    return ranges


def _idle_by_span(device, spans, w0: int, w1: int) -> dict:
    """The device's idle time in the host window [w0, w1] (ns), each gap
    named by the innermost span (the shortest) open on the host at the
    gap's midpoint, ``outside_spans`` where none is: the total ms by span
    and the ``IDLE_GAPS`` longest gaps."""
    busy = _union((max(a, w0), min(b, w1)) for _, _, a, b in device
                  if b > w0 and a < w1)
    closed = [r for r in spans if r is not None]
    names = [r[0] for r in closed]
    start = np.array([r[1] for r in closed], np.int64)
    end = np.array([r[2] for r in closed], np.int64)
    length = (end - start).astype(np.float64)
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    total: Dict[str, float] = defaultdict(float)
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        open_ = np.where((start <= mid) & (mid <= end), length, np.inf)
        name = (names[int(np.argmin(open_))]
                if closed and np.isfinite(open_.min()) else "outside_spans")
        total[name] += (b - a) / 1e6
        gaps.append((name, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"total_ms": dict(sorted(total.items(), key=lambda kv: -kv[1])),
            "longest": [[n, ms] for n, ms in gaps[:IDLE_GAPS]]}


def profile(n_peers: int, campaign: bool = False, serve: bool = False,
            trace_out: Optional[str] = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA card")
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = torch.device("cuda", 0)
    build = _serve if serve else _campaign if campaign else _closed_loop
    run, rounds = build(dev, n_peers)
    _timed(run)
    unprofiled_ms = [_timed(run) for _ in range(3)]

    timer = trace.StepTimer()
    before = trace.set_recorder(timer)
    try:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.time_ns()
            wall_ms = _timed(run)
            w1 = time.time_ns()
    finally:
        trace.set_recorder(before)
    device, launches = _trace_events(prof)
    if not device:
        raise SystemExit("the CUDA trace holds no device events")
    busy_ms = sum(b - a for a, b in _union(
        (a, b) for _, _, a, b in device)) / 1e6
    by_name: Counter = Counter()
    for name, _, a, b in device:
        by_name[name] += (b - a) / 1e6
    top = [{"kernel": name[:90], "ms": ms}
           for name, ms in by_name.most_common(12)]
    port_kernels = {}
    for label, kernel in PORT_KERNELS.items():
        ks = [(c, a, b) for n, c, a, b in device if kernel in n]
        port_kernels[label] = {
            "launches": len(ks),
            "launches_per_round": len(ks) / rounds,
            "device_ms": sum(b - a for _, a, b in ks) / 1e6,
            "linked_to_launch": sum(c in launches for c, _, _ in ks)}
    if trace_out is not None:
        prof.export_chrome_trace(trace_out)
        trace.add_spans_to_trace(trace_out, timer)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(str(w.message).splitlines()[0][:160] for w in caught)

    return {
        "device": torch.cuda.get_device_name(0),
        "n_peers": n_peers,
        "path": ("serving chunk" if serve else "rollout_events (campaign)"
                 if campaign else "rollout"),
        "rounds": rounds,
        "unprofiled_wall_ms": unprofiled_ms,
        "traced_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_round": len(device) / rounds,
        "top_kernels": top,
        "port_kernels": port_kernels,
        "ranges": _range_device_ms(device, launches, timer.spans),
        "unlinked_device_events": sum(c not in launches
                                      for _, c, _, _ in device),
        "spans_dropped": timer.dropped,
        "idle_by_span": _idle_by_span(device, timer.spans, w0, w1),
        "host_syncs_in_rollout": dict(syncs),
    }


def phase_breakdown(gs: GossipSub, st, reps: int, timer=None) -> dict:
    """Per-phase times (ms) of one round: ``bench.py``'s
    ``phase_breakdown`` on the port.  Sub-phases re-run the heartbeat's
    own functions on the same state the heartbeat sees; the exchange runs
    as the model runs it, its select on K2.

    Phases record through a :class:`~.utils.trace.StepTimer` (pass one to
    share the timeline with the caller's own phases)."""
    from .ops import scoring as scoring_ops
    from .ops.gossip import heartbeat_mesh
    from .ops.gossip_packed import gossip_exchange_packed
    from .ops.graphs import safe_gather
    from .ops.px import px_rewire
    from .utils.trace import StepTimer, block_until_ready

    p, sp = gs.params, gs.score_params
    # The sub-phases take the WIDE view of the index planes (int32, -1
    # sentinel), the one the heartbeat computes on; the rollout below takes
    # the STORAGE view.
    st_storage = st
    st = gs._widen_indices(st)
    timer = timer if timer is not None else StepTimer()
    phase_names = []

    def timeit(name, fn, *args):
        block_until_ready(fn(*args))  # warm
        for _ in range(reps):
            with timer(name):
                timer.fence(fn(*args))
        phase_names.append(name)

    # A round's heartbeat runs only every heartbeat_steps rounds, so the
    # per-round figure times a whole heartbeat cycle and divides.
    hb_steps = gs.heartbeat_steps

    def full_cycle(s):
        return gs.rollout(s, hb_steps, record=False)[0]

    block_until_ready(full_cycle(st_storage))
    for _ in range(max(1, reps // 2)):
        with timer("round_cycle"):
            timer.fence(full_cycle(st_storage))
    timeit("propagate", gs._propagate, st)
    timeit("heartbeat", gs._heartbeat, st)

    def scores_fn(counters, gcounters, mesh, nbrs, nbr_valid):
        c = scoring_ops.tick_mesh_clocks(counters, mesh, p.heartbeat_interval_s)
        c = scoring_ops.decay_topic_counters(c, sp)
        g = scoring_ops.decay_global_counters(gcounters, sp)
        return scoring_ops.neighbor_scores(c, g, nbrs, nbr_valid, sp)

    timeit("hb_scores", scores_fn,
           st.counters, st.gcounters, st.mesh, st.nbrs, st.nbr_valid)
    scores = scores_fn(
        st.counters, st.gcounters, st.mesh, st.nbrs, st.nbr_valid
    )
    part = st.alive & st.subscribed
    edge_ok = st.edge_live & st.nbr_sub
    key = rng_ops.PRNGKey(1, device=gs.device)

    def mesh_fn(k_, mesh, sc, nbrs, rev, eo, al, bo, ob):
        return heartbeat_mesh(
            k_, mesh, sc, nbrs, rev, eo, al, p, bo, ob, False,
            og_threshold=sp.opportunistic_graft_threshold)

    timeit("hb_mesh", mesh_fn, key, st.mesh, scores, st.nbrs, st.rev,
           edge_ok, part, st.backoff, st.outbound)
    nm, gr, pr, bo, bv = mesh_fn(
        key, st.mesh, scores, st.nbrs, st.rev, edge_ok, part,
        st.backoff, st.outbound)

    def px_fn(k_, nbrs, rev, nv, ob, bo_, nm_, pr_, sc, al):
        return px_rewire(k_, nbrs, rev, nv, ob, bo_, nm_, pr_, sc, al,
                         sp.accept_px_threshold)

    timeit("hb_px", px_fn, key, st.nbrs, st.rev, st.nbr_valid, st.outbound,
           bo, nm, pr, scores, st.alive)

    # The three prologue functions above each re-gather the same [N, K]
    # index planes; the fused path computes (jidx, ridx) once and threads
    # them through (plus the px offer bit out of heartbeat_mesh's gather):
    # the whole scores -> mesh -> px prologue, both ways.
    def _prologue(fused):
        def run(k_, counters, gcounters, mesh, nbrs, rev, nbr_valid, eo, al,
                backoff, outbound, alive):
            edge_idx = (
                (torch.clamp(nbrs, 0, gs.n - 1), torch.clamp(rev, 0, gs.k - 1))
                if fused else None
            )
            c = scoring_ops.tick_mesh_clocks(counters, mesh,
                                             p.heartbeat_interval_s)
            c = scoring_ops.decay_topic_counters(c, sp)
            g = scoring_ops.decay_global_counters(gcounters, sp)
            sc = scoring_ops.neighbor_scores(
                c, g, nbrs, nbr_valid, sp,
                jidx=None if edge_idx is None else edge_idx[0],
            )
            hb = heartbeat_mesh(
                k_, mesh, sc, nbrs, rev, eo, al, p, backoff, outbound,
                False, og_threshold=sp.opportunistic_graft_threshold,
                edge_idx=edge_idx, with_px_offer=fused,
            )
            nm_, _gr, pr_, bo_, _bv = hb[:5]
            return px_rewire(
                k_, nbrs, rev, nbr_valid, outbound, bo_, nm_, pr_, sc,
                alive, sp.accept_px_threshold,
                edge_idx=edge_idx, offer_ok=hb[5] if fused else None,
            )
        return run

    pro_args = (key, st.counters, st.gcounters, st.mesh, st.nbrs, st.rev,
                st.nbr_valid, edge_ok, part, st.backoff, st.outbound,
                st.alive)
    timeit("hb_prologue_unfused", _prologue(False), *pro_args)
    timeit("hb_prologue_fused", _prologue(True), *pro_args)

    # Masks and fanout logic come from the model's own helpers, so the
    # profiled functions cannot drift from the shipped heartbeat.
    have_scrubbed, gossip_w = gs.gossip_window_masks(st)

    def ihave_iwant(k_, have_adv, have_dedup, nm_, nbrs, rev, eo, al, sc,
                    gw, mute):
        serve_ok = ~safe_gather(mute, nbrs, True)
        return gossip_exchange_packed(
            k_, k_, have_adv, have_dedup, nm_, nbrs, rev, eo, al, sc, gw,
            p, sp.gossip_threshold, serve_ok, p.max_iwant_length,
            select=cuda_gossip.exchange_select)

    timeit("hb_gossip", ihave_iwant, key, st.have_w, have_scrubbed, nm,
           st.nbrs, st.rev, edge_ok, part, scores, gossip_w, st.gossip_mute)

    timeit("hb_fanout", gs.fanout_maintenance, key, st.fanout,
           st.fanout_age, st.subscribed, st.alive, edge_ok, scores)

    stats = timer.stats()
    out = {n: round(stats[n]["mean_ms"], 2) for n in phase_names}
    out["round_amortized"] = round(stats["round_cycle"]["mean_ms"] / hb_steps, 2)
    return out


def phases(n_peers: int, device, trace_out: Optional[str] = None) -> dict:
    """``--phases``: the JAX package's ``tools/profile_rollout.py`` -- the
    headline geometry, 32 valid publishes from seeded random peers, 4
    rounds in, then :func:`phase_breakdown`; prints the per-phase times
    (ms) and returns them."""
    from .utils.trace import StepTimer, block_until_ready

    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name}  n={n_peers}  "
          f"kernel={'cuda' if dev.type == 'cuda' else 'plain'}")
    gs = GossipSub(n_peers=n_peers, n_slots=32, conn_degree=16,
                   msg_window=128, device=dev)
    t0 = time.perf_counter()
    st = block_until_ready(gs.init(seed=0))
    print(f"init: {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    for slot in range(32):
        st = gs.publish(st, int(rng.integers(n_peers)), slot, True)
    st = gs.rollout(st, 4, record=False)[0]
    timer = StepTimer()
    out = phase_breakdown(gs, st, 8, timer)
    for phase, ms in out.items():
        print(f"{phase:24s} {ms:9.2f} ms")
    if trace_out is not None:
        with open(trace_out, "w") as f:
            f.write(timer.export_chrome_trace())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=100_000)
    ap.add_argument("--campaign", action="store_true",
                    help="profile the composite campaign's rollout_events")
    ap.add_argument("--serve", action="store_true",
                    help="profile one loaded streaming-engine chunk")
    ap.add_argument("--phases", action="store_true",
                    help="time the round's phases and the heartbeat's parts "
                    "(bench.py's phase_breakdown)")
    ap.add_argument("--device", default="cuda",
                    help="where --phases runs (default cuda)")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the traced run's Chrome trace with the "
                    "program's spans (with --phases, the timer's)")
    args = ap.parse_args(argv)
    if args.phases:
        phases(args.peers, args.device, args.trace_out)
        return
    print(json.dumps(profile(args.peers, args.campaign, args.serve,
                             args.trace_out)))


if __name__ == "__main__":
    main()
