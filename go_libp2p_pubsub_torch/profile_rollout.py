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
  the host runs at nearly its unprofiled pace): its wall time, the device
  busy time (the union of its kernels' and copies' intervals on the card)
  and the idle share ``1 - busy / wall``, all of that one rollout, plus
  the kernel launches per round, the kernels that take the most time and
  the launches and device time of the port's own two kernels;
- one rollout traced with CPU and CUDA activity, with
  ``record_function`` ranges around the PRNG (``rng.split``,
  ``rng.uniform``), the round's two halves (``_propagate``,
  ``_heartbeat``), the flight recorder and the port's two kernel wrappers
  (``gossip_propagate``, ``gossip_exchange``): the device time of the
  kernels launched inside each range (ranges nest: the PRNG's time is also
  inside ``_heartbeat``'s, K1's inside ``_propagate``'s);
- one rollout under ``torch.cuda.set_sync_debug_mode("warn")``: every
  operation that synchronises the host with the device, by message (a
  round must have none before it can be captured as a CUDA graph).

With ``--campaign`` the same readings are of the composite attack
campaign of ``scenario/traces/campaign_100000.trace.json`` (scaled to
``--peers``): its compiled state and event rows, and
``rollout_events(record=True)`` over its 48 rounds, with two more ranges,
the event application before each round (``_apply_events``, publishes
included) and the adversary channels (``_campaign_record``).

With ``--serve`` the readings are of one serving chunk at ``--peers``:
the streaming engine of ``serve/stream_trace.py``'s configuration (2
topics, chunks of 8 rounds x 8 publishes), warmed, and each run pushes 8
messages to its ring and runs one ``run_chunk``.  The ranges are the
single-topic round each topic runs (``_propagate``, one call a topic a
round), the multi-topic ``_heartbeat``, the recorder's recount of the
chunk's last round (``flight_record_round``), the publishes
(``publish``) and the completion digest (``stream_digest``).

Prints one JSON object.  Needs a CUDA card.

With ``--phases`` it prints instead the per-phase times of one round at
``--peers`` (the headline geometry, 32 publishes, 4 rounds in), as the
JAX package's ``bench.py`` ``phase_breakdown`` splits it: a whole
heartbeat cycle (``round_cycle``, divided by the heartbeat period into
``round_amortized``), ``propagate`` (K1) and ``heartbeat``, and the
heartbeat's parts re-run on the state it sees -- ``hb_scores``,
``hb_mesh``, ``hb_px``, the scores/mesh/PX prologue unfused and fused,
``hb_gossip`` (the IHAVE/IWANT exchange, K2) and ``hb_fanout``.  Each is
the mean of ``--reps`` runs after a warm one, timed through
``utils.trace.StepTimer`` (host clock, ending in a synchronise of the
card); ``--trace-out`` writes the timer's Chrome trace.  It runs on
``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
import warnings
from collections import Counter
from typing import Optional

import numpy as np
import torch

from .models.gossipsub import GossipSub, resolve_device
from .ops import cuda_gossip
from .ops import rng as rng_ops

ROUNDS = 24
RNG_RANGES = ("split", "uniform")
MODEL_RANGES = ("_propagate", "_heartbeat", "flight_record_round")
CAMPAIGN_RANGES = ("_apply_events", "_campaign_record")
# range label -> (wrapper in ops/cuda_gossip.py, its kernel's name)
PORT_KERNELS = {"gossip_propagate": ("propagate", "propagate_kernel"),
                "gossip_exchange": ("exchange_select", "exchange_kernel")}


def _state(gs: GossipSub, n_msgs: int = 128, n_forged: int = 4):
    rng = np.random.default_rng(1)
    forged = set(rng.choice(n_msgs, size=n_forged, replace=False).tolist())
    st = gs.init(seed=0)
    for slot in range(n_msgs):
        st = gs.publish(st, int(rng.integers(gs.n)), slot, slot not in forged)
    return st


def _closed_loop(dev, n_peers: int):
    """(model, one recorded rollout, rounds) of the headline closed loop."""
    gs = GossipSub(n_peers=n_peers, n_slots=32, conn_degree=16,
                   msg_window=128, device=dev)
    st = _state(gs)
    return gs, lambda: gs.rollout(st, ROUNDS, record=True), ROUNDS


def _campaign(dev, n_peers: int):
    """(model, one recorded ``rollout_events``, rounds) of the composite
    campaign at ``n_peers``."""
    from .scenario import compile_scenario
    from .scenario.campaign import campaign_spec

    comp = compile_scenario(campaign_spec(n_peers), device=dev)
    gs = comp.model
    return gs, lambda: gs.rollout_events(
        comp.state, comp.events, attackers=comp.attackers,
        target=comp.target, record=True), comp.spec.n_steps


def _serve(dev, n_peers: int):
    """(model, one loaded serving chunk, rounds) at ``n_peers``."""
    from .models.multitopic import MultiTopicGossipSub
    from .serve import IngestRing, StreamingEngine
    from .serve import stream_trace as S
    from .serve.engine import _program

    model = MultiTopicGossipSub(device=dev, **dict(S.CONFIG, n_peers=n_peers))
    ring = IngestRing(capacity=S.CAPACITY, policy="block")
    eng = StreamingEngine(model, ring, seed=0, **S.ENGINE)
    eng.warmup()
    # The ranges go on the model the prepared program runs: an equal model
    # prepared earlier in the process owns it.
    model = _program(model, eng.chunk_steps, eng.pub_width).model
    pushed = [0]

    def run():
        for _ in range(S.ENGINE["pub_width"]):
            j = pushed[0]
            pushed[0] += 1
            ring.push(topic=j % model.t, payload=b"profile %d" % j,
                      publisher=(j * 7919) % n_peers)
        eng.run_chunk()
    return model, run, S.ENGINE["chunk_steps"]


# The ranges of each path: (owner of the method, its name, label).
def _model_targets(gs, names):
    return [(gs, name, name) for name in names]


def _serve_targets(model):
    return [(model.gs, "_propagate", "_propagate"),
            (model, "_heartbeat", "_heartbeat"),
            (model, "flight_record_round", "flight_record_round"),
            (model, "publish", "publish"),
            (model, "stream_digest", "stream_digest")]


def _timed(run) -> float:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _busy_ms(events) -> float:
    """Union of the device intervals (µs) of ``events``, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


@contextlib.contextmanager
def _ranges(targets):
    """Wrap the PRNG's functions, the kernel wrappers and the model methods
    ``targets`` ((object, method name, label) each) in ``record_function``
    ranges for the length of the block."""
    from torch.profiler import record_function

    def wrap(label, fn):
        @functools.wraps(fn)  # carries a wrapper's launch count along
        def ranged(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return ranged

    saved = [(rng_ops, name, f"rng.{name}") for name in RNG_RANGES]
    saved += [(cuda_gossip, fn, label)
              for label, (fn, _) in PORT_KERNELS.items()]
    saved = [(module, name, label, getattr(module, name))
             for module, name, label in saved]
    for module, name, label, fn in saved:
        setattr(module, name, wrap(label, fn))
    for obj, name, label in targets:
        setattr(obj, name, wrap(label, getattr(obj, name)))
    try:
        yield [label for _, _, label, _ in saved] + [
            label for _, _, label in targets]
    finally:
        for module, name, _, fn in saved:
            if hasattr(fn, "launches"):
                fn.launches = getattr(module, name).launches
            setattr(module, name, fn)
        for obj, name, _ in targets:
            delattr(obj, name)


def _kernel_events(events, kernel: str) -> list:
    """Device events of the port's kernel ``kernel``, in start order."""
    from torch.autograd import DeviceType

    return sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and kernel in e.name), key=lambda e: e.time_range.start)


def _range_device_ms(events, labels):
    """Device ms of the kernels launched inside each range, counting an
    outermost occurrence only (a range nested in one of its own name is
    already inside its parent's total); and, per port kernel, its launches
    and how many of them the trace links to a CPU event.

    A range's total holds the kernels the trace links to the CPU events
    inside it.  The port's kernels are launched through ctypes, not by an
    aten op; where the trace links none of a kernel's launches, they are
    matched in order with the calls of its wrapper's range (one launch a
    call, on one stream) and added to every range around each call."""
    from torch.autograd import DeviceType

    out = {label: 0.0 for label in labels}
    calls = Counter()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    for e in cpu:
        if e.name not in out:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != e.name:
            parent = parent.cpu_parent
        if parent is None:
            out[e.name] += e.device_time_total / 1e3
            calls[e.name] += 1
    port = {}
    for label, (_, kernel) in PORT_KERNELS.items():
        launched = _kernel_events(events, kernel)
        linked = sum(kernel in k.name for e in cpu for k in e.kernels)
        port[label] = {"launches": len(launched), "linked": linked}
        if linked == len(launched):
            continue
        wrapper = sorted((e for e in cpu if e.name == label),
                         key=lambda e: e.time_range.start)
        if linked or len(wrapper) != len(launched):
            raise SystemExit(
                f"{label}: {len(launched)} launches, {linked} linked to CPU "
                f"events, {len(wrapper)} wrapper calls: cannot attribute")
        for call, k in zip(wrapper, launched):
            around, parent = set(), call
            while parent is not None:
                around.add(parent.name)
                parent = parent.cpu_parent
            for name in around & out.keys():
                out[name] += k.time_range.elapsed_us() / 1e3
    return ({label: {"device_ms": out[label], "calls": calls[label]}
             for label in labels}, port)


def profile(n_peers: int, campaign: bool = False,
            serve: bool = False) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = torch.device("cuda", 0)
    build = _serve if serve else _campaign if campaign else _closed_loop
    gs, run, rounds = build(dev, n_peers)
    _timed(run)
    unprofiled_ms = [_timed(run) for _ in range(3)]

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = _timed(run)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise SystemExit("the CUDA trace holds no device events")
    busy_ms = _busy_ms(device)
    by_name: Counter = Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = [{"kernel": name[:90], "ms": ms} for name, ms in by_name.most_common(12)]
    port_kernels = {}
    for label, (_, kernel) in PORT_KERNELS.items():
        launched = _kernel_events(device, kernel)
        port_kernels[label] = {
            "launches": len(launched),
            "device_ms": sum(e.time_range.elapsed_us() for e in launched) / 1e3}

    targets = (_serve_targets(gs) if serve else _model_targets(
        gs, MODEL_RANGES + (CAMPAIGN_RANGES if campaign else ())))
    with _ranges(targets) as labels:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof_ranges:
            _timed(run)
    ranges, linked = _range_device_ms(prof_ranges.events(), labels)
    for label, seen in linked.items():
        port_kernels[label]["linked_in_range_trace"] = seen

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
        "ranges": ranges,
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
                    help="with --phases, write the timer's Chrome trace")
    args = ap.parse_args(argv)
    if args.phases:
        phases(args.peers, args.device, args.trace_out)
        return
    print(json.dumps(profile(args.peers, args.campaign, args.serve)))


if __name__ == "__main__":
    main()
