"""The stream: the serving engine fed a signed publish stream.

The program's serving path: ``MultiTopicGossipSub`` under
``StreamingEngine`` with an ``IngestRing``, every publish validated on
E1 (``ValidationPipeline(backend="device")``) before it enters the ring.

Set-up: the seed's messages signed in bulk (the traffic mix's generator,
``traffic/stream_arrivals.py``), the deployment's topology from the seed
(``inputs.topology``, handed to the model through its ``builder`` hook
and to the reference alike), the model's ``init`` (3 heartbeats), the
engine's warm-up chunk, the validation pipeline warmed at a full chunk and
at one envelope, and ``warm`` messages published and drained.

The window, one thread: before each chunk the messages due go through
the pipeline in one flush and into the ring (a steady mix: those whose
arrival time has passed; a saturated mix: as many as tops the ring up to
a full chunk), then ``run_chunk()``.  The engine runs a chunk whether or
not anything is queued: the simulated network's time goes on.  The
window lasts ``seconds`` and at least until the checked stretch has run
(on the card it holds ~250 chunks; the stretch ends by chunk 44).  A
saturated window that has used up its signed pool ends at that chunk
boundary (the pool is sized far above the rate the card serves, so this
only happens to a much faster program) and its metric is over the
seconds it ran.

A traced run serves its first ``HOST_SHARE`` of the window with the
program's span recorder held off and no profiler, as an untraced run
does; the host counters (lanes filled, push-to-completion times) are
read over that part alone.  Then the recorder comes back on and the
profiler traces ``TRACE_CHUNKS`` chunks; a traced host is slower than the
steady mix offers, so the ring's backlog from there on would describe a
saturated ring, not the cell.

``validated_msgs_per_s``: the peers each valid message had reached when
its completion was read (``StreamingEngine.deliveries``), summed over the
messages completed in the window, over the window's seconds.

``correct``, after the window and a drain: the warm start state against
the plain reference's (``reference/stream.py``); one stretch of
``check_length`` consecutive window chunks from a chunk drawn from the
seed, replayed by the reference from the program's state at its start
(cloned on the device then) with the events the engine dispatched, in
every state leaf, each chunk's delivered counts and the last round's
telemetry; each stretch lane against the ring's item it came from and
the reference's own ed25519 verdict; every verdict against the forged
set; the exactly-once counters (ring, engine, and every valid message
published once and completed once); the forged messages' spread.
"""

from __future__ import annotations

import gc
import inspect
import sys
import time
from typing import Dict, List

import numpy as np

from . import inputs, registry
from .common import RunError, check, model_seed
from .tracing import Spans, TraceWindow

HOST_SHARE = 0.5        # a traced run's untraced share of the window
TRACE_CHUNKS = 4        # chunks in the traced part of the window
DRAIN_CHUNKS = 64       # chunks the drain may take past the ring's depth
# The limit of the float comparisons (the closed loop's; PERF.md section 2
# gives the readings): the largest float gap over every float array, as a
# share of the reference array's largest magnitude.
FLOAT_GAP = 1e-4


def _require_program() -> None:
    """The serving path this driver reads: the model's topology hook and
    the engine's record of what a chunk dispatched."""
    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub
    from go_libp2p_pubsub_torch.serve import engine

    if ("builder" not in inspect.signature(MultiTopicGossipSub).parameters
            or not hasattr(engine.StreamingEngine, "_ingest")):
        raise RunError("the program's serving engine has no record of the "
                       "chunks it dispatched (StreamingEngine.last_events) "
                       "or its model no topology hook: the stream cells "
                       "cannot be checked")


_require_program()


def _program_model(cfg: dict, graph, dev):
    from go_libp2p_pubsub_torch.config import GossipSubParams, ScoreParams
    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub

    return MultiTopicGossipSub(
        n_topics=cfg["n_topics"], n_peers=cfg["n_peers"],
        n_slots=cfg["n_slots"], conn_degree=cfg["conn_degree"],
        msg_window=cfg["msg_window"],
        params=GossipSubParams(**cfg["params"]),
        score_params=ScoreParams(**cfg["score_params"]),
        heartbeat_steps=cfg["heartbeat_steps"],
        builder=inputs.TopologyBuilder(graph), device=dev)


def program_arrays(st, m: int) -> Dict[str, np.ndarray]:
    """The program's multi-topic state as the reference's plain arrays."""
    from pubsub_bench.reference import compare

    out = compare.program_state(st, m)
    out["state.keys"] = out["state.keys"].astype(np.int64) & compare.MASK
    out["state.step"] = np.asarray(int(st.step))
    return out


def _clone(st):
    """A copy of a state's tensors (the host ints as they are)."""
    import torch

    if hasattr(st, "_fields"):
        return type(st)(*(_clone(v) for v in st))
    return st.clone() if isinstance(st, torch.Tensor) else st


def sign(cfg: dict, msgs: dict) -> list:
    """Every message signed by the native signer (one batched call), the
    forged ones tampered after signing: ``inputs.Signed`` records."""
    from go_libp2p_pubsub_torch.crypto import native

    names = cfg["topics"]
    pks = native.public_key_batch(list(msgs["keys"]))
    raw = [native.signing_bytes(names[t], i, p) for i, (t, p) in
           enumerate(zip(msgs["topic"], msgs["payload"]))]
    sigs = native.sign_batch([msgs["keys"][k] for k in msgs["key"]], raw)
    out = []
    for i, (t, p, k, sig, bad) in enumerate(zip(
            msgs["topic"], msgs["payload"], msgs["key"], sigs,
            msgs["forged"])):
        if bad:
            p = bytes([p[0] ^ 0xFF]) + p[1:]
        out.append(inputs.Signed(names[t], i, p, pks[k], sig, bool(bad)))
    return out


class Feed:
    """The window's side of the ring: validates the messages due in one
    flush and pushes them, remembering each push (message index, verdict)
    in the ring's order."""

    def __init__(self, signed, msgs, pipe, ring):
        self.signed, self.msgs = signed, msgs
        self.envs = [inputs.to_envelope(s) for s in signed]
        self.pipe, self.ring = pipe, ring
        self.next = 0
        self.pushed: List[tuple] = []      # (message index, verdict)
        self.rejected = 0
        self.short = 0                     # messages due past the pool

    def push_until(self, upto: int) -> None:
        if upto > len(self.envs):
            self.short += upto - len(self.envs)
        batch = range(self.next, min(upto, len(self.envs)))
        if not len(batch):
            return
        for i in batch:
            self.pipe.submit(self.envs[i])
        verdicts = [ok for _, ok in self.pipe.flush()]
        m = self.msgs
        for i, ok in zip(batch, verdicts):
            if self.ring.push(int(m["topic"][i]), m["payload"][i],
                              int(m["publisher"][i]), valid=ok, timeout=0):
                self.pushed.append((i, ok))
            else:
                self.rejected += 1
        self.next = batch.stop


def run(ctx: dict) -> dict:
    import torch

    from go_libp2p_pubsub_torch.crypto.pipeline import ValidationPipeline
    from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip
    from go_libp2p_pubsub_torch.serve.engine import StreamingEngine
    from go_libp2p_pubsub_torch.serve.ingest import IngestRing
    from go_libp2p_pubsub_torch.utils import trace as program_trace

    cfg, mix, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], ctx["dev"]
    if "rate" in ctx:
        mix = dict(mix, rate_msgs_per_s=float(ctx["rate"]))
    gen = registry.generator(mix)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    n, m = cfg["n_peers"], cfg["msg_window"]
    steps, width = cfg["chunk_steps"], cfg["pub_width"]
    lanes = steps * width
    warm = int(mix["warm"])
    total = gen.count(mix, ctx["seconds"])
    msgs = gen.messages(mix, seed, total, n)
    signed = sign(cfg, msgs)
    due = (gen.arrivals(mix, seed, total - warm)
           if mix["mode"] == "steady" else None)

    graph = inputs.topology(seed, n, cfg["n_slots"], cfg["conn_degree"])
    model = _program_model(cfg, graph, dev)
    ring = IngestRing(int(cfg["ring_capacity"]), policy="block")
    engine = StreamingEngine(model, ring, chunk_steps=steps, pub_width=width,
                             completion_frac=float(cfg["completion_frac"]),
                             seed=model_seed(seed))
    start_state = _clone(engine.state)
    engine.warmup()
    pipe = ValidationPipeline(backend=cfg["crypto_backend"], device=dev,
                              flush_threshold=total + 1)
    for batch in (signed[:lanes], signed[:1]):
        for s in batch:
            pipe.submit(inputs.to_envelope(s))
        pipe.flush()
    feed = Feed(signed, msgs, pipe, ring)
    while feed.next < warm:
        feed.push_until(min(warm, feed.next + lanes))
        engine.run_chunk()
    engine.run_until_drained(DRAIN_CHUNKS)
    sync()

    spans = Spans(profile=bool(ctx["trace"]))
    tracer = TraceWindow(dev) if ctx["trace"] else None
    # The readers' recorder, held off until the traced part.
    held = program_trace.set_recorder(None) if tracer is not None else None
    trace_from = None
    saturated = due is None
    check_from = gen.stretch_start(mix, seed)
    check_len = int(mix["check_length"])
    stretch = {"events": [], "have": [], "items": []}
    cuda_gossip.reset_launches()
    cuda_ed25519.reset_launches()
    popped = len(feed.pushed)
    deliveries0, completed0 = engine.deliveries, len(engine.latencies_s)
    lanes0 = (engine.lanes_filled, engine.lanes_offered)
    host_end = None         # (lanes filled, offered, completions, chunks)
    pushed0 = len(feed.pushed)
    exhausted = False
    c = 0
    setup_s = time.perf_counter() - ctx["t_start"]
    t0 = time.perf_counter()
    while True:
        if (tracer is not None and trace_from is None
                and time.perf_counter() - t0 >= HOST_SHARE * ctx["seconds"]):
            host_end = (engine.lanes_filled, engine.lanes_offered,
                        len(engine.latencies_s), c)
            program_trace.set_recorder(held)
            tracer.start()
            trace_from = c
        if saturated and feed.next + lanes - ring.depth > len(feed.envs):
            exhausted = True
            break
        with spans.span("ingest"):
            if not saturated:
                now = time.perf_counter() - t0
                feed.push_until(warm + int(np.searchsorted(due, now,
                                                           side="right")))
            else:
                feed.push_until(feed.next + lanes - ring.depth)
        if c == check_from:
            stretch["start"] = _clone(engine.state)
            stretch["popped"] = popped
        with spans.span("chunk"):
            summary = engine.run_chunk()
        popped += summary["items"]
        if check_from <= c < check_from + check_len:
            stretch["events"].append(engine.last_events)
            stretch["have"].append(engine.state.have_w.clone())
            stretch["items"].append(summary["items"])
            if c == check_from + check_len - 1:
                stretch["end"] = _clone(engine.state)
                stretch["tail"] = dict(engine.flight_tail)
        if trace_from is not None and c == trace_from + TRACE_CHUNKS - 1:
            tracer.stop()
        c += 1
        if (time.perf_counter() - t0 >= ctx["seconds"]
                and c >= check_from + check_len):
            break
    elapsed = time.perf_counter() - t0
    sync()
    if tracer is not None:
        tracer.stop()
        program_trace.set_recorder(held)
    if host_end is None:
        host_end = (engine.lanes_filled, engine.lanes_offered,
                    len(engine.latencies_s), c)
    window_deliveries = engine.deliveries - deliveries0
    latencies = list(engine.latencies_s[completed0:host_end[2]])
    depth_at_end = ring.depth
    counters = {
        "chunks": c, "rounds": c * steps,
        "lanes_filled": host_end[0] - lanes0[0],
        "lanes_offered": host_end[1] - lanes0[1], "host_chunks": host_end[3],
        "depth_at_end": depth_at_end, "pool_exhausted": exhausted,
        "k1_launches": cuda_gossip.propagate.launches,
        "k2_launches": cuda_gossip.exchange_select.launches,
        "e1_launches": cuda_ed25519.verify.launches}
    records = {"spans": dict(spans.seconds), "counters": counters,
               "latencies_s": latencies, "card": ctx["card"]}
    if tracer is not None:
        records.update(tracer.records(ctx["card"]))
        traced = (min(TRACE_CHUNKS, c - trace_from)
                  if trace_from is not None else 0)
        records["rounds_traced"] = traced * steps
        del tracer
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    drain_chunks = engine.run_until_drained(DRAIN_CHUNKS
                                            + -(-depth_at_end // lanes))
    sync()
    counters.update(drain_chunks=drain_chunks,
                    pending_after_drain=len(engine.pending),
                    pushed_in_window=len(feed.pushed) - pushed0,
                    window_s=elapsed)
    print(f"stream: {c} chunks, {counters['pushed_in_window']} pushed in "
          f"the window ({counters['pushed_in_window'] / elapsed:.1f} msgs/s),"
          f" ring depth at its end {depth_at_end}, drained in {drain_chunks}"
          f" chunks, {len(engine.pending)} pending after", file=sys.stderr)

    run_out = {
        "pushed": list(feed.pushed), "rejected": feed.rejected,
        "short": feed.short, "accounting": ring.accounting(),
        "evicted": engine.evicted,
        "duplicate_completions": engine.duplicate_completions,
        "replay_deduped": engine.replay_deduped,
        "pending": len(engine.pending),
        "logged": [p.seq for p in engine.publish_log],
        "forged_spread": forged_spread(model, engine.state),
    }
    attempted = counters["pushed_in_window"] + feed.rejected
    result = {
        "attempted": attempted, "failed": 0, "checks": [],
        "e2e": {"validated_msgs_per_s": validated_rate(window_deliveries,
                                                       elapsed),
                "setup_s": setup_s},
        "records": records, "memory_peak_bytes": int(peak),
    }
    if not ctx.get("check", True):
        return result

    # The program's outputs to the host; its state freed before the
    # reference runs on the card.
    got = {"start": program_arrays(start_state, m)}
    if "end" in stretch:
        got["stretch_start"] = program_arrays(stretch["start"], m)
        got["end"] = program_arrays(stretch["end"], m)
        got["digests"] = [
            model.stream_digest(stretch["end"]._replace(have_w=h))[
                "delivered"].cpu().numpy() for h in stretch["have"]]
        got["tail"] = {k: np.asarray(v) for k, v in stretch["tail"].items()
                       if k != "step"}
        got["events"] = stretch["events"]
        got["lanes"] = lane_items(feed.pushed, stretch["popped"],
                                  stretch["items"])
    del engine, model, start_state, stretch, pipe, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from pubsub_bench.reference import closed_loop as ref_loop
    from pubsub_bench.reference import stream as ref_stream

    t_ref = time.perf_counter()
    control = bool(ctx.get("control"))
    ref = {"start": ref_stream.start(cfg, model_seed(seed), graph, dev)}
    if control:
        # The control in the program's place: the reference one precision
        # below the configuration's float32, in bfloat16.
        got["start"] = ref_stream.start(cfg, model_seed(seed), graph, dev,
                                        control=True)
    if "end" in got:
        ref.update(ref_stream.replay(cfg, got["stretch_start"],
                                     got["events"], dev))
        if control:
            ctl = ref_stream.replay(cfg, got["stretch_start"], got["events"],
                                    dev, control=True)
            got.update(end=ctl["end"], digests=ctl["digests"],
                       tail=ctl["tail"])
        stretch_signed = [signed[i] for i, _ in got["lanes"]]
        ref["verdicts"] = ref_loop.verdicts(stretch_signed)
    checks, failed = stream_checks(got, ref, run_out, msgs, check_len)
    print(f"phases: setup {setup_s:.1f} s, window {elapsed:.1f} s "
          f"({c} chunks), reference {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    result.update(checks=checks, failed=failed)
    return result


def validated_rate(deliveries: int, elapsed_s: float) -> float:
    """The peers reached by the valid messages completed in the window,
    over its seconds."""
    return float(deliveries) / elapsed_s


def forged_spread(model, st) -> int:
    """The most peers holding any one forged (invalid) message of the
    window, over the topics."""
    import torch

    have = model.have_bool(st)
    invalid = st.msg_used & ~st.msg_valid                      # [T, M]
    holders = torch.where(invalid, have.sum(dim=1), 0)
    return int(holders.max()) if holders.numel() else 0


def lane_items(pushed, popped: int, items: List[int]) -> List[tuple]:
    """The ring items (message index, verdict) of each lane the stretch's
    chunks filled, in lane order (the engine packs a chunk's items in the
    ring's order)."""
    out, at = [], popped
    for count in items:
        out.extend(pushed[at:at + count])
        at += count
    return out


def _lanes(events):
    """A chunk's filled lanes in the engine's packing order (round-robin
    over the rounds): (topic, publisher, verdict, window slot) each."""
    steps, width = events.pub_src.shape
    out = []
    for cursor in range(steps * width):
        r, col = cursor % steps, cursor // steps
        if events.pub_src[r, col] >= 0 and events.pub_topic[r, col] >= 0:
            out.append((int(events.pub_topic[r, col]),
                        int(events.pub_src[r, col]),
                        bool(events.pub_valid[r, col]),
                        int(events.pub_slot[r, col])))
    return out


def stream_checks(got: dict, ref: dict, run_out: dict, msgs: dict,
                  check_len: int):
    """The compared numbers of a stream run, and the messages that failed
    them."""
    from pubsub_bench.reference import compare

    first = compare.judge(got["start"], ref["start"])
    start_bad = sum(first["mismatches"].values())
    gap = first["float_gap"]
    worst = {"start." + k: v for k, v in first["mismatches"].items()}
    stretch_bad = digest_bad = lane_bad = verdict_bad = 0
    checked = 0
    spread = int(run_out["forged_spread"])
    if "end" in got:
        checked = len(got["events"])
        judged = compare.judge(got["end"], ref["end"])
        tail = compare.judge({"tail." + k: v for k, v in got["tail"].items()},
                             {"tail." + k: v for k, v in ref["tail"].items()})
        stretch_bad = (sum(judged["mismatches"].values())
                       + sum(tail["mismatches"].values()))
        worst.update(judged["mismatches"])
        worst.update(tail["mismatches"])
        gap = max(gap, judged["float_gap"], tail["float_gap"])
        digest_bad = sum(
            int(np.count_nonzero(np.asarray(a, np.int64)
                                 != np.asarray(b, np.int64)))
            for a, b in zip(got["digests"], ref["digests"]))
        digest_bad += abs(len(got["digests"]) - len(ref["digests"]))
        # Each lane against the ring item it came from, and its verdict
        # against the reference's ed25519.
        # A forged message's holders at the stretch's end, by the slot
        # its lane published it in (the stretch reuses no slot).
        filled = [lane for ev in got["events"] for lane in _lanes(ev)]
        want = got["lanes"]
        lane_bad = abs(len(filled) - len(want))
        have = got["end"]["state.have"]
        for (topic, src, ok, slot), (i, verdict), ref_ok in zip(
                filled, want, ref["verdicts"]):
            lane_bad += int(topic != int(msgs["topic"][i])
                            or src != int(msgs["publisher"][i])
                            or ok != verdict)
            verdict_bad += int(ok != bool(ref_ok))
            if msgs["forged"][i]:
                spread = max(spread, int(have[topic, :, slot].sum()))
    forged_set = np.asarray(msgs["forged"])
    wrong_verdicts = sum(int(ok == bool(forged_set[i]))
                         for i, ok in run_out["pushed"])
    valid = [seq for seq, (_, ok) in enumerate(run_out["pushed"]) if ok]
    logged = run_out["logged"]
    unaccounted = (len(set(valid) ^ set(logged))
                   + (len(logged) - len(set(logged))) + run_out["pending"])
    acct = run_out["accounting"]
    checks = [
        check("start_state_mismatches", start_bad, 0),
        check("stretch_mismatches", stretch_bad, 0),
        check("digest_mismatches", digest_bad, 0),
        check("lane_mismatches", lane_bad, 0),
        check("verdict_mismatches", verdict_bad, 0),
        check("verdicts_vs_forged_set", wrong_verdicts, 0),
        check("float_gap", gap, FLOAT_GAP),
        check("forged_spread", spread, 1),
        check("valid_not_completed_once", unaccounted, 0),
        check("silent_drops", acct["silent_drops"], 0),
        check("evicted", run_out["evicted"], 0),
        check("duplicate_completions", run_out["duplicate_completions"], 0),
        check("replay_deduped", run_out["replay_deduped"], 0),
        check("messages_short", run_out["short"], 0),
        check("ring_rejected", run_out["rejected"], 0),
        check("stretch_chunks_checked", checked, check_len, op=">="),
    ]
    if any(v for k, v in worst.items()):
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
        print("differing elements by array: " + ", ".join(
            f"{k} {v}" for k, v in top), file=sys.stderr)
    failed = wrong_verdicts + unaccounted + run_out["rejected"] + int(
        stretch_bad > 0 or digest_bad > 0 or lane_bad > 0 or gap > FLOAT_GAP)
    return checks, failed
