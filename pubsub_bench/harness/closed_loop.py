"""The closed loop: one simulation client, a new episode when the last ends.

Set-up: the seed's signed windows (the traffic mix's generator gives
``pool`` of them), the deployment's topology from the seed
(``inputs.topology``, handed to ``GossipSub`` through its ``builder``
hook and to the reference alike), ``init`` and 3 warm heartbeats, the
device validation pipeline, and one warm episode.

An episode, from the same warm state each time (the API is functional):
validate the episode's window through ``ValidationPipeline(backend=
"device")`` (E1 launched once, verdicts on the host), publish its
messages from publishers drawn from the seed with their verdicts,
``rollout(rounds, record=True)``, ``delivery_stats`` read to the host.

``validated_msgs_per_s``: the deliveries of valid messages of every
episode in the window (a delivery is one peer's receipt, the delivery
fraction times the peers) over the window's seconds, from its start to
the end of its last episode.

``correct``: the warm start state, and up to ``check_episodes`` episodes
drawn from the seed among all the window's episodes (a reservoir), held
against the plain reference (``reference/closed_loop.py``) in every
state leaf, flight-record channel and delivery statistic (integers and
booleans equal, floats within ``FLOAT_GAP``, the approximate score
quantiles within ``QUANTILE_BINS`` bins), their verdicts against the
reference's ed25519; every episode's verdicts against the window's
forged set; the forged messages' spread.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from . import inputs, registry
from .common import check, model_seed, rng_for
from .tracing import Spans, TraceWindow

TRACE_FROM = 2          # the first traced episode (after two untraced)
TRACE_EPISODES = 3      # episodes in the traced part of the window
# The limits of the float comparisons (PERF.md section 2 gives the
# readings they were set from): the largest float gap over every float
# array, as a share of the reference array's largest magnitude, and the
# recorded score quantiles' distance in bins.
FLOAT_GAP = 1e-4
QUANTILE_BINS = 1.01


def _program_model(cfg: dict, graph, dev):
    from go_libp2p_pubsub_torch.config import GossipSubParams, ScoreParams
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub

    return GossipSub(
        n_peers=cfg["n_peers"], n_slots=cfg["n_slots"],
        conn_degree=cfg["conn_degree"], msg_window=cfg["msg_window"],
        params=GossipSubParams(**cfg["params"]),
        score_params=ScoreParams(**cfg["score_params"]),
        heartbeat_steps=cfg["heartbeat_steps"],
        builder=inputs.TopologyBuilder(graph), device=dev)


def run(ctx: dict) -> dict:
    import torch

    from go_libp2p_pubsub_torch.crypto.pipeline import ValidationPipeline
    from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip

    cfg, mix, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], ctx["dev"]
    gen = registry.generator(mix)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    n, window, rounds = cfg["n_peers"], cfg["msg_window"], cfg["rollout_rounds"]
    pool = int(mix["pool"])
    signed = inputs.sign_windows(gen.windows(mix, seed, window))
    envs = [[inputs.to_envelope(s) for s in w] for w in signed]
    expected = [inputs.expected_verdicts(w) for w in signed]

    graph = inputs.topology(seed, n, cfg["n_slots"], cfg["conn_degree"])
    gs = _program_model(cfg, graph, dev)
    st0 = gs.init(seed=model_seed(seed))
    pipe = ValidationPipeline(backend="device", device=dev,
                              flush_threshold=window + 1)
    spans = Spans(profile=bool(ctx["trace"]))

    def episode(e: int):
        with spans.span("validate"):
            for env in envs[e % pool]:
                pipe.submit(env)
            ok = [v for _, v in pipe.flush()]
        pubs = gen.publishers(mix, seed, e, window, n)
        with spans.span("publish"):
            st = st0
            for slot in range(window):
                st = gs.publish(st, int(pubs[slot]), slot, ok[slot])
        with spans.span("rollout", sync=sync if ctx["trace"] else None):
            out, rec = gs.rollout(st, rounds, record=True)
        with spans.span("stats"):
            stats = gs.delivery_stats(out)
            frac = stats[0].cpu().numpy()
        delivered = float(np.nansum(frac.astype(np.float64))) * n
        return np.array(ok), out, rec, stats, delivered

    episode(-1)                                 # the warm episode
    sync()
    spans.seconds.clear()
    cuda_gossip.reset_launches()
    cuda_ed25519.reset_launches()
    sample_rng = rng_for(seed, 20)
    keep = int(mix["check_episodes"])
    kept = []                                   # (episode, outputs)
    wrong_verdicts = 0
    tracer = TraceWindow(dev) if ctx["trace"] else None
    delivered, ends, e = [], [], 0
    setup_s = time.perf_counter() - ctx["t_start"]
    t0 = time.perf_counter()
    while True:
        if tracer is not None and e == TRACE_FROM:
            tracer.start()
        ok, out, rec, stats, ep_delivered = episode(e)
        if tracer is not None and e == TRACE_FROM + TRACE_EPISODES - 1:
            tracer.stop()
        delivered.append(ep_delivered)
        ends.append(time.perf_counter() - t0)
        wrong_verdicts += int(np.count_nonzero(ok != expected[e % pool]))
        slot = len(kept) if len(kept) < keep else int(
            sample_rng.integers(0, e + 1))
        if slot < keep:
            item = (e, (ok, out, rec, stats))
            if slot == len(kept):
                kept.append(item)
            else:
                kept[slot] = item
        e += 1
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    elapsed = time.perf_counter() - t0
    sync()
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counters = {"episodes": e, "rounds": e * rounds,
                "k1_launches": cuda_gossip.propagate.launches,
                "k2_launches": cuda_gossip.exchange_select.launches,
                "e1_launches": cuda_ed25519.verify.launches}
    records = {"spans": dict(spans.seconds), "counters": counters,
               "card": ctx["card"]}
    if tracer is not None:
        records.update(tracer.records(ctx["card"]))
        traced = min(TRACE_EPISODES, max(e - TRACE_FROM, 0))
        records["rounds_traced"] = traced * rounds
        del tracer

    # The program's outputs to the host; its state freed before the
    # reference runs on the card.
    from pubsub_bench.reference import closed_loop as ref_loop
    from pubsub_bench.reference import compare

    m = cfg["msg_window"]
    start = compare.program_state(st0, m)
    got = []
    for ep, (ok, out, rec, stats) in sorted(kept, key=lambda k: k[0]):
        arrays = compare.program_state(out, m)
        arrays.update(compare.named(rec, "record."))
        arrays.update(compare.named(
            dict(zip(("frac", "p50", "p99"), stats)), "stats."))
        got.append((ep, ok, arrays))
    del gs, st0, pipe, kept, out, rec, stats
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_inputs = [{"window": signed[ep % pool],
                   "publishers": gen.publishers(mix, seed, ep, window, n)} for ep, _, _ in got]
    t_ref = time.perf_counter()
    ref = ref_loop.episodes(cfg, model_seed(seed), graph, ref_inputs, dev)
    if ctx.get("control"):
        # The control in the program's place: the reference one precision
        # below the configuration's float32, in bfloat16.
        ctl = ref_loop.episodes(cfg, model_seed(seed), graph, ref_inputs,
                                dev, control=True)
        start = ctl["start"]
        got = [(ep, c["verdicts"], c["arrays"])
               for (ep, _, _), c in zip(got, ctl["episodes"])]
    checks, failed = closed_loop_checks(start, got, ref, signed, pool)
    failed += wrong_verdicts
    checks.insert(1, check("verdicts_vs_forged_set", wrong_verdicts, 0))
    thirds = np.array_split(np.diff([0.0] + ends), 3)
    print("episode seconds, median by third of the window: " + ", ".join(
        f"{np.median(part):.4f}" for part in thirds if len(part)),
        file=sys.stderr)
    print(f"phases: setup {setup_s:.1f} s, window {elapsed:.1f} s "
          f"({e} episodes), reference {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    return {
        "attempted": e, "failed": failed, "checks": checks,
        "e2e": {"validated_msgs_per_s": validated_rate(delivered, elapsed),
                "setup_s": setup_s},
        "records": records, "memory_peak_bytes": int(peak),
    }


def validated_rate(delivered, elapsed_s: float) -> float:
    """Deliveries of every episode in the window over its seconds."""
    return float(sum(delivered)) / elapsed_s


def closed_loop_checks(start, got, ref, signed, pool):
    """The compared numbers of a closed-loop run, and the episodes that
    failed them."""
    from pubsub_bench.reference import compare

    first = compare.judge(start, ref["start"])
    start_bad = sum(first["mismatches"].values())
    gap, bins = first["float_gap"], 0.0
    verdict_bad = arrays_bad = spread = failed = 0
    worst = {}
    for (ep, ok, arrays), r in zip(got, ref["episodes"]):
        vb = int(np.count_nonzero(ok != r["verdicts"]))
        judged = compare.judge(arrays, r["arrays"], r["widths"])
        ab = sum(judged["mismatches"].values())
        for k, v in judged["mismatches"].items():
            worst[k] = worst.get(k, 0) + v
        gap = max(gap, judged["float_gap"])
        bins = max(bins, judged["quantile_bins"])
        verdict_bad += vb
        arrays_bad += ab
        failed += int(vb > 0 or ab > 0 or judged["float_gap"] > FLOAT_GAP
                      or judged["quantile_bins"] > QUANTILE_BINS)
        have = arrays["state.have"]
        for slot, s in enumerate(signed[ep % pool]):
            if s.forged:
                spread = max(spread, int(compare.bit_holders(have, slot).sum()))
    for k, v in first["mismatches"].items():
        worst["start." + k] = v
    checks = [
        check("start_state_mismatches", start_bad, 0),
        check("verdict_mismatches", verdict_bad, 0),
        check("episode_mismatches", arrays_bad, 0),
        check("float_gap", gap, FLOAT_GAP),
        check("score_quantile_bins", bins, QUANTILE_BINS),
        check("forged_spread", spread, 1),
        check("episodes_checked", len(got), 1, op=">="),
    ]
    if worst:
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
        print("differing elements by array: " + ", ".join(
            f"{k} {v}" for k, v in top), file=sys.stderr)
    return checks, failed
