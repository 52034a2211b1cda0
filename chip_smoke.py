#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each one fails the run, exit code != 0, on any error):

1. probe   -- a CUDA card must be present; prints its name and power limit;
2. build   -- compiles the gossip kernels K1/K2 and the ed25519 verify
              kernel E1 (nvcc, sm_90a, one call each) and the native
              ed25519 library (g++) from the repository's sources, all at
              once; counts the multiplies of E1's field multiply in its
              SASS (cuobjdump);
3. kernels -- each kernel against its plain PyTorch version on the card,
              bit for bit, in every arm: at N in {100000, 589}, K in
              {8, 16, 32}, W = 4, and over every instantiation and tail
              (W in {1, 2, 3, 4, 8}, K in {1, 8, 16, 31, 32}, N in {1,
              589, enough peers for several tiles a block and a ragged
              last one}); fails if ``-Xptxas -v`` reports a spill; prints
              how many blocks of each instantiation an SM holds; times
              both at the main path's shapes (CUDA events), warm and with
              the L2 flushed, beside the least time the card could take;
4. ed25519 -- E1 against the native library on every row, its plain
              PyTorch version (on the card) at every batch up to 2048 and
              the oracle on 128 rows, over the RFC 8032 vectors and a
              4096-signature corruption sweep, at every window the kernel
              has (w = 1 ... 6, the main path's among them) and at B in
              {1, 3, 7, 9, 127, 128, 129, 511, 512, 513, 2048, 4102}
              (batches that split a team, a warp and a block) in both
              arms (the team of four lanes and one thread a signature),
              with both arms again at the wrapper's crossover and one
              either side, and on the main path's 128-envelope window;
              counts the differing verdicts and fails if there is one;
              prints each instantiation's registers, stack frame and
              spills; E1's device time (CUDA events) at the 128-envelope
              window and at B = 512 ... 32768, the window sweep (w = 1
              ... 6 at every batch), ``verify_batch``'s wall time, the
              plain version's and the native library's times, and E1's
              bound
              (integer multiplies), on the whole card and on the SMs its
              launch occupies, and its share of each.  With
              ``--e1-baseline DIR`` it also builds the E1 of the checkout
              at DIR (the parent commit) and times it against this one in
              turns (baseline, this, this, baseline, twice) at every
              batch;
5. main    -- the closed loop: 128 signed envelopes (4 forged) verified by
              the native library, and again through
              ``ValidationPipeline(backend="device")`` on E1 (one launch;
              its time printed beside, not charged), GossipSub(100000
              peers, 32 slots, degree 16, 128-message window) on the
              card, 128 publishes with the real verdicts, a warm and a
              timed 24-round recorded rollout, the flight summary and
              delivery stats; asserts delivery, that no forged message
              spread, and that the timed rollout launched K1 24 times and
              K2 3 times.  A small model run on the card and on the CPU
              must agree leaf for leaf;
6. scenario -- the scenario event path: every sim-supported gossipsub
              campaign of the canon (14) and the composite attack
              campaign at 2,000 peers (as committed, and with per-edge
              delay: ``max_edge_delay=2``, a seeded random 0-2 delay
              plane, the eclipse wave dropped) through
              ``scenario.run_scenario`` on the card and on the CPU, equal
              in verdict, every record channel and every state leaf; then
              ``compile_scenario`` of the committed 100,000-peer trace the
              JAX package wrote (timed), ``replay_trace`` on that compiled
              copy, which must match the trace channel for channel with
              the same verdict and is also the warm run, a timed
              ``rollout_events`` of it (wall time ending in the record's
              read to the host), asserting 48 K1, 6 K2 and no E1 launches
              and that no invalid message reached a peer other than its
              publisher, and one more run under
              ``torch.cuda.set_sync_debug_mode("warn")`` counting the
              operations that synchronise;
7. serve    -- the streaming serving plane (the serving bench's
              configuration at 100,000 peers, 2 topics, chunks of 8 rounds
              x 8 publishes): the three workloads under a stepping clock
              through ``StreamingEngine`` at 2,000 peers on the card and
              on the CPU (every chunk's completions, delivered counts and
              flight tail, the latencies, the delivery stats and every
              state leaf equal) and the canon's ``multitopic_hot_
              publisher`` on both; the committed 100,000-peer trace the
              JAX package's engine wrote, replayed on the card with 0
              mismatches; the timed run of the three workloads with the
              real clock and the envelopes signed and verified inline by
              the native library (msgs/s, ingest p50/p99, depth, silent
              drops 0, forged spread <= 1, one prepared program, K1 =
              topics x rounds and K2 = topics x heartbeats, peak memory);
              three chunks under the sync-debug mode, which must
              synchronise exactly twice each (the digest and the flight
              tail reads); and 5 crash/restore cycles (``snapshot_every=
              1``) that must lose and duplicate nothing, keep one prepared
              program, and end equal to an uninterrupted engine, leaf for
              leaf.  Then the control and fault layers: the canon's four
              multitopic streaming campaigns (64 peers) through
              ``scenario.run_streaming_scenario`` under the stepping
              clock, against the trace the JAX package's runner wrote (0
              mismatches: verdicts, records, accounting, completions and
              latencies chunk by chunk); the crash campaign (traced,
              ``trace_out=``) and the verifier-crash campaign at 100,000
              peers, which must pass with nothing lost, duplicated or
              silently dropped, at most one program prepared (their
              geometry's), every sampled span closed and the reopened ones
              annotated with the crash gap, K1 = topics x rounds, K2 =
              topics x heartbeats and no E1; the crash campaign at 2,000
              peers on the card and on the CPU (every channel and state
              leaf equal); the serving bench's ``degraded`` ladder (the
              tiers must reach shed_priority and drop_oldest and return to
              normal, 0 silent drops); and its ``obs`` A/B on the 100k
              model (traced and untraced arms alternating, two repeats,
              equal completions, every span closed, no program prepared;
              the overhead is printed against the 2% budget);
8. tree     -- the tree plane and the rest of the router family: the
              100,000-peer ``TreeCast`` (``bench.py``'s ``bench_treecast``
              configuration scaled up, width 2 / max width 5) joins all
              at once, drains 64 root publishes in a timed
              ``rollout(record=True)`` and heals after 1% kills and 1%
              graceful leaves with 32 more publishes in a second one,
              against the trace the JAX package wrote
              (``models/traces/tree_100000.trace.json``, 0 mismatches:
              every step's ``tree_metrics`` and every leaf's digest at
              each phase's end), with 0 syncs inside the timed rollouts
              (counted under the sync-debug mode), device operations a
              step (profiler) and each step phase's device time (CUDA
              events); ``bench_treecast`` itself (10 peers, 64 messages,
              the delivered count asserted); the reference's integration
              contracts, two topics and a lossy link profile through
              ``SimNetwork`` on the card and on the CPU (equal bytes,
              message for message); at 2,000 peers card = CPU, leaf for
              leaf, for a tree under a ``FaultPlan`` through
              ``run_with_faults``, the canon's ``tree_churn_heal``
              widened (PASS on both) and FloodSub / RandomSub (default
              emit and emit 6: 32 slots, degree 16, 128 publishes, 24
              rounds, 1% killed at round 8); the same three at 100,000
              peers (delivery no lower than at 2,000 minus 0.01,
              rounds/s, peak memory); and ``GossipSub(direct_edges=)``
              over 1% of the wired edge pairs: at 2,000 peers card = CPU
              with one round's K1 and one heartbeat's K2 inputs held
              against the plain versions bit for bit, and at 100,000
              peers main-path style (128 publishes, 4 forged, a timed
              ``rollout(24, record=True)``: K1 24 and K2 3 launches,
              forged spread <= 1, every direct edge's receiver within one
              round of its sender, no direct edge in the mesh);
9. coded    -- the coded plane: the coded trace the JAX package wrote
              (``models/traces/coded.trace.json``: RLNC at 16,384 peers
              and the hybrid at 65,536, every step's receipts, rank
              histogram, stamp and loss digests, coded edges) and the
              canon's three hybrid streaming campaigns (the JAX runner's
              trace under the stepping clock) replayed with 0
              mismatches; ``degraded_links_rlnc`` on the card and on the
              CPU (equal verdict, record, state); at 2,000 peers card =
              CPU for RLNC with a decimated quarter, the hybrid under
              decimation and Bernoulli loss, and a hybrid streaming
              engine killed mid-decode and restored (every leaf, record
              channel, flight tail and completion); RLNC at
              ``bench.py``'s ``RLNC_SCALE`` widths and 100,000 peers, 24
              rounds each (the metric's window), clean and degraded (validated msgs/s,
              delivery, p50/p99, 0 syncs,
              forged spread <= 1, peak memory, a step's device time by
              part and its launches); and the hybrid at ``HYBRID_SCALE``'s
              widths and 100,000 peers against its eager-forced twin over
              d = 0, 2 and p = 0.125, 0.25, 0.5 (points past 180 s
              dropped and listed; the d = 0 identity leaf for leaf; K1 =
              runs x 32 and K2 = runs x 8; 0 syncs; the crossover; one
              round's K1 and one heartbeat's K2 inputs, coded edges
              present, against the plain versions, max abs err 0);
10. sharded -- the sharded rollout (``bench.py``'s ``SHARDED_SCALE``:
              204,800 peers, 32 slots, degree 16, ``build_topology_local``
              with topology seed 0, 8 shards, 48 rounds): the BFS
              placement on the host (its cut reduction against random at
              least 50%, the margin ``tests/test_placement.py`` holds);
              the bench's closed loop (128 natively verified envelopes, 4
              forged, published with their verdicts) through
              ``ShardedGossipSub(placement="bfs", split_gather=True)`` at
              world size 1 over NCCL on the card, warm and timed
              ``rollout(48, record=True)`` (validated msgs/s as
              ``bench.py:823-1000`` defines it, delivery > 0.999, p50/p99,
              forged spread <= 1, K1 48 and K2 6 launches, peak memory,
              the propagate and heartbeat phases and the gathers split
              against the monolithic all-gather as
              ``bench.py:sharded_phase_breakdown`` splits them); the same
              loop on 8 ranks on the one card (a gloo group over CUDA
              tensors, the ring's point-to-point blocks staged through
              host buffers and counted; each rank K1 48 and K2 6), whose
              canonical state (leaf digests) and flight record must equal
              world size 1's, and the port's plain ``GossipSub`` at the
              same seed under the inverse permutation must equal both;
              2,048 peers card = CPU at world sizes 1 and 4 with the ring
              and with all-gathers (every leaf, record channel, delivery
              statistic and a kill's mask, and the sharded wrappers
              against the unsharded plain functions); and K1/K2 timed at
              a rank's block shapes (B = 25,600 and 204,800) beside their
              bounds, the gather's bytes reckoned apart.  At most 180 s.

Depth cut to make room for phase ``sharded`` (each section's seconds on
an NVIDIA H100 80GB HBM3 at 700 W, before -> after): the hybrid loss grid
at 100k from 9 points to 5 (91.8 -> 51.7 s) and the ``obs`` A/B from
three repeats to two (24.7 -> 12.6 s).  RLNC at 100k keeps the bench's
24 rounds a run: its validated msgs/s is defined over that window
(``bench.py:1167``), and a shorter one would read higher for the same
code.

The last line is ``{"ok": true, "device": {...}}``; nothing else is
printed after a failure.  E1's block and arm sweeps, which chose its
launch geometry, are ``tools/e1_sweep.py``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
IMAD_PER_CLK_SM = 64               # 32-bit IMAD issue rate, compute cap. 9.0
N_MSGS, N_FORGED, ROLLOUT_STEPS = 128, 4, 24
HEADLINE = dict(n_peers=100_000, n_slots=32, conn_degree=16,
                msg_window=N_MSGS)
L2_FLUSH_BYTES = 128 << 20         # written before each L2-flushed launch
E1_SWEEP, E1_SEED = 4096, 2026     # the corruption sweep's rows and seed
E1_BATCHES = (N_MSGS, 512, 2048, 8192, 32768)
E1_CHECK_BATCHES = (1, 3, 7, 9, 127, 128, 129, 511, 512, 513)
E1_TWIN_MAX = 2048                 # the plain version's memory grows 4^w B


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# -- phase 3: kernels against their plain versions ---------------------------


def _rand(gen, shape, dev, p=None, high=None):
    import torch

    if p is not None:
        return torch.rand(shape, generator=gen, device=dev) < p
    if high is not None:
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


def _max_err(out, ref) -> float:
    import torch

    err = 0.0
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            d = (a.double() - b.double()).abs()
            d = torch.where(torch.isnan(a) != torch.isnan(b), torch.inf, d)
        else:
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().double()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def _time_ms(fn, reps: int = 20, lead: bool = True, flush=None) -> float:
    """Median device time of one call (CUDA events), after a warm call.

    With ``lead`` each timed call is queued behind a ~10 ms device spin, so
    the host has enqueued all its launches before the first one runs and
    the events bracket device work only; without it they also take in the
    host's time to issue the call (the GPU waits on the Python wrapper).
    With ``flush`` (a tensor larger than the L2) that tensor is written
    before each timed call, so the call finds its inputs in device memory
    and not in the L2."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for rep in range(reps):
        if flush is not None:
            flush.fill_(rep)
        if lead:
            torch.cuda._sleep(20_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def propagate_inputs(gen, n, k, w, dev, arm):
    mesh = _rand(gen, (n, k), dev, p=0.25)
    nbrs = _rand(gen, (n, k), dev, high=n + 1) - 1
    edge_live = _rand(gen, (n, k), dev, p=0.95)
    alive = _rand(gen, (n,), dev, p=0.95)
    have = _rand(gen, (n, w), dev) & _rand(gen, (n, w), dev)
    fresh = _rand(gen, (n, w), dev) & _rand(gen, (n, w), dev)
    valid = _rand(gen, (w,), dev)
    kw = {}
    if arm == "idontwant":
        kw = dict(idontwant=True,
                  idw_have_w=have & _rand(gen, (n, w), dev))
    elif arm == "fresh_src":
        kw = dict(fresh_src=_rand(gen, (n, k, w), dev))
    return (mesh, nbrs, edge_live, alive, have, fresh, valid), kw


def propagate_bytes(args, kw, out) -> int:
    """Bytes K1 must move for these inputs: every [N, K] mask and [N, W]
    plane read once, a neighbor id only where the edge delivers, the
    sender words once per distinct sender row, every output written once."""
    import torch

    mesh, nbrs, edge_live, alive, have, fresh, valid = args
    ok = mesh & edge_live
    n_ok = int(ok.sum())
    if "fresh_src" in kw:
        senders = _nbytes(kw["fresh_src"]) * n_ok // max(ok.numel(), 1)
        ids = 0
    else:
        rows = torch.unique(torch.clamp(nbrs[ok], 0, nbrs.shape[0] - 1))
        senders = int(rows.numel()) * fresh.shape[1] * 4
        ids = 4 * n_ok
    return (_nbytes(mesh, edge_live, alive, have, valid, kw.get("idw_have_w"))
            + ids + senders + _nbytes(*out))


def exchange_inputs(gen, n, k, w, dev):
    return (
        _rand(gen, (n, k), dev, high=n),            # jidx_p
        _rand(gen, (n, k), dev, p=0.2),             # adv_ok_p
        _rand(gen, (n, k), dev, p=0.9),             # accept_p
        _rand(gen, (n, k), dev, p=0.95),            # serve_p
        _rand(gen, (n, w), dev) & _rand(gen, (n, w), dev),   # rows
        _rand(gen, (n, w), dev) & _rand(gen, (n, w), dev),   # have_dedup
        _rand(gen, (n,), dev, p=0.95),              # alive
    )


def exchange_bytes(args, out) -> int:
    """Bytes K2 must move: the [N, K] masks, the dedup view and liveness
    read once, an advertiser id and its words only where it advertised
    (distinct rows once), every output written once."""
    import torch

    jidx_p, adv_ok_p, accept_p, serve_p, rows, dedup, alive = args
    n_adv = int(adv_ok_p.sum())
    distinct = torch.unique(jidx_p[adv_ok_p]).numel()
    return (_nbytes(adv_ok_p, accept_p, serve_p, dedup, alive) + 4 * n_adv
            + int(distinct) * rows.shape[1] * 4 + _nbytes(*out))


def ptxas_report(text: str):
    """``-Xptxas -v`` output -> {kernel<W>: {registers, stack_frame,
    spill_stores, spill_loads}} for the kernels' instantiations."""
    report, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
        if m:
            k = re.search(r"(propagate|exchange|ed25519_verify|"
                          r"ed25519_verify_one)_kernelILi(\d+)E", m.group(1))
            fn = f"{k.group(1)}_kernel<{k.group(2)}>" if k else None
            if fn:
                report.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            report[fn]["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
    return report


def check_ptxas(text: str):
    """Fails the run if either kernel spills; returns the report."""
    report = ptxas_report(text)
    kernels = {name.split("<")[0] for name in report}
    if kernels != {"propagate_kernel", "exchange_kernel"}:
        fail(f"ptxas reported no registers for both kernels: {report}")
    for name, r in report.items():
        if r.get("spill_stores", 0) or r.get("spill_loads", 0):
            fail(f"{name} spills: {r}")
    return report


def _peers_many(cuda_gossip, dev) -> int:
    """Peers for two full tiles on every persistent block of any
    instantiation (the one an SM holds most blocks of, at one slot, sets
    it) and a ragged third of 17 on the last one."""
    shapes = [cuda_gossip.launch_shape(kernel, v, 1, dev)
              for kernel in cuda_gossip.KERNELS
              for v in (0, *cuda_gossip.VECTOR_WIDTHS)]
    most = max(s.blocks_per_sm for s in shapes)
    return 2 * most * cuda_gossip.sm_count(dev) * shapes[0].tile_peers + 17


def check_cases(dev, geometries):
    """Both kernels against their plain versions, bit for bit, in every arm
    at each (N, K, W); returns (max errors by wrapper, cases)."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.ops import gossip_packed as plain

    gen = torch.Generator(device=dev)
    err = {"propagate": 0.0, "exchange_select": 0.0}
    cases = 0
    for n, k, w in geometries:
        for arm in ("plain", "idontwant", "fresh_src"):
            gen.manual_seed(n * 100 + k * 10 + w)
            args, kw = propagate_inputs(gen, n, k, w, dev, arm)
            out = cuda_gossip.propagate(*args, **kw)
            ref = plain.propagate_packed(*args, **kw)
            torch.cuda.synchronize()
            e = _max_err(out, ref)
            if e != 0.0:
                fail(f"K1 {arm} N={n} K={k} W={w}: max abs err {e}")
            err["propagate"] = max(err["propagate"], e)
            cases += 1
        for caps in ((3, 2), (70, 40), (5000, 5000)):
            gen.manual_seed(n * 100 + k * 10 + w + 7)
            args = exchange_inputs(gen, n, k, w, dev)
            out = cuda_gossip.exchange_select(*args, *caps)
            ref = plain.exchange_select(*args, *caps)
            torch.cuda.synchronize()
            e = _max_err(out, ref)
            if e != 0.0:
                fail(f"K2 caps={caps} N={n} K={k} W={w}: max abs err {e}")
            err["exchange_select"] = max(err["exchange_select"], e)
            cases += 1
    return err, cases


def time_kernels(dev, flush):
    """Both kernels at the main path's shapes (N=100000, K=32, W=4): warm
    (back to back) and L2-flushed times, their bytes bounds, and the
    plain versions' times."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.ops import gossip_packed as plain

    gen = torch.Generator(device=dev)
    n, k, w = HEADLINE["n_peers"], HEADLINE["n_slots"], N_MSGS // 32
    gen.manual_seed(1)
    args, kw = propagate_inputs(gen, n, k, w, dev, "plain")
    k1 = lambda: cuda_gossip.propagate(*args, **kw)  # noqa: E731
    k1_bytes = propagate_bytes(args, kw, cuda_gossip.propagate(*args, **kw))
    k1_ms, k1_cold = _time_ms(k1), _time_ms(k1, flush=flush)
    xargs = exchange_inputs(gen, n, k, w, dev)
    caps = (5000, 5000)
    k2 = lambda: cuda_gossip.exchange_select(*xargs, *caps)  # noqa: E731
    k2_bytes = exchange_bytes(xargs, cuda_gossip.exchange_select(*xargs, *caps))
    k2_ms, k2_cold = _time_ms(k2), _time_ms(k2, flush=flush)
    timed = {}
    for name, fn, ms, cold, nbytes in (
            ("gossip_propagate", k1, k1_ms, k1_cold, k1_bytes),
            ("gossip_exchange", k2, k2_ms, k2_cold, k2_bytes)):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        timed[name] = dict(ms=ms, ms_l2_flushed=cold, bound_ms=bound,
                           bound_bytes=nbytes, bound_share=bound / ms,
                           bound_share_l2_flushed=bound / cold, fn=fn)
    timed["gossip_propagate"]["plain"] = (
        lambda: plain.propagate_packed(*args, **kw))
    timed["gossip_exchange"]["plain"] = (
        lambda: plain.exchange_select(*xargs, *caps))
    return timed


def check_kernels(dev, ptxas):
    """Phase 3.  Returns the per-kernel records (launches filled later)."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip

    w = N_MSGS // 32
    many = _peers_many(cuda_gossip, dev)
    emit(dict(phase="launch_shapes", n_slots=HEADLINE["n_slots"],
              peers_many=many, blocks_per_sm={
                  f"{kernel}_kernel<{v}>": cuda_gossip.launch_shape(
                      kernel, v, HEADLINE["n_slots"], dev).blocks_per_sm
                  for kernel in cuda_gossip.KERNELS
                  for v in (0, *cuda_gossip.VECTOR_WIDTHS)}))
    geometries = [(n, k, w) for n in (HEADLINE["n_peers"], 589)
                  for k in (8, 16, 32)]
    geometries += [(n, k, wx) for n in (1, 589, many)
                   for k in (1, 8, 16, 31, 32) for wx in (1, 2, 3, 4, 8)]
    err, cases = check_cases(dev, geometries)

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    timed = time_kernels(dev, flush)
    del flush
    src = "go_libp2p_pubsub_torch/csrc/gossip_kernels.cu"
    records = []
    for name, wrapper, kernel, line in (
            ("gossip_propagate", "propagate", "propagate_kernel", 77),
            ("gossip_exchange", "exchange_select", "exchange_kernel", 212)):
        t = timed[name]
        shape = cuda_gossip.launch_shape(kernel.split("_")[0], w,
                                         HEADLINE["n_slots"], dev)
        records.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"go_libp2p_pubsub_tpu/ops/pallas_gossip.py:{line}",
            launches=None, max_abs_err=err[wrapper], ms=t["ms"],
            plain_ms=_time_ms(t["plain"], reps=5), bound_ms=t["bound_ms"],
            bound_by="bytes", library_ms=None, bound_bytes=t["bound_bytes"],
            call_ms=_time_ms(t["fn"], lead=False),
            ms_l2_flushed=t["ms_l2_flushed"], bound_share=t["bound_share"],
            bound_share_l2_flushed=t["bound_share_l2_flushed"],
            registers=ptxas[f"{kernel}<{w}>"]["registers"],
            tile_peers=shape.tile_peers, blocks_per_sm=shape.blocks_per_sm,
            grid=cuda_gossip.grid_blocks(HEADLINE["n_peers"], shape,
                                         cuda_gossip.sm_count(dev)),
            cases=cases))
    return records


# -- phase 4: the ed25519 verify kernel E1 ---------------------------------------


def check_e1_ptxas(text: str):
    """E1's registers, stack frame and spills for each arm and window;
    fails on a spill at the main path's window (elsewhere a spill is
    recorded, not failed on)."""
    from go_libp2p_pubsub_torch.ops import cuda_ed25519
    from go_libp2p_pubsub_torch.ops import ed25519 as ted

    report = ptxas_report(text)
    want = {f"{k}<{w}>" for w in cuda_ed25519.WINDOWS
            for k in ("ed25519_verify_kernel", "ed25519_verify_one_kernel")}
    if set(report) != want or any("registers" not in r
                                  for r in report.values()):
        fail(f"ptxas reported no registers for every E1 window: {report}")
    w0 = ted.default_window("cuda")
    for k in ("ed25519_verify_kernel", "ed25519_verify_one_kernel"):
        r = report[f"{k}<{w0}>"]
        if r.get("spill_stores", 0) or r.get("spill_loads", 0):
            fail(f"{k}<{w0}> spills: {r}")
    return report


def fe_mul_imads() -> dict:
    """The 32-bit multiplies of E1's field multiply, counted in the SASS of
    its probe kernel (one ``fe_mul`` per thread): IMAD, IMAD.X, IMAD.HI
    and IMAD.WIDE.U32 (with .X), not the signed IMAD.WIDE of the probe's
    pointer arithmetic nor IMAD.MOV/SHL/IADD, which move, shift and add."""
    from go_libp2p_pubsub_torch.ops import cuda_build, cuda_ed25519

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", cuda_ed25519.LIB_PATH],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr[-2000:]}")
    for sec in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        if "fe_mul_probe" not in sec.split("\n", 1)[0]:
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sec)
        mult = [o for o in ops if o in ("IMAD", "IMAD.X")
                or o.startswith(("IMAD.HI", "IMAD.WIDE.U32"))]
        if not mult:
            fail("no IMAD in the SASS of E1's field multiply")
        return dict(imads=len(mult), imad_family=sum(
            o.startswith("IMAD") for o in ops), instructions=len(ops))
    fail("cuobjdump shows no fe_mul probe kernel")


def _query_gpu(field: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi --query-gpu={field} failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def e1_bound_ms(batch: int, w: int, imads: int, dev,
                occupied: bool = False) -> float:
    """The least time for ``batch`` verifications at window ``w``: the
    larger of the integer multiplies (``imads`` a field multiply times
    ``fe_mul_count(w)`` a verification) at 64 IMAD a clock on every SM at
    the card's maximum SM clock, and the bytes (128 in, 1 out a row) at
    the memory rate.  With ``occupied`` the multiplies get only the SMs
    that E1's launch can occupy, min(blocks, SMs) at the signatures a
    block of the arm the wrapper launches for ``batch``: the bound of a
    batch that fills less than one wave, at its launch geometry."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if occupied:
        sms = min(sms, -(-batch // cuda_ed25519.sigs_per_block(batch)))
    rate = IMAD_PER_CLK_SM * sms * float(_query_gpu("clocks.max.sm")) * 1e6
    ops = imads * cuda_ed25519.fe_mul_count(w) * batch
    return max(ops / rate, 129 * batch / HBM_BYTES_PER_S) * 1e3


def e1_sweep_data():
    """The RFC 8032 batch and the seeded corruption sweep, with the native
    library's verdicts."""
    from go_libp2p_pubsub_torch.crypto import native, vectors

    pks, msgs, sigs, kinds = vectors.corruption_sweep(E1_SWEEP, E1_SEED)
    rp, rm, rs, _ = vectors.rfc8032_batch()
    pks, msgs, sigs = rp + pks, rm + msgs, rs + sigs
    return pks, msgs, sigs, native.verify_batch(pks, msgs, sigs)


def _window_triples(envs):
    """(public keys, signed bytes, signatures) of the window's envelopes."""
    from go_libp2p_pubsub_torch.crypto import native

    return ([e.pubkey for e in envs],
            [native.signing_bytes(e.topic, e.seqno, e.payload) for e in envs],
            [e.signature for e in envs])


def check_e1(dev, data, window_envs):
    """E1 against the native library, the plain version and the oracle at
    every window the kernel has (the main path's included) and every check
    batch, and on the main path's 128-envelope window.  The plain version
    runs once a batch, at ``min(w0, 4)`` for the main path's window w0 (its
    verdicts do not depend on the window; its memory grows 4^w B).  Both
    arms at the wrapper's crossover and one either side.  Counts every
    differing verdict, then fails if
    there was one; returns (verdicts compared, differing verdicts, largest
    |E1 - other| over the verdicts as 0/1)."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.crypto import ed25519_ref, native
    from go_libp2p_pubsub_torch.ops import cuda_ed25519
    from go_libp2p_pubsub_torch.ops import ed25519 as ted

    tally = dict(compared=0, differ=0, err=0, where=[])

    def compare(what, got, other):
        got, other = np.asarray(got, bool), np.asarray(other, bool)
        d = np.abs(got.astype(np.int64) - other.astype(np.int64))
        tally["compared"] += d.size
        tally["differ"] += int(d.sum())
        tally["err"] = max(tally["err"], int(d.max()) if d.size else 0)
        if d.any():
            tally["where"].append(f"{what}: {int(d.sum())}")

    pks, msgs, sigs, want = data
    n_all = len(pks)
    oracle = np.array([ed25519_ref.verify(p, m, s) for p, m, s in zip(
        pks[:128], msgs[:128], sigs[:128])])
    if not np.array_equal(oracle, want[:128]):
        fail("the oracle and the native library disagree")
    twins, twin_w = {}, min(ted.default_window(dev), 4)

    def twin(key, rows):
        if key not in twins:
            twins[key] = ted.verify_rows(rows, "windowed",
                                         twin_w).cpu().numpy()
        return twins[key]

    for w in cuda_ed25519.WINDOWS:
        got = ted.verify_batch(pks, msgs, sigs, window=w, device=dev)
        compare(f"w={w} B={n_all} vs native", got, want)
        compare(f"w={w} vs oracle", got[:128], oracle)
        for b in (*E1_CHECK_BATCHES, E1_TWIN_MAX):
            rows, host_ok = ted.prepare_rows(pks[:b], msgs[:b], sigs[:b],
                                             pad_to=b)
            rows = torch.from_numpy(rows).to(dev)
            plain = twin(b, rows)
            for lanes in (cuda_ed25519.LANES, 1):
                raw = cuda_ed25519._verify_arm(rows, w, lanes).cpu().numpy()
                at = f"w={w} B={b} lanes={lanes}"
                compare(f"{at} vs native", raw & host_ok, want[:b])
                compare(f"{at} vs plain", raw & host_ok, plain & host_ok)
                compare(f"{at} host-passed raw vs plain", raw[host_ok],
                        plain[host_ok])

    # Both arms at the crossover and one either side, every window: each
    # against the native library, raw against each other, and the
    # wrapper's default against the arm it should pick.
    x = cuda_ed25519.ONE_THREAD_FROM
    reps = -(-(x + 1) // n_all)
    pool = [v * reps for v in (pks, msgs, sigs)]
    for b in (x - 1, x, x + 1):
        rows, host_ok = ted.prepare_rows(*[v[:b] for v in pool], pad_to=b)
        rows = torch.from_numpy(rows).to(dev)
        want_b = np.tile(want, reps)[:b]
        for w in cuda_ed25519.WINDOWS:
            team, one = (cuda_ed25519._verify_arm(rows, w, lanes).cpu()
                         .numpy() for lanes in (cuda_ed25519.LANES, 1))
            default = cuda_ed25519.verify(rows, "windowed", w).cpu().numpy()
            compare(f"crossover w={w} B={b} team vs native", team & host_ok,
                    want_b)
            compare(f"crossover w={w} B={b} one vs native", one & host_ok,
                    want_b)
            compare(f"crossover w={w} B={b} team raw vs one raw", team, one)
            compare(f"crossover w={w} B={b} default vs its arm", default,
                    team if b < x else one)

    # The main path's rows: the signed window at B = 128, raw verdicts.
    win = _window_triples(window_envs)
    win_native = native.verify_batch(*win)
    rows, host_ok = ted.prepare_rows(*win, pad_to=N_MSGS)
    rows = torch.from_numpy(rows).to(dev)
    plain = twin("window", rows)
    for w in cuda_ed25519.WINDOWS:
        raw = cuda_ed25519.verify(rows, "windowed", w).cpu().numpy()
        compare(f"window w={w} raw vs plain", raw, plain)
        compare(f"window w={w} vs native", raw & host_ok, win_native)

    rows, host_ok = ted.prepare_rows(pks[:128], msgs[:128], sigs[:128])
    straus = ted.verify_rows(torch.from_numpy(rows).to(dev), "straus")
    straus = straus.cpu().numpy()[:len(host_ok)]
    if not np.array_equal(straus & host_ok, want[:128]):
        fail("the plain Straus ladder differs from the native library")
    if tally["differ"]:
        fail(f"E1: {tally['differ']} of {tally['compared']} verdicts differ "
             f"({'; '.join(tally['where'])})")
    return tally["compared"], tally["differ"], float(tally["err"])


def time_e1(dev, data, window_envs, imads, baseline=None):
    """E1's device time at the window and the curve batches, the window
    sweep, ``verify_batch``'s wall time, the plain
    version's and the native library's times, and the bound.  With a
    ``baseline`` (:func:`e1_baseline`) its time and E1's at every batch,
    in turns: baseline, E1, E1, baseline, twice (median of 20 each)."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.crypto import native
    from go_libp2p_pubsub_torch.ops import cuda_ed25519
    from go_libp2p_pubsub_torch.ops import ed25519 as ted

    w0 = ted.default_window(dev)
    win = _window_triples(window_envs)
    pks, msgs, sigs, _ = data
    reps = -(-max(E1_BATCHES) // len(pks))
    pool = [x * reps for x in (pks, msgs, sigs)]
    curve, sweep, wall, bound, bound_sms = {}, {}, {}, {}, {}
    turns = {}

    def e1(rows, w):
        return cuda_ed25519.verify(rows, "windowed", w)

    for b in E1_BATCHES:
        triples = win if b == N_MSGS else [x[:b] for x in pool]
        rows, _ = ted.prepare_rows(*triples, pad_to=b)
        rows = torch.from_numpy(rows).to(dev)
        for w in cuda_ed25519.WINDOWS:
            ms = _time_ms(lambda: cuda_ed25519.verify(rows, "windowed", w),
                          reps=5 if b > 8192 else 10)
            sweep.setdefault(str(b), {})[f"w{w}"] = ms
        if baseline is not None:
            if not torch.equal(baseline(rows, w0), e1(rows, w0)):
                fail(f"E1 and the baseline's E1 differ at B = {b}")
            order = (baseline, e1, e1, baseline) * 2
            ms = [_time_ms(lambda: f(rows, w0), reps=20) for f in order]
            turns[str(b)] = {
                name: [t for f, t in zip(order, ms) if f is arm]
                for name, arm in (("baseline_ms", baseline), ("e1_ms", e1))}
        curve[str(b)] = b / (sweep[str(b)][f"w{w0}"] / 1e3)
        bound[str(b)] = e1_bound_ms(b, w0, imads, dev)
        bound_sms[str(b)] = e1_bound_ms(b, w0, imads, dev, occupied=True)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ted.verify_batch(*triples, pad_to=b, window=w0, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        wall[str(b)] = sorted(times)[1]
    peak = max(curve.values())
    knee = min(int(k) for k, v in curve.items() if v >= 0.9 * peak)
    plain_ms = {}
    for b in (N_MSGS, 512):
        triples = win if b == N_MSGS else [x[:b] for x in pool]
        rows = torch.from_numpy(ted.prepare_rows(*triples, pad_to=b)[0]).to(dev)
        plain_ms[str(b)] = _time_ms(
            lambda: ted.verify_rows(rows, "windowed", w0), reps=2, lead=False)
    native.verify_batch(*[x[:16] for x in win])  # warm threads
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.verify_batch(*win)
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(window=w0, ms_by_batch={k: v[f"w{w0}"] for k, v in sweep.items()},
                baseline_turns_by_batch=turns,
                one_thread_from=cuda_ed25519.ONE_THREAD_FROM,
                sigs_per_s=curve, batch_knee=knee, window_sweep_ms=sweep,
                best_window_by_batch={k: min(v, key=v.get)
                                      for k, v in sweep.items()},
                verify_batch_wall_ms=wall, plain_ms_by_batch=plain_ms,
                native_ms_window=sorted(times)[2], bound_ms_by_batch=bound,
                bound_share_by_batch={k: bound[k] / sweep[k][f"w{w0}"]
                                      for k in bound},
                bound_ms_occupied_sms_by_batch=bound_sms,
                bound_share_occupied_sms_by_batch={
                    k: bound_sms[k] / sweep[k][f"w{w0}"] for k in bound_sms})


def e1_baseline(root: str):
    """Builds the E1 of the checkout at ``root`` (the parent commit: one
    thread a signature, a C entry without the arm) into the
    build directory; returns (its launcher, rows x window -> bool on the
    card; its ``-Xptxas -v`` report)."""
    import ctypes

    import torch

    from go_libp2p_pubsub_torch.ops import cuda_build, cuda_ed25519

    src = os.path.join(os.path.abspath(root), "go_libp2p_pubsub_torch",
                       "csrc", "ed25519_verify.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR,
                            "libed25519_verify_baseline.so")
    report = ptxas_report(cuda_build.build(src, lib_path, verbose=True))
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ed25519_verify.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.ed25519_verify.restype = ci

    def run(rows, w):
        table = cuda_ed25519._base_table(w, rows.device)
        out = torch.empty(rows.shape[0], dtype=torch.bool, device=rows.device)
        cuda_build.raise_on(lib.ed25519_verify(
            rows.data_ptr(), table.data_ptr(), out.data_ptr(), rows.shape[0],
            w, torch.cuda.current_stream(rows.device).cuda_stream),
            "baseline ed25519_verify launch")
        return out

    return run, report


def check_ed25519(dev, e1_ptxas, imads, card, baseline=None):
    """Phase 4.  Returns E1's record (``launches`` None until the main
    path's run fills it).
    ``baseline``: :func:`e1_baseline`'s result, or None."""
    import numpy as np

    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    t0 = time.perf_counter()
    data = e1_sweep_data()
    envs, _ = signed_window(np.random.default_rng(1))
    compared, mismatches, max_err = check_e1(dev, data, envs)
    timed = time_e1(dev, data, envs, imads["imads"],
                    baseline[0] if baseline else None)
    w0, win = timed["window"], str(N_MSGS)
    emit(dict(phase="ed25519", rows=len(data[0]), verdicts_compared=compared,
              mismatches=mismatches, windows_checked=list(
                  cuda_ed25519.WINDOWS), accepted=int(data[3].sum()),
              seconds=time.perf_counter() - t0, card=card,
              sm_clock_max_mhz=float(_query_gpu("clocks.max.sm")),
              fe_mul_imads=imads,
              fe_mul_per_verify={w: cuda_ed25519.fe_mul_count(w)
                                 for w in cuda_ed25519.WINDOWS},
              **{k: v for k, v in timed.items() if k != "window"},
              window=w0, lanes=cuda_ed25519.LANES,
              threads=cuda_ed25519.THREADS,
              sigs_per_block={str(b): cuda_ed25519.sigs_per_block(b)
                              for b in E1_BATCHES}, ptxas=e1_ptxas,
              baseline_ptxas=baseline[1] if baseline else None))
    return dict(
        name="ed25519_verify", route="cuda",
        source="go_libp2p_pubsub_torch/csrc/ed25519_verify.cu",
        replaces="go_libp2p_pubsub_tpu/ops/ed25519.py:779",
        launches=None, max_abs_err=max_err, mismatches=mismatches,
        ms=timed["ms_by_batch"][win],
        plain_ms=timed["plain_ms_by_batch"][win],
        bound_ms=timed["bound_ms_by_batch"][win], bound_by="operations",
        library_ms=None, window=w0, batch=N_MSGS,
        bound_share=timed["bound_share_by_batch"][win],
        bound_ms_occupied_sms=timed["bound_ms_occupied_sms_by_batch"][win],
        bound_share_occupied_sms=timed[
            "bound_share_occupied_sms_by_batch"][win],
        ms_by_batch=timed["ms_by_batch"], sigs_per_s=timed["sigs_per_s"],
        batch_knee=timed["batch_knee"],
        registers=e1_ptxas[f"ed25519_verify_kernel<{w0}>"]["registers"],
        stack_frame=e1_ptxas[f"ed25519_verify_kernel<{w0}>"].get(
            "stack_frame", 0),
        spill_stores=e1_ptxas[f"ed25519_verify_kernel<{w0}>"].get(
            "spill_stores", 0),
        cases=compared)


# -- phase 5: the closed loop --------------------------------------------------


def signed_window(rng):
    """128 envelopes signed by the native library, 4 of them tampered after
    signing so their signatures must fail."""
    from go_libp2p_pubsub_torch.crypto import native

    seeds = [rng.bytes(32) for _ in range(N_MSGS)]
    payloads = [rng.bytes(64) for _ in range(N_MSGS)]
    msgs = [native.signing_bytes("bench", i, p) for i, p in enumerate(payloads)]
    pks = native.public_key_batch(seeds)
    sigs = native.sign_batch(seeds, msgs)
    forged = set(rng.choice(N_MSGS, size=N_FORGED, replace=False).tolist())
    envs = []
    for i in range(N_MSGS):
        payload = payloads[i]
        if i in forged:
            payload = bytes([payload[0] ^ 0xFF]) + payload[1:]
        envs.append(native.Envelope("bench", i, payload, pks[i], sigs[i]))
    return envs, forged


def _leaves(x, pre=""):
    for name in type(x)._fields:
        v = getattr(x, name)
        if hasattr(v, "_fields"):
            yield from _leaves(v, pre + name + ".")
        else:
            yield pre + name, v


def small_model_agrees(dev) -> int:
    """A 2,000-peer model from one seed, on the card (kernels) and on the
    CPU (plain versions): every leaf and record channel must be equal."""
    import torch

    from go_libp2p_pubsub_torch import bridge
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub

    kw = dict(n_peers=2000, n_slots=32, conn_degree=16, msg_window=N_MSGS)
    results = []
    for device in (dev, "cpu"):
        gs = GossipSub(device=device, **kw)
        st = gs.init(seed=7)
        for s in range(40):
            st = gs.publish(st, (s * 97) % 2000, s, s % 9 != 4)
        st, rec = gs.rollout(st, ROLLOUT_STEPS, record=True)
        results.append((bridge.state_to_numpy(st), rec))
    (a, ra), (b, rb) = results

    import numpy as np

    n = 0
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        if not np.array_equal(x, y):
            fail(f"card and CPU runs differ in leaf {name}")
        n += 1
    for name in ra:
        x, y = ra[name].cpu(), rb[name]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            fail(f"card and CPU runs differ in record channel {name}")
        n += 1
    return n


def main_path(dev, card: str):
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.crypto import native
    from go_libp2p_pubsub_torch.crypto.pipeline import ValidationPipeline
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub
    from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip
    from go_libp2p_pubsub_torch.utils.metrics import flight_summary

    rng = np.random.default_rng(1)
    envs, forged = signed_window(rng)
    expected = np.array([i not in forged for i in range(N_MSGS)])
    pks = [e.pubkey for e in envs]
    msgs = [native.signing_bytes(e.topic, e.seqno, e.payload) for e in envs]
    sigs = [e.signature for e in envs]
    native.verify_batch(pks[:16], msgs[:16], sigs[:16])  # warm threads
    t0 = time.perf_counter()
    verdicts = native.verify_batch(pks, msgs, sigs)
    verify_s = time.perf_counter() - t0
    if not np.array_equal(verdicts, expected):
        fail("native verdicts do not match the forged set")
    # The same window through the validation pipeline on kernel E1: one
    # launch for the flush.  Its time is printed, not charged (the headline
    # charges the native verify, as bench.py does).
    pipe = ValidationPipeline(backend="device", device=dev,
                              flush_threshold=N_MSGS + 1)
    for env in envs:
        pipe.submit(env)
    cuda_ed25519.reset_launches()
    t0 = time.perf_counter()
    device_out = pipe.flush()
    device_verify_s = time.perf_counter() - t0
    e1_launches = cuda_ed25519.verify.launches
    device_verdicts = np.array([ok for _, ok in device_out])
    if e1_launches != 1:
        fail(f"the pipeline's flush launched E1 {e1_launches} times, not 1")
    if not (np.array_equal(device_verdicts, verdicts)
            and pipe.stats["rejected"] == N_FORGED):
        fail("device verdicts do not match the native ones and the forged set")

    cuda_gossip.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    gs = GossipSub(device=dev, **HEADLINE)
    t0 = time.perf_counter()
    st = gs.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for slot in range(N_MSGS):
        st = gs.publish(st, int(rng.integers(HEADLINE["n_peers"])), slot,
                        bool(verdicts[slot]))
    torch.cuda.synchronize()

    gs.rollout(st, ROLLOUT_STEPS, record=True)     # warm run
    torch.cuda.synchronize()
    cuda_gossip.reset_launches()
    t0 = time.perf_counter()
    out, rec = gs.rollout(st, ROLLOUT_STEPS, record=True)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                "gossip_exchange": cuda_gossip.exchange_select.launches}
    if launches != {"gossip_propagate": ROLLOUT_STEPS,
                    "gossip_exchange": ROLLOUT_STEPS // 8}:
        fail(f"timed rollout launched {launches}, expected "
             f"{ROLLOUT_STEPS} K1 and {ROLLOUT_STEPS // 8} K2")
    launches["ed25519_verify"] = e1_launches

    flight = flight_summary(rec)
    frac, p50, p99 = (x.cpu().numpy() for x in gs.delivery_stats(out))
    if frac.shape != (N_MSGS,):
        fail(f"delivery_stats frac shape {frac.shape}")
    mean_frac = float(np.nanmean(frac))
    if not mean_frac > 0.999:
        fail(f"delivery degraded: mean frac {mean_frac}")
    if not (np.isfinite(p50) and np.isfinite(p99)):
        fail(f"latency percentiles not finite: {p50} {p99}")
    if float(p50) != flight["lat_p50"] or float(p99) != flight["lat_p99"]:
        fail(f"flight-record latency quantiles {flight['lat_p50']}/"
             f"{flight['lat_p99']} disagree with delivery_stats {p50}/{p99}")
    have = gs.have_bool(out).cpu().numpy()
    for i in forged:
        if int(have[:, i].sum()) > 1:
            fail(f"forged message {i} propagated")
    if np.isnan(frac[sorted(forged)]).sum() != N_FORGED:
        fail("forged messages counted as deliverable")
    delivered = float(np.nansum(frac)) * HEADLINE["n_peers"]
    value = delivered / (rollout_s + verify_s)
    n_checked = small_model_agrees(dev)
    emit(dict(
        phase="main", msgs_per_sec=value, delivered=delivered,
        delivery_mean=mean_frac, p50_rounds=float(p50),
        p99_rounds=float(p99), rollout_ms=rollout_s * 1e3,
        verify_ms=verify_s * 1e3,
        device_verify_ms_not_charged=device_verify_s * 1e3,
        init_s=init_s, rounds=ROLLOUT_STEPS,
        launches=launches, small_model_leaves_equal=n_checked,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=card,
    ))
    return launches


# -- phase 6: the scenario event path ------------------------------------------


SCENARIO_N = 2000            # the composite's width for card-vs-CPU runs
SCENARIO_STEPS = 48


def _same_result(a, b, what: str) -> int:
    """Two ``ScenarioResult``s (card, CPU): verdicts, every record channel
    and every final state leaf bit for bit.  Returns the count compared."""
    import numpy as np

    from go_libp2p_pubsub_torch import bridge

    if a.verdict.to_dict() != b.verdict.to_dict():
        fail(f"{what}: card and CPU verdicts differ")
    if sorted(a.record) != sorted(b.record):
        fail(f"{what}: card and CPU record channels differ")
    n = 0
    for name in a.record:
        x, y = np.asarray(a.record[name]), np.asarray(b.record[name])
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"{what}: card and CPU differ in record channel {name}")
        n += 1
    for (name, x), (_, y) in zip(
            _leaves(bridge.state_to_numpy(a.final_state)),
            _leaves(bridge.state_to_numpy(b.final_state))):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"{what}: card and CPU differ in state leaf {name}")
        n += 1
    return n


def _sync_warnings(fn) -> int:
    """Operations of ``fn()`` that synchronise the host with the card
    (``torch.cuda.set_sync_debug_mode("warn")``); waiting on an event, as
    a record's read does, is not one."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _edge_delay_campaign(device, n_peers: int):
    """The composite with per-edge delay: ``max_edge_delay=2``, a seeded
    random 0-2 plane on the compiled state, and no eclipse wave (its
    silence needs the ideal fabric)."""
    import dataclasses

    import numpy as np

    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.scenario.campaign import campaign_spec

    spec = campaign_spec(n_peers)
    spec = dataclasses.replace(
        spec, name=spec.name + "_edge_delay",
        model=dict(spec.model, max_edge_delay=2),
        attacks=[w for w in spec.attacks if w.kind != "eclipse"],
        slo=dataclasses.replace(spec.slo, min_final_target_honest_edges=None))
    comp = scenario.compile_scenario(spec, device=device)
    plane = np.random.default_rng(4).integers(
        0, 3, (comp.model.n, comp.model.k))
    comp.state = comp.model.set_edge_delay(comp.state, plane)
    return scenario.run_scenario(comp)


def scenario_phase(dev, card: str):
    """Phase 6.  Returns the kernels' launches in the timed campaign."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.ops import bitpack, cuda_ed25519, cuda_gossip
    from go_libp2p_pubsub_torch.scenario.campaign import (
        campaign_spec, load_trace)
    from go_libp2p_pubsub_torch.scenario.runner import flight_to_jsonable

    t0 = time.perf_counter()
    names = [name for name in scenario.CANON
             if scenario.build(name).family == "gossipsub"
             and scenario.sim_supported(scenario.build(name))]
    if len(names) != 14:
        fail(f"expected 14 sim gossipsub canon campaigns, found {len(names)}")
    compared, verdicts, canon_s = 0, {}, {}
    for name in names:
        t1 = time.perf_counter()
        card_res = scenario.run_scenario(scenario.build(name), device=dev)
        canon_s[name] = time.perf_counter() - t1
        compared += _same_result(card_res, scenario.run_scenario(
            scenario.build(name), device="cpu"), name)
        verdicts[name] = card_res.verdict.passed
    composite = {}
    for label, run in (
            ("composite", lambda d: scenario.run_scenario(
                campaign_spec(SCENARIO_N), device=d)),
            ("composite_edge_delay",
             lambda d: _edge_delay_campaign(d, SCENARIO_N))):
        cuda_gossip.reset_launches()
        card_res = run(dev)
        if cuda_gossip.propagate.launches != SCENARIO_STEPS:
            fail(f"{label}: K1 launched {cuda_gossip.propagate.launches} "
                 f"times on the card, not {SCENARIO_STEPS}")
        compared += _same_result(card_res, run("cpu"), label)
        composite[label] = card_res.verdict.passed
    small_s = time.perf_counter() - t0

    # The committed 100,000-peer trace the JAX package wrote.
    doc = load_trace()
    spec = campaign_spec(doc=doc)
    t1 = time.perf_counter()
    comp = scenario.compile_scenario(spec, device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t1
    # The replay runs that compiled campaign: it is also the warm run, with
    # every kernel and operation at the timed run's shapes.
    result, matched, mismatched = scenario.replay_trace(
        doc, device=dev, compiled=comp)
    if not matched:
        fail(f"100k replay: mismatched channels {mismatched}")
    if result.verdict.to_dict() != doc["verdict"]:
        fail("100k replay: the verdict differs from the trace's")
    model = comp.model
    run = lambda: model.rollout_events(  # noqa: E731
        comp.state, comp.events, attackers=comp.attackers,
        target=comp.target, record=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_gossip.reset_launches()
    cuda_ed25519.reset_launches()
    t1 = time.perf_counter()
    final, rec = run()      # the record is read to the host: a synchronise
    rollout_s = time.perf_counter() - t1
    launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                "gossip_exchange": cuda_gossip.exchange_select.launches,
                "ed25519_verify": cuda_ed25519.verify.launches}
    # Campaign messages carry no signatures (as on the reference): E1 has
    # no work on this path.
    if launches != {"gossip_propagate": SCENARIO_STEPS,
                    "gossip_exchange": SCENARIO_STEPS // 8,
                    "ed25519_verify": 0}:
        fail(f"timed campaign launched {launches}, expected "
             f"{SCENARIO_STEPS} K1, {SCENARIO_STEPS // 8} K2 and no E1")
    if flight_to_jsonable(rec) != doc["flight"]:
        fail("the timed campaign's record differs from the trace's")
    # Once more under the sync-debug mode, which costs host time: every
    # operation that would stall the host on the device warns.
    sync_warnings = _sync_warnings(run)
    have = bitpack.unpack(final.have_w, model.m)
    held = have.sum(dim=0)
    invalid = final.msg_used & ~final.msg_valid
    if int(invalid.sum()) == 0 or int(held[invalid].max()) > 1:
        fail("an invalid message reached a peer other than its publisher")
    emit(dict(
        phase="scenario", canon=verdicts, canon_card_s=canon_s,
        composite=composite, composite_n_peers=SCENARIO_N,
        values_compared=compared,
        small_runs_s=small_s, n_peers=model.n, rounds=SCENARIO_STEPS,
        n_publishes=comp.n_publishes, compile_scenario_s=compile_s,
        rollout_ms=rollout_s * 1e3,
        rounds_per_s=SCENARIO_STEPS / rollout_s, launches=launches,
        verdict=result.verdict.to_dict(), mismatched_channels=mismatched,
        tolerance_channels=[], sync_debug_warnings=sync_warnings,
        invalid_msgs=int(invalid.sum()),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=card,
    ))
    return launches


# -- phase 7: the streaming serving plane ----------------------------------------


SERVE_SMALL_N = 2000         # the serve path's width for card-vs-CPU runs
FAULT_CYCLES, FAULT_PER_CYCLE = 5, 16


def _same_states(a, b, what: str) -> int:
    """Every leaf of two states (any device) bit for bit; returns the
    count compared."""
    import numpy as np

    from go_libp2p_pubsub_torch import bridge

    n = 0
    for (name, x), (_, y) in zip(_leaves(bridge.state_to_numpy(a)),
                                 _leaves(bridge.state_to_numpy(b))):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"{what}: differ in state leaf {name}")
        n += 1
    return n


def _serve_launch_counts(model, rounds_from: int, rounds: int):
    """K1 and K2 launches ``rounds`` rounds from step ``rounds_from`` must
    make: one K1 per topic a round, one K2 per topic a heartbeat."""
    hb = model.heartbeat_steps
    beats = sum(1 for s in range(rounds_from, rounds_from + rounds)
                if s % hb == hb - 1)
    return {"gossip_propagate": model.t * rounds,
            "gossip_exchange": model.t * beats}


def serve_timed(dev, card: str):
    """The serving bench's three workloads on one warmed 100k-peer engine
    with the real clock and the envelopes verified inline by the native
    library ahead of enqueue; returns (per-workload report, launches)."""
    import torch

    from go_libp2p_pubsub_torch.crypto import native
    from go_libp2p_pubsub_torch.crypto.pipeline import (
        Envelope, ValidationPipeline, sign_envelope)
    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub
    from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip
    from go_libp2p_pubsub_torch.serve import IngestRing, StreamingEngine
    from go_libp2p_pubsub_torch.serve import stream_trace as S
    from go_libp2p_pubsub_torch.utils.metrics import quantiles

    n = S.CONFIG["n_peers"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = MultiTopicGossipSub(device=dev, **S.CONFIG)
    ring = IngestRing(capacity=S.CAPACITY, policy="block")
    eng = StreamingEngine(model, ring, seed=0, **S.ENGINE)
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pipe = ValidationPipeline(
        backend="native", flush_threshold=1 << 20,
        on_verdict_ctx=lambda env, ok, ctx: ring.push(
            topic=ctx[0], payload=env.payload, publisher=ctx[1], valid=ok,
            timeout=30.0))

    def submit(item):
        topic, src, forged, seed, seqno = item
        env = sign_envelope(seed, f"topic-{topic}", seqno,
                            b"stream payload %d" % seqno, backend="native")
        if forged:  # tampered after signing: the inline verify must refuse
            env = Envelope(env.topic, env.seqno, env.payload + b"!",
                           env.pubkey, env.signature)
        pipe.submit(env, ctx=(topic, src))

    groups = S.workloads(n)
    report = {}
    cuda_gossip.reset_launches()
    cuda_ed25519.reset_launches()
    step0 = eng.steps_run
    for name, feed in groups.items():
        ring.max_depth = 0
        acct0 = ring.accounting()
        lat0, done0, pub0 = (len(eng.latencies_s), eng.completed,
                             len(eng.publish_log))
        chunks0, steps0 = eng.chunks_run, eng.steps_run
        k0 = (cuda_gossip.propagate.launches,
              cuda_gossip.exchange_select.launches)
        t1 = time.perf_counter()
        for group in feed:
            for item in group:
                submit(item)
            pipe.flush()
            eng.run_chunk()
        eng.run_until_drained(max_chunks=64)
        elapsed = time.perf_counter() - t1
        acct = ring.accounting()
        q = quantiles(eng.latencies_s[lat0:])
        delivered = eng.completed - done0
        report[name] = dict(
            sustained_msgs_per_sec=delivered * float(n) / elapsed,
            ingest_p50_s=q["p50"], ingest_p99_s=q["p99"],
            delivered=delivered, published=len(eng.publish_log) - pub0,
            max_queue_depth=ring.max_depth,
            silent_drops=acct["silent_drops"] - acct0["silent_drops"],
            chunks=eng.chunks_run - chunks0, rounds=eng.steps_run - steps0,
            launches={"gossip_propagate": cuda_gossip.propagate.launches
                      - k0[0],
                      "gossip_exchange": cuda_gossip.exchange_select.launches
                      - k0[1]},
            launches_expected=_serve_launch_counts(
                model, steps0, eng.steps_run - steps0),
            prepared_programs=eng.compile_cache_size(), elapsed_s=elapsed)
        if report[name]["silent_drops"] != 0:
            fail(f"serve {name}: {report[name]['silent_drops']} silent drops")
        if delivered != report[name]["published"]:
            fail(f"serve {name}: delivered {delivered} of "
                 f"{report[name]['published']}")
    launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                "gossip_exchange": cuda_gossip.exchange_select.launches,
                "ed25519_verify": cuda_ed25519.verify.launches}
    want = _serve_launch_counts(model, step0, eng.steps_run - step0)
    if {k: launches[k] for k in want} != want or launches["ed25519_verify"]:
        fail(f"timed serve run launched {launches}, expected {want} and no E1")
    delivered = model.stream_digest(eng.state)["delivered"].cpu().numpy()
    spread = max(int(delivered[t, s]) for t, s in eng.invalid_published)
    if len(eng.invalid_published) != S.N_FORGED or spread > 1:
        fail(f"forged messages: {len(eng.invalid_published)} published, "
             f"spread {spread}")
    if eng.compile_cache_size() != 1:
        fail(f"the timed run prepared {eng.compile_cache_size()} programs")
    return dict(
        workloads=report, warmup_s=warm_s, forged_spread=spread,
        rounds=eng.steps_run - step0, launches=launches,
        prepared_programs=eng.compile_cache_size(),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        card=card), launches, (model, eng)


def serve_sync_debug(model, eng, chunks: int = 3):
    """A few loaded chunks under ``torch.cuda.set_sync_debug_mode("warn")``:
    the synchronising operations of each chunk, which must be the two
    reads (the digest and the flight tail)."""
    import warnings

    import torch

    per_chunk = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for c in range(chunks):
            for i in range(8):
                eng.ring.push(topic=i % 2, payload=b"sync %d %d" % (c, i),
                              publisher=(c * 8 + i) * 977 % model.n)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng.run_chunk()
            per_chunk.append(sum("synchronizing CUDA operation"
                                 in str(w.message) for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if any(k != 2 for k in per_chunk):
        fail(f"serve chunks synchronised {per_chunk} times, not twice each")
    return per_chunk


def serve_faulted(dev, model):
    """Crash/restore cycles on the 100k model (``snapshot_every=1``): each
    cycle pushes 16 messages and runs a chunk (which snapshots), then a
    fresh ring and engine warm up and restore.  An uninterrupted engine
    takes the same pushes; both drain and must end in the same state and
    completions, with nothing lost or duplicated and no program prepared."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.serve import IngestRing, StreamingEngine
    from go_libp2p_pubsub_torch.serve import stream_trace as S
    from go_libp2p_pubsub_torch.utils.metrics import quantiles

    rng = np.random.default_rng(5)
    pushes = [[(i % 2, b"faulted c%d i%d" % (c, i), int(rng.integers(model.n)))
               for i in range(FAULT_PER_CYCLE)] for c in range(FAULT_CYCLES)]
    ckpt_dir = tempfile.mkdtemp(prefix="serve-ckpt-")
    path = os.path.join(ckpt_dir, "engine.ckpt")

    def engine(seed, **kw):
        ring = IngestRing(capacity=S.CAPACITY, policy="block")
        return StreamingEngine(model, ring, seed=seed, **S.ENGINE, **kw), ring

    try:
        plain, pring = engine(1)
        plain.warmup()
        for cycle in pushes:
            for topic, payload, src in cycle:
                pring.push(topic=topic, payload=payload, publisher=src)
            plain.run_chunk()
        plain.run_until_drained(max_chunks=64)

        eng, ring = engine(1, snapshot_path=path, snapshot_every=1)
        eng.warmup()
        recoveries, snap_s, snap_bytes, programs = [], 0.0, 0, []
        for c, cycle in enumerate(pushes):
            for topic, payload, src in cycle:
                ring.push(topic=topic, payload=payload, publisher=src)
            eng.run_chunk()
            snap_s += eng.snapshot_seconds
            snap_bytes = os.path.getsize(path)
            t_crash = time.perf_counter()
            eng, ring = engine(2 + c, snapshot_path=path, snapshot_every=1)
            eng.warmup()
            eng.restore()
            torch.cuda.synchronize()
            recoveries.append(time.perf_counter() - t_crash)
            programs.append(eng.compile_cache_size())
        eng.run_until_drained(max_chunks=64)
        snap_s += eng.snapshot_seconds
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    pushed = FAULT_CYCLES * FAULT_PER_CYCLE
    lost = pushed - eng.completed
    if lost or eng.duplicate_completions or plain.completed != pushed:
        fail(f"faulted: lost {lost}, duplicates {eng.duplicate_completions}, "
             f"uninterrupted completed {plain.completed} of {pushed}")
    if any(p != 1 for p in programs):
        fail(f"faulted: prepared programs after the restores {programs}")
    done = sorted((p.topic, p.slot, p.chash) for p in eng.publish_log)
    if done != sorted((p.topic, p.slot, p.chash) for p in plain.publish_log):
        fail("faulted: the restored run published other messages")
    leaves = _same_states(eng.state, plain.state, "faulted vs uninterrupted")
    rq = quantiles(recoveries)
    return dict(cycles=FAULT_CYCLES, pushed=pushed, completed=eng.completed,
                lost=lost, duplicates=eng.duplicate_completions,
                recovery_p50_s=rq["p50"], recovery_p99_s=rq["p99"],
                recovery_s=recoveries, snapshot_bytes=snap_bytes,
                snapshot_s_total=snap_s,
                snapshots=FAULT_CYCLES + 1,
                prepared_programs_after_restores=programs,
                leaves_equal_to_uninterrupted=leaves)


SERVE_CRASH, SERVE_VERIFIER = ("streaming_engine_crash_recovery",
                              "streaming_verifier_crash")


class _DispatchCounter:
    """Counts, while installed, the streaming engines' chunk dispatches
    (warmups included) and their rounds, and the model's heartbeats: the
    chunks' and the three of each fresh state's ``init``.  Every round
    runs K1 once per topic and every heartbeat K2 once per topic."""

    def __enter__(self):
        from go_libp2p_pubsub_torch.models.multitopic import (
            MultiTopicGossipSub)
        from go_libp2p_pubsub_torch.serve.engine import StreamingEngine

        self.patched = [(StreamingEngine, "_dispatch",
                         StreamingEngine._dispatch),
                        (MultiTopicGossipSub, "_heartbeat",
                         MultiTopicGossipSub._heartbeat)]
        self.dispatches = self.rounds = self.chunk_beats = self.beats = 0
        dispatch, heartbeat = (orig for _, _, orig in self.patched)

        def counted_dispatch(eng, events, n_items=0):
            hb = eng.model.heartbeat_steps
            if eng.chunk_steps % hb:
                fail(f"a chunk of {eng.chunk_steps} rounds does not hold a "
                     f"whole number of heartbeats (every {hb})")
            self.dispatches += 1
            self.rounds += eng.chunk_steps
            self.chunk_beats += eng.chunk_steps // hb
            return dispatch(eng, events, n_items)

        def counted_heartbeat(model, st):
            self.beats += 1
            return heartbeat(model, st)

        StreamingEngine._dispatch = counted_dispatch
        MultiTopicGossipSub._heartbeat = counted_heartbeat
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self.patched:
            setattr(cls, name, orig)
        return False


def serve_canon_replay(dev):
    """The canon's four multitopic streaming campaigns (64 peers) through
    the port's runner on the card under the stepping clock, against the
    trace the JAX package's runner wrote: 0 mismatches on every
    deterministic channel."""
    from go_libp2p_pubsub_torch.scenario import stream_canon

    t0 = time.perf_counter()
    doc = stream_canon.load_trace()
    out = stream_canon.port_replay(dev, doc=doc)
    bad = {name: diff for name, diff in out.items() if diff}
    if bad or sorted(out) != sorted(stream_canon.CAMPAIGNS):
        fail(f"streaming canon replay: mismatches {bad}")
    return dict(campaigns=sorted(out), mismatches=0,
                verdicts={n: c["verdict"]["passed"]
                          for n, c in doc["campaigns"].items()},
                chunks=sum(len(c["chunks"]) for c in doc["campaigns"].values()),
                seconds=time.perf_counter() - t0)


def serve_full_width(dev):
    """The crash and verifier-crash campaigns with their model at the
    serving geometry (100,000 peers), on the card, with the real clock;
    the crash campaign traced (``trace_out=``).  Each must pass with
    nothing lost, duplicated or silently dropped, prepare nothing new and
    launch K1 = topics x rounds, K2 = topics x heartbeats and no E1; the
    traced run must close every sampled span and annotate the reopened
    ones with the crash gap."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip
    from go_libp2p_pubsub_torch.serve import engine as E
    from go_libp2p_pubsub_torch.serve import stream_trace as S

    out = {}
    tmp = tempfile.mkdtemp(prefix="serve-trace-")
    try:
        for name in (SERVE_CRASH, SERVE_VERIFIER):
            spec = dataclasses.replace(scenario.build(name),
                                       model=dict(S.CONFIG))
            trace = os.path.join(tmp, "crash.json") if name == SERVE_CRASH \
                else None
            programs0 = set(E._PROGRAMS)
            cuda_gossip.reset_launches()
            cuda_ed25519.reset_launches()
            t0 = time.perf_counter()
            with _DispatchCounter() as seen:
                res = scenario.run_streaming_scenario(spec, device=dev,
                                                      trace_out=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            new = [geom for _, geom in set(E._PROGRAMS) - programs0]
            t = S.CONFIG["n_topics"]
            launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                        "gossip_exchange": cuda_gossip.exchange_select.launches,
                        "ed25519_verify": cuda_ed25519.verify.launches}
            want = {"gossip_propagate": t * seen.rounds,
                    "gossip_exchange": t * seen.beats, "ed25519_verify": 0}
            rec, st = res.record, res.engine_stats
            lost = int(rec["lost_after_restart"][0])
            dups = int(rec["duplicate_deliveries"][0])
            silent = int(rec["silent_drops"][0])
            if not res.verdict.passed:
                fail(f"{name} at {S.CONFIG['n_peers']} peers: "
                     f"{res.verdict.to_dict()}")
            if lost or dups or silent:
                fail(f"{name} at full width: lost {lost}, duplicates {dups}, "
                     f"silent drops {silent}")
            if launches != want or seen.beats < seen.chunk_beats:
                fail(f"{name} at full width launched {launches}, "
                     f"expected {want} ({seen.chunk_beats} chunk "
                     f"heartbeats of {seen.beats})")
            geom = (res.plan.chunk_steps, res.plan.pub_width)
            if any(g != geom for g in new) or len(new) > 1:
                fail(f"{name} at full width prepared programs {new} "
                     f"(its geometry is {geom})")
            r = dict(verdict=res.verdict.passed, wall_s=wall,
                     runner_seconds=res.seconds,
                     recovery_s=float(rec["recovery_s"][0]),
                     ingest_p50_s=float(rec["ingest_lat_p50_s"][0]),
                     ingest_p99_s=float(rec["ingest_lat_p99_s"][0]),
                     completed=st["completed"], published=res.n_publishes,
                     admitted_valid=st["admitted_valid"], lost=lost,
                     duplicates=dups, silent_drops=silent,
                     restores=st["restores"],
                     pipeline_restarts=st["pipeline_restarts"],
                     replay_deduped=st["replay_deduped"],
                     dispatches=seen.dispatches, rounds=seen.rounds,
                     heartbeats=seen.beats, chunk_heartbeats=seen.chunk_beats,
                     launches=launches, prepared_programs=len(new),
                     programs_of_the_model=st["compile_cache_size"])
            if name == SERVE_CRASH:
                if st["restores"] != 1:
                    fail(f"{name}: {st['restores']} restores, not 1")
                with open(trace) as f:
                    art = json.load(f)
                summ = art["summary"]
                reopened = [sp for sp in art["spans"] if any(
                    e["name"] == "crash_recovery" for e in sp["events"])]
                if summ["open"] or not summ["spans"]:
                    fail(f"{name}: {summ['open']} of {summ['spans']} "
                         "sampled spans left open")
                if not reopened or not all(sp["closed"] for sp in reopened):
                    fail(f"{name}: no span carries the crash gap")
                r.update(spans=summ["spans"], spans_open=summ["open"],
                         spans_reopened=len(reopened),
                         recovery_gap_s=art["recovery_gap_s"])
            elif st["pipeline_restarts"] != 1:
                fail(f"{name}: {st['pipeline_restarts']} pipeline restarts")
            out[name] = r
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def serve_small_crash(dev):
    """The crash campaign at 2,000 peers on the card and on the CPU under
    the stepping clock: every deterministic channel, chunk for chunk, and
    every end-state leaf equal."""
    import dataclasses

    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.scenario import stream_canon, streaming_runner
    from go_libp2p_pubsub_torch.serve import StreamingEngine
    from go_libp2p_pubsub_torch.serve import stream_trace as S

    t0 = time.perf_counter()
    spec = dataclasses.replace(scenario.build(SERVE_CRASH),
                               model=dict(S.CONFIG, n_peers=SERVE_SMALL_N))
    runs = [stream_canon.capture(streaming_runner, StreamingEngine, spec,
                                 device=device) for device in (dev, "cpu")]
    (doc, eng), (cdoc, ceng) = runs
    diff = stream_canon.mismatches(doc, cdoc)
    if diff or doc != cdoc:
        fail(f"{SERVE_CRASH} at {SERVE_SMALL_N} peers: card and CPU "
             f"differ: {diff}")
    leaves = _same_states(eng.state, ceng.state,
                          f"{SERVE_CRASH} at {SERVE_SMALL_N} peers")
    return dict(n_peers=SERVE_SMALL_N, verdict=doc["verdict"]["passed"],
                chunks=len(doc["chunks"]), leaves_equal=leaves,
                seconds=time.perf_counter() - t0)


def serve_degraded(dev):
    """The serving bench's ``degraded`` section (``bench.py``): its own
    64-peer model, a ``reject`` ring of 32 and a watchdog at 24/8
    watermarks under an offered load of 24 a chunk against a drain of 8,
    then silence.  The tiers must reach shed_priority and drop_oldest and
    end at normal, with 0 silent drops."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub
    from go_libp2p_pubsub_torch.serve import (IngestRing, StreamingEngine,
                                              Watchdog)

    rng = np.random.default_rng(0)
    model = MultiTopicGossipSub(device=dev, n_topics=2, n_peers=64, n_slots=8,
                                conn_degree=4, msg_window=64,
                                heartbeat_steps=4)
    ring = IngestRing(capacity=32, policy="reject")
    eng = StreamingEngine(model, ring, chunk_steps=4, pub_width=2,
                          completion_frac=0.99, seed=0)
    eng.warmup()
    wd = Watchdog(eng, ring, chunk_stall_s=3600.0, high_watermark=24,
                  low_watermark=8, topic_priority=[0, 1])
    tiers = [wd.tier_name]
    t0 = time.perf_counter()
    seq = 0
    for step in range(10):
        if step < 5:
            for i in range(24):
                ring.push(topic=i % 2, payload=b"degraded %d" % seq,
                          publisher=int(rng.integers(64)), valid=True)
                seq += 1
        eng.run_chunk()
        wd.note_chunk()
        wd.poll()
        if wd.tier_name != tiers[-1]:
            tiers.append(wd.tier_name)
    eng.run_until_drained(max_chunks=32)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    acct = ring.accounting()
    if "shed_priority" not in tiers or "drop_oldest" not in tiers \
            or tiers[-1] != "normal":
        fail(f"degraded: the ladder went {tiers}")
    if acct["silent_drops"]:
        fail(f"degraded: {acct['silent_drops']} silent drops")
    return dict(tiers_seen=tiers, shed_priority=acct["shed_priority"],
                dropped_oldest=acct["dropped_oldest"],
                rejected_pushes=acct["rejected"],
                silent_drops=acct["silent_drops"], offered=seq,
                completed=eng.completed,
                degraded_msgs_per_sec=eng.completed * 64.0 / elapsed,
                elapsed_s=elapsed, tier_log=[list(x) for x in wd.tier_log])


OBS_REPS, OBS_MSGS = 2, 64


def serve_obs(dev, model):
    """The serving bench's ``obs`` A/B on the phase's 100k model: fresh
    ring and engine pairs, traced (``MetricsRegistry``,
    ``SpanLedger(sample_n=1)``, ``BlackBox(64)``) and untraced, alternate,
    ``OBS_REPS`` repeats each, over the same signed constant workload.  Both arms
    must complete every message, every span must close, the span-exact
    p50 must not exceed the chunk-quantized p50, and no program may be
    prepared; the overhead (best of the repeats) is reported against the
    reference's 2% budget, not enforced."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.crypto.pipeline import (ValidationPipeline,
                                                        sign_envelope)
    from go_libp2p_pubsub_torch.obs import BlackBox, SpanLedger
    from go_libp2p_pubsub_torch.serve import IngestRing, StreamingEngine
    from go_libp2p_pubsub_torch.serve import stream_trace as S
    from go_libp2p_pubsub_torch.utils.metrics import MetricsRegistry

    from go_libp2p_pubsub_torch.serve import engine as E

    p = S.ENGINE["pub_width"]
    programs0 = set(E._PROGRAMS)

    def arm(traced, seed):
        reg = MetricsRegistry() if traced else None
        led = SpanLedger(sample_n=1) if traced else None
        box = BlackBox(capacity=64) if traced else None
        ring = IngestRing(capacity=S.CAPACITY, policy="block", metrics=reg,
                          tracer=led)
        eng = StreamingEngine(model, ring, seed=seed, metrics=reg,
                              tracer=led, blackbox=box, **S.ENGINE)
        eng.warmup()
        pipe = ValidationPipeline(
            backend="native", flush_threshold=1 << 20, tracer=led,
            metrics=reg, on_verdict_ctx=lambda env, ok, ctx: ring.push(
                topic=ctx[0], payload=env.payload, publisher=ctx[1],
                valid=ok, timeout=30.0))
        rng = np.random.default_rng(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i0 in range(0, OBS_MSGS, p):
            for i in range(i0, min(i0 + p, OBS_MSGS)):
                env = sign_envelope(rng.bytes(32), f"topic-{i % 2}", i,
                                    b"obs payload %d" % i, backend="native")
                pipe.submit(env, ctx=(i % 2, int(rng.integers(model.n))))
            pipe.flush()
            eng.run_chunk()
        eng.run_until_drained(max_chunks=64)
        elapsed = time.perf_counter() - t0
        return eng, led, eng.completed * float(model.n) / elapsed

    t0 = time.perf_counter()
    traced, untraced, completed = [], [], []
    eng = led = None
    for rep in range(OBS_REPS):
        e0, _, r0 = arm(False, seed=100 + rep)
        eng, led, r1 = arm(True, seed=200 + rep)
        untraced.append(r0)
        traced.append(r1)
        completed.append([e0.completed, eng.completed])
        del e0
    if any(a != b or a != OBS_MSGS for a, b in completed):
        fail(f"obs A/B: completions per (untraced, traced) arm {completed}")
    summ = led.summary()
    q_chunk = eng.latency_quantiles(mode="chunk")
    q_exact = eng.latency_quantiles(mode="exact")
    if summ["open"] or summ["spans"] != OBS_MSGS:
        fail(f"obs A/B: {summ['open']} of {summ['spans']} spans open")
    if not q_exact["p50"] <= q_chunk["p50"] + 1e-9:
        fail(f"obs A/B: span-exact p50 {q_exact['p50']} above the "
             f"chunk-quantized {q_chunk['p50']}")
    if set(E._PROGRAMS) != programs0:
        fail("obs A/B: the arms prepared a program")
    best_plain, best_traced = max(untraced), max(traced)
    overhead = max(0.0, 1.0 - best_traced / best_plain)
    return dict(reps=OBS_REPS, msgs_per_rep=OBS_MSGS, sample_n=1,
                untraced_msgs_per_sec=untraced,
                traced_msgs_per_sec=traced,
                best_untraced_msgs_per_sec=best_plain,
                best_traced_msgs_per_sec=best_traced,
                overhead_frac=overhead, budget_frac=0.02,
                within_budget=overhead <= 0.02, completed=completed,
                spans=summ["spans"], spans_open=summ["open"],
                chunk_p50_s=q_chunk["p50"], chunk_p99_s=q_chunk["p99"],
                span_p50_s=q_exact["p50"], span_p99_s=q_exact["p99"],
                programs_of_the_model=eng.compile_cache_size(),
                seconds=time.perf_counter() - t0)


def serve_phase(dev, card: str):
    """Phase 7.  Returns the kernels' launches in the timed serve run and
    in the two streaming campaigns at full width."""
    import torch

    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.serve import stream_trace as S

    t0 = time.perf_counter()
    # Card = CPU at 2,000 peers: the trace's workloads under the stepping
    # clock, and the canon's multitopic campaign.
    docs, engines = [], []
    for device in (dev, "cpu"):
        doc, eng = S.port_replay(SERVE_SMALL_N, device=device)
        docs.append(doc)
        engines.append(eng)
    diff = S.mismatches(docs[0], docs[1])
    if diff or docs[0] != docs[1]:
        fail(f"serve at {SERVE_SMALL_N} peers: card and CPU differ: {diff}")
    compared = _same_states(engines[0].state, engines[1].state,
                            f"serve at {SERVE_SMALL_N} peers")
    name = "multitopic_hot_publisher"
    canon = scenario.run_scenario(scenario.build(name), device=dev)
    compared += _same_result(canon, scenario.run_scenario(
        scenario.build(name), device="cpu"), name)
    small_s = time.perf_counter() - t0

    # The 100,000-peer trace the JAX package's engine wrote.
    t1 = time.perf_counter()
    doc = S.load_trace()
    out, _ = S.port_replay(doc["config"]["n_peers"], device=dev)
    diff = S.mismatches(out, doc)
    if diff:
        fail(f"100k serve replay: {len(diff)} mismatches: {diff[:8]}")
    replay_s = time.perf_counter() - t1
    del out
    torch.cuda.empty_cache()

    timed, launches, (model, eng) = serve_timed(dev, card)
    sync_per_chunk = serve_sync_debug(model, eng)
    faulted = serve_faulted(dev, model)

    # The control and fault layers: the streaming canon against its JAX
    # trace, the crash campaigns at full width, card = CPU, the degraded
    # ladder and the tracing A/B.
    control = {}
    for key, section in (("canon_replay", lambda: serve_canon_replay(dev)),
                         ("full_width", lambda: serve_full_width(dev)),
                         ("small_crash", lambda: serve_small_crash(dev)),
                         ("degraded", lambda: serve_degraded(dev)),
                         ("obs", lambda: serve_obs(dev, model))):
        t2 = time.perf_counter()
        control[key] = section()
        control[key]["section_s"] = time.perf_counter() - t2
        print(f"serve {key}: {control[key]['section_s']:.1f} s", flush=True)
    emit(dict(
        phase="serve", n_peers=model.n, n_topics=model.t,
        small_n_peers=SERVE_SMALL_N, small_values_compared=compared,
        canon_verdict=canon.verdict.passed, small_runs_s=small_s,
        trace_chunks=sum(len(w["chunks"]) for w in doc["workloads"].values()),
        trace_mismatches=0, replay_s=replay_s,
        sync_debug_warnings_per_chunk=sync_per_chunk,
        faulted=faulted, **timed, **control))
    streaming = {k: sum(control["full_width"][name]["launches"][k]
                        for name in (SERVE_CRASH, SERVE_VERIFIER))
                 for k in launches}
    return launches, streaming


# -- phase 8: the tree plane and the rest of the router family ------------------


TREE_SMALL_N = 2000          # the tree/router width for card-vs-CPU runs
ROUTER_ROUNDS, ROUTER_KILL_AT = 24, 8
ROUTER_GEOMETRY = dict(n_slots=32, conn_degree=16, msg_window=N_MSGS)
DIRECT_FRAC, DIRECT_SEED = 0.01, 11


def _device_ops(fn, calls: int = 1) -> float:
    """Device operations (kernels, copies, fills) a call of ``fn`` queues,
    from a CUDA-only profiler trace of ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        fail("the CUDA trace holds no device events")
    return len(ops) / calls


def tree_replay(dev, card: str):
    """The 100k tree against the JAX-written trace: join, a timed drain
    and a timed heal after churn, 0 mismatches; the syncs inside the timed
    rollouts (0), launches a step (device operations: kernels, copies,
    fills) and each step phase's device time."""
    import torch

    from go_libp2p_pubsub_torch.models import tree_trace as TT
    from go_libp2p_pubsub_torch.ops import tree as tree_ops

    doc = TT.load_trace()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, ex = TT.port_replay(doc, device=dev)
    replay_s = time.perf_counter() - t0
    diff = TT.mismatches(out, doc)
    if diff:
        fail(f"100k tree replay: mismatches by channel {diff}")
    if not (ex["conditions"]["drained"] and ex["conditions"]["healed"]):
        fail(f"100k tree: not drained and healed: {ex['conditions']}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    model, states = ex["engine"].model, ex["states"]
    rec = {name: doc["phases"][name]["record"] for name in doc["phases"]}
    delivered = {
        "drain": rec["drain"]["msgs_delivered_total"]["data"][-1]
        - rec["join"]["msgs_delivered_total"]["data"][-1],
        "churn": rec["churn"]["msgs_delivered_total"]["data"][-1]
        - rec["drain"]["msgs_delivered_total"]["data"][-1]}
    timed = {}
    for name, start in (("drain", "published"), ("churn", "churned")):
        steps, wall = doc["phases"][name]["steps"], ex["wall_s"][name]
        syncs = _sync_warnings(
            lambda s=states[start], k=steps: model.rollout(s, k))
        if syncs:
            fail(f"100k tree {name}: {syncs} syncs inside the rollout")
        timed[name] = dict(steps=steps, wall_ms=wall * 1e3,
                           steps_per_s=steps / wall,
                           deliveries=delivered[name],
                           deliveries_per_s=delivered[name] / wall,
                           syncs_in_rollout=syncs)

    # A drain step's device time by phase (CUDA events behind a device
    # spin, so each brackets device work only), and operations a step.
    s0 = model.rollout(states["published"], 8, record=False)[0]
    ins = {"part": s0}
    ins["watchdog"] = tree_ops._phase_part(s0)
    ins["join"] = tree_ops._phase_watchdog(ins["watchdog"], 64)
    ins["data"] = tree_ops._phase_join(ins["join"])
    after_data, dead = tree_ops._phase_data(ins["data"])
    ins["repair"] = after_data
    ins["sizes"] = tree_ops._phase_repair(after_data, dead)
    iters = tree_ops.default_size_iters(model.params.max_peers)
    calls = {
        "part": lambda: tree_ops._phase_part(ins["part"]),
        "watchdog": lambda: tree_ops._phase_watchdog(ins["watchdog"], 64),
        "join": lambda: tree_ops._phase_join(ins["join"]),
        "data": lambda: tree_ops._phase_data(ins["data"]),
        "repair": lambda: tree_ops._phase_repair(ins["repair"], dead),
        "sizes": lambda: tree_ops._phase_sizes(ins["sizes"], iters),
        "step": lambda: tree_ops.step(s0),
    }
    phase_ms = {name: _time_ms(fn, reps=10) for name, fn in calls.items()}
    phase_launches = {name: _device_ops(fn) for name, fn in calls.items()}
    per_step = _device_ops(lambda: tree_ops.step(s0), calls=4)
    return dict(
        n_peers=model.params.max_peers,
        steps={name: doc["phases"][name]["steps"] for name in doc["phases"]},
        stranded={name: doc["phases"][name]["stranded"]
                  for name in doc["phases"]},
        mismatches=0, replay_s=replay_s, timed=timed,
        step_phase_ms=phase_ms, step_phase_launches=phase_launches,
        launches_per_step=per_step, peak_mem_gb=peak, card=card)


def bench_treecast_port(dev, card: str, n_msgs: int = 64, n_peers: int = 10):
    """``bench.py``'s ``bench_treecast`` (config (a)) on the port: 10 peers,
    a width-2 tree, 64 messages; the delivered count asserted as there."""
    import torch

    from go_libp2p_pubsub_torch.config import SimParams, TreeOpts
    from go_libp2p_pubsub_torch.ops import tree as tree_ops

    params = SimParams(max_peers=16, max_width=8, queue_cap=128, out_cap=128)
    st = tree_ops.init_state(params, TreeOpts(), root=0, device=dev)
    st = tree_ops.begin_subscribe_many(
        st, torch.arange(16, device=dev) % 16 < n_peers)
    st = tree_ops.run_steps(st, 32)
    if int(st.joined.sum()) != n_peers:
        fail("bench_treecast: the join walk did not converge")
    st = tree_ops.publish_many(
        st, torch.arange(n_msgs, dtype=torch.int32, device=dev))
    steps = n_msgs + 8
    tree_ops.run_steps(st, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tree_ops.run_steps(st, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    delivered = int(out.out_len.sum())
    if delivered != n_msgs * (n_peers - 1):
        fail(f"bench_treecast: expected full delivery, got {delivered}")
    return {"treecast_10peer_deliveries_per_sec": delivered / dt,
            "treecast_10peer_steps_per_sec": steps / dt,
            "delivered": delivered, "steps": steps, "card": card}


def _api_logs(device):
    """The reference's integration contracts (``pubsub_test.go``:
    TestBasicPubsub, TestNodesDropping, TestLowerNodesDropping,
    TestNodesDroppingGracefully), two independent topics and a lossy
    link profile, through ``SimNetwork`` on ``device`` -> what each
    subscriber received, message for message."""
    import numpy as np

    from go_libp2p_pubsub_torch import SimNetwork, SimParams, TopicManager

    def pubsub(n_hosts, max_peers, **kw):
        net = SimNetwork(SimParams(max_peers=max_peers, **kw), device=device)
        hosts = net.make_hosts(n_hosts)
        tms = [TopicManager(h) for h in hosts]
        topic = tms[0].new_topic("foobar")
        subs = [tm.subscribe(hosts[0].id, "foobar") for tm in tms[1:]]
        return net, hosts, topic, subs

    def check(log, topic, subs, skip=(), mid=0):
        mes = f"message number {mid}".encode()
        topic.publish_message(mes)
        for i, ch in enumerate(subs):
            if i not in skip:
                data = ch.get()
                if data != mes:
                    fail(f"SimNetwork on {device}: node {i} got {data!r}")
                log.append((i, data))

    def settle(log, net, subs):
        net.step(16)
        log.extend((i, list(s.messages())) for i, s in enumerate(subs)
                   if not s.closed)

    logs = {}
    log = logs["basic_pubsub"] = []
    net, hosts, topic, subs = pubsub(4, 8)
    for i in range(10):
        check(log, topic, subs, (), i)
    for name, n_hosts, max_peers, victim, lossy, after in (
            ("nodes_dropping", 4, 8, 1, {0, 2}, {0}),
            ("lower_nodes_dropping", 8, 16, 3, {2, 5, 6}, {2}),
            ("nodes_dropping_gracefully", 4, 8, None, {0}, {0})):
        log = logs[name] = []
        net, hosts, topic, subs = pubsub(n_hosts, max_peers)
        check(log, topic, subs, (), 0)
        if victim is None:
            subs[0].close()
        else:
            hosts[victim].close()
        if name != "nodes_dropping":
            net.step(8)
        check(log, topic, subs, lossy, 1)
        settle(log, net, subs)
        for i in range(10):
            check(log, topic, subs, after, i + 100)
    net = SimNetwork(SimParams(max_peers=8), device=device)
    hosts = net.make_hosts(4)
    tms = [TopicManager(h) for h in hosts]
    t_a, t_b = tms[0].new_topic("alpha"), tms[1].new_topic("beta")
    subs_a = [tms[i].subscribe(hosts[0].id, "alpha") for i in (1, 2, 3)]
    subs_b = [tms[i].subscribe(hosts[1].id, "beta") for i in (0, 2, 3)]
    t_a.publish_message(b"on-alpha")
    t_b.publish_message(b"on-beta")
    logs["multi_topic"] = [s.get() for s in subs_a + subs_b]
    if logs["multi_topic"] != [b"on-alpha"] * 3 + [b"on-beta"] * 3:
        fail(f"SimNetwork on {device}: topics crossed")
    net, hosts, topic, subs = pubsub(10, 16, queue_cap=64, out_cap=64)
    net.set_link_profile(np.zeros((16, 8), np.int32),
                         np.full((16, 8), 0.2, np.float32))
    for i in range(24):
        topic.publish_message(b"lossy %d" % i)
    net.step(48)
    logs["lossy_links"] = [list(s.messages()) for s in subs]
    return logs


def _tree_under_faults(device, n: int):
    """A 2,000-peer tree under a ``FaultPlan`` through ``run_with_faults``:
    kills and graceful leaves at three steps, 48 root publishes."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.config import SimParams, TreeOpts
    from go_libp2p_pubsub_torch.ops import tree as tree_ops
    from go_libp2p_pubsub_torch.utils.faults import FaultPlan, run_with_faults

    st = tree_ops.init_state(SimParams(max_peers=n, queue_cap=64, out_cap=64),
                             TreeOpts(), root=0, seed=3, device=device)
    st = tree_ops.begin_subscribe_many(
        st, torch.ones(n, dtype=torch.bool, device=st.alive.device))
    st = tree_ops.run_steps(st, 32)
    st = tree_ops.publish_many(
        st, torch.arange(48, dtype=torch.int32, device=st.alive.device))
    rng = np.random.default_rng(5)
    plan = FaultPlan()
    for t in (4, 20, 40):
        pick = rng.choice(np.arange(1, n), 40, replace=False)
        plan.kill_at(t, pick[:20], n).leave_at(t, pick[20:], n)
    return run_with_faults(
        st, 160, tree_ops.run_steps, plan,
        lambda s, m: s._replace(alive=s.alive & ~m),
        lambda s, m: s._replace(leaving=s.leaving | m))


def _tree_churn_heal_wide(device, n: int):
    """The canon's ``tree_churn_heal`` widened from 24 to ``n`` peers (its
    8 spare rows kept: ``max_peers`` n + 8)."""
    import dataclasses

    from go_libp2p_pubsub_torch import scenario

    spec = scenario.build("tree_churn_heal")
    spec = dataclasses.replace(spec, name=spec.name + f"_{n}", model=dict(
        spec.model, n_peers=n, max_peers=n + 8))
    return scenario.run_scenario(spec, device=device)


def _router_run(model, n_pub: int, kill_frac: float, rng_seed: int):
    """``n_pub`` publishes (the first 4 forged) at seeded sources, then
    ``ROUTER_ROUNDS`` rounds with ``kill_frac`` of the peers killed before
    round ``ROUTER_KILL_AT`` -> (state, seconds of the rounds)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(rng_seed)
    st = model.init(seed=0)
    for slot in range(n_pub):
        st = model.publish(st, int(rng.integers(model.n)), slot, slot >= 4)
    kill = np.zeros(model.n, bool)
    kill[rng.choice(np.arange(model.n), int(model.n * kill_frac),
                    replace=False)] = True
    kill_t = torch.from_numpy(kill).to(st.alive.device)
    sync = (torch.cuda.synchronize if st.alive.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    st = model.run(st, ROUTER_KILL_AT)
    st = st._replace(alive=st.alive & ~kill_t)
    st = model.run(st, ROUTER_ROUNDS - ROUTER_KILL_AT)
    sync()
    return st, time.perf_counter() - t0


def _router_models(device, n: int):
    from go_libp2p_pubsub_torch.models.floodsub import FloodSub
    from go_libp2p_pubsub_torch.models.randomsub import RandomSub

    return {"floodsub": FloodSub(n_peers=n, device=device,
                                 **ROUTER_GEOMETRY),
            "randomsub": RandomSub(n_peers=n, device=device,
                                   **ROUTER_GEOMETRY),
            "randomsub_emit6": RandomSub(n_peers=n, emit=6, device=device,
                                         **ROUTER_GEOMETRY)}


def _delivery(model, st) -> float:
    import numpy as np

    frac, _ = model.delivery_stats(st)
    return float(np.nanmean(frac.cpu().numpy()))


def direct_edges_for(nbrs, rev, valid, frac: float, seed: int):
    """A symmetric bool[N, K] mask over ``frac`` of a topology's wired edge
    pairs (numpy slot form): each pair drawn once from its lower
    endpoint's slot and mirrored through ``rev``."""
    import numpy as np

    from go_libp2p_pubsub_torch.ops.graphs import decode_index_plane

    nb, rv = decode_index_plane(nbrs), decode_index_plane(rev)
    own = valid & (np.arange(nb.shape[0])[:, None] < nb)
    pick = own & (np.random.default_rng(seed).random(own.shape) < frac)
    de = pick.copy()
    i, s = np.nonzero(pick)
    de[nb[i, s], rv[i, s]] = True
    return de


def _direct_model(device, n: int):
    """``GossipSub(direct_edges=)`` over 1% of the pairs of the topology
    ``init(seed=0)`` builds."""
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub

    kw = dict(n_peers=n, **ROUTER_GEOMETRY)
    graph = GossipSub(device="cpu", **kw).build_graph(0)
    de = direct_edges_for(*(t.numpy() for t in graph[:3]), DIRECT_FRAC,
                          DIRECT_SEED)
    return GossipSub(direct_edges=de, device=device, **kw), de


def _direct_state(model, rng_seed: int = 1):
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    forged = set(rng.choice(N_MSGS, size=N_FORGED, replace=False).tolist())
    st = model.init(seed=0)
    for slot in range(N_MSGS):
        st = model.publish(st, int(rng.integers(model.n)), slot,
                           slot not in forged)
    return st, forged


class _Capture:
    """Records, while installed, the first call's arguments of each kernel
    wrapper (K1 ``propagate``, K2 ``exchange_select``).  A wrapper counts
    its launches on the module's name, so the stand-in carries the count
    and hands it back on exit."""

    def __enter__(self):
        import functools

        from go_libp2p_pubsub_torch.ops import cuda_gossip

        self.mod, self.calls = cuda_gossip, {}
        self.orig = {name: getattr(cuda_gossip, name)
                     for name in ("propagate", "exchange_select")}

        def wrap(name, fn):
            @functools.wraps(fn)  # carries ``launches`` along
            def captured(*args, **kw):
                if name not in self.calls:
                    self.calls[name] = tuple(
                        (a.clone() if hasattr(a, "clone") else a)
                        for a in args), {
                        k: (v.clone() if hasattr(v, "clone") else v)
                        for k, v in kw.items()}
                return fn(*args, **kw)
            return captured

        for name, fn in self.orig.items():
            setattr(cuda_gossip, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            fn.launches = getattr(self.mod, name).launches
            setattr(self.mod, name, fn)
        return False


def direct_small(dev) -> dict:
    """The direct-edge construction at 2,000 peers on the card and on the
    CPU (every leaf and record channel equal), and the K1/K2 inputs of one
    of its rounds and one heartbeat against the plain versions."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.ops import gossip_packed as plain

    results = []
    for device in (dev, "cpu"):
        model, _ = _direct_model(device, TREE_SMALL_N)
        st, _ = _direct_state(model)
        if device is dev:
            with _Capture() as cap:
                st, rec = model.rollout(st, ROLLOUT_STEPS, record=True)
        else:
            st, rec = model.rollout(st, ROLLOUT_STEPS, record=True)
        results.append((st, rec))
    compared = _same_states(results[0][0], results[1][0],
                            f"direct edges at {TREE_SMALL_N} peers")
    for name, x in results[0][1].items():
        y = results[1][1][name]
        if x.dtype != y.dtype or not torch.equal(x.cpu(), y):
            fail(f"direct edges at {TREE_SMALL_N}: record channel {name}")
        compared += 1
    errs = {}
    for name, ref_fn in (("propagate", plain.propagate_packed),
                         ("exchange_select", plain.exchange_select)):
        if name not in cap.calls:
            fail(f"the direct-edge run never called {name}")
        args, kw = cap.calls[name]
        out = getattr(cuda_gossip, name)(*args, **kw)
        ref = ref_fn(*args, **kw)
        torch.cuda.synchronize()
        errs[name] = _max_err(out, ref)
        if errs[name] != 0.0:
            fail(f"{name} on the direct-edge inputs: max abs err {errs[name]}")
    return dict(values_compared=compared, kernel_input_max_abs_err=errs)


def direct_full(dev, card: str):
    """``GossipSub(direct_edges=)`` at the headline geometry, main-path
    style: 128 publishes (4 forged), init's 3 heartbeats, a warm and a
    timed ``rollout(24, record=True)``."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip

    torch.cuda.reset_peak_memory_stats(dev)
    model, de = _direct_model(dev, HEADLINE["n_peers"])
    st, forged = _direct_state(model)
    torch.cuda.synchronize()
    model.rollout(st, ROLLOUT_STEPS, record=True)
    torch.cuda.synchronize()
    cuda_gossip.reset_launches()
    t0 = time.perf_counter()
    out, rec = model.rollout(st, ROLLOUT_STEPS, record=True)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                "gossip_exchange": cuda_gossip.exchange_select.launches}
    if launches != {"gossip_propagate": ROLLOUT_STEPS,
                    "gossip_exchange": ROLLOUT_STEPS // 8}:
        fail(f"direct-edge rollout launched {launches}")
    have = model.have_bool(out)
    spread = max(int(have[:, i].sum()) for i in forged)
    if spread > 1:
        fail(f"a forged message spread to {spread} peers")
    d = torch.from_numpy(de).to(dev)
    if bool((out.mesh & d).any()):
        fail("a direct edge is in the mesh after the run")
    # Every direct edge's receiver i holds each valid message within one
    # round of its sender j = nbrs[i, s] (where that round was run).
    from go_libp2p_pubsub_torch.ops.graphs import decode_index_plane

    i, s = torch.nonzero(d, as_tuple=True)
    j = decode_index_plane(out.nbrs)[i, s].long()
    fs = out.first_step
    last = out.step - 1
    valid = (out.msg_valid & out.msg_used)[None, :]
    due = (fs[j] >= 0) & (fs[j] + 1 <= last) & valid
    late = due & ((fs[i] < 0) | (fs[i] > fs[j] + 1))
    if bool(late.any()):
        fail(f"{int(late.sum())} direct-edge deliveries took over a round")
    frac, p50, p99 = model.delivery_stats(out)
    return dict(
        n_peers=model.n, direct_edges=int(de.sum()),
        direct_pairs_checked=int(due.sum()), forged_spread=spread,
        rounds=ROLLOUT_STEPS, rollout_ms=rollout_s * 1e3,
        rounds_per_s=ROLLOUT_STEPS / rollout_s, launches=launches,
        delivery_mean=float(torch.nanmean(frac)), p50_rounds=float(p50),
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        card=card), launches


def tree_phase(dev, card: str):
    """Phase 8.  Returns the kernels' launches in the direct-edge run."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    sections = {}
    t0 = time.perf_counter()
    sections["tree_100k"] = tree_replay(dev, card)
    print(f"tree tree_100k: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    sections["bench_treecast"] = bench_treecast_port(dev, card)

    t1 = time.perf_counter()
    if _api_logs(dev) != _api_logs("cpu"):
        fail("SimNetwork: the card's subscribers received other bytes "
             "than the CPU's")
    sections["sim_network"] = dict(cases=6, card_equals_cpu=True,
                                   seconds=time.perf_counter() - t1)

    t1 = time.perf_counter()
    small = {"faults": _same_states(
        _tree_under_faults(dev, TREE_SMALL_N),
        _tree_under_faults("cpu", TREE_SMALL_N), "run_with_faults")}
    card_res = _tree_churn_heal_wide(dev, TREE_SMALL_N)
    cpu_res = _tree_churn_heal_wide("cpu", TREE_SMALL_N)
    if not (card_res.verdict.passed and cpu_res.verdict.passed):
        fail("tree_churn_heal at 2,000 peers: the verdict is not PASS")
    small["tree_churn_heal"] = _same_result(card_res, cpu_res,
                                            "tree_churn_heal wide")
    small_delivery = {}
    for name, model in _router_models(dev, TREE_SMALL_N).items():
        a, _ = _router_run(model, N_MSGS, 0.01, 3)
        cpu_model = _router_models("cpu", TREE_SMALL_N)[name]
        b, _ = _router_run(cpu_model, N_MSGS, 0.01, 3)
        small[name] = _same_states(a, b, f"{name} at {TREE_SMALL_N}")
        small_delivery[name] = _delivery(model, a)
    sections["card_equals_cpu"] = dict(
        n_peers=TREE_SMALL_N, leaves=small,
        verdict=card_res.verdict.to_dict(), delivery=small_delivery,
        seconds=time.perf_counter() - t1)

    routers = {}
    for name, model in _router_models(dev, HEADLINE["n_peers"]).items():
        torch.cuda.reset_peak_memory_stats(dev)
        warm = model.init(seed=0)
        model.run(warm, 2)
        del warm
        st, secs = _router_run(model, N_MSGS, 0.01, 3)
        frac, p50 = model.delivery_stats(st)
        mean = _delivery(model, st)
        if mean < small_delivery[name] - 0.01:
            fail(f"{name} at 100k: delivery {mean} below the 2,000-peer "
                 f"run's {small_delivery[name]} - 0.01")
        routers[name] = dict(
            emit=getattr(model, "emit", None), delivery_mean=mean,
            p50_rounds=float(p50), rounds=ROUTER_ROUNDS,
            rounds_per_s=ROUTER_ROUNDS / secs, alive=int(st.alive.sum()),
            peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del st
        torch.cuda.empty_cache()
    sections["routers_100k"] = dict(routers, card=card)

    sections["direct_small"] = direct_small(dev)
    cuda_ed25519.reset_launches()
    sections["direct_100k"], launches = direct_full(dev, card)
    launches["ed25519_verify"] = cuda_ed25519.verify.launches
    emit(dict(phase="tree", seconds=time.perf_counter() - t0, card=card,
              **sections))
    return launches


# -- phase 9: the coded plane ---------------------------------------------------


CODED_SMALL_N = 2000         # the coded plane's width for card-vs-CPU runs
CODED_SMALL_STEPS = 8
# bench.py:89-91 RLNC_SCALE (window = N_MSGS) and :108-111 HYBRID_SCALE.
RLNC_GEOMETRY = dict(n_slots=16, conn_degree=8, gen_size=8,
                     msg_window=N_MSGS)
RLNC_STEPS, RLNC_COHORT, RLNC_DELAY = 24, 0.25, 2
HYBRID_GEOMETRY = dict(n_slots=16, conn_degree=8, gen_size=4, msg_window=32,
                       heartbeat_steps=4)
HYBRID_STEPS = 32
HYBRID_GRID = (("d", 0), ("d", 2), ("p", 0.125), ("p", 0.25), ("p", 0.5))
HYBRID_BUDGET_S = 180.0      # the grid stops adding points past this


def _same_coded(a, b, what: str) -> int:
    """Every leaf of two coded states (any device) bit for bit."""
    from go_libp2p_pubsub_torch.models.coded_trace import PortEngine

    la, lb = PortEngine().leaves(None, a), PortEngine().leaves(None, b)
    if la.keys() != lb.keys():
        fail(f"{what}: the states' leaves differ")
    for name in la:
        x, y = la[name], lb[name]
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"{what}: differ in state leaf {name}")
    return len(la)


def _same_channels(ra, rb, what: str) -> int:
    import numpy as np

    if sorted(ra) != sorted(rb):
        fail(f"{what}: the record channels differ")
    for name in ra:
        x, y = (np.asarray(r[name].cpu() if hasattr(r[name], "cpu")
                           else r[name]) for r in (ra, rb))
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"{what}: differ in record channel {name}")
    return len(ra)


def coded_replays(dev):
    """The coded trace and the canon's three hybrid streaming campaigns
    against the JAX-written traces (0 mismatches), and
    ``degraded_links_rlnc`` on the card and on the CPU (equal verdict,
    record and state)."""
    from go_libp2p_pubsub_torch import scenario
    from go_libp2p_pubsub_torch.models import coded_trace as CT
    from go_libp2p_pubsub_torch.scenario import stream_canon

    t0 = time.perf_counter()
    doc = CT.load_trace()
    _, bad, timings = CT.port_replay(doc, dev)
    if bad:
        fail(f"coded trace replay: {len(bad)} mismatches: {bad[:8]}")
    out = dict(coded_trace=dict(
        header=doc["header"], mismatches=0,
        steps_per_s={k: len(v) / sum(v) for k, v in timings.items()},
        seconds=time.perf_counter() - t0))
    t1 = time.perf_counter()
    res = stream_canon.port_replay(dev, names=stream_canon.HYBRID_CAMPAIGNS)
    bad = {name: diff for name, diff in res.items() if diff}
    if bad:
        fail(f"hybrid streaming canon replay: mismatches {bad}")
    sdoc = stream_canon.load_trace()["campaigns"]
    out["hybrid_canon"] = dict(
        campaigns=sorted(res), mismatches=0,
        verdicts={n: sdoc[n]["verdict"]["passed"] for n in res},
        seconds=time.perf_counter() - t1)
    t1 = time.perf_counter()
    name = "degraded_links_rlnc"
    card = scenario.run_scenario(scenario.build(name), device=dev)
    cpu = scenario.run_scenario(scenario.build(name), device="cpu")
    if card.verdict.to_dict() != cpu.verdict.to_dict():
        fail(f"{name}: the card's verdict is not the CPU's")
    n = _same_channels(card.record, cpu.record, name)
    n += _same_coded(card.final_state, cpu.final_state, name)
    out[name] = dict(verdict=card.verdict.passed, values_compared=n,
                     seconds=time.perf_counter() - t1)
    return out


def _rlnc_small(device):
    from go_libp2p_pubsub_torch.models.rlnc import RLNC

    import numpy as np

    n = CODED_SMALL_N
    model = RLNC(device=device, n_peers=n, **dict(RLNC_GEOMETRY,
                                                  msg_window=16))
    rng = np.random.default_rng(5)
    delay = np.zeros(n, np.int32)
    delay[rng.choice(n, size=round(RLNC_COHORT * n), replace=False)] = \
        RLNC_DELAY
    st = model.set_gossip_delay(model.init(1), delay)
    for slot in range(16):
        st = model.publish(st, int(rng.integers(n)), slot, slot % 7 != 3)
    return model.rollout(st, CODED_SMALL_STEPS, record=True)


def _hybrid_small(device, loss):
    from go_libp2p_pubsub_torch.models.hybrid import HybridGossipSub

    import numpy as np

    n = CODED_SMALL_N
    model = HybridGossipSub(device=device, n_peers=n, **HYBRID_GEOMETRY)
    st = model.init(2)
    st = (model.set_ingress_loss(st, loss[1]) if loss[0] == "d"
          else model.set_ingress_loss_p(st, loss[1]))
    rng = np.random.default_rng(6)
    for slot in range(32):
        st = model.publish(st, int(rng.integers(n)), slot, True)
    return model.rollout(st, CODED_SMALL_STEPS, record=True)


def _hybrid_engine_crash(device, path):
    """A hybrid streaming engine under decimation 2, killed after two
    chunks: a fresh engine warms up, restores the snapshot (partial
    ranks in its meta) and serves on, clean after three more chunks."""
    from go_libp2p_pubsub_torch.models.hybrid import HybridGossipSub
    from go_libp2p_pubsub_torch.serve import IngestRing, StreamingEngine
    from go_libp2p_pubsub_torch.serve import stream_trace as S
    from go_libp2p_pubsub_torch.utils import checkpoint

    model = HybridGossipSub(device=device, n_peers=CODED_SMALL_N,
                            **HYBRID_GEOMETRY)

    def pair():
        clock = S.SteppingClock()
        ring = IngestRing(capacity=64, policy="block", clock=clock)
        eng = StreamingEngine(model, ring, chunk_steps=4, pub_width=4,
                              clock=clock, snapshot_path=path)
        eng.warmup()
        return eng, ring

    def push(ring, lo, hi):
        for i in range(lo, hi):
            ring.push(topic=0, payload=b"coded %d" % i,
                      publisher=(37 * i) % CODED_SMALL_N)

    eng, ring = pair()
    eng.set_ingress_delay(2)
    push(ring, 0, 16)
    eng.run_chunk()
    eng.run_chunk()
    eng.snapshot()
    ranks = checkpoint.meta(path)["decode_ranks"]
    eng, ring = pair()
    eng.restore(path)
    push(ring, 16, 24)
    for _ in range(3):
        eng.run_chunk()
    eng.set_ingress_delay(0)
    eng.run_until_drained(max_chunks=32)
    return eng, ranks


def coded_small(dev):
    """Card = CPU at 2,000 peers: RLNC with a quarter of the peers
    decimated, the hybrid under decimation and under Bernoulli loss (all
    recorded), and a hybrid engine crash and restore: every state leaf,
    record channel, flight tail and completion equal."""
    import os
    import tempfile

    t0 = time.perf_counter()
    n = 0
    runs = [(_rlnc_small(d)) for d in (dev, "cpu")]
    n += _same_coded(runs[0][0], runs[1][0], "rlnc at 2,000")
    n += _same_channels(runs[0][1], runs[1][1], "rlnc at 2,000")
    for loss in (("d", 2), ("p", 0.375)):
        runs = [_hybrid_small(d, loss) for d in (dev, "cpu")]
        what = f"hybrid {loss[0]}={loss[1]} at 2,000"
        n += _same_coded(runs[0][0], runs[1][0], what)
        n += _same_channels(runs[0][1], runs[1][1], what)
        if int(runs[0][1]["coded_edges"][-1]) == 0:
            fail(f"{what}: no edge went coded")
    with tempfile.TemporaryDirectory() as d:
        engs = [_hybrid_engine_crash(dv, os.path.join(d, f"{i}.ckpt"))
                for i, dv in enumerate((dev, "cpu"))]
    (a, ra), (b, rb) = engs
    n += _same_coded(a.state, b.state, "hybrid engine crash at 2,000")
    n += _same_channels(a.flight_tail, b.flight_tail, "hybrid engine tail")
    if (ra != rb or ra["partial"] == 0 or a.completed != b.completed
            or a.latencies_s != b.latencies_s or a.pending
            or a.duplicate_completions or a.restores != 1
            or a.completed != len(a.publish_log)):
        fail(f"hybrid engine crash at 2,000: card {a.completed} / "
             f"{len(a.publish_log)} (ranks {ra}), CPU {b.completed} "
             f"(ranks {rb}), pending {len(a.pending)}, duplicates "
             f"{a.duplicate_completions}")
    return dict(n_peers=CODED_SMALL_N, values_compared=n,
                engine_completed=a.completed, decode_ranks_at_crash=ra,
                seconds=time.perf_counter() - t0)


def _step_split(dev, model, st):
    """Device ms of one coded round's parts (CUDA events behind a device
    spin, after a warm call; one timed call of the draw, the encode (draw
    included), the fold's K x Kg elimination passes and the step, the
    median of 3 of the hybrid's eager plane (K1) and a heartbeat (K2))."""
    import torch

    from go_libp2p_pubsub_torch.models.rlnc import draw_block, encode, fold
    from go_libp2p_pubsub_torch.ops import gf256, rng
    from go_libp2p_pubsub_torch.ops.graphs import decode_index_plane

    hybrid = hasattr(st, "gossip")
    g = model.gs._widen_indices(st.gossip) if hybrid else st
    basis, k = st.basis, model.k
    key = rng.split(st.key_coded if hybrid else st.key, 2)[0]
    n, m, kg = basis.shape[0], basis.shape[1], basis.shape[2]
    blk = draw_block(k, m, kg)

    def draw():
        for r0 in range(0, n, blk):
            gf256.coeffs_by_uid(key, (min(blk, n - r0), k, m, kg),
                                row_offset=r0)

    frag = encode(key, basis, k)
    j = torch.clamp(decode_index_plane(g.nbrs), 0, n - 1).long()
    flat_idx = j * k + torch.clamp(decode_index_plane(g.rev), 0, k - 1)
    ok = (gf256.gf_rank(basis) > 0)[j] & g.edge_live[:, :, None]
    out = {"draw": _time_ms(draw, reps=1),
           "encode": _time_ms(lambda: encode(key, basis, k), reps=1),
           "fold": _time_ms(lambda: fold(basis, frag, flat_idx, ok), reps=1)}
    if hybrid:
        accept = torch.ones(n, dtype=torch.bool, device=dev)
        out["eager"] = _time_ms(lambda: model.gs._propagate(
            g, eager_edge_ok=~st.coded, ingress_ok=accept), reps=3)
        out["heartbeat"] = _time_ms(lambda: model.gs._heartbeat(g), reps=3)
    out["step"] = _time_ms(lambda: model.step(st), reps=1)
    out["launches_a_step"] = _device_ops(lambda: model.step(st))
    return out


def rlnc_full(dev, card: str):
    """RLNC at ``RLNC_SCALE``'s widths, scaled from 1,024 to 100,000 peers,
    main-path style: the signed window verified natively, 128 publishes
    with the verdicts, a timed ``rollout(RLNC_STEPS, record=True)`` (the
    bench's 24 rounds, the metric's window) clean
    and with a quarter of the peers decimated (delay 2), each under the
    sync-debug mode; validated msgs/s as ``bench.py:1167`` defines it."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.crypto import native
    from go_libp2p_pubsub_torch.models.rlnc import RLNC

    rng = np.random.default_rng(1)
    envs, forged = signed_window(rng)
    pks = [e.pubkey for e in envs]
    msgs = [native.signing_bytes(e.topic, e.seqno, e.payload) for e in envs]
    sigs = [e.signature for e in envs]
    native.verify_batch(pks[:16], msgs[:16], sigs[:16])
    t0 = time.perf_counter()
    verdicts = native.verify_batch(pks, msgs, sigs)
    verify_s = time.perf_counter() - t0
    n = HEADLINE["n_peers"]
    srcs = rng.integers(n, size=N_MSGS)
    delay = np.zeros(n, np.int32)
    delay[rng.choice(n, size=round(RLNC_COHORT * n), replace=False)] = \
        RLNC_DELAY
    model = RLNC(device=dev, n_peers=n, **RLNC_GEOMETRY)
    out = {}
    split = None
    for arm in ("clean", "degraded"):
        torch.cuda.reset_peak_memory_stats(dev)
        st = model.init(0)
        if arm == "degraded":
            st = model.set_gossip_delay(st, delay)
        for slot in range(N_MSGS):
            st = model.publish(st, int(srcs[slot]), slot,
                               bool(verdicts[slot]))
        model.step(st)                                   # warm
        torch.cuda.synchronize()
        box = {}

        def timed():
            t1 = time.perf_counter()
            box["out"] = model.rollout(st, RLNC_STEPS, record=True)
            torch.cuda.synchronize()
            box["s"] = time.perf_counter() - t1

        syncs = _sync_warnings(timed)
        fin, rec = box["out"]
        frac, p50, p99 = (x.cpu().numpy() for x in model.delivery_stats(fin))
        rank = model.rank(fin).cpu().numpy()
        spread = max(int((rank[:, i] > 0).sum()) for i in forged)
        if syncs or spread > 1 or not np.isfinite(p50):
            fail(f"rlnc {arm} at 100k: {syncs} syncs, forged spread "
                 f"{spread}, p50 {p50}")
        mean = float(np.nanmean(frac))
        delivered = float(np.nansum(frac)) * n
        out[arm] = dict(
            validated_msgs_per_s=delivered / (box["s"] + verify_s),
            delivery_mean=mean, p50_rounds=float(p50),
            p99_rounds=float(p99), rollout_ms=box["s"] * 1e3,
            steps_per_s=RLNC_STEPS / box["s"], syncs=syncs,
            forged_spread=spread,
            peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        if arm == "clean":
            if mean < 0.999:
                fail(f"rlnc clean at 100k: delivery {mean}")
            split = _step_split(dev, model, model.rollout(st, 2, False)[0])
        del box, fin, rec
        torch.cuda.empty_cache()
    return dict(n_peers=n, **RLNC_GEOMETRY, steps=RLNC_STEPS,
                verify_ms=verify_s * 1e3, step_split_ms=split, card=card,
                **out)


def _strict_win(a, e) -> bool:
    """``bench.py``'s rule: more delivered, or equal at a lower p99."""
    return (a["delivery_mean"] > e["delivery_mean"] + 1e-9
            or (abs(a["delivery_mean"] - e["delivery_mean"]) <= 1e-9
                and a["p99_rounds"] < e["p99_rounds"]))


def hybrid_full(dev, card: str):
    """The hybrid at ``HYBRID_SCALE``'s widths, scaled from 256 to 100,000
    peers: adaptive against its eager-forced twin (switch thresholds above
    1) over ``HYBRID_GRID`` (decimation d = 0, 2 and Bernoulli p = 0.125,
    0.25, 0.5; cut from 9 points to make room for phase ``sharded``), a
    timed ``rollout(32)`` each under the sync-debug mode; the d = 0
    identity leaf for leaf; K1/K2 launches; one round's K1 and one
    heartbeat's K2 inputs, with coded edges present, against the plain
    versions."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.models.hybrid import HybridGossipSub
    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.ops import gossip_packed as plain

    n = HEADLINE["n_peers"]
    torch.cuda.reset_peak_memory_stats(dev)
    ada = HybridGossipSub(device=dev, n_peers=n, **HYBRID_GEOMETRY)
    twin = HybridGossipSub(device=dev, n_peers=n, switch_hi=2.0,
                           switch_lo=1.5, **HYBRID_GEOMETRY)
    st0 = ada.init(0)
    srcs = np.random.default_rng(3).integers(n, size=32)
    for slot in range(32):
        st0 = ada.publish(st0, int(srcs[slot]), slot, True)
    ada.rollout(st0, 1, record=False)                    # warm
    torch.cuda.synchronize()
    rows, dropped, finals, syncs = [], [], {}, 0
    t0 = time.perf_counter()
    cuda_gossip.reset_launches()
    for kind, val in HYBRID_GRID:
        if time.perf_counter() - t0 > HYBRID_BUDGET_S:
            dropped.append(f"{kind}={val}")
            continue
        st = (ada.set_ingress_loss(st0, val) if kind == "d"
              else ada.set_ingress_loss_p(st0, val))
        row = {"loss": kind, "value": val,
               "loss_frac": val / (val + 1) if kind == "d" else val}
        for name, model in (("adaptive", ada), ("eager_forced", twin)):
            box = {}

            def timed():
                t1 = time.perf_counter()
                box["st"] = model.rollout(st, HYBRID_STEPS, record=False)[0]
                torch.cuda.synchronize()
                box["s"] = time.perf_counter() - t1

            syncs += _sync_warnings(timed)
            fin = box["st"]
            frac, p50, p99 = (x.cpu().numpy()
                              for x in model.delivery_stats(fin))
            row[name] = dict(
                delivery_mean=float(np.nanmean(frac)),
                p50_rounds=float(p50), p99_rounds=float(p99),
                coded_edges=int((fin.coded & fin.gossip.nbr_valid).sum()),
                rollout_ms=box["s"] * 1e3)
            if (kind, val) in (("d", 0), ("d", 2)):
                finals[(kind, val, name)] = fin
        row["adaptive_wins"] = _strict_win(row["adaptive"],
                                           row["eager_forced"])
        rows.append(row)
    grid_s = time.perf_counter() - t0
    runs = 2 * len(rows)
    launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                "gossip_exchange": cuda_gossip.exchange_select.launches}
    want = {"gossip_propagate": runs * HYBRID_STEPS,
            "gossip_exchange": runs * HYBRID_STEPS // 4}
    if launches != want:
        fail(f"the hybrid grid launched {launches}, expected {want}")
    if syncs:
        fail(f"the hybrid grid's timed rollouts synchronised {syncs} times")
    identity = _same_coded(finals[("d", 0, "adaptive")],
                           finals[("d", 0, "eager_forced")],
                           "hybrid d=0: adaptive against the eager twin")
    coded = finals[("d", 2, "adaptive")]
    if not bool(coded.coded.any()):
        fail("hybrid d=2 at 100k: no edge went coded")
    # One round and one heartbeat with coded edges present: the kernels
    # against their plain versions on the captured inputs.
    with _Capture() as cap:
        st = coded
        for _ in range(4):
            st = ada.step(st)
        torch.cuda.synchronize()
    errs = {}
    for name, ref_fn in (("propagate", plain.propagate_packed),
                         ("exchange_select", plain.exchange_select)):
        if name not in cap.calls:
            fail(f"the hybrid round never called {name}")
        args, kw = cap.calls[name]
        got = getattr(cuda_gossip, name)(*args, **kw)
        ref = ref_fn(*args, **kw)
        torch.cuda.synchronize()
        errs[name] = _max_err(got, ref)
        if errs[name] != 0.0:
            fail(f"{name} on the hybrid's inputs: max abs err {errs[name]}")
    split = _step_split(dev, ada, coded)
    wins = [r for r in rows if r["adaptive_wins"]]
    return dict(
        n_peers=n, **HYBRID_GEOMETRY, steps=HYBRID_STEPS, grid=rows,
        dropped=dropped, grid_s=grid_s,
        crossover_loss_frac=min((r["loss_frac"] for r in wins),
                                default=None),
        d0_identity_leaves=identity, syncs=syncs, launches=launches,
        kernel_input_max_abs_err=errs, coded_edges_at_capture=int(
            (coded.coded & coded.gossip.nbr_valid).sum()),
        step_split_ms=split,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        card=card), launches


def coded_phase(dev, card: str):
    """Phase 9.  Returns the kernels' launches in the hybrid grid."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    t0 = time.perf_counter()
    sections = {}
    cuda_ed25519.reset_launches()
    for key, section in (("replays", lambda: coded_replays(dev)),
                         ("card_equals_cpu", lambda: coded_small(dev)),
                         ("rlnc_100k", lambda: rlnc_full(dev, card))):
        t1 = time.perf_counter()
        sections[key] = section()
        torch.cuda.empty_cache()
        print(f"coded {key}: {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    sections["hybrid_100k"], launches = hybrid_full(dev, card)
    print(f"coded hybrid_100k: {time.perf_counter() - t1:.1f} s", flush=True)
    launches["ed25519_verify"] = cuda_ed25519.verify.launches
    emit(dict(phase="coded", seconds=time.perf_counter() - t0, card=card,
              **sections))
    return launches


# -- phase 10: the sharded rollout ---------------------------------------------


# bench.py:78 SHARDED_SCALE: the sharded closed loop's configuration.
SHARDED = dict(n_peers=204_800, n_devices=8, n_slots=32, degree=16,
               steps=48, topo_seed=0)
SHARDED_SMALL_N = 2048          # card = CPU width of the sharded runs
SHARDED_SMALL_STEPS = 24
SHARDED_BLOCK_SHAPES = (25_600, 204_800)   # K1/K2 at a rank's block
CUT_MARGIN = 0.50               # tests/test_placement.py's cut reduction
SHARDED_BUDGET_S = 180.0


def _sharded_model_kw():
    from go_libp2p_pubsub_torch.models.gossipsub import build_topology_local

    return dict(n_slots=SHARDED["n_slots"], conn_degree=SHARDED["degree"],
                msg_window=N_MSGS, builder=build_topology_local)


def _sharded_closed_loop(pm, srcs, verdicts, steps):
    """``bench.py:sharded_child_main``'s loop on one rank: BFS placement,
    the split-gather ring, 128 publishes with the verdicts (canonical
    sources) -> (model, published state)."""
    from go_libp2p_pubsub_torch.parallel.gossip_sharded import (
        ShardedGossipSub,
    )

    sg = ShardedGossipSub(SHARDED["n_peers"], pm, placement="bfs",
                          split_gather=True, **_sharded_model_kw())
    st = sg.init(seed=SHARDED["topo_seed"])
    for slot in range(N_MSGS):
        st = sg.publish(st, int(srcs[slot]), slot, bool(verdicts[slot]))
    return sg, st


def _sharded_rank(device, srcs, verdicts):
    """One of the 8 ranks on the one card (a gloo group over CUDA
    tensors): the closed loop, a 48-round recorded rollout, the canonical
    state's leaf digests (rank 0), the record and this rank's launches."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.parallel.gossip_sharded import digest
    from go_libp2p_pubsub_torch.parallel.mesh import make_mesh

    pm = make_mesh(SHARDED["n_peers"], device=device)
    sg, st = _sharded_closed_loop(pm, srcs, verdicts, SHARDED["steps"])
    torch.cuda.synchronize()
    cuda_gossip.reset_launches()
    t0 = time.perf_counter()
    out, rec = sg.rollout(st, SHARDED["steps"], record=True)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                "gossip_exchange": cuda_gossip.exchange_select.launches}
    canon = sg.gather_canonical(out)
    return dict(
        rank=pm.rank, rollout_s=rollout_s, launches=launches,
        staged=dict(pm.staged), perm_head=sg.perm[:8].tolist(),
        placement_report=sg.placement_report,
        digest=digest(canon) if pm.rank == 0 else None,
        record={k: v.cpu().numpy() for k, v in rec.items()}
        if pm.rank == 0 else None)


def _sharded_small_plan(split: bool):
    import numpy as np

    from go_libp2p_pubsub_torch.models.gossipsub import build_topology_local

    rng = np.random.default_rng(4)
    n = SHARDED_SMALL_N
    pubs = [(int(rng.integers(n)), slot, slot % 11 != 3)
            for slot in range(40)]
    topo = build_topology_local(np.random.default_rng(3), n,
                                SHARDED["n_slots"], SHARDED["degree"])
    return dict(n_peers=n, model=dict(n_slots=SHARDED["n_slots"],
                                      conn_degree=SHARDED["degree"],
                                      msg_window=N_MSGS),
                topology=topo, placement="bfs", split_gather=split, seed=3,
                publishes=pubs, steps=SHARDED_SMALL_STEPS,
                kill=list(range(0, n, 97)))


def _sharded_small_rank(device):
    from go_libp2p_pubsub_torch.parallel.gossip_sharded import run_plan

    return [run_plan(device, _sharded_small_plan(split))
            for split in (True, False)]


def _same_sharded_runs(a, b, what: str) -> int:
    """Every leaf, record channel, delivery statistic and the kill's mask
    of two small sharded runs, bit for bit -> values compared."""
    import numpy as np

    n = 0
    for key in ("state", "record"):
        if a[key].keys() != b[key].keys():
            fail(f"{what}: {key} names differ")
        for name in a[key]:
            x, y = np.asarray(a[key][name]), np.asarray(b[key][name])
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                fail(f"{what}: {key} {name} differs")
            n += 1
    for x, y in zip(a["stats"], b["stats"]):
        if not np.array_equal(x, y, equal_nan=True):
            fail(f"{what}: delivery_stats differ")
        n += 1
    if not np.array_equal(a["alive_after_kill"], b["alive_after_kill"]):
        fail(f"{what}: the kill's alive mask differs")
    if not all(a["wrappers"].values()) or not all(b["wrappers"].values()):
        fail(f"{what}: a sharded wrapper disagrees with the unsharded "
             f"functions: {a['wrappers']} {b['wrappers']}")
    return n + 1


def _same_digests(a: dict, b: dict, what: str) -> int:
    if a.keys() != b.keys():
        fail(f"{what}: leaf names differ")
    bad = [k for k in a if a[k] != b[k]]
    if bad:
        fail(f"{what}: leaves differ: {bad}")
    return len(a)


def _same_records(a: dict, b: dict, what: str) -> int:
    import numpy as np

    if a.keys() != b.keys():
        fail(f"{what}: record channels differ")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        if not np.array_equal(x, y):
            fail(f"{what}: record channel {k} differs")
    return len(a)


def sharded_block_kernels(dev):
    """K1 (through ``fresh_src``, as ``propagate_sharded`` feeds it) and K2
    (a gathered words table) at a rank's block shapes, K = 32, W = 4:
    warm device ms, the plain versions' ms, the bytes bound (the gather's
    bytes reckoned apart) and the agreement with the plain versions."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.ops import gossip_packed as plain

    gen = torch.Generator(device=dev).manual_seed(10)
    k, w, n_all = 32, 4, SHARDED["n_peers"]
    out = {}
    for b in SHARDED_BLOCK_SHAPES:
        args, _ = propagate_inputs(gen, b, k, w, dev, "plain")
        mesh, nbrs = args[0], torch.remainder(args[1], n_all)
        args = (mesh, nbrs) + args[2:]
        fresh_all = _rand(gen, (n_all, w), dev) & _rand(gen, (n_all, w), dev)
        src = fresh_all[nbrs.long()]                       # the gather
        kw = dict(fresh_src=src)
        k1 = cuda_gossip.propagate(*args, **kw)
        ref1 = plain.propagate_packed(*args, **kw)
        x = exchange_inputs(gen, b, k, w, dev)
        table = _rand(gen, (n_all, w), dev) & _rand(gen, (n_all, w), dev)
        x = (torch.remainder(x[0], n_all),) + x[1:4] + (table,) + x[5:]
        k2 = cuda_gossip.exchange_select(*x, 5000, 5000)
        ref2 = plain.exchange_select(*x, 5000, 5000)
        torch.cuda.synchronize()
        errs = (_max_err(k1, ref1), _max_err(k2, ref2))
        if errs != (0.0, 0.0):
            fail(f"K1/K2 at block {b}: max abs err {errs}")
        k1_bytes = propagate_bytes(args, kw, k1)
        k2_bytes = exchange_bytes(x, k2)
        out[b] = dict(
            k1_ms=_time_ms(lambda: cuda_gossip.propagate(*args, **kw)),
            k1_plain_ms=_time_ms(lambda: plain.propagate_packed(*args, **kw),
                                 reps=3),
            k1_bound_ms=k1_bytes / HBM_BYTES_PER_S * 1e3,
            k1_bytes=k1_bytes,
            # The row gather feeding K1: every rank reads the whole fresh
            # table (all-gather; N*W words) and writes the [B, K, W] cube.
            gather_bytes=n_all * w * 4 + _nbytes(src),
            gather_bound_ms=(n_all * w * 4 + _nbytes(src))
            / HBM_BYTES_PER_S * 1e3,
            k2_ms=_time_ms(lambda: cuda_gossip.exchange_select(
                *x, 5000, 5000)),
            k2_plain_ms=_time_ms(lambda: plain.exchange_select(
                *x, 5000, 5000), reps=3),
            k2_bound_ms=k2_bytes / HBM_BYTES_PER_S * 1e3,
            k2_bytes=k2_bytes, max_abs_err=max(errs))
    return out


def sharded_world1(dev, card, srcs, verdicts, verify_s, forged):
    """World size 1 over NCCL on the card: the closed loop at 204,800
    peers, warm and timed 48-round recorded rollouts, the phase split
    against the monolithic gather (``bench.py:sharded_phase_breakdown``),
    and the canonical state's digests.  Then, on the same group, the
    2,048-peer runs at R = 1 on the card and (a gloo sub-group) on the
    CPU."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from go_libp2p_pubsub_torch.ops import cuda_gossip
    from go_libp2p_pubsub_torch.ops import bitpack
    from go_libp2p_pubsub_torch.parallel.gossip_sharded import (
        digest, run_plan,
    )
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub
    from go_libp2p_pubsub_torch.parallel.mesh import free_port, make_mesh
    from go_libp2p_pubsub_torch.utils.metrics import flight_summary

    import datetime

    torch.cuda.set_device(dev)
    torch.cuda.synchronize(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, device_id=dev,
        timeout=datetime.timedelta(seconds=SHARDED_BUDGET_S))
    try:
        n = SHARDED["n_peers"]
        pm = make_mesh(n, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        sg, st = _sharded_closed_loop(pm, srcs, verdicts, SHARDED["steps"])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sg.rollout(st, SHARDED["steps"], record=True)      # warm run
        torch.cuda.synchronize()
        cuda_gossip.reset_launches()
        t0 = time.perf_counter()
        out, rec = sg.rollout(st, SHARDED["steps"], record=True)
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
        launches = {"gossip_propagate": cuda_gossip.propagate.launches,
                    "gossip_exchange": cuda_gossip.exchange_select.launches}
        want = {"gossip_propagate": SHARDED["steps"],
                "gossip_exchange": SHARDED["steps"] // 8}
        if launches != want:
            fail(f"sharded world 1: launches {launches}, expected {want}")
        flight = flight_summary(rec)
        frac, p50, p99 = (x.cpu().numpy() for x in sg.delivery_stats(out))
        mean_frac = float(np.nanmean(frac))
        if not mean_frac > 0.999:
            fail(f"sharded world 1: delivery {mean_frac}")
        if float(p50) != flight["lat_p50"] or float(p99) != flight["lat_p99"]:
            fail("sharded world 1: flight-record quantiles disagree with "
                 "delivery_stats")
        have = sg.model.have_bool(out).cpu().numpy()
        spread = max(int(have[:, i].sum()) for i in forged)
        if spread > 1:
            fail(f"sharded world 1: a forged message reached {spread} peers")
        delivered = float(np.nansum(frac)) * n
        peak = torch.cuda.max_memory_allocated(dev) / 1e9

        # The phase split against the monolithic gather (bench.py:746).
        split_m = sg.model
        mono = GossipSub(n_peers=n, mesh=pm.using_ring(False),   # all-gathers
                         peer_uid=sg.perm, device=dev, **_sharded_model_kw())
        wide = split_m._widen_indices(out)
        j = torch.clamp(wide.nbrs, 0, n - 1)
        table = torch.cat([wide.have_w, bitpack.pack(wide.mesh)], dim=1)
        ring, flat = pm.using_ring(True), pm.using_ring(False)
        phases = {
            "propagate": dict(
                split_ms=_time_ms(lambda: split_m._propagate(wide), reps=5),
                monolithic_ms=_time_ms(lambda: mono._propagate(wide),
                                       reps=5),
                gather_split_ms=_time_ms(
                    lambda: ring.gather(wide.fresh_w, j), reps=5),
                gather_monolithic_ms=_time_ms(
                    lambda: flat.gather(wide.fresh_w, j), reps=5)),
            "heartbeat": dict(
                split_ms=_time_ms(lambda: split_m._heartbeat(wide), reps=3),
                monolithic_ms=_time_ms(lambda: mono._heartbeat(wide),
                                       reps=3)),
            "exchange_gather": dict(
                split_ms=_time_ms(lambda: ring.gather(table, j), reps=5),
                monolithic_ms=_time_ms(lambda: flat.gather(table, j),
                                       reps=5),
                table_words=int(table.shape[1])),
        }
        phases["propagate"]["compute_est_ms"] = max(
            0.0, phases["propagate"]["split_ms"]
            - phases["propagate"]["gather_split_ms"])
        canon = sg.gather_canonical(out)
        world1 = dict(
            digest=digest(canon),
            record={k: v.cpu().numpy() for k, v in rec.items()})
        del canon, wide, out, st, sg, mono
        torch.cuda.empty_cache()
        summary = dict(
            gossipsub_sharded_validated_msgs_per_sec=delivered / (
                rollout_s + verify_s),
            n_peers=n, world=1, backend="nccl", placement="bfs",
            split_gather=True, rollout_steps=SHARDED["steps"],
            delivery_frac=mean_frac, p50_latency_rounds=float(p50),
            p99_latency_rounds=float(p99), forged_spread=spread,
            init_s=init_s, rollout_s=rollout_s,
            window_verify_charged_ms=verify_s * 1e3, peak_mem_gb=peak,
            launches=launches, phase_split_ms=phases, flight=flight,
            card=card)

        # 2,048 peers at R = 1: the card (this NCCL group) and the CPU (a
        # gloo sub-group of the same process).
        cpu_group = dist.new_group([0], backend="gloo")
        small = {}
        for split in (True, False):
            plan = _sharded_small_plan(split)
            small[("card", 1, split)] = run_plan(dev, plan)
            small[("cpu", 1, split)] = run_plan("cpu", plan, group=cpu_group)
        return summary, world1, launches, small
    finally:
        dist.destroy_process_group()


def sharded_phase(dev, card: str):
    """Phase 10.  Returns the kernels' launches in the world-1 timed
    rollout."""
    import concurrent.futures as cf

    import numpy as np
    import torch

    from go_libp2p_pubsub_torch.crypto import native
    from go_libp2p_pubsub_torch.models.gossipsub import (
        GossipSub, build_topology_local,
    )
    from go_libp2p_pubsub_torch.ops import cuda_ed25519
    from go_libp2p_pubsub_torch.parallel.gossip_sharded import digest
    from go_libp2p_pubsub_torch.parallel.mesh import run_ranks
    from go_libp2p_pubsub_torch.parallel.placement import (
        partition_bfs, placement_report,
    )

    t_phase = time.perf_counter()
    n = SHARDED["n_peers"]
    # 1. Placement on the host: the bench's mesh into 8 shards.
    t0 = time.perf_counter()
    nbrs, _rev, valid, _out = build_topology_local(
        np.random.default_rng(SHARDED["topo_seed"]), n, SHARDED["n_slots"],
        SHARDED["degree"])
    perm, _ = partition_bfs(nbrs, valid, SHARDED["n_devices"])
    report = placement_report(nbrs, valid, SHARDED["n_devices"], perm,
                              seed=SHARDED["topo_seed"])
    placement_s = time.perf_counter() - t0
    if report["cut_reduction_vs_random"] < CUT_MARGIN:
        fail(f"BFS placement cut reduction {report['cut_reduction_vs_random']}"
             f" under {CUT_MARGIN}")
    print(f"sharded placement: {placement_s:.1f} s", flush=True)

    # The bench's closed loop: the signed window verified natively.
    rng = np.random.default_rng(1)
    envs, forged = signed_window(rng)
    pks = [e.pubkey for e in envs]
    msgs = [native.signing_bytes(e.topic, e.seqno, e.payload) for e in envs]
    sigs = [e.signature for e in envs]
    native.verify_batch(pks[:16], msgs[:16], sigs[:16])
    t0 = time.perf_counter()
    verdicts = native.verify_batch(pks, msgs, sigs)
    verify_s = time.perf_counter() - t0
    if not np.array_equal(verdicts, [i not in forged for i in range(N_MSGS)]):
        fail("sharded: native verdicts do not match the forged set")
    srcs = [int(rng.integers(n)) for _ in range(N_MSGS)]

    # 2. World size 1 over NCCL, and the R = 1 small runs.
    t0 = time.perf_counter()
    cuda_ed25519.reset_launches()
    summary, world1, launches, small = sharded_world1(
        dev, card, srcs, verdicts, verify_s, forged)
    launches["ed25519_verify"] = cuda_ed25519.verify.launches
    print(f"sharded world1: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. Eight ranks on the one card (gloo over CUDA tensors), and the
    # R = 4 small runs on the card and on the CPU, side by side.
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(1) as ex:
        small4 = ex.submit(lambda: (
            run_ranks(_sharded_small_rank, 4, "gloo", str(dev), 300.0),
            run_ranks(_sharded_small_rank, 4, "gloo", "cpu", 300.0)))
        ranks8 = run_ranks(_sharded_rank, SHARDED["n_devices"], "gloo",
                           str(dev), 600.0, args=(srcs, verdicts))
        card4, cpu4 = small4.result()
    eight_s = time.perf_counter() - t0
    print(f"sharded eight_ranks: {eight_s:.1f} s", flush=True)
    want = {"gossip_propagate": SHARDED["steps"],
            "gossip_exchange": SHARDED["steps"] // 8}
    for r in ranks8:
        if r["launches"] != want:
            fail(f"rank {r['rank']}: launches {r['launches']}, want {want}")
        if r["placement_report"] != report:
            fail(f"rank {r['rank']}: placement report differs from the "
                 f"host's")
    leaves8 = _same_digests(ranks8[0]["digest"], world1["digest"],
                            "8 ranks against world 1 (canonical state)")
    _same_records(ranks8[0]["record"], world1["record"],
                  "8 ranks against world 1 (flight record)")

    # The port's plain GossipSub at the same seed, unplaced.
    t0 = time.perf_counter()
    plain = GossipSub(device=dev, n_peers=n, **_sharded_model_kw())
    st = plain.init(seed=SHARDED["topo_seed"])
    for slot in range(N_MSGS):
        st = plain.publish(st, srcs[slot], slot, bool(verdicts[slot]))
    st, rec = plain.rollout(st, SHARDED["steps"], record=True)
    plain_digest = digest({
        name: (v.cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v)) for name, v in _leaves(st)})
    _same_digests(plain_digest, world1["digest"],
                  "plain GossipSub against the sharded run (canonical)")
    _same_records({k: v.cpu().numpy() for k, v in rec.items()},
                  world1["record"], "plain GossipSub's flight record")
    del st, rec, plain
    torch.cuda.empty_cache()
    plain_s = time.perf_counter() - t0

    # 4. Card = CPU at 2,048 peers, R = 1 and 4, ring and all-gather.
    compared = 0
    for split in (True, False):
        compared += _same_sharded_runs(
            small[("card", 1, split)], small[("cpu", 1, split)],
            f"2,048 peers R=1 split={split}: card against CPU")
        compared += _same_sharded_runs(
            card4[0][0 if split else 1], cpu4[0][0 if split else 1],
            f"2,048 peers R=4 split={split}: card against CPU")
        compared += _same_sharded_runs(
            small[("cpu", 1, split)], cpu4[0][0 if split else 1],
            f"2,048 peers split={split}: R=1 against R=4")
    for rank in card4:
        for run in rank:
            if run["launches"] != {
                    "gossip_propagate": SHARDED_SMALL_STEPS,
                    "gossip_exchange": SHARDED_SMALL_STEPS // 8}:
                fail(f"2,048 peers R=4 on the card: launches "
                     f"{run['launches']}")
    blocks = sharded_block_kernels(dev)
    seconds = time.perf_counter() - t_phase
    emit(dict(
        phase="sharded", seconds=seconds, card=card,
        placement=dict(report, init_s=placement_s, n_peers=n,
                       n_shards=SHARDED["n_devices"]),
        world1=summary,
        eight_ranks=dict(
            world=SHARDED["n_devices"], backend="gloo", device=str(dev),
            rollout_s=[r["rollout_s"] for r in ranks8],
            staged_bytes=[r["staged"]["bytes"] for r in ranks8],
            staged_ops=[r["staged"]["ops"] for r in ranks8],
            launches=ranks8[0]["launches"], wall_s=eight_s,
            canonical_leaves_equal_world1=leaves8,
            canonical_leaves_equal_plain=leaves8, plain_run_s=plain_s),
        card_equals_cpu=dict(n_peers=SHARDED_SMALL_N,
                             steps=SHARDED_SMALL_STEPS, worlds=[1, 4],
                             values_compared=compared),
        block_kernels={str(b): v for b, v in blocks.items()},
        budget_s=SHARDED_BUDGET_S))
    if seconds > SHARDED_BUDGET_S:
        fail(f"phase sharded took {seconds:.1f} s, over {SHARDED_BUDGET_S}")
    return launches


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--e1-baseline", metavar="DIR",
                    help="also time the E1 of the checkout at DIR against "
                    "this one, in turns (phase ed25519)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    try:
        from go_libp2p_pubsub_torch.crypto import native
        from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        kernels = ex.submit(cuda_gossip.build, True)
        e1 = ex.submit(cuda_ed25519.build, True)
        ed = ex.submit(native.build)
        base = (ex.submit(e1_baseline, args.e1_baseline)
                if args.e1_baseline else None)
        ptxas = check_ptxas(kernels.result())
        e1_ptxas = check_e1_ptxas(e1.result())
        ed.result()
        baseline = base.result() if base else None
    imads = fe_mul_imads()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas,
              e1_ptxas=e1_ptxas, e1_fe_mul_imads=imads))

    records = check_kernels(dev, ptxas)
    records.append(check_ed25519(dev, e1_ptxas, imads, card, baseline))
    launches = main_path(dev, card)
    scenario_launches = scenario_phase(dev, card)
    serve_launches, streaming_launches = serve_phase(dev, card)
    tree_launches = tree_phase(dev, card)
    coded_launches = coded_phase(dev, card)
    sharded_launches = sharded_phase(dev, card)
    for r in records:
        r["launches"] = launches[r["name"]]
        r["launches_scenario"] = scenario_launches[r["name"]]
        r["launches_serve"] = serve_launches[r["name"]]
        r["launches_streaming"] = streaming_launches[r["name"]]
        r["launches_tree"] = tree_launches[r["name"]]
        r["launches_coded"] = coded_launches[r["name"]]
        r["launches_sharded"] = sharded_launches[r["name"]]
        emit(dict(phase="kernel", **r))
    emit({"kernels": records})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
