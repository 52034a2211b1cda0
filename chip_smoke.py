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
              {1, 127, 128, 129, 512, 2048, 4102}, and on the main path's
              128-envelope window; counts the differing verdicts and
              fails if there is one; E1's device time (CUDA events) at
              the 128-envelope window and at B = 512 ... 32768, the
              window sweep (w = 1 ... 6 at every batch),
              ``verify_batch``'s wall time, the plain version's and the
              native library's times, and E1's bound (integer
              multiplies), on the whole card and on the SMs its launch
              occupies, and its share of each;
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
              must agree leaf for leaf.

The last line is ``{"ok": true, "device": {...}}``; nothing else is
printed after a failure.
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
E1_CHECK_BATCHES = (1, 127, 128, 129, 512)
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
            k = re.search(r"(propagate|exchange|ed25519_verify)_kernelILi(\d+)E",
                          m.group(1))
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
            launches=0, max_abs_err=err[wrapper], ms=t["ms"],
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
    """E1's registers, stack frame and spills for each window (a spill is
    recorded, not failed on)."""
    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    report = ptxas_report(text)
    want = {f"ed25519_verify_kernel<{w}>" for w in cuda_ed25519.WINDOWS}
    if set(report) != want or any("registers" not in r
                                  for r in report.values()):
        fail(f"ptxas reported no registers for every E1 window: {report}")
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
    that E1's launch can occupy, min(blocks, SMs): the bound of a batch
    that fills less than one wave, at its launch geometry."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if occupied:
        sms = min(sms, -(-batch // cuda_ed25519.BLOCK_THREADS))
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
    runs at ``min(w, 4)`` (its verdicts do not depend on the window; its
    memory grows 4^w B).  Counts every differing verdict, then fails if
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
    twins = {}

    def twin(key, rows, w):
        if (key, w) not in twins:
            twins[key, w] = ted.verify_rows(rows, "windowed", w).cpu().numpy()
        return twins[key, w]

    for w in cuda_ed25519.WINDOWS:
        got = ted.verify_batch(pks, msgs, sigs, window=w, device=dev)
        compare(f"w={w} B={n_all} vs native", got, want)
        compare(f"w={w} vs oracle", got[:128], oracle)
        for b in (*E1_CHECK_BATCHES, E1_TWIN_MAX):
            rows, host_ok = ted.prepare_rows(pks[:b], msgs[:b], sigs[:b],
                                             pad_to=b)
            rows = torch.from_numpy(rows).to(dev)
            raw = cuda_ed25519.verify(rows, "windowed", w).cpu().numpy()
            plain = twin(b, rows, min(w, 4))
            compare(f"w={w} B={b} vs native", raw & host_ok, want[:b])
            compare(f"w={w} B={b} vs plain", raw & host_ok, plain & host_ok)
            compare(f"w={w} B={b} host-passed raw vs plain", raw[host_ok],
                    plain[host_ok])

    # The main path's rows: the signed window at B = 128, raw verdicts.
    win = _window_triples(window_envs)
    win_native = native.verify_batch(*win)
    rows, host_ok = ted.prepare_rows(*win, pad_to=N_MSGS)
    rows = torch.from_numpy(rows).to(dev)
    plain = twin("window", rows, min(ted.default_window(dev), 4))
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


def time_e1(dev, data, window_envs, imads):
    """E1's device time at the window and the curve batches, the window
    sweep, ``verify_batch``'s wall time, the plain version's and the native
    library's times, and the bound."""
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
    for b in E1_BATCHES:
        triples = win if b == N_MSGS else [x[:b] for x in pool]
        rows, _ = ted.prepare_rows(*triples, pad_to=b)
        rows = torch.from_numpy(rows).to(dev)
        for w in cuda_ed25519.WINDOWS:
            ms = _time_ms(lambda: cuda_ed25519.verify(rows, "windowed", w),
                          reps=5 if b > 8192 else 10)
            sweep.setdefault(str(b), {})[f"w{w}"] = ms
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


def check_ed25519(dev, e1_ptxas, imads, card):
    """Phase 4.  Returns E1's record (launches filled later)."""
    import numpy as np

    from go_libp2p_pubsub_torch.ops import cuda_ed25519

    t0 = time.perf_counter()
    data = e1_sweep_data()
    envs, _ = signed_window(np.random.default_rng(1))
    compared, mismatches, max_err = check_e1(dev, data, envs)
    timed = time_e1(dev, data, envs, imads["imads"])
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
              window=w0, ptxas=e1_ptxas))
    return dict(
        name="ed25519_verify", route="cuda",
        source="go_libp2p_pubsub_torch/csrc/ed25519_verify.cu",
        replaces="go_libp2p_pubsub_tpu/ops/ed25519.py:779",
        launches=0, max_abs_err=max_err, mismatches=mismatches,
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

    def leaves(x, pre=""):
        for name in type(x)._fields:
            v = getattr(x, name)
            if hasattr(v, "_fields"):
                yield from leaves(v, pre + name + ".")
            else:
                yield pre + name, v

    import numpy as np

    n = 0
    for (name, x), (_, y) in zip(leaves(a), leaves(b)):
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


def main() -> None:
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
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        kernels = ex.submit(cuda_gossip.build, True)
        e1 = ex.submit(cuda_ed25519.build, True)
        ed = ex.submit(native.build)
        ptxas = check_ptxas(kernels.result())
        e1_ptxas = check_e1_ptxas(e1.result())
        ed.result()
    imads = fe_mul_imads()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas,
              e1_ptxas=e1_ptxas, e1_fe_mul_imads=imads))

    records = check_kernels(dev, ptxas)
    records.append(check_ed25519(dev, e1_ptxas, imads, card))
    launches = main_path(dev, card)
    for r in records:
        r["launches"] = launches[r["name"]]
        emit(dict(phase="kernel", **r))
    emit({"kernels": records})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
