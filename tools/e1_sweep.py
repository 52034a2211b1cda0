#!/usr/bin/env python3
"""Kernel E1's launch sweeps on a CUDA card: the team's block size, and the
batch from which the wrapper launches one thread a signature.

Usage, from the repository's root on a machine with a CUDA card and nvcc::

    python3 tools/e1_sweep.py

1. blocks -- rebuilds ``csrc/ed25519_verify.cu`` with ``-DE1_THREADS=t``
   for each t in ``BLOCKS`` (in parallel, into the port's ``build/``),
   checks that each build gives the product build's verdicts, and times
   the team at ``BLOCK_BATCHES``.  ``cuda_ed25519.THREADS`` is chosen from
   it.
2. arms -- the product build's two arms (``cuda_ed25519._verify_arm``),
   the team against one thread a signature at ``ARM_BATCHES``, in turns
   (team, one thread, one thread, team).  ``cuda_ed25519.ONE_THREAD_FROM``
   is chosen from it.

Both at the card's default window (``ed25519.default_window``), on the RFC
8032 vectors and ``chip_smoke.py``'s seeded corruption sweep, repeated to
the batch.  Times are medians of CUDA-event timings behind a device spin
(``chip_smoke._time_ms``).  Prints one JSON line a sweep, then the card's
name and power limit as ``nvidia-smi`` gives them.  Exits non-zero, and
prints no result, without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

BLOCKS = (32, 64, 128, 256)
BLOCK_BATCHES = (128, 32768)
ARM_BATCHES = (16384, 24576, 25600, 26624, 28672, 32768)
REPS = 10  # timed calls a measurement (a turn, in the arm sweep)


def _block_build(threads: int):
    """E1 built with ``threads`` a block; returns rows x window -> the
    team's verdicts on the card."""
    import torch

    from go_libp2p_pubsub_torch.ops import cuda_build, cuda_ed25519

    path = os.path.join(cuda_build.BUILD_DIR,
                        f"libed25519_verify_t{threads}.so")
    cuda_build.build(cuda_ed25519.SOURCE, path,
                     defines=(f"E1_THREADS={threads}",))
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ed25519_verify.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    lib.ed25519_verify.restype = ci

    def run(rows, w):
        table = cuda_ed25519._base_table(w, rows.device)
        out = torch.empty(rows.shape[0], dtype=torch.bool, device=rows.device)
        cuda_build.raise_on(lib.ed25519_verify(
            rows.data_ptr(), table.data_ptr(), out.data_ptr(), rows.shape[0],
            w, cuda_ed25519.LANES,
            torch.cuda.current_stream(rows.device).cuda_stream),
            f"ed25519_verify launch ({threads} threads a block)")
        return out

    return run


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from go_libp2p_pubsub_torch.crypto import native
    from go_libp2p_pubsub_torch.ops import cuda_ed25519
    from go_libp2p_pubsub_torch.ops import ed25519 as ted

    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(len(BLOCKS) + 2) as ex:
        builds = {t: ex.submit(_block_build, t) for t in BLOCKS}
        product = ex.submit(cuda_ed25519.build)
        ed = ex.submit(native.build)
        product.result()
        ed.result()
        builds = {t: f.result() for t, f in builds.items()}
    w0 = ted.default_window(dev)
    pks, msgs, sigs, _ = cs.e1_sweep_data()
    reps = -(-max(BLOCK_BATCHES + ARM_BATCHES) // len(pks))
    pool = [x * reps for x in (pks, msgs, sigs)]

    def rows_of(b):
        rows, _ = ted.prepare_rows(*[x[:b] for x in pool], pad_to=b)
        return torch.from_numpy(rows).to(dev)

    blocks = {}
    for b in BLOCK_BATCHES:
        rows = rows_of(b)
        want = cuda_ed25519._verify_arm(rows, w0, cuda_ed25519.LANES)
        for t, run in builds.items():
            if not torch.equal(run(rows, w0), want):
                cs.fail(f"E1 at {t} threads a block differs at B = {b}")
            blocks.setdefault(str(b), {})[str(t)] = cs._time_ms(
                lambda: run(rows, w0), reps=REPS)
    cs.emit(dict(sweep="blocks", window=w0, threads=BLOCKS,
                 product_threads=cuda_ed25519.THREADS, ms_by_batch=blocks))

    arms = {}
    for b in ARM_BATCHES:
        rows = rows_of(b)
        team, one = (lambda: cuda_ed25519._verify_arm(
            rows, w0, cuda_ed25519.LANES)), (
            lambda: cuda_ed25519._verify_arm(rows, w0, 1))
        if not torch.equal(team(), one()):
            cs.fail(f"E1's two arms differ at B = {b}")
        order = (team, one, one, team)
        ms = [cs._time_ms(f, reps=REPS) for f in order]
        turns = {name: sorted(t for f, t in zip(order, ms) if f is arm)
                 for name, arm in (("team_ms", team), ("one_thread_ms", one))}
        arms[str(b)] = dict(turns, faster="team" if sum(
            turns["team_ms"]) < sum(turns["one_thread_ms"]) else "one_thread")
    cs.emit(dict(sweep="arms", window=w0, reps=REPS,
                 one_thread_from=cuda_ed25519.ONE_THREAD_FROM,
                 ms_by_batch=arms))
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
