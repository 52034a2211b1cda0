"""Where a recorded rollout's time goes on the card.

    python -m go_libp2p_pubsub_torch.profile_rollout [--peers 100000]

Builds the headline closed loop's model (GossipSub, 32 slots, degree 16,
128-message window, seed 0, 128 publishes of which 4 invalid), runs one
warm ``rollout(24, record=True)``, then, from the same state each time:

- three unprofiled rollouts: wall time (host clock, ending in a
  synchronise);
- one rollout traced with CUDA activity only (no CPU operator tracing, so
  the host runs at nearly its unprofiled pace): its wall time, the device
  busy time (the union of its kernels' and copies' intervals on the card)
  and the idle share ``1 - busy / wall``, all of that one rollout, plus
  the kernel launches per round and the kernels that take the most time;
- one rollout traced with CPU and CUDA activity, with
  ``record_function`` ranges around the PRNG (``rng.split``,
  ``rng.uniform``), the round's two halves (``_propagate``,
  ``_heartbeat``) and the flight recorder: the device time of the kernels
  launched inside each range (ranges nest: the PRNG's time is also inside
  ``_heartbeat``'s);
- one rollout under ``torch.cuda.set_sync_debug_mode("warn")``: every
  operation that synchronises the host with the device, by message (a
  round must have none before it can be captured as a CUDA graph).

Prints one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import warnings
from collections import Counter

import numpy as np
import torch

from .models.gossipsub import GossipSub
from .ops import rng as rng_ops

ROUNDS = 24
RNG_RANGES = ("split", "uniform")
MODEL_RANGES = ("_propagate", "_heartbeat", "flight_record_round")


def _state(gs: GossipSub, n_msgs: int = 128, n_forged: int = 4):
    rng = np.random.default_rng(1)
    forged = set(rng.choice(n_msgs, size=n_forged, replace=False).tolist())
    st = gs.init(seed=0)
    for slot in range(n_msgs):
        st = gs.publish(st, int(rng.integers(gs.n)), slot, slot not in forged)
    return st


def _timed_rollout(gs: GossipSub, st) -> float:
    t0 = time.perf_counter()
    gs.rollout(st, ROUNDS, record=True)
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
def _ranges(gs: GossipSub):
    """Wrap the PRNG's functions and the model's round halves in
    ``record_function`` ranges for the length of the block."""
    from torch.profiler import record_function

    def wrap(label, fn):
        def ranged(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return ranged

    saved = {name: getattr(rng_ops, name) for name in RNG_RANGES}
    for name, fn in saved.items():
        setattr(rng_ops, name, wrap(f"rng.{name}", fn))
    for name in MODEL_RANGES:
        setattr(gs, name, wrap(name, getattr(gs, name)))
    try:
        yield [f"rng.{name}" for name in RNG_RANGES] + list(MODEL_RANGES)
    finally:
        for name, fn in saved.items():
            setattr(rng_ops, name, fn)
        for name in MODEL_RANGES:
            delattr(gs, name)


def _range_device_ms(events, labels) -> dict:
    """Device ms of the kernels launched inside each range, counting an
    outermost occurrence only (a range nested in one of its own name is
    already inside its parent's total)."""
    from torch.autograd import DeviceType

    out = {label: 0.0 for label in labels}
    calls = Counter()
    for e in events:
        if e.name not in out or e.device_type != DeviceType.CPU:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != e.name:
            parent = parent.cpu_parent
        if parent is None:
            out[e.name] += e.device_time_total / 1e3
            calls[e.name] += 1
    return {label: {"device_ms": out[label], "calls": calls[label]}
            for label in labels}


def profile(n_peers: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = torch.device("cuda", 0)
    gs = GossipSub(n_peers=n_peers, n_slots=32, conn_degree=16,
                   msg_window=128, device=dev)
    st = _state(gs)
    _timed_rollout(gs, st)
    unprofiled_ms = [_timed_rollout(gs, st) for _ in range(3)]

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = _timed_rollout(gs, st)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise SystemExit("the CUDA trace holds no device events")
    busy_ms = _busy_ms(device)
    by_name: Counter = Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = [{"kernel": name[:90], "ms": ms} for name, ms in by_name.most_common(12)]

    with _ranges(gs) as labels:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof_ranges:
            _timed_rollout(gs, st)
    ranges = _range_device_ms(prof_ranges.events(), labels)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gs.rollout(st, ROUNDS, record=True)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(str(w.message).splitlines()[0][:160] for w in caught)

    return {
        "device": torch.cuda.get_device_name(0),
        "n_peers": n_peers,
        "rounds": ROUNDS,
        "unprofiled_wall_ms": unprofiled_ms,
        "traced_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_round": len(device) / ROUNDS,
        "top_kernels": top,
        "ranges": ranges,
        "host_syncs_in_rollout": dict(syncs),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=100_000)
    print(json.dumps(profile(ap.parse_args().peers)))


if __name__ == "__main__":
    main()
