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

Prints one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
import warnings
from collections import Counter

import numpy as np
import torch

from .models.gossipsub import GossipSub
from .ops import cuda_gossip
from .ops import rng as rng_ops

ROUNDS = 24
RNG_RANGES = ("split", "uniform")
MODEL_RANGES = ("_propagate", "_heartbeat", "flight_record_round")
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
    """Wrap the PRNG's functions, the model's round halves and the kernel
    wrappers in ``record_function`` ranges for the length of the block."""
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
    for name in MODEL_RANGES:
        setattr(gs, name, wrap(name, getattr(gs, name)))
    try:
        yield [label for _, _, label, _ in saved] + list(MODEL_RANGES)
    finally:
        for module, name, _, fn in saved:
            if hasattr(fn, "launches"):
                fn.launches = getattr(module, name).launches
            setattr(module, name, fn)
        for name in MODEL_RANGES:
            delattr(gs, name)


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
    port_kernels = {}
    for label, (_, kernel) in PORT_KERNELS.items():
        launched = _kernel_events(device, kernel)
        port_kernels[label] = {
            "launches": len(launched),
            "device_ms": sum(e.time_range.elapsed_us() for e in launched) / 1e3}

    with _ranges(gs) as labels:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof_ranges:
            _timed_rollout(gs, st)
    ranges, linked = _range_device_ms(prof_ranges.events(), labels)
    for label, seen in linked.items():
        port_kernels[label]["linked_in_range_trace"] = seen

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
        "port_kernels": port_kernels,
        "ranges": ranges,
        "host_syncs_in_rollout": dict(syncs),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=100_000)
    args = ap.parse_args()
    print(json.dumps(profile(args.peers)))


if __name__ == "__main__":
    main()
