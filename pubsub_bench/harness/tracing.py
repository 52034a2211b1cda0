"""The traced run's records: host spans, kernel taps and the device trace.

- ``Spans``: the benchmark's own spans around the calls into each layer,
  a ``torch.profiler.record_function`` range (so the device trace can
  name what the host was doing) and a host-clock duration.
- ``KernelTap``: while installed, the port's kernel entries
  (``ops/cuda_gossip.propagate``, ``exchange_select``,
  ``ops/cuda_ed25519.verify``) keep their arguments and outputs, from
  which ``roofline/counts.py`` reckons each launch's least time once the
  traced window has closed.
- ``reduce_trace``: a finished ``torch.profiler`` session -> device busy
  seconds and window seconds, device time by kernel name, the idle gaps
  named by the benchmark span open on the host, and the contract's
  ``breakdown``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "pubsub_bench.window"
SPAN_PREFIX = "pubsub_bench."


class Spans:
    """Host-clock durations by span name; with ``profile`` each span is
    also a profiler range."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; ``sync`` (a callable) runs inside the span
        before the clock stops (``torch.cuda.synchronize`` in a traced
        run, so the span ends when the device work has)."""
        ctx = contextlib.nullcontext()
        if self.profile:
            import torch

            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        with ctx:
            t0 = time.perf_counter()
            yield
            if sync is not None:
                sync()
            self.seconds[name].append(time.perf_counter() - t0)


class KernelTap:
    """Keeps each kernel entry's arguments while installed."""

    def __init__(self):
        self.calls: Dict[str, list] = {"propagate": [], "exchange": [],
                                       "ed25519": []}
        self._saved: List[Tuple[object, str, object]] = []

    def _wrap(self, module, attr: str, key: str):
        fn = getattr(module, attr)
        calls = self.calls[key]

        def tapped(*args, **kw):
            out = fn(*args, **kw)
            calls.append((args, kw, out))
            return out

        # The entry counts its launches on the module's name for it
        # (``propagate.launches += 1``), which is this wrapper while it
        # stands there: carry the count over and back.
        if hasattr(fn, "launches"):
            tapped.launches = fn.launches
        tapped.__wrapped__ = fn
        self._saved.append((module, attr, fn))
        setattr(module, attr, tapped)

    def install(self) -> None:
        from go_libp2p_pubsub_torch.ops import cuda_ed25519, cuda_gossip

        self._wrap(cuda_gossip, "propagate", "propagate")
        self._wrap(cuda_gossip, "exchange_select", "exchange")
        self._wrap(cuda_ed25519, "verify", "ed25519")

    def remove(self) -> None:
        for module, attr, fn in reversed(self._saved):
            tapped = getattr(module, attr)
            if hasattr(tapped, "launches"):
                fn.launches = tapped.launches
            setattr(module, attr, fn)
        self._saved.clear()

    def least_seconds(self, card: dict) -> Dict[str, float]:
        """The summed least time of the tapped launches, by kernel."""
        import torch

        from pubsub_bench.roofline import counts

        out = {"propagate": 0.0, "exchange": 0.0, "ed25519": 0.0}
        for args, kw, res in self.calls["propagate"]:
            tensors = {k: v for k, v in kw.items()
                       if isinstance(v, torch.Tensor)}
            out["propagate"] += counts.bytes_least_s(
                counts.propagate_bytes(args[:7], tensors, tuple(res)))
        for args, _, res in self.calls["exchange"]:
            out["exchange"] += counts.bytes_least_s(
                counts.exchange_bytes(args[:7], tuple(res)))
        for args, _, _ in self.calls["ed25519"]:
            if card.get("max_sm_clock_mhz"):
                out["ed25519"] += counts.e1_least_s(
                    int(args[0].shape[0]), card["sms"],
                    card["max_sm_clock_mhz"])
        return out


class TraceWindow:
    """A ``torch.profiler`` session (host and device) over part of the
    measured window, with the kernel taps installed while it runs.
    ``start``/``stop`` may sit in different iterations of a loop."""

    def __init__(self, device):
        self.device = device
        self.tap = KernelTap()
        self.prof = None
        self._range = None
        self.done = False

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.tap.install()
        self._range = torch.profiler.record_function(WINDOW_SPAN)
        self._range.__enter__()

    def stop(self) -> None:
        import torch

        if self.prof is None or self.done:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self.tap.remove()
        self.prof.stop()
        self.done = True

    def records(self, card: dict) -> dict:
        """The reduced trace and the tapped launches' least times."""
        return {"trace": reduce_trace(self.prof) if self.prof else None,
                "least_s": self.tap.least_seconds(card),
                "tapped": {k: len(v) for k, v in self.tap.calls.items()}}


# The device trace's kernel names of the port's three kernels.
KERNEL_NAMES = {"propagate": "propagate_kernel",
                "exchange": "exchange_kernel",
                "ed25519": "ed25519_verify"}


def _events(prof):
    """(name, is_device, start_us, end_us) of every profiler event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" in str(e.device_type()).lower()
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
        dur = (e.duration_ns() / 1e3 if hasattr(e, "duration_ns")
               else e.duration_us())
        out.append((e.name(), dev, float(start), float(start + dur)))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(prof) -> Optional[dict]:
    """The device side of a traced window, or None when the trace holds
    no device time."""
    events = _events(prof)
    windows = [(a, b) for n, d, a, b in events if not d and n == WINDOW_SPAN]
    # Device events, less the ranges that mirror the host's annotations
    # on the device's timeline.
    device = [(n, a, b) for n, d, a, b in events
              if d and b > a and not n.startswith(SPAN_PREFIX)]
    if not windows or not device:
        return None
    w0, w1 = windows[0][0], windows[-1][1]
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in device
               if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in clipped])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in clipped:
        by_name[n] += (b - a) / 1e6
    host = sorted((a, b, n[len(SPAN_PREFIX):]) for n, d, a, b in events
                  if not d and n.startswith(SPAN_PREFIX) and n != WINDOW_SPAN)
    gaps = []
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            inner = [(h1 - h0, n) for h0, h1, n in host if h0 <= mid <= h1]
            name = min(inner)[1] if inner else "outside_spans"
            gaps.append((name, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    kernels = {key: sum(s for n, s in by_name.items() if sub in n)
               for key, sub in KERNEL_NAMES.items()}
    kernels_run = sum(1 for n, _, _ in clipped
                      if not n.startswith(("Memcpy", "Memset")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_kernels": kernels_run,
        "kernel_s": kernels,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps[:10]],
        },
    }
