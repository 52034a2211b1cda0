"""Tracing / profiling: step timers, profiler capture, topology dumps.

The JAX package's ``utils/trace.py`` in the port: wall-clock phase timers
around device work (fenced with a synchronise of the device the work ran
on, the counterpart of ``jax.block_until_ready``), a ``torch.profiler``
capture written as a Chrome trace (``profiler_trace``, the counterpart of
the reference's ``xla_trace``), and the tree and mesh exports, which read
the port's tensors back to numpy.

Beside those, the port's own spans (the JAX package has none): the
program marks its layer boundaries with ``with span("round.propagate",
st.step):``.  While no recorder is set (the default) a span is one shared
object that reads no clock and calls nothing.  ``set_recorder(timer)``
makes a :class:`StepTimer` the process's recorder: from then on each span
appends its name, its start and end on ``time.time_ns()`` (the host clock
of ``torch.profiler``'s events, so a span lines up with a profiled
window), the span open when it opened and the round, to
``timer.spans``.  A span never synchronises the device: it times the host
(enqueueing, launches, and any synchronisation the code does itself), and
it adds no event to a running profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.graphs import decode_index_plane


def _cuda_devices(value: Any) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or a
    NamedTuple / dict / list / tuple of them)."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.device.type == "cuda" else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value))
    return set()


def block_until_ready(value: Any) -> Any:
    """Wait for the work producing ``value`` (see :func:`_cuda_devices`):
    a synchronise of each card it lives on, nothing on the CPU.  The
    counterpart of ``jax.block_until_ready``."""
    for dev in _cuda_devices(value):
        torch.cuda.synchronize(dev)
    return value


class StepTimer:
    """Accumulating named phase timer.

    ``with timer("propagate"): st = gs.step(st)`` -- each phase records a
    wall-time sample; device work is fenced with a synchronise of every
    card the value passed to ``fence`` lives on (nothing for CPU tensors;
    skipped if no value is set before exit).

    Every sample also keeps its start offset from the timer's construction,
    so the full phase timeline can be exported as a Chrome-trace /
    Perfetto-loadable JSON (``export_chrome_trace``) -- the phase breakdown
    becomes a viewable flame track instead of a flat dict.
    """

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}
        # (name, start offset s, duration s) in completion order.
        self.events: List[Tuple[str, float, float]] = []
        self._epoch = time.perf_counter()
        self._fence_val: Any = None
        # The program's spans while this timer is the recorder
        # (``set_recorder``): (name, start ns, end ns, parent's index or
        # -1, round or None) in opening order; None while still open.
        # Past ``SPAN_CAPACITY`` spans are counted in ``dropped`` only.
        self.spans: List[Optional[SpanRecord]] = []
        self.dropped = 0
        self._open: Dict[int, int] = {}   # thread -> innermost open span
        self._span_lock = threading.Lock()

    def fence(self, value: Any) -> Any:
        """Mark ``value`` to be synchronised when the phase closes."""
        self._fence_val = value
        return value

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._fence_val is not None:
                block_until_ready(self._fence_val)
                self._fence_val = None
            dt = time.perf_counter() - t0
            self.samples.setdefault(name, []).append(dt)
            self.events.append((name, t0 - self._epoch, dt))

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "max_ms": float(a.max() * 1e3),
            }
        return out

    def export_chrome_trace(self) -> str:
        """The recorded phases as Chrome trace-event JSON (complete "X"
        events, microsecond timestamps) -- loadable in ``chrome://tracing``
        and Perfetto.  One process/thread track: the timer measures the
        host-side dispatch timeline, not per-device streams (use
        ``profiler_trace`` for the card's own tracks)."""
        events = [
            {
                "name": name,
                "cat": "phase",
                "ph": "X",
                "ts": round(start * 1e6, 3),
                "dur": round(dur * 1e6, 3),
                "pid": 0,
                "tid": 0,
            }
            for name, start, dur in self.events
        ]
        return json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}, sort_keys=True
        )

    def span_seconds(self, name: str) -> List[float]:
        """Host seconds of each closed span ``name``, in opening order."""
        return [(r[2] - r[1]) * 1e-9 for r in self.spans
                if r is not None and r[0] == name]


# -- the program's spans --------------------------------------------------------

# (name, start ns, end ns, parent's index in ``StepTimer.spans`` or -1,
# the round ``st.step`` or None), stamps on ``time.time_ns()``.
SpanRecord = Tuple[str, int, int, int, Optional[int]]
SPAN_CAPACITY = 1 << 20

_recorder: Optional[StepTimer] = None


def set_recorder(timer: Optional[StepTimer]) -> Optional[StepTimer]:
    """Make ``timer`` the process's span recorder (None: spans off again);
    returns the one it replaces."""
    global _recorder
    before, _recorder = _recorder, timer
    return before


def recorder() -> Optional[StepTimer]:
    """The process's span recorder, or None."""
    return _recorder


class _Off:
    """What :func:`span` returns with no recorder: one shared object."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("timer", "name", "step", "index", "parent", "start")

    def __init__(self, timer: StepTimer, name: str, step: Optional[int]):
        self.timer, self.name, self.step = timer, name, step

    def __enter__(self) -> None:
        t = self.timer
        with t._span_lock:   # the live plane flushes from several threads
            self.index = len(t.spans)
            if self.index >= SPAN_CAPACITY:
                t.dropped += 1
                return
            t.spans.append(None)
        tid = threading.get_ident()
        self.parent = t._open.get(tid, -1)
        t._open[tid] = self.index
        self.start = time.time_ns()

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.index < SPAN_CAPACITY:
            t = self.timer
            t.spans[self.index] = (self.name, self.start, end, self.parent,
                                   self.step)
            t._open[threading.get_ident()] = self.parent
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager marking one layer boundary of the program:
    ``with span("round.heartbeat", st.step): ...``.  ``step`` is the
    round, where the site holds it as a host int.  Records into the
    process's recorder (:func:`set_recorder`); with none, it returns one
    shared no-op object and reads nothing."""
    timer = _recorder
    if timer is None:
        return _OFF
    return _Span(timer, name, step)


def add_spans_to_trace(path: str, timer: StepTimer) -> int:
    """Write ``timer``'s closed spans into the Chrome trace at ``path`` (a
    ``profiler_trace`` capture, whose event times count from its
    ``baseTimeNanoseconds``) as "X" events on a track of their own, with
    the round and the parent in ``args``, so both load on one timeline;
    returns the number of spans written."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), 0
    events: List[dict] = [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": "program spans"}}]
    for i, r in enumerate(timer.spans):
        if r is None:
            continue
        name, start, end, parent, step = r
        events.append({
            "name": name, "cat": "program_span", "ph": "X",
            "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
            "pid": pid, "tid": tid,
            "args": {"index": i, "parent": parent, "step": step}})
    doc.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events) - 1


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], device="cpu",
                   file_name: str = "trace.json") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/file_name`` as Chrome trace JSON: host operators, and the
    card's kernels and copies when ``device`` is a CUDA device.

    No-op when ``log_dir`` is None, so callers can wire it to a config flag
    unconditionally.
    """
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, file_name))


# ---------------------------------------------------------------------------
# topology snapshot export (the printTree analog)
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def export_tree(st) -> Dict[int, Any]:
    """TreeState -> nested {peer: {child: {...}}} dict rooted at ``st.root``.

    Host-side, for debugging and golden-topology assertions; the recursive
    shape mirrors what ``printTree`` printed from private Go state.
    """
    parent = _host(st.parent)
    joined = _host(st.joined)
    root = int(st.root)
    kids: Dict[int, List[int]] = {}
    for p in range(parent.shape[0]):
        if joined[p] and parent[p] >= 0:
            kids.setdefault(int(parent[p]), []).append(p)

    # Iterative DFS: a width-1 chain is a legal topology, so depth can reach
    # N -- far past Python's recursion limit at sim scale.
    out: Dict[int, Any] = {root: {}}
    stack: List[tuple] = [(root, out[root])]
    visited = {root}
    while stack:
        node, slot = stack.pop()
        for c in kids.get(node, []):
            if c in visited:  # cycle -- never legal in a tree
                raise ValueError(f"cycle detected at peer {c}")
            visited.add(c)
            slot[c] = {}
            stack.append((c, slot[c]))
    return out


def tree_text(st) -> str:
    """Indented text rendering of ``export_tree`` (one peer per line)."""
    lines: List[str] = []
    stack: List[tuple] = [(node, 0, d) for node, d in
                          sorted(export_tree(st).items(), reverse=True)]
    while stack:
        node, depth, d = stack.pop()
        lines.append("  " * depth + str(node))
        stack.extend((c, depth + 1, d[c]) for c in sorted(d, reverse=True))
    return "\n".join(lines)


def export_mesh(st) -> Dict[int, List[int]]:
    """GossipState -> {peer: sorted mesh-neighbor ids} adjacency dict."""
    mesh = _host(st.mesh & st.nbr_valid)
    nbrs = _host(decode_index_plane(st.nbrs))
    alive = _host(st.alive)
    out: Dict[int, List[int]] = {}
    for p in range(mesh.shape[0]):
        if alive[p]:
            out[p] = sorted(int(nbrs[p, s]) for s in np.nonzero(mesh[p])[0])
    return out
