"""Chaos layer for the live plane: seeded, deterministic link faults.

The reference evaluates failure handling by literally killing hosts in
tests (``pubsub_test.go:178``) — there is no way to make a *link* lossy,
slow, or flaky while both endpoints stay up, which is exactly the regime
the resilience papers grade on (arXiv:2007.02754 §4 runs GossipSub attacks
over real degraded links).  The sim plane already models per-edge delay and
drop as tensors (``ops/tree.py`` link profiles); this module gives the
asyncio plane the same capability at the socket boundary.

Design:

- :class:`LinkPolicy` — one link's fault parameters: drop, fixed+jittered
  delay, duplication, reordering, bandwidth cap, mid-stream reset, dial
  blackhole.
- :class:`LinkPolicyTable` — (src, dst, proto) -> policy with ``"*"``
  wildcards (fnmatch patterns); most-specific match wins, later entries
  break ties.  Mutable at runtime: the scenario live-runner installs and
  removes window policies mid-campaign.
- :class:`ChaosTransport` — the injector.  Holds one ``random.Random`` per
  (src, dst, proto) link, seeded from ``(seed, src, dst, proto)`` via
  sha256, so the per-link fault decision stream is a pure function of the
  seed and the offered message sequence — independent of wall clock and of
  every other link.  Every non-trivial decision is appended to a per-link
  event trace, the surface the golden determinism test asserts on.
- :class:`ChaosStream` — wraps a :class:`.transport.Stream`; reads pass
  through (ingress faults are the peer's egress faults), writes consult
  the table.  Held-back messages drain through a single per-stream pump
  task ordered by (due-time, submit-seq), so FIFO is preserved unless a
  reorder fault explicitly holds a message back.

Fault *decisions* are drawn synchronously at submit time in message order;
only the *delivery* of delayed copies touches the event loop clock.  With
no policy installed for a link, writes take the inline fast path — zero
added awaits — which is what keeps the clean-path overhead unmeasurable
(PERF.md "Retry policy and chaos overhead").
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import random
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Callable, Dict, List, Optional, Tuple

from ..wire import Message, encode_message
from .transport import Stream, StreamClosed

Link = Tuple[str, str, str]  # (src, dst, proto)


def _check_prob(name: str, p: float) -> None:
    if not (0.0 <= p <= 1.0):
        raise ValueError(f"{name} must be in [0, 1], got {p}")


def _check_nonneg(name: str, v: float) -> None:
    if v < 0:
        raise ValueError(f"{name} must be >= 0, got {v}")


@dataclass(frozen=True)
class LinkPolicy:
    """Fault parameters for one directed link (egress side).

    - ``drop_prob``      — silent per-message loss (the sim fabric's
      per-copy drop; no error surfaces to the writer).
    - ``delay_s`` / ``jitter_s`` — fixed + uniform-jittered hold before the
      bytes leave.
    - ``duplicate_prob`` — the message is sent twice.
    - ``reorder_prob`` / ``reorder_extra_s`` — the message is held back an
      extra beat so a later submit can overtake it.
    - ``bandwidth_bytes_per_s`` — serialization cap (0 = uncapped): each
      message occupies the link for ``len/bw`` seconds and queues behind
      earlier ones.
    - ``reset_prob`` / ``reset_after_msgs`` — mid-stream RST: the write
      aborts the underlying connection instead of sending (``reset_after``
      fires once, on the Nth submitted message; 0 = never).
    - ``blackhole``      — dials on this link fail outright (checked in
      ``LiveHost.new_stream`` before connecting).
    """

    drop_prob: float = 0.0
    delay_s: float = 0.0
    jitter_s: float = 0.0
    duplicate_prob: float = 0.0
    reorder_prob: float = 0.0
    reorder_extra_s: float = 0.002
    bandwidth_bytes_per_s: float = 0.0
    reset_prob: float = 0.0
    reset_after_msgs: int = 0
    blackhole: bool = False

    def __post_init__(self) -> None:
        for n in ("drop_prob", "duplicate_prob", "reorder_prob", "reset_prob"):
            _check_prob(n, getattr(self, n))
        for n in ("delay_s", "jitter_s", "reorder_extra_s",
                  "bandwidth_bytes_per_s"):
            _check_nonneg(n, getattr(self, n))
        if self.reset_after_msgs < 0:
            raise ValueError("reset_after_msgs must be >= 0")

    def is_noop(self) -> bool:
        return not (
            self.drop_prob or self.delay_s or self.jitter_s
            or self.duplicate_prob or self.reorder_prob
            or self.bandwidth_bytes_per_s or self.reset_prob
            or self.reset_after_msgs or self.blackhole
        )


class LinkPolicyTable:
    """(src, dst, proto) -> :class:`LinkPolicy`, with ``"*"`` wildcards.

    Patterns are ``fnmatch`` globs per field.  Resolution picks the rule
    with the most non-``"*"`` fields (specificity); among equals the most
    recently added wins, so a scenario can shadow a broad baseline with a
    targeted override and restore it by removing the override.
    """

    def __init__(self) -> None:
        self._rules: List[Tuple[str, str, str, LinkPolicy]] = []

    def set(self, policy: LinkPolicy, src: str = "*", dst: str = "*",
            proto: str = "*") -> None:
        # Copy-on-write so the event-loop thread can resolve concurrently
        # with a scenario thread editing windows.
        self._rules = self._rules + [(src, dst, proto, policy)]

    def remove(self, src: str = "*", dst: str = "*", proto: str = "*") -> int:
        """Remove rules registered with exactly this pattern triple; returns
        how many were removed."""
        keep = [r for r in self._rules if r[:3] != (src, dst, proto)]
        n = len(self._rules) - len(keep)
        self._rules = keep
        return n

    def clear(self) -> None:
        self._rules = []

    def policy_for(self, src: str, dst: str, proto: str) -> Optional[LinkPolicy]:
        best: Optional[LinkPolicy] = None
        best_spec = -1
        for rs, rd, rp, pol in self._rules:
            if (fnmatchcase(src, rs) and fnmatchcase(dst, rd)
                    and fnmatchcase(proto, rp)):
                spec = sum(f != "*" for f in (rs, rd, rp))
                if spec >= best_spec:  # later entries break ties
                    best, best_spec = pol, spec
        return best


@dataclass(frozen=True)
class ChaosDecision:
    """The per-message fault outcome ``ChaosTransport.decide`` draws."""

    drop: bool = False
    copies: int = 1
    hold_s: float = 0.0     # delay + jitter + reorder hold
    ser_s: float = 0.0      # bandwidth-cap serialization time
    reset: bool = False


class ChaosTransport:
    """Deterministic per-link fault injector.

    One instance per :class:`..live.LiveNetwork` (shared by every host, so
    a link's identity is global).  All decision draws happen in message-
    submit order from a per-link PRNG seeded by ``(seed, src, dst, proto)``
    — same seed, same offered sequence => same event trace, asserted by the
    golden test in ``tests/test_chaos.py``.
    """

    def __init__(self, seed: int = 0, table: Optional[LinkPolicyTable] = None):
        self.seed = int(seed)
        self.table = table if table is not None else LinkPolicyTable()
        self._rngs: Dict[Link, random.Random] = {}
        self._counts: Dict[Link, int] = {}
        self._traces: Dict[Link, List[tuple]] = {}

    # -- determinism core ----------------------------------------------------

    def _rng(self, link: Link) -> random.Random:
        rng = self._rngs.get(link)
        if rng is None:
            h = hashlib.sha256(
                f"{self.seed}|{link[0]}|{link[1]}|{link[2]}".encode()
            ).digest()
            rng = random.Random(int.from_bytes(h[:8], "big"))
            self._rngs[link] = rng
        return rng

    def _record(self, link: Link, event: tuple) -> None:
        self._traces.setdefault(link, []).append(event)

    def trace(self, link: Optional[Link] = None):
        """The recorded event trace — one link's list, or the whole dict."""
        if link is not None:
            return list(self._traces.get(link, []))
        return {k: list(v) for k, v in self._traces.items()}

    def reset_trace(self) -> None:
        self._traces.clear()

    def policy_for(self, src: str, dst: str, proto: str) -> Optional[LinkPolicy]:
        return self.table.policy_for(src, dst, proto)

    def allow_dial(self, src: str, dst: str, proto: str) -> bool:
        """Dial-time blackhole check (no RNG draw: blackholes are windows,
        not probabilities)."""
        pol = self.table.policy_for(src, dst, proto)
        if pol is not None and pol.blackhole:
            self._record((src, dst, proto), ("blackhole_dial",))
            return False
        return True

    def decide(self, link: Link, policy: LinkPolicy, nbytes: int) -> ChaosDecision:
        """Draw one message's fault outcome (submit order == draw order).

        Draw sequence is fixed — drop, duplicate, reorder, jitter, reset —
        and each draw happens only when its parameter is enabled, so a
        policy's trace is stable under edits to unrelated fields.
        """
        rng = self._rng(link)
        idx = self._counts.get(link, 0)
        self._counts[link] = idx + 1

        if policy.drop_prob and rng.random() < policy.drop_prob:
            self._record(link, ("drop", idx))
            return ChaosDecision(drop=True)
        copies = 1
        if policy.duplicate_prob and rng.random() < policy.duplicate_prob:
            copies = 2
            self._record(link, ("dup", idx))
        hold = policy.delay_s
        if policy.reorder_prob and rng.random() < policy.reorder_prob:
            hold += policy.reorder_extra_s
            self._record(link, ("reorder", idx))
        if policy.jitter_s:
            hold += rng.uniform(0.0, policy.jitter_s)
        if hold > 0:
            self._record(link, ("delay", idx, int(round(hold * 1e6))))
        reset = bool(policy.reset_prob and rng.random() < policy.reset_prob)
        if policy.reset_after_msgs and idx + 1 == policy.reset_after_msgs:
            reset = True
        if reset:
            self._record(link, ("reset", idx))
        ser = (
            nbytes / policy.bandwidth_bytes_per_s
            if policy.bandwidth_bytes_per_s else 0.0
        )
        return ChaosDecision(copies=copies, hold_s=hold, ser_s=ser, reset=reset)

    # -- stream wrapping -----------------------------------------------------

    def wrap(self, stream: Stream, local_id: str,
             spawn: Callable[..., "asyncio.Task"]) -> "ChaosStream":
        """Wrap an egress/ingress stream for ``local_id``'s side of the
        connection.  ``spawn`` must be the owning host's task tracker so the
        pump dies with the host."""
        return ChaosStream(stream, self, local_id, spawn)


class ChaosStream:
    """A :class:`.transport.Stream` with chaos applied to writes.

    Duck-types the Stream surface ``live.py`` uses (``write_message`` /
    ``read_message`` / ``close`` / ``abort`` / ``closed`` /
    ``remote_peer`` / ``protoid``).  Reads delegate untouched — ingress
    faults belong to the remote side's wrapper.
    """

    def __init__(self, inner: Stream, chaos: ChaosTransport, local_id: str,
                 spawn: Callable[..., "asyncio.Task"]):
        self._inner = inner
        self._chaos = chaos
        self._local = local_id
        self._spawn = spawn
        self._link: Link = (local_id, inner.remote_peer, inner.protoid)
        self._heap: List[Tuple[float, int, Message]] = []
        self._seq = 0
        self._wake: Optional[asyncio.Event] = None
        self._pump: Optional[asyncio.Task] = None
        self._link_free = 0.0
        self._failed: Optional[str] = None

    # -- Stream surface ------------------------------------------------------

    @property
    def remote_peer(self) -> str:
        return self._inner.remote_peer

    @property
    def protoid(self) -> str:
        return self._inner.protoid

    @property
    def closed(self) -> bool:
        return self._inner.closed

    async def read_message(self) -> Message:
        return await self._inner.read_message()

    def close(self) -> None:
        self._cancel_pump()
        self._inner.close()

    def abort(self) -> None:
        self._cancel_pump()
        self._inner.abort()

    # -- chaos write path ----------------------------------------------------

    async def write_message(self, m: Message) -> None:
        if self._failed is not None:
            raise StreamClosed(self._failed)
        pol = self._chaos.policy_for(self._local, self._inner.remote_peer,
                                     self._inner.protoid)
        if (pol is None or pol.is_noop()) and not self._heap:
            await self._inner.write_message(m)
            return
        if pol is None or pol.is_noop():
            # A window just closed but held messages are still queued: keep
            # FIFO by routing through the pump at zero hold.
            d = ChaosDecision()
        else:
            d = self._chaos.decide(self._link, pol, len(encode_message(m)))
        if d.reset:
            self._inner.abort()
            raise StreamClosed("stream reset (chaos)")
        if d.drop:
            return
        loop = asyncio.get_event_loop()
        due = loop.time() + d.hold_s
        if d.ser_s:
            due = max(due, self._link_free)
            self._link_free = due + d.ser_s
        for _ in range(d.copies):
            heapq.heappush(self._heap, (due, self._seq, m))
            self._seq += 1
        if self._wake is None:
            self._wake = asyncio.Event()
        self._wake.set()
        if self._pump is None or self._pump.done():
            self._pump = self._spawn(self._pump_loop())

    async def _pump_loop(self) -> None:
        loop = asyncio.get_event_loop()
        try:
            while self._heap:
                due, _, m = self._heap[0]
                now = loop.time()
                if due > now:
                    # Sleep until the head is due, but wake early if an
                    # earlier-due entry arrives.
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               timeout=due - now)
                    except asyncio.TimeoutError:
                        pass
                    continue  # re-read the (possibly new) head
                heapq.heappop(self._heap)
                await self._inner.write_message(m)
        except StreamClosed as e:
            # Asynchronous write failure: surface on the next submit (the
            # live plane's forward path marks the child dead there).
            self._failed = str(e)
            self._heap.clear()

    def _cancel_pump(self) -> None:
        if self._pump is not None and not self._pump.done():
            self._pump.cancel()
        self._heap.clear()


# ---------------------------------------------------------------------------
# partition helpers (scenario.live_runner's blackhole windows)
# ---------------------------------------------------------------------------

# A network partition must be *detectable*, not just silent: ``blackhole``
# only refuses NEW dials, and a pure ``drop_prob=1.0`` link lets writes
# "succeed" into the void, so neither side would ever notice the cut.
# ``reset_prob=1.0`` makes the first write on an existing cross-partition
# stream abort the connection — both sides see StreamClosed and run their
# repair/failover machinery, which is the behavior a real L3 partition
# (RST or timeout) produces.
PARTITION_POLICY = LinkPolicy(blackhole=True, reset_prob=1.0)


def install_partition(table: LinkPolicyTable, side_a, side_b,
                      policy: LinkPolicy = PARTITION_POLICY) -> int:
    """Cut every directed link between two host-id cohorts; returns the
    number of rules installed (for symmetry with :func:`remove_partition`)."""
    n = 0
    for a in side_a:
        for b in side_b:
            table.set(policy, src=a, dst=b)
            table.set(policy, src=b, dst=a)
            n += 2
    return n


def remove_partition(table: LinkPolicyTable, side_a, side_b) -> int:
    """Lift a partition installed by :func:`install_partition`; returns the
    number of rules removed."""
    n = 0
    for a in side_a:
        for b in side_b:
            n += table.remove(src=a, dst=b)
            n += table.remove(src=b, dst=a)
    return n
