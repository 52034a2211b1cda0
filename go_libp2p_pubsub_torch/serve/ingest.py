"""Host ingest ring: batch an unbounded publish stream into device chunks.

Producers (socket handlers, the bench's load generators, the scenario
streaming runner) ``push`` (topic, payload, publisher) tuples; the
:class:`~.engine.StreamingEngine` ``pop_batch``-es them into the fixed-shape
publish slots of its next rollout chunk.  The ring is a preallocated
circular buffer under one lock — "lock-free-ish" in the honest sense that
the hot path is a couple of index updates inside an uncontended mutex, not
a CAS loop; the contention profile that matters here is one producer-side
caller vs one consumer-side engine thread.

Backpressure is an explicit, named policy — never an implicit drop:

- ``block``       — ``push`` waits (bounded by ``timeout``) for space; a
                    timed-out push returns ``False`` to ITS caller, so no
                    message ever vanishes unacknowledged;
- ``drop_oldest`` — the ring evicts its head to admit the newcomer
                    (freshest-wins streams), counting every eviction;
- ``reject``      — a full ring refuses the newcomer (caller retries).

On top of the policy, the watchdog's first degradation tier can install a
*shed set* (``set_shed_topics``): pushes for shed topics are refused at the
door and counted under ``shed_priority`` — like ``reject``, the caller
still owns the message, so the shed never enters the conservation formula
as anything but an attributed refusal.

``snapshot()`` / ``restore_snapshot()`` round-trip the buffer contents AND
the full counter set so a restored ring resumes the same conservation
ledger.  Restore reinstates counters verbatim — replayed items must NOT
re-increment ``accepted`` (they were counted at their original admission;
re-pushing them would double-count and break ``silent_drops == 0``).

``accounting()`` exposes the conservation check the streaming SLO grades:
every accepted message is either still queued, handed to the device, or
attributed to a named policy counter — ``silent_drops`` is the residual and
must be zero under every policy.

Queue-depth and policy counters land on an (optional) existing
:class:`~..utils.metrics.MetricsRegistry` under ``serve.ingest.*``.
"""

from __future__ import annotations

import base64
import threading
import time
from dataclasses import dataclass
from typing import FrozenSet, Iterable, List, Optional

from ..obs.spans import content_hash

BACKPRESSURE_POLICIES = ("block", "drop_oldest", "reject")


@dataclass(frozen=True)
class IngestItem:
    """One queued publish: identity, payload, and its ingest timestamp
    (host clock at ``push`` — the start of the ingest→delivery latency the
    engine measures exactly)."""

    seq: int            # ring-assigned, monotonically increasing
    topic: int
    publisher: int
    payload: bytes
    valid: bool         # upstream validation verdict (gates relay on device)
    t_ingest: float     # host clock at push


class IngestRing:
    """Bounded FIFO ring of :class:`IngestItem` with explicit backpressure.

    Thread-safe; ``push`` and ``pop_batch`` may run from different threads.
    Zero-length payloads are legal (a bare topic beacon is a real pubsub
    message shape).
    """

    def __init__(
        self,
        capacity: int,
        policy: str = "block",
        metrics=None,
        clock=time.monotonic,
        tracer=None,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if policy not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {policy!r}; "
                f"have: {', '.join(BACKPRESSURE_POLICIES)}"
            )
        self.capacity = capacity
        self.policy = policy
        self.metrics = metrics
        self.tracer = tracer   # optional obs.SpanLedger (ring_accept stamps)
        self._clock = clock
        self._buf: List[Optional[IngestItem]] = [None] * capacity
        self._head = 0          # index of the oldest item
        self._size = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self.max_depth = 0
        self._accepted = 0
        self._popped = 0
        self._dropped_oldest = 0
        self._dropped_oldest_valid = 0
        self._rejected = 0
        self._block_waits = 0
        self._shed_topics: FrozenSet[int] = frozenset()
        self._shed_priority = 0
        # The active policy is a gauge from birth (r20): its index in
        # BACKPRESSURE_POLICIES, so /metrics shows which backpressure mode
        # is live without scraping tier logs.
        self._metric_gauge(
            "serve.ingest.policy", BACKPRESSURE_POLICIES.index(policy)
        )

    # -- producer side ------------------------------------------------------

    def push(
        self,
        topic: int,
        payload: bytes,
        publisher: int,
        valid: bool = True,
        timeout: Optional[float] = None,
    ) -> bool:
        """Enqueue one publish; returns True iff it was admitted.

        ``timeout`` only applies under the ``block`` policy (None = wait
        forever).  A False return means the CALLER still owns the message —
        the ring never took it, so nothing was dropped silently.
        """
        with self._lock:
            if int(topic) in self._shed_topics:
                self._shed_priority += 1
                self._metric_inc("serve.ingest.shed_priority")
                return False
            if self._size >= self.capacity:
                if self.policy == "reject":
                    self._rejected += 1
                    self._metric_inc("serve.ingest.rejected")
                    return False
                if self.policy == "drop_oldest":
                    self._evict_oldest_locked()
                else:  # block
                    self._block_waits += 1
                    self._metric_inc("serve.ingest.block_waits")
                    if not self._not_full.wait_for(
                        lambda: self._size < self.capacity, timeout=timeout
                    ):
                        self._rejected += 1
                        self._metric_inc("serve.ingest.rejected")
                        return False
            item = IngestItem(
                seq=self._seq,
                topic=int(topic),
                publisher=int(publisher),
                payload=bytes(payload),
                valid=bool(valid),
                t_ingest=self._clock(),
            )
            self._seq += 1
            self._buf[(self._head + self._size) % self.capacity] = item
            self._size += 1
            self._accepted += 1
            self.max_depth = max(self.max_depth, self._size)
            self._metric_inc("serve.ingest.accepted")
            self._metric_depth()
            if self.tracer is not None and item.valid:
                self.tracer.stamp(
                    content_hash(item.topic, item.publisher, item.payload),
                    "ring_accept", t=item.t_ingest,
                    seq=item.seq, topic=item.topic,
                )
            return True

    # -- consumer side ------------------------------------------------------

    def pop_batch(self, max_n: int) -> List[IngestItem]:
        """Dequeue up to ``max_n`` items in FIFO order (may be empty)."""
        out: List[IngestItem] = []
        with self._lock:
            take = min(max_n, self._size)
            for _ in range(take):
                item = self._buf[self._head]
                assert item is not None
                self._buf[self._head] = None
                self._head = (self._head + 1) % self.capacity
                self._size -= 1
                out.append(item)
            self._popped += len(out)
            if out:
                self._not_full.notify_all()
                self._metric_depth()
        return out

    # -- degradation controls (driven by the serve watchdog) ----------------

    def set_shed_topics(self, topics: Iterable[int]) -> None:
        """Install the shed set: pushes for these topics are refused at the
        door and counted under ``shed_priority``.  Pass an empty iterable to
        clear.  The refusal is loud (counter + metric) and caller-owned —
        it never appears in the silent-drop residual."""
        with self._lock:
            self._shed_topics = frozenset(int(t) for t in topics)
            self._metric_gauge(
                "serve.ingest.shed_topics", len(self._shed_topics)
            )

    def set_policy(self, policy: str) -> None:
        """Swap the backpressure policy at runtime (watchdog tier 2 moves
        block→drop_oldest under sustained overload, and back)."""
        if policy not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {policy!r}; "
                f"have: {', '.join(BACKPRESSURE_POLICIES)}"
            )
        with self._lock:
            self.policy = policy
            self._metric_gauge(
                "serve.ingest.policy", BACKPRESSURE_POLICIES.index(policy)
            )
            # Leaving `block` must release anyone parked on the condition so
            # they re-evaluate under the new policy.
            self._not_full.notify_all()

    # -- checkpoint ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe snapshot of buffer contents + the full ledger, taken
        under the lock (payloads base64-encoded)."""
        with self._lock:
            items = []
            for i in range(self._size):
                item = self._buf[(self._head + i) % self.capacity]
                assert item is not None
                items.append({
                    "seq": item.seq,
                    "topic": item.topic,
                    "publisher": item.publisher,
                    "payload": base64.b64encode(item.payload).decode("ascii"),
                    "valid": item.valid,
                    "t_ingest": item.t_ingest,
                })
            return {
                "capacity": self.capacity,
                "policy": self.policy,
                "items": items,
                "counters": {
                    "seq": self._seq,
                    "accepted": self._accepted,
                    "popped": self._popped,
                    "dropped_oldest": self._dropped_oldest,
                    "dropped_oldest_valid": self._dropped_oldest_valid,
                    "rejected": self._rejected,
                    "block_waits": self._block_waits,
                    "shed_priority": self._shed_priority,
                    "max_depth": self.max_depth,
                },
            }

    def restore_snapshot(self, snap: dict) -> int:
        """Reinstate buffer contents and counters from :meth:`snapshot`.

        Counters are restored VERBATIM — replayed items were already counted
        as accepted at their original admission, so restoring must not go
        through ``push`` (that would double-count ``accepted`` and turn the
        conservation residual negative).  Returns the number of queued
        items reinstated for replay."""
        items = snap["items"]
        if len(items) > self.capacity:
            raise ValueError(
                f"snapshot holds {len(items)} items but ring capacity is "
                f"{self.capacity}"
            )
        counters = snap["counters"]
        with self._lock:
            self._buf = [None] * self.capacity
            for i, d in enumerate(items):
                self._buf[i] = IngestItem(
                    seq=int(d["seq"]),
                    topic=int(d["topic"]),
                    publisher=int(d["publisher"]),
                    payload=base64.b64decode(d["payload"]),
                    valid=bool(d["valid"]),
                    t_ingest=float(d["t_ingest"]),
                )
            self._head = 0
            self._size = len(items)
            self._seq = int(counters["seq"])
            self._accepted = int(counters["accepted"])
            self._popped = int(counters["popped"])
            self._dropped_oldest = int(counters["dropped_oldest"])
            self._dropped_oldest_valid = int(
                counters.get("dropped_oldest_valid", 0)
            )
            self._rejected = int(counters["rejected"])
            self._block_waits = int(counters["block_waits"])
            self._shed_priority = int(counters.get("shed_priority", 0))
            self.max_depth = int(counters["max_depth"])
            self._not_full.notify_all()
            self._metric_depth()
            return self._size

    # -- introspection ------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return self._size

    def accounting(self) -> dict:
        """Conservation ledger.  ``silent_drops`` is the residual between
        what was accepted and what is accounted for — the streaming SLO's
        zero-silent-drops channel reads it directly."""
        with self._lock:
            silent = (
                self._accepted - self._popped - self._dropped_oldest
                - self._size
            )
            valid_in_queue = sum(
                1 for i in range(self._size)
                if self._buf[(self._head + i) % self.capacity].valid
            )
            return {
                "accepted": self._accepted,
                "popped": self._popped,
                "in_queue": self._size,
                "valid_in_queue": valid_in_queue,
                "dropped_oldest": self._dropped_oldest,
                "dropped_oldest_valid": self._dropped_oldest_valid,
                "rejected": self._rejected,
                "block_waits": self._block_waits,
                "shed_priority": self._shed_priority,
                "max_depth": self.max_depth,
                "silent_drops": silent,
            }

    # -- internals ----------------------------------------------------------

    def _evict_oldest_locked(self) -> None:
        victim = self._buf[self._head]
        self._buf[self._head] = None
        self._head = (self._head + 1) % self.capacity
        self._size -= 1
        self._dropped_oldest += 1
        if victim is not None and victim.valid:
            self._dropped_oldest_valid += 1
        self._metric_inc("serve.ingest.dropped_oldest")

    def _metric_inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def _metric_gauge(self, name: str, value) -> None:
        if self.metrics is not None:
            self.metrics.gauge(name, value)

    def _metric_depth(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("serve.ingest.depth", self._size)
