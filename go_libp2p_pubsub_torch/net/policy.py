"""Retry/backoff policy for the live plane's control paths.

The reference's failure story is one blanket repair timeout and a rejoin
that originally ``panic``ed (``client.go:14``, ``client.go:96-98``); every
dial is a single attempt.  Under the chaos layer (``net/chaos.py``) that
thinness becomes measurable: one blackholed dial strands a subtree for a
full repair timeout.  This module is the hardening: every dial-shaped
operation in ``live.py`` runs under a :class:`RetryPolicy` —

- bounded attempts with **decorrelated-jitter exponential backoff**
  (``sleep = min(cap, U(base, prev * 3))``, the AWS-architecture variant
  that avoids synchronized retry storms),
- an overall **deadline** so retries never outlive the protocol window
  they serve (e.g. rejoin retries are capped by the repair timeout),
- a per-class **circuit breaker** (closed -> open after N consecutive
  failures -> half-open probe after a cooldown) so a dead destination
  class fails fast instead of serially burning backoff budget,
- and a counter in the shared :class:`~..utils.metrics.MetricsRegistry`
  for **every** transition: ``live.retry.<cls>.{attempt,retry,success,
  exhausted,timeout}`` and ``live.breaker.<cls>.{opened,half_open,closed,
  fastfail}``.

Also home of :class:`LiveCallTimeout`, the typed error
``LiveNetwork.call`` raises instead of a bare
``concurrent.futures.TimeoutError`` so a stuck coroutine is named in the
failure, not guessed from a stack.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Awaitable, Callable, Dict, Optional, Tuple

from ..config import RetryOpts
from ..utils.metrics import MetricsRegistry
from .transport import StreamClosed

# Exceptions a retried operation may recover from: transport failures,
# unknown-peer lookups (the peer may register between attempts), and
# timeouts.  Anything else is a bug and propagates immediately.
RETRYABLE = (StreamClosed, KeyError, OSError, ConnectionError,
             asyncio.TimeoutError)


class LiveCallTimeout(TimeoutError):
    """A ``LiveNetwork.call`` that outlived its deadline, carrying the name
    of the coroutine that was in flight."""

    def __init__(self, coro_name: str, timeout_s: float):
        super().__init__(
            f"live call {coro_name!r} timed out after {timeout_s:g}s"
        )
        self.coro_name = coro_name
        self.timeout_s = timeout_s


class CircuitOpen(StreamClosed):
    """Fast-fail raised while a class's breaker is open.  Subclasses
    :class:`StreamClosed` so every existing ``except StreamClosed`` site
    degrades exactly as a failed dial would — the breaker changes *when*
    the failure surfaces, never *what* callers must handle."""

    def __init__(self, cls: str):
        super().__init__(f"circuit breaker open for class {cls!r}")
        self.cls = cls


class CircuitBreaker:
    """Per-class breaker: closed -> open after ``failures_to_open``
    consecutive failures -> half-open single probe after ``reset_s``."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        cls: str,
        failures_to_open: int,
        reset_s: float,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cls = cls
        self.failures_to_open = failures_to_open
        self.reset_s = reset_s
        self.registry = registry
        self.clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0

    def _inc(self, event: str) -> None:
        if self.registry is not None:
            self.registry.inc(f"live.breaker.{self.cls}.{event}")

    def allow(self) -> bool:
        """May an attempt proceed right now?  Transitions open -> half-open
        when the cooldown has elapsed (the single probe)."""
        if self.state == self.OPEN:
            if self.clock() - self._opened_at >= self.reset_s:
                self.state = self.HALF_OPEN
                self._inc("half_open")
                return True
            self._inc("fastfail")
            return False
        return True

    def record_success(self) -> None:
        if self.state != self.CLOSED:
            self._inc("closed")
        self.state = self.CLOSED
        self.consecutive_failures = 0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or (
            self.state == self.CLOSED
            and self.consecutive_failures >= self.failures_to_open
        ):
            if self.state != self.OPEN:
                self._inc("opened")
            self.state = self.OPEN
            self._opened_at = self.clock()


class RetryPolicy:
    """Deadline + decorrelated-jitter backoff + attempt budget + breakers.

    One instance is shared per :class:`~.live.LiveTopicManager` (one per
    host), so breaker state reflects that host's view of each operation
    class.  ``rng``/``clock``/``sleep`` are injectable for deterministic
    tests.
    """

    def __init__(
        self,
        opts: Optional[RetryOpts] = None,
        registry: Optional[MetricsRegistry] = None,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Optional[Callable[[float], Awaitable[None]]] = None,
    ):
        self.opts = opts or RetryOpts()
        self.registry = registry
        self.rng = rng or random.Random()
        self.clock = clock
        self.sleep = sleep or asyncio.sleep
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _inc(self, name: str) -> None:
        if self.registry is not None:
            self.registry.inc(name)

    def breaker(self, cls: str) -> CircuitBreaker:
        br = self._breakers.get(cls)
        if br is None:
            br = CircuitBreaker(
                cls,
                failures_to_open=self.opts.breaker_failures,
                reset_s=self.opts.breaker_reset_s,
                registry=self.registry,
                clock=self.clock,
            )
            self._breakers[cls] = br
        return br

    def backoff_delays(self):
        """The decorrelated-jitter delay sequence (pure, for tests): yields
        the sleep before attempt 2, 3, ... up to ``max_attempts``."""
        o = self.opts
        prev = o.base_delay_s
        for _ in range(o.max_attempts - 1):
            prev = min(o.max_delay_s, self.rng.uniform(o.base_delay_s, prev * 3))
            yield prev

    async def run(
        self,
        cls: str,
        fn: Callable[[], Awaitable],
        retry_on: Tuple[type, ...] = RETRYABLE,
        max_attempts: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ):
        """Run ``await fn()`` under the policy; returns its result or
        raises the last failure (or :class:`CircuitOpen` when fast-failed).
        """
        o = self.opts
        attempts = max_attempts if max_attempts is not None else o.max_attempts
        deadline = self.clock() + (
            deadline_s if deadline_s is not None else o.deadline_s
        )
        br = self.breaker(cls)
        if not br.allow():
            raise CircuitOpen(cls)
        prev = o.base_delay_s
        last: Optional[BaseException] = None
        for attempt in range(1, attempts + 1):
            self._inc(f"live.retry.{cls}.attempt")
            try:
                result = await fn()
            except retry_on as e:
                if isinstance(e, CircuitOpen):
                    # A nested fast-fail: retrying here would just spin on
                    # the same open breaker.
                    raise
                br.record_failure()
                last = e
                if attempt >= attempts or not br.allow():
                    break
                prev = min(o.max_delay_s,
                           self.rng.uniform(o.base_delay_s, prev * 3))
                delay = min(prev, deadline - self.clock())
                if delay < 0:
                    break
                self._inc(f"live.retry.{cls}.retry")
                await self.sleep(delay)
                if self.clock() >= deadline:
                    break
            else:
                br.record_success()
                self._inc(f"live.retry.{cls}.success")
                return result
        self._inc(f"live.retry.{cls}.exhausted")
        assert last is not None
        raise last

    async def probe(
        self,
        fn: Callable[[], Awaitable],
        timeout_s: float = 0.25,
        cls: str = "probe",
    ):
        """Single-attempt, short-deadline liveness probe: no retries, no
        backoff, no breaker involvement.  A quorum check (live.py failover)
        must measure reachability *now* — burning decorrelated-jitter budget
        on each roster member would stretch time-to-heal by the whole
        electorate.  Returns ``fn()``'s result, or ``None`` on any retryable
        failure/timeout (accounted as ``live.retry.<cls>.{attempt,success,
        exhausted}``)."""
        self._inc(f"live.retry.{cls}.attempt")
        try:
            result = await asyncio.wait_for(fn(), timeout=timeout_s)
        except RETRYABLE:
            self._inc(f"live.retry.{cls}.exhausted")
            return None
        self._inc(f"live.retry.{cls}.success")
        return result

    async def wait_for(self, aw: Awaitable, timeout_s: float, cls: str):
        """``asyncio.wait_for`` with the timeout accounted to ``cls`` in
        the registry — the typed replacement for the live plane's bare
        waits."""
        try:
            return await asyncio.wait_for(aw, timeout=timeout_s)
        except asyncio.TimeoutError:
            self._inc(f"live.retry.{cls}.timeout")
            raise
