"""Serving-plane supervisor: stall detection, checkpoint restarts, and
explicit degradation tiers.

Same design rules as the live plane's dial-path breakers
(``net/policy.py``): no threads, no wall-clock reads outside the injected
``clock``, every transition counted — so every behavior is testable with a
fake clock, deterministically.

The watchdog is *polled* by whoever owns the serving loop (the bench
child, the streaming scenario runner, a socket frontend).  Liveness is
tracked through two heartbeat stamps the loop refreshes: ``note_chunk()``
after every engine chunk and ``note_verifier()`` after every verification
flush.  ``poll()`` then:

1. restarts the engine from its last durable snapshot when no chunk has
   completed within ``chunk_stall_s`` (the engine is wedged or its process
   was replaced — the restart path is ``StreamingEngine.restore()``, which
   reuses the shared compiled rollout, so recovery never recompiles);
2. reports a dead verifier pool when no flush landed within
   ``verifier_stall_s`` and invokes the ``on_verifier_restart`` callback
   (the owner rebuilds its :class:`~..crypto.pipeline.ValidationPipeline`
   and resubmits its retry window);
3. walks the overload ladder on ring depth with watermark hysteresis:

   ``normal`` → ``shed_priority`` → ``drop_oldest``

   Tier 1 installs the ring's shed set (topics below the top priority are
   refused at the door, each refusal counted under ``shed_priority`` in the
   conservation ledger).  Tier 2 additionally swaps the backpressure policy
   to ``drop_oldest`` (freshest-wins), restoring the *currently desired*
   policy on the way back down: with a :mod:`.controller` attached, that is
   the controller's ``KnobState.backpressure_policy`` — the single source
   of truth — so a controller retune that happened mid-escalation is never
   reverted to a stale construction-time policy.  Every shed is loudly
   attributed — the ledger's ``silent_drops`` stays zero through every
   tier.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

TIER_NAMES = ("normal", "shed_priority", "drop_oldest")


class Watchdog:
    """Poll-driven supervisor over one engine + ring pair.

    ``topic_priority[t]`` ranks topic ``t`` (higher = more important);
    tier 1 sheds every topic whose priority is below the maximum.  With a
    uniform priority vector there is nothing to shed and tier 1 is an
    (attributed) no-op on the way to tier 2.
    """

    def __init__(
        self,
        engine,
        ring,
        checkpoint_path: Optional[str] = None,
        chunk_stall_s: float = 30.0,
        verifier_stall_s: Optional[float] = None,
        high_watermark: Optional[int] = None,
        low_watermark: Optional[int] = None,
        topic_priority: Optional[Sequence[int]] = None,
        on_engine_restart: Optional[Callable[[dict], None]] = None,
        on_verifier_restart: Optional[Callable[[], None]] = None,
        metrics=None,
        clock=time.monotonic,
        blackbox=None,
        postmortem_path: Optional[str] = None,
    ) -> None:
        if chunk_stall_s <= 0:
            raise ValueError("chunk_stall_s must be > 0")
        self.engine = engine
        self.ring = ring
        self.checkpoint_path = checkpoint_path
        self.chunk_stall_s = chunk_stall_s
        self.verifier_stall_s = verifier_stall_s
        self.high_watermark = (
            int(high_watermark) if high_watermark is not None
            else ring.capacity
        )
        self.low_watermark = (
            int(low_watermark) if low_watermark is not None
            else max(0, ring.capacity // 2)
        )
        if not (0 <= self.low_watermark < self.high_watermark):
            raise ValueError(
                "need 0 <= low_watermark < high_watermark "
                f"(got {self.low_watermark} / {self.high_watermark})"
            )
        n_topics = engine.model.t
        if topic_priority is None:
            topic_priority = [0] * n_topics
        if len(topic_priority) != n_topics:
            raise ValueError(
                f"topic_priority has {len(topic_priority)} entries for "
                f"{n_topics} topics"
            )
        self.topic_priority = [int(p) for p in topic_priority]
        top = max(self.topic_priority)
        self._shed_set = [
            t for t, p in enumerate(self.topic_priority) if p < top
        ]
        self.on_engine_restart = on_engine_restart
        self.on_verifier_restart = on_verifier_restart
        self.metrics = metrics
        self.clock = clock
        # r18 black box: when wired, restart_engine dumps the last-K chunk
        # frames to ``postmortem_path`` — the forensic record of the run-up
        # to the death, not just the final counters.
        self.blackbox = blackbox
        self.postmortem_path = postmortem_path
        self.tier = 0
        self._orig_policy = ring.policy
        # Attached by serve.controller.Controller: when present, the
        # controller's KnobState is the single source of truth for the
        # desired backpressure policy (see _desired_policy).
        self.controller = None
        self._last_chunk: Optional[float] = None
        self._last_verifier: Optional[float] = None
        self.engine_restarts = 0
        self.verifier_restarts = 0
        self.tier_log: List[Tuple[float, str, str]] = []  # (t, tier, reason)
        if self.metrics is not None:
            # The tier is a gauge from birth (r20): /metrics shows
            # "normal" as an explicit 0, not an absent family.
            self.metrics.gauge("serve.watchdog.tier", self.tier)

    # -- liveness stamps (called by the serving loop) -----------------------

    def note_chunk(self) -> None:
        self._last_chunk = self.clock()

    def note_verifier(self) -> None:
        self._last_verifier = self.clock()

    # -- supervision ---------------------------------------------------------

    def poll(self) -> List[str]:
        """One supervision pass; returns the (possibly empty) list of
        actions taken: "engine_restart", "verifier_restart", "tier_up",
        "tier_down"."""
        now = self.clock()
        actions: List[str] = []
        if (
            self._last_chunk is not None
            and now - self._last_chunk >= self.chunk_stall_s
        ):
            self.restart_engine(
                f"no chunk for {now - self._last_chunk:.1f}s "
                f"(stall threshold {self.chunk_stall_s:.1f}s)"
            )
            actions.append("engine_restart")
        if (
            self.verifier_stall_s is not None
            and self._last_verifier is not None
            and now - self._last_verifier >= self.verifier_stall_s
        ):
            self.verifier_restarts += 1
            self._inc("serve.watchdog.verifier_restarts")
            self._last_verifier = self.clock()
            if self.on_verifier_restart is not None:
                self.on_verifier_restart()
            actions.append("verifier_restart")
        depth = self.ring.depth
        if depth >= self.high_watermark and self.tier < 2:
            self._set_tier(self.tier + 1, f"depth {depth} >= high "
                           f"{self.high_watermark}")
            actions.append("tier_up")
        elif depth <= self.low_watermark and self.tier > 0:
            self._set_tier(self.tier - 1, f"depth {depth} <= low "
                           f"{self.low_watermark}")
            actions.append("tier_down")
        return actions

    def restart_engine(self, reason: str) -> dict:
        """Restore the engine from its last durable snapshot and reset the
        chunk stamp.  Public so an owner that *knows* its engine died (the
        chaos runner, a process supervisor) can restart without waiting out
        the stall threshold."""
        path = self.checkpoint_path
        if hasattr(self.engine, "recovery_context"):
            # Hand the restore path the supervision context so reopened
            # spans are annotated with WHY the world stopped, not just for
            # how long.
            self.engine.recovery_context = {
                "tier": self.tier_name, "reason": reason,
            }
        info = self.engine.restore(path)
        self.engine_restarts += 1
        self._inc("serve.watchdog.engine_restarts")
        self._last_chunk = self.clock()
        self.tier_log.append((self.clock(), TIER_NAMES[self.tier],
                              f"engine restart: {reason}"))
        tracer = getattr(self.engine, "tracer", None)
        if tracer is not None:
            tracer.event("engine_restart", t=self.clock(), reason=reason,
                         tier=self.tier_name)
        if self.blackbox is not None and self.postmortem_path is not None:
            self.blackbox.dump(self.postmortem_path, extra={
                "reason": reason,
                "tier": self.tier_name,
                "engine_restarts": self.engine_restarts,
                "tier_log": [[t, name, why]
                             for t, name, why in self.tier_log],
                "restore_info": dict(info),
            })
        if self.on_engine_restart is not None:
            self.on_engine_restart(info)
        return info

    def reattach(self, engine, ring) -> None:
        """Point supervision at a replacement engine+ring pair (the staged
        crash path discards both) and RE-APPLY the current tier's controls
        to the new ring — a fresh ring is born with no shed set and its
        constructed policy, which under an active escalation would silently
        exit the tier the ladder decided on."""
        self.engine = engine
        self.ring = ring
        if self.tier >= 1:
            ring.set_shed_topics(self._shed_set)
        if self.tier >= 2:
            ring.set_policy("drop_oldest")
        else:
            ring.set_policy(self._desired_policy())

    @property
    def tier_name(self) -> str:
        return TIER_NAMES[self.tier]

    # -- internals -----------------------------------------------------------

    def _desired_policy(self) -> str:
        """The policy de-escalation restores: the controller's current
        desired policy when one is attached (single source of truth —
        satellite fix r20), else the policy memorized at construction."""
        if self.controller is not None:
            return self.controller.knobs.backpressure_policy
        return self._orig_policy

    def _set_tier(self, tier: int, reason: str) -> None:
        self.tier = tier
        if tier >= 1:
            self.ring.set_shed_topics(self._shed_set)
        else:
            self.ring.set_shed_topics(())
        if tier >= 2:
            self.ring.set_policy("drop_oldest")
        else:
            self.ring.set_policy(self._desired_policy())
        self.tier_log.append((self.clock(), TIER_NAMES[tier], reason))
        self._inc("serve.watchdog.tier_changes")
        if self.metrics is not None:
            self.metrics.gauge("serve.watchdog.tier", tier)
        tracer = getattr(self.engine, "tracer", None)
        if tracer is not None:
            # tier_log transitions double as ledger events, so the trace
            # timeline shows WHEN the ladder moved among the spans it bent.
            tracer.event("watchdog_tier", t=self.clock(),
                         tier=TIER_NAMES[tier], reason=reason)

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)
