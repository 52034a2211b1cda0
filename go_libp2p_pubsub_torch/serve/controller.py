"""Self-tuning serving plane: the loop from telemetry back to the knobs.

Every perf knob on the serving plane used to be a static flag chosen at
init; real deployments drift (diurnal ramps, burst storms, loss-regime
shifts — the Filecoin/ETH2 measurement literature), so ROADMAP item 4 asks
for a controller that closes the loop from the telemetry plane to the
runtime controls.  Same design rules as ``net/policy.py`` and
``.watchdog``: no threads, no wall-clock reads outside the injected
``clock``, every transition counted and attributable — the controller is
*polled* by whoever owns the serving loop, once per chunk boundary.

Each poll reads the live pressure signals — ring depth vs the current
geometry's drain rate, the *carry* of pending messages across chunk
boundaries (the loss-regime signature: propagation outrunning the chunk
length), chunk wall vs checkpoint wall, verify-stage wall from the shared
:class:`~..utils.metrics.MetricsRegistry` — and moves knobs in two
classes:

- runtime knobs, through the existing ``set_*`` controls: backpressure
  policy (``IngestRing.set_policy``), shed watermarks (the watchdog's,
  retuned to the active geometry so the degradation ladder and the tuner
  are ONE composed control surface), snapshot cadence
  (``engine.snapshot_every``), verify batch grouping
  (``ValidationPipeline.flush_threshold``);
- the chunk geometry, which DOES recompile — except the engine pre-warms a
  bounded ladder of geometries on one jitted rollout
  (:meth:`~.engine.StreamingEngine.set_geometry`), so stepping the ladder
  never compiles: ``compile_cache_size() == ladder_size()`` holds across
  the whole run, crash/restore included.

Every decision is stamped into the span/trace plane as a
``controller_decision`` ledger event carrying its triggering evidence
(depth, carry, walls), so a verdict flip is attributable to the
measurement that caused it — and mirrored as ``serve.controller.*``
gauges on /metrics.

The desired-policy handshake (r20 satellite fix): the watchdog's tier-2
escalation overrides the ring policy, and its DE-escalation restores the
controller's ``KnobState.backpressure_policy`` — the single source of
truth — not the policy memorized at construction.  Symmetrically, the
controller never writes the ring policy while the watchdog holds tier 2.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .tuning import ChunkGeometry, ControllerPolicy, Decision, KnobState


class Controller:
    """Poll-driven tuner over one engine + ring (+ optional watchdog and
    validation pipeline), sharing their injected clock and registry."""

    def __init__(
        self,
        engine,
        ring,
        policy: Optional[ControllerPolicy] = None,
        watchdog=None,
        pipe=None,
        metrics=None,
        tracer=None,
        clock=time.monotonic,
    ) -> None:
        self.engine = engine
        self.ring = ring
        self.policy = policy if policy is not None else ControllerPolicy()
        self.watchdog = watchdog
        self.pipe = pipe
        self.metrics = metrics
        self.tracer = tracer
        self.clock = clock
        # The calm rung is the engine's constructed geometry (the spec's
        # static choice) — where the controller returns after pressure.
        self._calm = engine.geometry
        self.knobs = KnobState(
            geometry_index=self._ladder_index(engine.geometry),
            backpressure_policy=ring.policy,
            snapshot_every=int(getattr(engine, "snapshot_every", 0)),
            flush_threshold=(
                int(pipe.flush_threshold) if pipe is not None else 0
            ),
            high_watermark=(
                int(watchdog.high_watermark) if watchdog is not None else 0
            ),
            low_watermark=(
                int(watchdog.low_watermark) if watchdog is not None else 0
            ),
        )
        # The spec's policy: what "calm" restores the backpressure knob to.
        self._base_policy = ring.policy
        self.decisions: List[Decision] = []
        self.polls = 0
        self._pending_age: Dict[Any, int] = {}
        self._calm_polls = 0
        self._last_block_waits = 0
        self._last_restores = int(getattr(engine, "restores", 0))
        if watchdog is not None:
            # One composed control surface: the watchdog consults the
            # controller's KnobState for the policy de-escalation restores.
            watchdog.controller = self
        self._export_gauges()

    # -- the control loop ----------------------------------------------------

    def poll(self) -> List[Decision]:
        """One tuning pass at a chunk boundary; returns the decisions it
        took (possibly empty).  Reads only host-side telemetry — never
        touches device state — so a poll costs microseconds."""
        self.polls += 1
        # The engine's live geometry is ground truth: a restore may have
        # adopted the snapshot's rung behind the controller's back.
        self.knobs.geometry_index = self._ladder_index(self.engine.geometry)
        ev = self._evidence()
        new: List[Decision] = []
        new += self._tune_geometry(ev)
        new += self._tune_snapshot_cadence(ev)
        new += self._tune_flush_threshold(ev)
        new += self._tune_backpressure(ev)
        if self.metrics is not None:
            self.metrics.inc("serve.controller.polls")
        self._export_gauges()
        return new

    def reattach(self, engine, ring) -> None:
        """Point the tuner at a replacement engine+ring pair (the staged
        crash path discards both).  The knob state and the decision record
        SURVIVE — they are the controller's memory, and the watchdog's
        ``reattach`` re-applies the desired policy from them — while
        per-pair baselines (pending ages, ring counters, the restore
        count) reset to the new pair's."""
        self.engine = engine
        self.ring = ring
        self._pending_age = {}
        self._calm_polls = 0
        self._last_block_waits = 0
        self._last_restores = int(getattr(engine, "restores", 0))
        self.knobs.geometry_index = self._ladder_index(engine.geometry)
        self._export_gauges()

    def controls(self) -> Dict[str, Any]:
        """JSON-safe digest for /debug/obs: the live knob values, the
        watchdog tier, and the most recent decisions."""
        doc: Dict[str, Any] = {
            "knobs": self.knobs.to_dict(),
            "geometry": list(self.engine.geometry.as_tuple()),
            "ladder": [list(g.as_tuple()) for g in self.engine.ladder],
            "ring_policy": self.ring.policy,
            "decisions": [d.to_dict() for d in self.decisions[-8:]],
            "n_decisions": len(self.decisions),
            "polls": self.polls,
        }
        if self.watchdog is not None:
            doc["watchdog_tier"] = self.watchdog.tier
            doc["watchdog_tier_name"] = self.watchdog.tier_name
        return doc

    # -- evidence ------------------------------------------------------------

    def _evidence(self) -> Dict[str, Any]:
        """The poll's measurement snapshot — attached verbatim to every
        decision it triggers."""
        eng = self.engine
        depth = self.ring.depth
        # Carry: how many chunk boundaries the oldest pending message has
        # survived, keyed on the engine's chunk counter (NOT on polls — a
        # poll with no intervening chunk must not age anything).  Carry 1
        # (published near a chunk's end, completing next chunk) is normal;
        # carry >= carry_up_chunks means rounds-to-deliver exceeds the
        # chunk length — the loss-regime signature.
        cr = int(eng.chunks_run)
        live = set(eng.pending.keys())
        self._pending_age = {
            k: self._pending_age.get(k, cr) for k in live
        }
        carry = max(
            (cr - first for first in self._pending_age.values()), default=0
        )
        wall = float(getattr(eng, "last_chunk_wall_s", 0.0))
        snaps = int(getattr(eng, "snapshots_taken", 0))
        avg_snap_s = (
            float(getattr(eng, "snapshot_seconds", 0.0)) / snaps
            if snaps else 0.0
        )
        verify_s = None
        verify_batch = 0
        if self.metrics is not None:
            verify_s = self.metrics.latest("crypto.pipeline.verify_s")
            vb = self.metrics.latest("crypto.pipeline.batch")
            verify_batch = int(vb) if vb is not None else 0
        acct_waits = 0
        try:
            acct_waits = int(self.ring.accounting()["block_waits"])
        except Exception:
            pass
        return {
            "depth": int(depth),
            "capacity": int(self.ring.capacity),
            "slots": int(eng.geometry.slots),
            "carry": int(carry),
            "chunk_wall_s": wall,
            "avg_snapshot_s": avg_snap_s,
            "verify_s": float(verify_s) if verify_s is not None else 0.0,
            "verify_batch": verify_batch,
            "block_waits": acct_waits,
            "tier": (self.watchdog.tier if self.watchdog is not None else 0),
        }

    # -- knob movers ---------------------------------------------------------

    def _tune_geometry(self, ev: Dict[str, Any]) -> List[Decision]:
        eng = self.engine
        if eng.ladder_size() < 2:
            return []
        pol = self.policy
        cur = eng.geometry
        depth_pressure = ev["depth"] >= pol.depth_up_frac * cur.slots
        carry_pressure = ev["carry"] >= pol.carry_up_chunks
        target: Optional[ChunkGeometry] = None
        reason = ""
        if carry_pressure:
            # Propagation outruns the chunk: pick the longest rung so one
            # dispatch covers the delayed rounds (ties: widest drains too).
            target = max(
                eng.ladder, key=lambda g: (g.chunk_steps, g.slots)
            )
            reason = (
                f"pending carry {ev['carry']} chunks >= "
                f"{pol.carry_up_chunks}: rounds-to-deliver outrun "
                f"chunk_steps {cur.chunk_steps}"
            )
        elif depth_pressure:
            # Backlog outruns the drain rate: pick the widest rung (ties:
            # shortest wall).
            target = max(
                eng.ladder, key=lambda g: (g.slots, -g.chunk_steps)
            )
            reason = (
                f"depth {ev['depth']} >= "
                f"{pol.depth_up_frac:.2f} x {cur.slots} slots"
            )
        if target is not None and target.as_tuple() != cur.as_tuple():
            self._calm_polls = 0
            return self._apply_geometry(target, reason, ev)
        # De-escalation: hysteretic return to the calm rung.
        calm_now = (
            ev["depth"] <= pol.depth_down_frac * self._calm.slots
            and ev["carry"] == 0
        )
        self._calm_polls = self._calm_polls + 1 if calm_now else 0
        if (
            self._calm_polls >= pol.cooldown_polls
            and cur.as_tuple() != self._calm.as_tuple()
        ):
            self._calm_polls = 0
            return self._apply_geometry(
                self._calm,
                f"calm for {pol.cooldown_polls} polls (depth "
                f"{ev['depth']} <= {pol.depth_down_frac:.2f} x "
                f"{self._calm.slots}, carry 0)",
                ev,
            )
        return []

    def _apply_geometry(
        self, target: ChunkGeometry, reason: str, ev: Dict[str, Any]
    ) -> List[Decision]:
        old = self.engine.geometry
        self.engine.set_geometry(*target.as_tuple())
        self.knobs.geometry_index = self._ladder_index(target)
        out = [self._decide(
            "geometry",
            f"{old.chunk_steps}x{old.pub_width}",
            f"{target.chunk_steps}x{target.pub_width}",
            reason, ev,
        )]
        # Composed control surface: the watchdog's shed watermarks follow
        # the active drain rate, so "overloaded" always means "more than
        # the CURRENT geometry can drain", not the construction-time one.
        if self.watchdog is not None:
            high = min(
                self.ring.capacity,
                max(2, int(self.policy.watermark_high_chunks * target.slots)),
            )
            low = min(max(0, target.slots // 2), high - 1)
            old_marks = (
                self.watchdog.high_watermark, self.watchdog.low_watermark
            )
            if (high, low) != old_marks:
                self.watchdog.high_watermark = high
                self.watchdog.low_watermark = low
                self.knobs.high_watermark = high
                self.knobs.low_watermark = low
                out.append(self._decide(
                    "watermarks",
                    f"{old_marks[0]}/{old_marks[1]}",
                    f"{high}/{low}",
                    f"retuned to geometry "
                    f"{target.chunk_steps}x{target.pub_width} "
                    f"({target.slots} slots/chunk)",
                    ev,
                ))
        return out

    def _tune_snapshot_cadence(self, ev: Dict[str, Any]) -> List[Decision]:
        eng = self.engine
        if self.knobs.snapshot_every < 1 or eng.snapshot_path is None:
            return []      # snapshots disabled: nothing to pace
        pol = self.policy
        cur = self.knobs.snapshot_every
        restores = int(getattr(eng, "restores", 0))
        crashed = restores > self._last_restores
        self._last_restores = restores
        new = cur
        reason = ""
        if crashed:
            # A restore just happened: tighten to the floor — the cheapest
            # moment to buy back durability is right after paying for its
            # absence.
            new = pol.snapshot_every_min
            reason = f"restore observed (restores={restores}): tighten"
        elif ev["chunk_wall_s"] > 0.0 and ev["avg_snapshot_s"] > 0.0:
            frac = ev["avg_snapshot_s"] / (cur * ev["chunk_wall_s"])
            if frac > pol.snapshot_cost_frac:
                new = min(pol.snapshot_every_max, cur * 2)
                reason = (
                    f"checkpoint wall {frac:.2f} of chunk wall > "
                    f"{pol.snapshot_cost_frac:.2f}: stretch"
                )
            elif frac < pol.snapshot_cost_frac / 4 and cur > \
                    pol.snapshot_every_min:
                new = max(pol.snapshot_every_min, cur // 2)
                reason = (
                    f"checkpoint wall {frac:.2f} of chunk wall < "
                    f"{pol.snapshot_cost_frac / 4:.2f}: tighten"
                )
        if new == cur:
            return []
        eng.snapshot_every = new
        self.knobs.snapshot_every = new
        return [self._decide("snapshot_every", cur, new, reason, ev)]

    def _tune_flush_threshold(self, ev: Dict[str, Any]) -> List[Decision]:
        if self.pipe is None:
            return []
        pol = self.policy
        cur = int(self.pipe.flush_threshold)
        # Only tune while the threshold BINDS (the last verify batch
        # actually filled it): when submit volume never reaches the
        # threshold, batch grouping is set by the caller's flush cadence
        # and moving the knob would be evidence-free churn.
        if ev["verify_batch"] < cur:
            return []
        new = cur
        reason = ""
        if (
            ev["chunk_wall_s"] > 0.0
            and ev["verify_s"] > pol.verify_cost_frac * ev["chunk_wall_s"]
            and cur > pol.flush_threshold_min
        ):
            new = max(pol.flush_threshold_min, cur // 2)
            reason = (
                f"verify wall {ev['verify_s']:.4f}s > "
                f"{pol.verify_cost_frac:.2f} x chunk wall "
                f"{ev['chunk_wall_s']:.4f}s at a full batch: split batches"
            )
        elif (
            ev["chunk_wall_s"] > 0.0
            and ev["verify_s"] < pol.verify_cost_frac * ev["chunk_wall_s"] / 4
            and cur < pol.flush_threshold_max
        ):
            new = min(pol.flush_threshold_max, cur * 2)
            reason = (
                f"verify wall {ev['verify_s']:.4f}s well under chunk wall "
                "at a full batch: regroup larger"
            )
        if new == cur:
            return []
        self.pipe.flush_threshold = new
        self.knobs.flush_threshold = new
        return [self._decide("flush_threshold", cur, new, reason, ev)]

    def _tune_backpressure(self, ev: Dict[str, Any]) -> List[Decision]:
        pol_cur = self.knobs.backpressure_policy
        waits = ev["block_waits"]
        blocked_since = waits - self._last_block_waits
        self._last_block_waits = waits
        want = pol_cur
        reason = ""
        if (
            pol_cur == "block"
            and blocked_since > 0
            and ev["depth"] >= ev["capacity"]
        ):
            # Producers are parking on a full ring: fail fast instead of
            # stalling the whole ingest path (every rejection is counted,
            # caller-owned — never a silent drop).
            want = "reject"
            reason = (
                f"{blocked_since} producer waits on a full ring "
                f"(depth {ev['depth']} = capacity): fail fast"
            )
        elif (
            pol_cur != self._base_policy
            and ev["depth"] <= self.policy.depth_down_frac * ev["capacity"]
            and ev["carry"] == 0
        ):
            want = self._base_policy
            reason = (
                f"depth {ev['depth']} back under "
                f"{self.policy.depth_down_frac:.2f} x capacity: restore "
                "the configured policy"
            )
        if want == pol_cur:
            return []
        self.knobs.backpressure_policy = want
        # The watchdog's tier 2 owns the LIVE ring policy while escalated;
        # the knob state still records the controller's desire, and the
        # de-escalation path restores it (the single-source-of-truth fix).
        if self.watchdog is None or self.watchdog.tier < 2:
            self.ring.set_policy(want)
        return [self._decide("backpressure_policy", pol_cur, want,
                             reason, ev)]

    # -- bookkeeping ---------------------------------------------------------

    def _ladder_index(self, geom: ChunkGeometry) -> int:
        for i, g in enumerate(self.engine.ladder):
            if g.as_tuple() == geom.as_tuple():
                return i
        raise ValueError(
            f"geometry {geom.as_tuple()} is not on the engine's ladder"
        )

    def _decide(
        self, knob: str, old, new, reason: str, ev: Dict[str, Any]
    ) -> Decision:
        d = Decision(
            t=self.clock(), knob=knob, old=old, new=new, reason=reason,
            evidence=dict(ev),
        )
        self.decisions.append(d)
        if self.metrics is not None:
            self.metrics.inc("serve.controller.decisions")
            self.metrics.inc(f"serve.controller.decisions.{knob}")
        if self.tracer is not None:
            # The span plane is the audit log: every decision lands as a
            # ledger event with its evidence, so a verdict flip is
            # attributable to the measurement that triggered it.
            self.tracer.event(
                "controller_decision", t=d.t, knob=knob,
                old=str(old), new=str(new), reason=reason,
                **{f"ev_{k}": v for k, v in ev.items()},
            )
        return d

    def _export_gauges(self) -> None:
        if self.metrics is None:
            return
        g = self.engine.geometry
        self.metrics.gauge(
            "serve.controller.geometry_index", self.knobs.geometry_index
        )
        self.metrics.gauge("serve.controller.chunk_steps", g.chunk_steps)
        self.metrics.gauge("serve.controller.pub_width", g.pub_width)
        self.metrics.gauge(
            "serve.controller.snapshot_every", self.knobs.snapshot_every
        )
        self.metrics.gauge(
            "serve.controller.flush_threshold", self.knobs.flush_threshold
        )
        from .ingest import BACKPRESSURE_POLICIES

        self.metrics.gauge(
            "serve.controller.desired_policy",
            BACKPRESSURE_POLICIES.index(self.knobs.backpressure_policy),
        )
