"""Device-resident streaming rollout: one prepared chunk, replayed forever.

Port of the JAX package's ``serve/engine.py``.  The shapes of a chunk's
event rows are frozen (``chunk_steps`` rounds x ``pub_width`` publish
lanes, padded with the schedule's ``-1`` sentinels), and every chunk runs
the same prepared program on freshly filled rows; the multi-topic state
stays on the device from chunk to chunk.

The model speaks the reference's engine dialect: a
``MultiTopicGossipSub``, or the coded hybrid (``HybridGossipSub``, T = 1),
whose ``stream_model_key`` fingerprints its checkpoints and whose
``decode_rank_summary`` goes into each snapshot's meta as
``decode_ranks``.

Where the reference jits one donated-state rollout per model value, the
port keeps a module-level cache of **prepared chunk programs**
(``_ChunkProgram``), keyed on the model's value (both models have value
``__eq__``/``__hash__``) and on the geometry.  A program holds
its geometry's staging buffers for the event rows (pinned host memory and
their device copies on a card) and runs the model's event path for one
chunk.  ``compile_cache_size()`` counts this model's programs: the ladder
size after warmup, and still the ladder size after any number of chunks,
geometry switches, or crash/restore cycles with a fresh engine over an
equal model.  No CUDA graph is captured: a program is a prepared Python
launch sequence, so the count says how many chunk shapes were prepared,
not how many device graphs exist.

Latency is exact host-clock ingest -> delivery, observed at chunk
boundaries (rounded up to the boundary where the delivered count crossed
the completion threshold).  Each chunk reads the device twice: the digest
(one int32 tensor: per-slot delivered counts and per-topic participants)
and the flight-recorder tail (the last round's telemetry, packed into one
int32 tensor; the hybrid's is the last round of its recorded chunk, the
reference's tail, with its latency histogram carried from the chunk's
start).  Nothing else in a chunk waits on the device.

Crash safety: ``snapshot()`` writes the state and the flight tail with
the reference's file format (``utils/checkpoint``: leaves under the
reference's key paths, words as uint32) and every piece of host
bookkeeping as JSON meta, atomically; ``restore()`` on a warmed engine
resumes from the last chunk boundary without preparing a new program, and
the content-hash dedup makes delivery exactly-once across a crash.  A
snapshot written by the JAX package's engine restores here, and the other
way round.

``tracer`` (an ``obs.spans.SpanLedger``) and ``blackbox`` (an
``obs.blackbox.BlackBox``) are optional hooks; the engine is exact with
both None.
``profile_every``/``profile_dir`` capture a ``torch.profiler`` trace of
every Nth chunk into ``profile_dir`` (``utils.trace.profiler_trace``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import bridge
from ..models.hybrid import HybridGossipSub
from ..models.multitopic import EVENT_ROWS, fires
from ..obs.spans import content_hash  # re-exported
from ..ops import schedule as sched
from ..utils import checkpoint as ckpt
from ..utils.trace import profiler_trace
from .ingest import IngestItem, IngestRing
from .tuning import ChunkGeometry, validate_ladder


def _state_to_numpy(st):
    """The engine state -> the reference's numpy form (checkpoint leaves)."""
    if isinstance(st, bridge.HybridState):
        return bridge.hybrid_state_to_numpy(st)
    return bridge.multitopic_state_to_numpy(st)


def _state_spec(st):
    if isinstance(st, bridge.HybridState):
        return bridge.hybrid_state_spec(st)
    return bridge.multitopic_state_spec(st)


def _state_from_numpy(st, device):
    if isinstance(st, bridge.HybridState):
        return bridge.hybrid_state_from_numpy(st, device=device)
    return bridge.multitopic_state_from_jax(st, device=device)


class _ChunkProgram:
    """One geometry's resident chunk: ``chunk_steps`` rounds of the
    model's event path with up to ``pub_width`` publishes a round, and the
    staging buffers its event rows go through to the device."""

    def __init__(self, model, chunk_steps: int, pub_width: int):
        self.model = model
        self.chunk_steps, self.pub_width = chunk_steps, pub_width
        dev = model.device
        pin = dev.type == "cuda"
        self._host, self._dev = {}, {}
        for name in EVENT_ROWS:
            dt = torch.int32 if name == "delay" else torch.bool
            self._host[name] = torch.empty((chunk_steps, model.n), dtype=dt,
                                           pin_memory=pin)
            self._dev[name] = (torch.empty_like(self._host[name], device=dev)
                               if pin else self._host[name])

    def row(self, name: str, t: int) -> torch.Tensor:
        return self._dev[name][t]

    def __call__(self, state, events: sched.MultiTopicEvents):
        """(state, events) -> (state after the chunk, device dict of the
        last round's telemetry)."""
        if (events.kill.shape != (self.chunk_steps, self.model.n)
                or events.pub_src.shape[1] != self.pub_width):
            raise ValueError(
                f"chunk events {events.kill.shape[0]}x"
                f"{events.pub_src.shape[1]} do not fit the prepared "
                f"{self.chunk_steps}x{self.pub_width} program")
        # A staged plane is reused only after the previous chunk's digest
        # read, which waited for every copy out of it.
        for name in EVENT_ROWS:
            plane = getattr(events, name)
            if fires(name, plane).any():
                self._host[name].numpy()[:] = plane
                if self._dev[name] is not self._host[name]:
                    self._dev[name].copy_(self._host[name], non_blocking=True)
        if isinstance(self.model, HybridGossipSub):
            return self.model.stream_chunk(state, events, rows=self)
        st, _ = self.model.rollout_events(state, events, record=False,
                                          rows=self)
        return st, self.model.flight_record_round(st)


# The prepared programs, per (model value, geometry): shared process-wide
# so a fresh engine over an equal model (the crash-restart path) prepares
# nothing.
_PROGRAMS: Dict[Tuple[object, Tuple[int, int]], _ChunkProgram] = {}


def _program(model, chunk_steps: int, pub_width: int) -> _ChunkProgram:
    key = (model, (chunk_steps, pub_width))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = _ChunkProgram(model, chunk_steps, pub_width)
    return prog


def _read(t: torch.Tensor) -> np.ndarray:
    """One device -> host read (a synchronising copy on a card)."""
    return t.cpu().numpy()


def _read_tail(tail: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The flight tail's device channels (int32 and float32 scalars, the
    int32 histogram) -> host numpy, in one int32 read."""
    names = sorted(tail)
    flat = [tail[k].reshape(-1) for k in names]
    packed = _read(torch.cat([
        v.view(torch.int32) if v.dtype == torch.float32
        else v.to(torch.int32) for v in flat]))
    out, i = {}, 0
    for k, v in zip(names, flat):
        part = packed[i:i + v.numel()]
        i += v.numel()
        if v.dtype == torch.float32:
            part = part.view(np.float32)
        out[k] = part.reshape(tuple(tail[k].shape)).copy()
    return out


@dataclasses.dataclass
class PendingMessage:
    """A published message awaiting its completion threshold."""

    seq: int
    topic: int
    slot: int
    publisher: int
    t_ingest: float       # host clock at ring push
    t_publish: float      # host clock when its chunk was dispatched
    step_published: int   # global device step of its publish row
    chash: str = ""       # content hash (exactly-once identity)


class StreamingEngine:
    """Resident chunked rollout over a :class:`MultiTopicGossipSub` (or
    the coded :class:`HybridGossipSub`).

    ``run_chunk`` pops up to ``chunk_steps * pub_width`` ring items, packs
    them into a fixed-shape ``MultiTopicEvents`` (publishes spread
    round-robin over the chunk's rounds) and runs the prepared program.
    The state lives on the model's device (the card by default)."""

    def __init__(
        self,
        model,
        ring: IngestRing,
        chunk_steps: int = 8,
        pub_width: int = 4,
        completion_frac: float = 0.99,
        seed: int = 0,
        metrics=None,
        clock=time.monotonic,
        snapshot_path: Optional[str] = None,
        snapshot_every: int = 0,
        tracer=None,
        blackbox=None,
        profile_every: int = 0,
        profile_dir: Optional[str] = None,
        geometry_ladder=None,
    ) -> None:
        if chunk_steps < 1 or pub_width < 1:
            raise ValueError("chunk_steps and pub_width must be >= 1")
        if not (0.0 < completion_frac <= 1.0):
            raise ValueError("completion_frac must be in (0, 1]")
        if snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0")
        if snapshot_every > 0 and snapshot_path is None:
            raise ValueError("snapshot_every needs a snapshot_path")
        if profile_every < 0:
            raise ValueError("profile_every must be >= 0")
        if profile_every > 0 and profile_dir is None:
            raise ValueError("profile_every needs a profile_dir")
        self.model = model
        self.ring = ring
        self.chunk_steps = chunk_steps
        self.pub_width = pub_width
        # Pre-declared chunk geometries: warmup() prepares every rung so
        # set_geometry() later switches between prepared programs.
        self.ladder = validate_ladder(
            geometry_ladder if geometry_ladder is not None
            else [(chunk_steps, pub_width)],
            (chunk_steps, pub_width),
        )
        self.completion_frac = completion_frac
        self.metrics = metrics
        self._clock = clock
        self.snapshot_path = snapshot_path
        self.snapshot_every = snapshot_every
        self.tracer = tracer
        self.blackbox = blackbox
        self.profile_every = profile_every
        self.profile_dir = profile_dir
        self.profile_captures = 0
        self.latencies_exact_s: List[float] = []  # span-interpolated (traced)
        self.last_recovery_gap_s: Optional[float] = None
        self.last_chunk_wall_s = 0.0
        self.recovery_context: Dict[str, str] = {}
        self._in_warmup = False
        self.state = model.init(seed=seed)
        self._next_slot = [0] * model.t          # per-topic cyclic allocator
        self.pending: Dict[Tuple[int, int], PendingMessage] = {}
        self.latencies_s: List[float] = []       # completed, host seconds
        self.publish_log: List[PendingMessage] = []   # every VALID publish
        self.invalid_published: List[Tuple[int, int]] = []  # (topic, slot)
        self.chunks_run = 0
        # Device rounds advanced so far (ladder switches make chunks
        # variable-length).
        self.steps_run = 0
        self.geometry_switches = 0
        self.published = 0
        self.completed = 0
        self.evicted = 0       # window slot recycled before completion
        self.restores = 0
        self.replay_deduped = 0        # valid items skipped: already published
        self.duplicate_completions = 0  # same content completed twice
        self.clock_anomalies = 0       # negative ingest->delivery intervals
        self.snapshots_taken = 0
        self.snapshot_seconds = 0.0    # cumulative wall time in snapshot()
        self._seen_hashes: set = set()        # every VALID publish, ever
        self._completed_hashes: set = set()   # every completed content
        self.flight_tail: Dict[str, np.ndarray] = {}
        # Degraded-links knob: when set, every chunk's first event row
        # carries this ingress delay for all peers.
        self.ingress_delay: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> None:
        """Run one all-quiet chunk per ladder rung (each rung's program is
        prepared on its first run), ending on the constructed geometry.
        Advances the device state by the ladder's total idle rounds.
        Warmup chunks never auto-snapshot (a fresh engine warms up before
        ``restore()`` and must not clobber the checkpoint)."""
        base = (self.chunk_steps, self.pub_width)
        self._in_warmup = True
        try:
            for g in self.ladder:
                if g.as_tuple() == base:
                    continue
                self.chunk_steps, self.pub_width = g.as_tuple()
                self._dispatch(self._empty_events())
            self.chunk_steps, self.pub_width = base
            self._dispatch(self._empty_events())
            if self.snapshot_path is not None:
                # The first full-state serialization is cold; pay it here,
                # in memory only (warmup never writes snapshot_path).
                ckpt.warm_serialize(self._checkpoint_tree())
        finally:
            self._in_warmup = False

    def compile_cache_size(self) -> int:
        """Prepared chunk programs of this model (value-equal models
        share them): the ladder size after warmup, and still the ladder
        size after any number of chunks, geometry switches and crash/
        restore cycles -- or a chunk shape drifted."""
        return sum(1 for (model, _) in _PROGRAMS if model == self.model)

    def ladder_size(self) -> int:
        """Number of pre-warmed chunk geometries (1 without a ladder)."""
        return len(self.ladder)

    @property
    def geometry(self) -> ChunkGeometry:
        return ChunkGeometry(self.chunk_steps, self.pub_width)

    def set_geometry(self, chunk_steps: int, pub_width: int) -> None:
        """Switch the NEXT chunk's shape to another pre-warmed rung; raises
        on a geometry that is not on the ladder."""
        want = (int(chunk_steps), int(pub_width))
        if want == (self.chunk_steps, self.pub_width):
            return
        if want not in {g.as_tuple() for g in self.ladder}:
            raise ValueError(
                f"geometry {want} is not on the pre-warmed ladder "
                f"{[g.as_tuple() for g in self.ladder]}; switching would "
                "prepare a new program"
            )
        self.chunk_steps, self.pub_width = want
        self.geometry_switches += 1
        if self.metrics is not None:
            self.metrics.inc("serve.engine.geometry_switches")
            self.metrics.gauge("serve.engine.chunk_steps", self.chunk_steps)
            self.metrics.gauge("serve.engine.pub_width", self.pub_width)

    # -- the chunk loop -----------------------------------------------------

    def run_chunk(self) -> dict:
        """Pop one chunk's worth of ingest, publish, advance chunk_steps
        rounds, and fold completions.  Returns a host-side summary."""
        events = self._empty_events()
        items = self.ring.pop_batch(self.chunk_steps * self.pub_width)
        base_step = self.steps_run
        t_dispatch = self._clock()
        cursor = 0
        for item in items:
            if item.valid:
                # Exactly-once gate: a content hash already published is a
                # resubmission or a replayed duplicate -- skip it loudly.
                chash = content_hash(item.topic, item.publisher, item.payload)
                if chash in self._seen_hashes:
                    self.replay_deduped += 1
                    if self.metrics is not None:
                        self.metrics.inc("serve.engine.replay_deduped")
                    continue
            row = cursor % self.chunk_steps
            col = cursor // self.chunk_steps
            cursor += 1
            slot = self._alloc_slot(item)
            events.pub_topic[row, col] = item.topic
            events.pub_src[row, col] = item.publisher
            events.pub_slot[row, col] = slot
            events.pub_valid[row, col] = item.valid
            if item.valid:
                self._seen_hashes.add(chash)
                p = PendingMessage(
                    seq=item.seq, topic=item.topic, slot=slot,
                    publisher=item.publisher, t_ingest=item.t_ingest,
                    t_publish=t_dispatch, step_published=base_step + row,
                    chash=chash,
                )
                self.pending[(item.topic, slot)] = p
                self.publish_log.append(p)
                if self.tracer is not None:
                    self.tracer.stamp(
                        chash, "chunk_dispatch", t=t_dispatch,
                        chunk=self.chunks_run, step=p.step_published,
                        slot=slot,
                    )
            else:
                self.invalid_published.append((item.topic, slot))
            self.published += 1
        return self._dispatch(events, n_items=len(items))

    def run_until_drained(self, max_chunks: int = 64) -> int:
        """Chunk until the ring is empty and no message is pending (or the
        chunk budget runs out).  Returns chunks run by this call."""
        n = 0
        while n < max_chunks and (self.ring.depth > 0 or self.pending):
            self.run_chunk()
            n += 1
        return n

    # -- checkpoint ----------------------------------------------------------

    def _model_key(self) -> str:
        """Config fingerprint stored in checkpoint meta (the reference's
        string, so snapshots cross between the packages): the model's own
        ``stream_model_key`` where it has one (the coded hybrid), else the
        multitopic form."""
        fn = getattr(self.model, "stream_model_key", None)
        if fn is not None:
            return fn()
        m = self.model
        return (
            f"multitopic t={m.t} n={m.n} k={m.k} m={m.m} w={m.w} "
            f"hb={m.heartbeat_steps}"
        )

    def _checkpoint_tree(self) -> dict:
        return {"state": _state_to_numpy(self.state),
                "flight_tail": dict(self.flight_tail)}

    def snapshot(self, path: Optional[str] = None) -> str:
        """Write a durable checkpoint at the current chunk boundary: the
        state and flight tail as arrays, the host bookkeeping (cursors,
        pending and publish logs, dedup hashes, counters, the ring's buffer
        and ledger) as JSON meta.  Atomic (write -> fsync -> rename)."""
        path = path if path is not None else self.snapshot_path
        if path is None:
            raise ValueError("snapshot needs a path (ctor or argument)")
        if self.chunks_run < 1 or not self.flight_tail:
            raise RuntimeError(
                "snapshot() needs a warmed engine (run warmup() first so "
                "the flight tail has its resident structure)"
            )
        t0 = time.monotonic()
        meta = {
            "kind": "streaming-engine",
            "model": self._model_key(),
            "chunk_steps": self.chunk_steps,
            "pub_width": self.pub_width,
            "completion_frac": self.completion_frac,
            "chunks_run": self.chunks_run,
            "steps_run": self.steps_run,
            "published": self.published,
            "completed": self.completed,
            "evicted": self.evicted,
            "replay_deduped": self.replay_deduped,
            "duplicate_completions": self.duplicate_completions,
            "clock_anomalies": self.clock_anomalies,
            "next_slot": list(self._next_slot),
            "publish_log": [dataclasses.asdict(p) for p in self.publish_log],
            "pending_keys": sorted(
                [t, s] for (t, s) in self.pending.keys()
            ),
            "invalid_published": [
                [t, s] for (t, s) in self.invalid_published
            ],
            "latencies_s": list(self.latencies_s),
            "seen_hashes": sorted(self._seen_hashes),
            "completed_hashes": sorted(self._completed_hashes),
            "ring": self.ring.snapshot(),
            "ingress_delay": self.ingress_delay,
            "t_wall": self._clock(),
            "latencies_exact_s": list(self.latencies_exact_s),
        }
        if self.tracer is not None:
            meta["spans"] = self.tracer.snapshot()
        # Coded models record their decode progress: partial ranks were
        # checkpointed mid-generation, not just full decodes.
        rank_fn = getattr(self.model, "decode_rank_summary", None)
        if rank_fn is not None:
            meta["decode_ranks"] = {
                k: int(v) for k, v in rank_fn(self.state).items()}
        ckpt.save(path, self._checkpoint_tree(), meta=meta)
        self.snapshots_taken += 1
        self.snapshot_seconds += time.monotonic() - t0
        if self.metrics is not None:
            self.metrics.inc("serve.engine.snapshots")
        return path

    def restore(self, path: Optional[str] = None) -> dict:
        """Resume from the last snapshot without preparing a new program.

        Call on a warmed engine (construct -> warmup() -> restore()).
        Overwrites the device state, flight tail and all host bookkeeping
        with the snapshot's and reinstates the ingest ring's buffer and
        ledger, so accepted-but-undelivered messages replay through the
        normal chunk path (exactly-once by the content-hash dedup)."""
        path = path if path is not None else self.snapshot_path
        if path is None:
            raise ValueError("restore needs a path (ctor or argument)")
        if self.chunks_run < 1 or not self.flight_tail:
            raise RuntimeError(
                "restore() needs a warmed engine (run warmup() first; the "
                "warmed flight tail is the restore template)"
            )
        meta = ckpt.meta(path)
        if meta.get("kind") != "streaming-engine":
            raise ValueError(
                f"{path} is not a streaming-engine checkpoint "
                f"(kind={meta.get('kind')!r})"
            )
        if meta["model"] != self._model_key():
            raise ValueError(
                "checkpoint/model config mismatch: "
                f"snapshot={meta['model']!r} engine={self._model_key()!r}"
            )
        snap_geom = (int(meta["chunk_steps"]), int(meta["pub_width"]))
        if snap_geom != (self.chunk_steps, self.pub_width):
            # A ladder engine adopts the snapshot's (prepared) geometry;
            # off-ladder shapes refuse.
            if snap_geom in {g.as_tuple() for g in self.ladder}:
                self.set_geometry(*snap_geom)
            else:
                raise ValueError(
                    "checkpoint chunk shapes "
                    f"({meta['chunk_steps']}x{meta['pub_width']}) not on "
                    f"the engine's ladder "
                    f"{[g.as_tuple() for g in self.ladder]}; restoring "
                    "would break the pre-warmed-programs contract"
                )
        tree = ckpt.restore(path, {
            "state": _state_spec(self.state),
            "flight_tail": dict(self.flight_tail)})
        self.state = _state_from_numpy(tree["state"], self.model.device)
        self.flight_tail = {k: np.asarray(v)
                            for k, v in tree["flight_tail"].items()}
        self.completion_frac = float(meta["completion_frac"])
        self.chunks_run = int(meta["chunks_run"])
        self.steps_run = int(meta.get(
            "steps_run", self.chunks_run * int(meta["chunk_steps"])
        ))
        self.published = int(meta["published"])
        self.completed = int(meta["completed"])
        self.evicted = int(meta["evicted"])
        self.replay_deduped = int(meta["replay_deduped"])
        self.duplicate_completions = int(meta["duplicate_completions"])
        self.clock_anomalies = int(meta.get("clock_anomalies", 0))
        self._next_slot = [int(x) for x in meta["next_slot"]]
        self.publish_log = [
            PendingMessage(**d) for d in meta["publish_log"]
        ]
        by_key = {(p.topic, p.slot): p for p in self.publish_log}
        self.pending = {
            (int(t), int(s)): by_key[(int(t), int(s))]
            for t, s in meta["pending_keys"]
        }
        self.invalid_published = [
            (int(t), int(s)) for t, s in meta["invalid_published"]
        ]
        self.latencies_s = [float(x) for x in meta["latencies_s"]]
        self._seen_hashes = set(meta["seen_hashes"])
        self._completed_hashes = set(meta["completed_hashes"])
        if meta.get("ingress_delay") is not None:
            self.ingress_delay = int(meta["ingress_delay"])
        replayed = self.ring.restore_snapshot(meta["ring"])
        self.latencies_exact_s = [
            float(x) for x in meta.get("latencies_exact_s", [])
        ]
        # Recovery gap: how long the world stood still between the
        # checkpoint's wall stamp and this restore.
        gap: Optional[float] = None
        if meta.get("t_wall") is not None:
            gap = max(0.0, self._clock() - float(meta["t_wall"]))
            self.last_recovery_gap_s = gap
        if self.tracer is not None and meta.get("spans") is not None:
            self.tracer.restore_snapshot(meta["spans"])
            rctx = {str(k): str(v) for k, v in self.recovery_context.items()}
            if gap is not None:
                self.tracer.event("crash_recovery", gap_s=gap, **rctx)
                self.tracer.annotate_open("crash_recovery", gap_s=gap, **rctx)
        self.recovery_context = {}
        self.restores += 1
        if self.metrics is not None:
            self.metrics.inc("serve.engine.restores")
        return {
            "chunk": self.chunks_run,
            "replayed": replayed,
            "pending": len(self.pending),
            "completed": self.completed,
            "recovery_gap_s": gap,
        }

    # -- views --------------------------------------------------------------

    def latency_quantiles(
        self, qs=(0.5, 0.99), mode: str = "chunk"
    ) -> Dict[str, float]:
        """{"p50": ..., "p99": ...} over completed ingest->delivery
        latencies (host seconds); NaN when nothing completed yet.
        ``mode="exact"`` reads the tracer-interpolated latencies."""
        from ..utils.metrics import quantiles

        if mode == "chunk":
            return quantiles(self.latencies_s, qs)
        if mode == "exact":
            return quantiles(self.latencies_exact_s, qs)
        raise ValueError(f"unknown latency mode {mode!r}; "
                         "have: chunk, exact")

    # -- internals ----------------------------------------------------------

    def set_ingress_delay(self, delay: Optional[int]) -> None:
        """Set (or clear with ``None``) the all-peer ingress delay stamped
        into each subsequent chunk (0 actively resets the fabric)."""
        self.ingress_delay = None if delay is None else int(delay)

    def _empty_events(self) -> sched.MultiTopicEvents:
        ev = sched.empty_multitopic_events(
            self.chunk_steps, self.model.n, self.pub_width
        )
        if self.ingress_delay is not None:
            ev.delay[0, :] = self.ingress_delay
        return ev

    def _alloc_slot(self, item: IngestItem) -> int:
        slot = self._next_slot[item.topic]
        self._next_slot[item.topic] = (slot + 1) % self.model.m
        stale = self.pending.pop((item.topic, slot), None)
        if stale is not None:
            # Window recycle outran delivery tracking: the old message is
            # closed out as evicted (counted, never silently lost).
            self.evicted += 1
            if self.metrics is not None:
                self.metrics.inc("serve.engine.evicted")
            if self.tracer is not None and stale.chash:
                self.tracer.close(stale.chash, status="evicted")
        return slot

    def _dispatch(self, events: sched.MultiTopicEvents, n_items: int = 0):
        t_start = self._clock()
        # A profiler capture of every profile_every-th chunk (never on
        # warmup chunks) -- the on-chip campaign's free profiler hook.
        do_profile = (
            self.profile_every > 0
            and not self._in_warmup
            and (self.chunks_run + 1) % self.profile_every == 0
        )
        program = _program(self.model, self.chunk_steps, self.pub_width)
        with profiler_trace(self.profile_dir if do_profile else None,
                            self.model.device,
                            f"chunk_{self.chunks_run:06d}.json"):
            self.state, tail = program(self.state, events)
        if do_profile:
            self.profile_captures += 1
        # Exact device rounds (traced runs only): a separate digest over
        # the first-receipt table, queued before the blocking digest read.
        deliver_dev = None
        if self.tracer is not None:
            deliver_dev = self.model.stream_deliver_steps(
                self.state, self.chunk_steps, self.completion_frac)
        digest = self.model.stream_digest(self.state)
        t, m = self.model.t, self.model.m
        counts = _read(torch.cat([digest["delivered"].reshape(-1),
                                  digest["participants"]]))
        t_done = self._clock()
        self.chunks_run += 1
        self.steps_run += self.chunk_steps
        self.last_chunk_wall_s = t_done - t_start
        deliver_steps = (_read(deliver_dev) if deliver_dev is not None
                         else None)
        step = int(digest["step"])
        completed_now = self._fold_completions(
            counts[: t * m].reshape(t, m), counts[t * m:], step, t_done,
            t_start=t_start, deliver_steps=deliver_steps,
        )
        # Flight-recorder tail: the chunk's last round of each telemetry
        # channel, packed into one int32 read.
        self.flight_tail = _read_tail(tail)
        self.flight_tail.setdefault("step", np.asarray(step, np.int32))
        if self.metrics is not None:
            self.metrics.gauge("serve.engine.pending", len(self.pending))
            self.metrics.inc("serve.engine.chunks")
        if self.blackbox is not None:
            acct = self.ring.accounting()
            frame = {
                "chunk": self.chunks_run - 1,
                "step": step,
                "items": n_items,
                "completed_now": completed_now,
                "pending": len(self.pending),
                "queue_depth": acct["in_queue"],
                "chunk_wall_s": self.last_chunk_wall_s,
                "published": self.published,
                "completed": self.completed,
                "evicted": self.evicted,
                "replay_deduped": self.replay_deduped,
                "shed_priority": acct["shed_priority"],
                "dropped_oldest": acct["dropped_oldest"],
                "rejected": acct["rejected"],
                "warmup": self._in_warmup,
            }
            if self.metrics is not None:
                v = self.metrics.latest("crypto.pipeline.verify_s")
                if v is not None:
                    frame["verify_s"] = v
            self.blackbox.record(frame)
        if (
            self.snapshot_every > 0
            and not self._in_warmup
            and self.chunks_run % self.snapshot_every == 0
        ):
            self.snapshot()
        return {
            "chunk": self.chunks_run - 1,
            "items": n_items,
            "completed_now": completed_now,
            "pending": len(self.pending),
            "step": step,
        }

    def _fold_completions(
        self,
        delivered: np.ndarray,
        participants: np.ndarray,
        step_end: int,
        t_done: float,
        t_start: Optional[float] = None,
        deliver_steps: Optional[np.ndarray] = None,
    ) -> int:
        done = 0
        for (topic, slot), p in list(self.pending.items()):
            target = max(1, int(self.completion_frac * participants[topic]))
            if int(delivered[topic, slot]) >= target:
                lat = t_done - p.t_ingest
                if lat < 0.0:
                    # Host clock skew: clamp and count, never report a
                    # negative latency silently.
                    self.clock_anomalies += 1
                    if self.metrics is not None:
                        self.metrics.inc("serve.engine.clock_anomalies")
                    lat = 0.0
                self.latencies_s.append(lat)
                if self.tracer is not None:
                    # Exact delivery time: the chunk-boundary stamp pulled
                    # back to the message's device round, interpolated
                    # inside this chunk's host wall window.
                    t_exact = t_done
                    r = -1
                    if deliver_steps is not None and t_start is not None:
                        r = int(deliver_steps[topic, slot])
                        if r >= 0:
                            r_local = min(
                                max(r - (step_end - self.chunk_steps), 0),
                                self.chunk_steps - 1,
                            )
                            t_exact = t_start + (
                                (r_local + 1) / self.chunk_steps
                            ) * (t_done - t_start)
                    lat_exact = min(max(0.0, t_exact - p.t_ingest), lat)
                    self.latencies_exact_s.append(lat_exact)
                    if p.chash:
                        self.tracer.stamp(
                            p.chash, "device_delivery", t=t_exact,
                            round=r, lat_s=lat_exact, lat_chunk_s=lat,
                        )
                        self.tracer.close(p.chash, t=t_exact)
                self.completed += 1
                if p.chash:
                    if p.chash in self._completed_hashes:
                        self.duplicate_completions += 1
                        if self.metrics is not None:
                            self.metrics.inc("serve.engine.duplicates")
                    self._completed_hashes.add(p.chash)
                del self.pending[(topic, slot)]
                done += 1
        if done and self.metrics is not None:
            self.metrics.inc("serve.engine.completed", done)
        return done
