"""Live host plane: the dissemination-tree protocol over real sockets.

This is SURVEY.md §7 step 6 — the DCN-side twin of the device-resident sim
engine (``ops/tree.py``).  It speaks the byte-compatible JSON wire protocol
(:mod:`..wire`) over :mod:`.transport` streams and implements the same
protocol state machine the reference implements with goroutines:

- admit/redirect           ``handleJoin``/``redirectJoin`` (``subtree.go:106-194``)
- join walk                ``joinToPeer``/``joinParents`` (``subtree.go:196-307``)
- fan-out                  ``forwardMessage`` (``subtree.go:319-354``) — but
  concurrent via ``asyncio.gather`` (the reference's ``// TODO: in parallel``,
  ``subtree.go:325``, done)
- repair                   ``redistributeChildren`` (``subtree.go:356-375``)
- receive loop             ``processMessages`` (``client.go:100-132``) with
  pause/adopt/resume (``client.go:105-122``)

Deliberate deviations from reference bugs (SURVEY.md §2.4), mirrored from the
sim engine so both planes behave identically:

- §2.4.3  ``State.NumPeers`` carries the *real* subtree size (the reference
  never increments ``sub.size`` so always reports 0).  The wire formula
  ``parent_size = NumPeers + 1`` is preserved, so a Go peer interprets our
  States correctly.
- §2.4.4  ``State.Peers`` carries the sender's *full* direct-children list
  (the reference sends only the newest grandchild, so repair loses earlier
  ones).  A Go parent doing ``c.children = m.Peers`` gets strictly better data.
- §2.4.5  all-children-dead admits instead of nil-dereferencing.
- §2.4.6  ``Topic.close_tree`` tears the tree down; plain ``close`` keeps the
  reference's leaky behavior for parity.
- §2.4.7  admission is serialized by an asyncio lock on *every* path
  (the reference skips the lock on the Part-repair path).
- §2.4.8  repair timeout triggers an implemented rejoin-at-root instead of
  ``panic("not yet implemented")`` (``client.go:96-98``).
- §2.4.10 fanout params received in welcomes are validated
  (``TreeOpts.validated_from_wire``) instead of adopted blind.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..config import SUB_REPAIR_TIMEOUT_S, DELIVERY_BUFFER, RetryOpts, TreeOpts
from ..crypto.pipeline import Envelope, ValidationPipeline, sign_envelope
from ..obs.spans import SpanLedger, live_span_key
from ..utils.log import get_logger, kv
from ..utils.metrics import MetricsRegistry
from ..wire import Message, MessageType
from .policy import LiveCallTimeout, RetryPolicy
from .transport import LiveHost, Peerstore, Stream, StreamClosed

MAX_JOIN_HOPS = 64  # bound on the redirect walk (reference: unbounded recursion)

# The host plane's structured logger (the go-log "pubsub" analog, §5.5):
# protocol events — join admission/redirect, child drops, repair adoptions,
# rejoins — log here with key=value fields; per-message publish stays at
# DEBUG so the data plane never pays formatting at INFO.
_log = get_logger("live")


class _BatchValidator:
    """Batched signature validation for one subscription's receive loop.

    The live-plane realization of :class:`ValidationPipeline`'s batch
    amortization — the component the reference left as ``// TODO: add
    signature`` (``pubsub.go:117``).  The receive loop
    ``submit``s each Data frame and keeps reading; a single flusher task
    verifies everything queued since the last flush in ONE pipeline call,
    run in an executor thread so the event loop (and therefore the socket
    reads that feed the next batch) never blocks on curve arithmetic.  Under
    burst load batches grow naturally; when idle a message verifies alone
    with no added latency.  Verdicts are consumed strictly in arrival order,
    preserving FIFO delivery.

    A verdict gates BOTH delivery and relay: an envelope that fails
    structural screening (not parseable, wrong topic, non-monotonic seqno)
    or signature verification is dropped and never forwarded to children —
    invalid traffic dies one hop from where it entered.
    """

    def __init__(
        self,
        sub: "LiveSubscription",
        topic: str,
        backend: str,
        max_pending: int = 512,
        device="cuda",
    ) -> None:
        self.sub = sub
        self.topic = topic
        # flush_threshold is effectively infinite: cadence is owned by the
        # flusher task, not by queue depth.
        # ``device`` is where the "device" backend verifies: kernel E1 on
        # a card; the plain version only when the caller passes "cpu".
        self.pipeline = ValidationPipeline(
            backend=backend, flush_threshold=1 << 30, device=device)
        self.max_pending = max_pending
        self._queue: List = []  # (Message, Envelope | None) in arrival order
        self._task: Optional[asyncio.Task] = None
        self._space = asyncio.Event()
        self._space.set()
        self.rejected_structural = 0
        self.rejected_signature = 0
        self.last_seqno = -1

    async def submit(self, m: Message) -> None:
        """Queue one Data frame for verification (backpressure-bounded)."""
        await self._space.wait()
        env: Optional[Envelope] = None
        try:
            env = Envelope.from_wire(m.data)
        except Exception:
            env = None  # not an envelope at all
        if env is not None and (
            env.topic != self.topic
            or len(env.pubkey) != 32
            or len(env.signature) != 64
        ):
            env = None  # wrong-topic replay or truncated authenticator
        self._queue.append((m, env))
        if len(self._queue) >= self.max_pending:
            self._space.clear()
        if self._task is None or self._task.done():
            self._task = self.sub.tm.host.spawn(self._flush_loop())

    async def _flush_loop(self) -> None:
        loop = asyncio.get_event_loop()
        while self._queue:
            batch, self._queue = self._queue, []
            self._space.set()
            envs = [e for _, e in batch if e is not None]
            for e in envs:
                self.pipeline.submit(e)
            try:
                results = (
                    await loop.run_in_executor(None, self.pipeline.flush)
                    if envs
                    else []
                )
            except Exception:
                # Backend infrastructure failure: the pipeline re-queued its
                # envelopes internally; drop that requeue (we still hold the
                # frames) and put the batch back at the head of our queue so
                # the next flush re-pairs every frame with its own verdict —
                # nothing is lost and later batches cannot misalign against
                # leftover verdicts.
                self.pipeline.drop_pending()
                self._queue = batch + self._queue
                raise
            # Match verdicts by envelope identity, never by position: a
            # partial failure path that leaves the pipeline and this loop
            # holding different batch views must fail closed (missing
            # verdict == rejected), not shift credit across envelopes.
            verdicts = {id(e): ok for e, ok in results}
            for m, env in batch:
                if env is None:
                    self.rejected_structural += 1
                    continue
                ok = verdicts.get(id(env), False)
                # Monotonic-seqno replay guard: the tree delivers FIFO from a
                # single root, so a valid stream is strictly increasing; a
                # replayed (or cross-captured) envelope arrives late and out
                # of order and is dropped here even though its signature
                # verifies.
                if not ok:
                    self.rejected_signature += 1
                    continue
                if env.seqno <= self.last_seqno:
                    # A repair replay of an envelope this subscriber already
                    # consumed is expected traffic, not a replay attack.
                    if not m.replay:
                        self.rejected_structural += 1
                    continue
                self.last_seqno = env.seqno
                await self.sub.out.put(env.payload)
                self.sub.node.trace_stamp(m, "deliver", seqno=env.seqno)
                await self.sub.node.forward_message(m)


@dataclass
class _Child:
    """Per-child bookkeeping (``child``, ``subtree.go:36-44``)."""

    stream: Stream
    size: int = 1              # subtree size incl. the child itself
    child_ids: List[str] = field(default_factory=list)  # its direct children
    dead: bool = False
    # Forward-log index at admission: forwards with idx >= this reached the
    # child directly, earlier ones predate it (the repair-replay boundary).
    admitted_fwd_idx: int = 0


# Repair-replay window: how many recent DATA forwards a node keeps for
# re-sending to a re-adopted orphan.  Repair completes within a few dials
# (milliseconds-to-seconds); 32 messages of history covers any plausible
# number of publishes inside that window at a bounded memory cost.
FWD_LOG_CAP = 32

# Replay-dedup window at each subscriber: payload digests of the most
# recently seen Data frames.  Must be >= FWD_LOG_CAP so no replayed frame
# can outlive the memory of its original delivery.
SEEN_DATA_CAP = 256

# Failover bookkeeping bounds: how many ranked successors ride on each
# Update (the root's direct children, admission-ordered) and how large the
# piggybacked two-level roster (children + reported grandchildren) may
# grow.  Both lists are advisory state pushed down the tree, not the tree
# itself, so capping them bounds frame size without losing safety — a
# member beyond the caps still heals through the normal join walk.
SUCCESSOR_CAP = 8
ROSTER_CAP = 64

# How long a parked (degraded read-only) successor sleeps between re-probe
# rounds while it waits for its partition to heal.
PARK_RETRY_S = 0.25


class _TreeNode:
    """Shared subtree state machine for roots and subscribers
    (``subtree``, ``subtree.go:16-34``)."""

    def __init__(
        self,
        host: LiveHost,
        protoid: str,
        opts: TreeOpts,
        repair_timeout_s: float = SUB_REPAIR_TIMEOUT_S,
        metrics: Optional[MetricsRegistry] = None,
        retry: Optional[RetryPolicy] = None,
        ledger: Optional[SpanLedger] = None,
    ) -> None:
        self.host = host
        self.protoid = protoid
        self.width = opts.tree_width
        self.max_width = opts.tree_max_width
        self.repair_timeout_s = repair_timeout_s
        self.metrics = metrics  # shared registry (the /metrics counters)
        # Per-host span ledger (r19 distributed tracing, obs/merge.py).
        # None means tracing off: every stamp site below is guarded so the
        # untraced plane stays bit- and counter-identical to r18.
        self.ledger = ledger
        # Every dial-shaped operation (subscribe dial, join-walk hops,
        # adoption dials, rejoin-at-root) runs under this policy; shared per
        # topic manager so breaker state is per (host, operation class).
        self.retry = retry if retry is not None else RetryPolicy(registry=metrics)
        self.children: Dict[str, _Child] = {}
        # Repair-replay log: the last FWD_LOG_CAP DATA messages this node
        # fanned out, tagged with a monotone index.  Index assignment (in
        # ``forward_message``) and admission stamping (in ``handle_join``)
        # both happen in event-loop-synchronous sections, so "forwarded
        # before this child was admitted" is a total order — the replay in
        # ``_redistribute`` can be exact: no loss, no duplicates.
        self._fwd_log: List[Tuple[int, Message]] = []
        self._fwd_idx = 0
        self.chlock = asyncio.Lock()  # chlock (subtree.go:18) — held on ALL
        # admission paths, fixing the reference's unlocked Part path (§2.4.7)
        self.parent_stream: Optional[Stream] = None
        self.pause: asyncio.Queue = asyncio.Queue(maxsize=4)  # repair handoff
        self.root_id: Optional[str] = None  # for rejoin-at-root
        self.closed = False
        # -- failover state (epoch fencing + successor election) ------------
        # ``epoch`` 0 is the whole pre-failover regime (omitted on the wire
        # for byte parity); each successor promotion increments it and
        # every node rejects Data/Update frames fenced below its own epoch.
        self.epoch = 0
        self.is_root = False        # True on LiveTopic nodes and post-promotion
        self.degraded = False       # parked minority successor (read-only)
        # Advisory state pushed down by the root on Update frames: the
        # ranked successor list and the two-level membership roster the
        # quorum check reads.
        self.successors: List[str] = []
        self.roster: List[str] = []
        self._last_roster_bcast: Optional[tuple] = None
        # Durable topic state (utils/checkpoint.save_topic_state): written on
        # epoch/roster transitions when a path is configured.
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_meta: Dict[str, int] = {}
        self._ckpt_lock = asyncio.Lock()

    def _inc(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value)

    def trace_stamp(self, m: Message, stage: str, **attrs) -> None:
        """Hop-level span stamp for a traced Data frame.  The key is
        computed from (protoid, payload) — identical on every host the
        frame crosses, so per-host ledgers line up with no id exchange —
        and memoized on the frame: a host stamps the same Message object
        at recv, deliver, and forward, and the sha256 runs on the shared
        event-loop thread, so one hash per frame per host matters.
        A no-op unless tracing is on AND the origin marked the frame."""
        if self.ledger is None or not m.traced:
            return
        key = m.span_key
        if key is None:
            key = live_span_key(self.protoid, m.data)
            m.span_key = key
        self.ledger.stamp(
            key, stage, **attrs
        )

    async def dial_retry(self, peer_id: str, cls: str = "dial",
                         max_attempts: Optional[int] = None) -> Stream:
        """Dial under the retry policy, with the attempt accounted to
        ``cls`` (``live.retry.<cls>.*`` counters)."""
        return await self.retry.run(
            cls,
            lambda: self.host.new_stream(peer_id, self.protoid),
            max_attempts=max_attempts,
        )

    # -- accounting ----------------------------------------------------------

    def subtree_size(self) -> int:
        """Real size of my subtree incl. self (fixes §2.4.3)."""
        return 1 + sum(c.size for c in self.children.values() if not c.dead)

    def live_child_ids(self) -> List[str]:
        return [cid for cid, c in self.children.items() if not c.dead]

    # -- failover: epoch fencing + successor/roster propagation --------------

    def successor_list(self) -> List[str]:
        """Rank-ordered successor list: my live direct children in admission
        order (dict insertion order IS admission order).  Deterministic at
        every subscriber, so all survivors converge on the same #1."""
        return self.live_child_ids()[:SUCCESSOR_CAP]

    def roster_list(self) -> List[str]:
        """Two-level membership view: direct children plus their reported
        children (State frames carry the full grandchild list, §2.4.4).
        With ``tree_width=2`` the direct children alone are far too few to
        be a meaningful electorate; two levels are what the root actually
        knows without new protocol traffic."""
        roster: List[str] = []
        for cid, c in self.children.items():
            if c.dead:
                continue
            if cid not in roster:
                roster.append(cid)
            for gid in c.child_ids:
                if gid not in roster:
                    roster.append(gid)
        return roster[:ROSTER_CAP]

    def adopt_epoch(self, epoch: int, why: str) -> None:
        """Move forward to a higher epoch (higher always wins)."""
        if epoch <= self.epoch:
            return
        self._inc("live.failover.epoch_adopted")
        _log.info(
            "epoch_adopted",
            extra=kv(peer=self.host.id, epoch=epoch, prev=self.epoch, why=why),
        )
        self.epoch = epoch

    def fence_frame(self, m: Message) -> bool:
        """Epoch fence: True iff the frame may be processed.  A frame fenced
        below my epoch is a zombie — traffic from a root (or relay chain)
        that was deposed by a promotion — and is dropped so a returning
        stale root cannot fork the tree.  A higher epoch is adopted: frames
        only flow root-down, so the sender is ahead of me, not stale."""
        if self.epoch and m.epoch < self.epoch:
            self._inc("live.failover.stale_epoch_rejected")
            return False
        if m.epoch > self.epoch:
            self.adopt_epoch(m.epoch, why="frame")
        return True

    def absorb_update(self, m: Message) -> None:
        """Record successor/roster state piggybacked on an Update frame
        (welcome or mid-stream roster broadcast).  Caller fences first."""
        if m.successors:
            self.successors = list(m.successors)
        if m.roster:
            self.roster = list(m.roster)

    async def roster_changed(self) -> None:
        """Root-only: membership moved — recompute the successor list and
        roster, push them down the tree on an Update frame, and checkpoint.
        Deduplicated against the last broadcast so State-driven calls are
        cheap no-ops when nothing actually changed."""
        if not self.is_root or self.closed:
            return
        succ, roster = self.successor_list(), self.roster_list()
        snap = (self.epoch, tuple(succ), tuple(roster))
        if snap == self._last_roster_bcast:
            return
        self._last_roster_bcast = snap
        self.successors, self.roster = succ, roster
        self._inc("live.failover.roster_broadcast")
        await self.forward_message(Message(
            type=MessageType.UPDATE,
            epoch=self.epoch,
            successors=succ,
            roster=roster,
        ))
        await self.save_checkpoint()

    async def save_checkpoint(self) -> None:
        """Write durable topic state ``{epoch, seq, successors, roster,
        children}`` via the atomic temp+fsync+rename path.  File I/O runs in
        an executor so the event loop (and the socket reads behind it) never
        blocks on disk; the lock serializes writers so a slow disk cannot
        interleave two snapshots."""
        if self.checkpoint_path is None or self.closed:
            return
        from ..utils import checkpoint as _ckpt

        state = {
            "epoch": self.epoch,
            "successors": list(self.successors),
            "roster": list(self.roster),
            "children": self.live_child_ids(),
            **self.checkpoint_meta,
        }
        loop = asyncio.get_event_loop()
        async with self._ckpt_lock:
            await loop.run_in_executor(
                None, _ckpt.save_topic_state, self.checkpoint_path, state
            )
        self._inc("live.failover.checkpointed")

    def load_checkpoint(self) -> bool:
        """Restore durable topic state if a checkpoint exists; returns
        whether one was loaded.  A restarted host re-enters at its saved
        epoch, so it refuses welcomes from (and is fenced out of) any tree
        regime older than the one it last saw."""
        if self.checkpoint_path is None or not os.path.exists(self.checkpoint_path):
            return False
        from ..utils import checkpoint as _ckpt

        state = _ckpt.load_topic_state(self.checkpoint_path)
        self.epoch = int(state.get("epoch", 0))
        self.successors = list(state.get("successors", []))
        self.roster = list(state.get("roster", []))
        for k in ("seq",):
            if k in state:
                self.checkpoint_meta[k] = int(state[k])
        self._inc("live.failover.resumed")
        _log.info(
            "checkpoint_resumed",
            extra=kv(peer=self.host.id, epoch=self.epoch,
                     successors=len(self.successors)),
        )
        return True

    async def notify_parent_state(self) -> None:
        """Upward accounting (``subtree.go:137-146``), with real size and the
        full children list (§2.4.3/§2.4.4).  ``num_peers`` excludes self so
        the receiver's ``size = NumPeers + 1`` lands on the true size."""
        s = self.parent_stream
        if s is None or s.closed:
            return
        try:
            await s.write_message(
                Message(
                    type=MessageType.STATE,
                    num_peers=self.subtree_size() - 1,
                    peers=self.live_child_ids(),
                )
            )
        except StreamClosed:
            pass  # parent death is handled by the read loop

    # -- admission (server side of the join walk) ----------------------------

    async def handle_join(self, s: Stream, prio: bool,
                          want_replay: bool = False) -> None:
        """Admit or redirect a joiner (``handleJoin``, ``subtree.go:106-154``).

        Caller must hold ``chlock`` — enforced by the two call sites
        (stream handlers and repair), unlike the reference's Part path.

        ``want_replay`` is the wire ``replay`` flag carried on the Join: a
        recovering member (post-failover rejoin, partition heal) asks for
        the admitter's whole retained forward-log window right after the
        welcome; content-hash dedup at the receiver absorbs the overlap.
        """
        width = self.max_width if prio else self.width
        live = self.live_child_ids()
        if len(live) >= width and live:
            await self._redirect_join(s, live)
            return
        # Admit: welcome Update names me as parent + fanout params
        # (subtree.go:121-128), plus the failover piggyback: my epoch and
        # the successor/roster view (the root computes its own; interior
        # nodes relay what the root last broadcast).  All three serialize
        # only when nonzero/nonempty, so a pristine tree's welcome stays
        # byte-identical to the reference encoder.
        succ = self.successor_list() if self.is_root else list(self.successors)
        roster = self.roster_list() if self.is_root else list(self.roster)
        try:
            await s.write_message(
                Message(
                    type=MessageType.UPDATE,
                    peers=[self.host.id],
                    tree_width=self.width,
                    tree_max_width=self.max_width,
                    epoch=self.epoch,
                    successors=succ,
                    roster=roster,
                )
            )
        except StreamClosed:
            return
        # Re-admission of an existing child (e.g. its rejoin raced our repair
        # dial): retire the stale record first so its reader task can't later
        # evict the fresh one.
        stale = self.children.pop(s.remote_peer, None)
        if stale is not None:
            stale.dead = True
            stale.stream.close()
        child = _Child(stream=s, admitted_fwd_idx=self._fwd_idx)
        self.children[s.remote_peer] = child
        self._inc("live.join_admitted")
        _log.info(
            "join_admitted",
            extra=kv(
                parent=self.host.id, child=s.remote_peer, prio=prio,
                children=len(self.children),
            ),
        )
        self.host.spawn(self._handle_child_messages(s.remote_peer, child))
        if want_replay:
            # Recovery join: replay everything still retained.  The joiner
            # asked because it cannot know what it missed; dedup on its side
            # drops what it already has (at-least-once wire, exactly-once
            # delivery — same contract as repair replay).
            await self._replay_fwd_log(
                s.remote_peer,
                since=self._fwd_log[0][0] if self._fwd_log else self._fwd_idx,
            )
        await self.roster_changed()
        await self.notify_parent_state()

    async def _redirect_join(self, s: Stream, live: List[str]) -> None:
        """Load-balancing redirect to the min-size live child
        (``redirectJoin``, ``subtree.go:156-194``)."""
        minc = min(live, key=lambda cid: self.children[cid].size)
        # The reference pre-increments the chosen child's size so consecutive
        # redirects spread (subtree.go:176-178); sizes here are corrected by
        # the next real State, so the increment is the same heuristic.
        self.children[minc].size += 1
        self._inc("live.join_redirected")
        _log.info(
            "join_redirected",
            extra=kv(parent=self.host.id, child=s.remote_peer, to=minc),
        )
        try:
            # epoch rides along (omitted at 0) so a post-failover joiner's
            # welcome fence doesn't mistake a current-regime redirect for a
            # zombie frame.
            await s.write_message(Message(
                type=MessageType.UPDATE, peers=[minc], epoch=self.epoch,
            ))
        except StreamClosed:
            pass
        s.close()

    async def _handle_child_messages(self, cid: str, child: _Child) -> None:
        """Per-child upward reader (``handleChildMessages``,
        ``subtree.go:46-76``): State updates accounting, Part (or stream
        death) triggers redistribution."""
        try:
            while True:
                m = await child.stream.read_message()
                if m.type == MessageType.STATE:
                    child.size = m.num_peers + 1  # wire formula (subtree.go:59)
                    child.child_ids = list(m.peers)
                    # Grandchild set moved: the roster may have too (dedup'd
                    # inside roster_changed, so unchanged States are free).
                    await self.roster_changed()
                    await self.notify_parent_state()
                elif m.type == MessageType.PART:
                    await self._drop_child(cid, child)
                    return
                # Data/Join/Update from a child are protocol violations; the
                # reference logs and ignores (subtree.go:71-73).
        except asyncio.CancelledError:
            raise  # host teardown: do NOT run repair on a dying node
        except StreamClosed:
            if not self.closed and not child.dead:
                # Abrupt child death seen as read error: repair now instead of
                # waiting for the next publish's write error.  Same observable
                # contract (loss windows only shrink).
                await self._drop_child(cid, child)

    async def _drop_child(self, cid: str, child: _Child) -> None:
        child.dead = True
        child.stream.close()
        # Identity check: only remove/redistribute if this record is still the
        # current one — a stale reader task must not evict a re-admitted child.
        if self.children.get(cid) is not child:
            return
        del self.children[cid]
        self._inc("live.child_dropped")
        _log.info(
            "child_dropped",
            extra=kv(
                parent=self.host.id, child=cid,
                orphans=len(child.child_ids),
            ),
        )
        # Replay horizon: everything fanned out since the DEAD child was
        # admitted.  A write into a dying socket can "succeed" into the TCP
        # buffer and vanish, so the last confirmed-delivered message is
        # unknowable — replay the whole uncertainty window and let the
        # replay-flag dedup at the receivers drop what actually arrived.
        await self._redistribute(child.child_ids, since=child.admitted_fwd_idx)
        await self.roster_changed()
        await self.notify_parent_state()

    async def _redistribute(self, grandchild_ids: List[str],
                            requeued: bool = False,
                            since: Optional[int] = None) -> None:
        """Re-adopt a dead child's children with priority capacity
        (``redistributeChildren``, ``subtree.go:356-375``) — all of them, not
        just the newest (§2.4.4).

        Adoption dials run under the retry policy; orphans whose dials
        exhaust it are re-queued for one deferred pass before the orphan's
        own repair-timeout rejoin takes over — an unreachable orphan costs
        retries, never a silently stranded subtree.

        ``since`` is the forward-log index from which delivery through the
        dead parent is uncertain (its own admission point): everything
        logged in [since, orphan re-admission) is replayed to the fresh
        child right after the welcome, marked with the wire ``replay`` flag
        so receivers can drop what the dead parent did deliver."""
        missed: List[str] = []
        for gid in grandchild_ids:
            if self.closed or gid == self.host.id or gid in self.live_child_ids():
                continue
            try:
                s = await self.dial_retry(gid, cls="adopt")
            except (StreamClosed, KeyError):
                if requeued:
                    self._inc("live.orphan_abandoned")
                else:
                    missed.append(gid)
                continue
            async with self.chlock:
                # Re-check liveness AFTER the dial completed: the orphan may
                # have rejoined — on its own, or via a concurrent repair —
                # while we dialed/backed off, and admitting this stream too
                # would double-adopt it.  Part tells it this adoption lost.
                if self.closed or gid in self.live_child_ids():
                    try:
                        await s.write_message(Message(type=MessageType.PART))
                    except StreamClosed:
                        pass
                    s.close()
                    continue
                self._inc("live.repair_adopted")
                _log.info(
                    "repair_adopted",
                    extra=kv(parent=self.host.id, grandchild=gid),
                )
                await self.handle_join(s, prio=True)
                if since is not None:
                    await self._replay_fwd_log(gid, since)
        if missed and not self.closed:
            self._inc("live.orphans_requeued", len(missed))
            self.host.spawn(self._deferred_redistribute(missed, since))

    async def _replay_fwd_log(self, cid: str, since: int) -> None:
        """Close the repair loss window: re-send the DATA messages whose
        delivery through the dead parent is uncertain to the just-admitted
        child.  Caller holds ``chlock``; the new child's ``admitted_fwd_idx``
        bounds the replay above (anything after it reaches the child through
        the normal fan-out), and the wire ``replay`` flag lets every receiver
        drop copies it already has — at-least-once on the wire, exactly-once
        at delivery."""
        child = self.children.get(cid)
        if child is None or child.dead:
            return
        # Re-stamp replayed frames with MY epoch: logged frames may predate
        # a promotion (epoch 0/old), and receivers already at the new epoch
        # would fence them out even though the content is legitimate.
        pending = [
            dataclasses.replace(
                m, replay=True, epoch=self.epoch if self.epoch else m.epoch
            )
            for i, m in self._fwd_log
            if since <= i < child.admitted_fwd_idx
        ]
        for m in pending:
            self.trace_stamp(m, "replay_send", to=cid)
            try:
                await child.stream.write_message(m)
            except StreamClosed:
                return  # the fresh child died too: the next repair's problem
        if pending:
            self._inc("live.repair_replayed", len(pending))

    async def _deferred_redistribute(self, gids: List[str],
                                     since: Optional[int] = None) -> None:
        """Second-chance pass for orphans whose adoption dials exhausted the
        retry budget — scheduled well inside the repair window so a slow
        restart is re-adopted here instead of falling back to rejoin."""
        await asyncio.sleep(min(1.0, self.repair_timeout_s / 2))
        if not self.closed:
            await self._redistribute(gids, requeued=True, since=since)

    # -- data plane ----------------------------------------------------------

    async def forward_message(self, m: Message) -> None:
        """Fan out to all live children **concurrently** (``forwardMessage``,
        ``subtree.go:319-354``, with the ``TODO: in parallel`` done).  Write
        failures mark children dead; their recorded children are re-adopted."""
        # Log + index the fan-out in the same synchronous section that
        # snapshots the target set: the repair replay relies on "admitted
        # before/after forward i" being a total order.
        if m.type == MessageType.DATA:
            self._fwd_log.append((self._fwd_idx, m))
            self._fwd_idx += 1
            if len(self._fwd_log) > FWD_LOG_CAP:
                del self._fwd_log[0]
        targets = [(cid, c) for cid, c in self.children.items() if not c.dead]
        if not targets:
            return
        if m.type == MessageType.DATA:
            self.trace_stamp(m, "send", fanout=len(targets))

        async def send(c: _Child):
            await c.stream.write_message(m)

        results = await asyncio.gather(
            *(send(c) for _, c in targets), return_exceptions=True
        )
        dead = [tc for tc, r in zip(targets, results) if isinstance(r, Exception)]
        # Mark ALL failed children dead before redistributing any of them:
        # otherwise the first redistribution's redirect walk can pick a
        # sibling that also just failed this gather but is not yet marked,
        # stranding the grandchild on a dead parent until repair timeout.
        for _, c in dead:
            c.dead = True
        for cid, c in dead:
            self._inc("live.forward_write_failed")
            # _drop_child's identity check also makes this a no-op when the
            # child's own reader task already dropped (and redistributed) it.
            # Its repair replays the forward log (this message included) to
            # the re-adopted grandchildren, so the fan-out that exposed the
            # death costs the orphan subtree nothing.
            await self._drop_child(cid, c)

    # -- join walk (client side) ---------------------------------------------

    async def join_to_peer(self, s: Stream, want_replay: bool = False) -> Stream:
        """Dial-side join (``joinToPeer``, ``subtree.go:196-226``): send Join,
        adopt validated fanout params from the welcome, walk redirects.
        ``want_replay`` marks the Join as a recovery (failover rejoin /
        partition heal): the eventual admitter replays its retained window."""
        await s.write_message(Message(type=MessageType.JOIN, replay=want_replay))
        welcome = await s.read_message()
        if welcome.tree_width and welcome.tree_max_width:
            # §2.4.10: validate instead of adopting blind (subtree.go:211-213).
            opts = TreeOpts.validated_from_wire(
                welcome.tree_width, welcome.tree_max_width
            )
            self.width, self.max_width = opts.tree_width, opts.tree_max_width
        return await self._join_parents(s, welcome, hops=0,
                                        want_replay=want_replay)

    async def _join_parents(self, s: Stream, welcome: Message, hops: int,
                            want_replay: bool = False) -> Stream:
        """Redirect walk (``joinParents``, ``subtree.go:241-307``): try each
        candidate parent; a welcome naming the sender means accepted, anything
        else is a further redirect."""
        if hops > MAX_JOIN_HOPS:
            raise StreamClosed("join walk exceeded max hops")
        # Epoch fence on the welcome itself: a candidate parent still living
        # in a deposed epoch is a zombie subtree — attaching under it would
        # fork the tree.  Refuse the whole welcome (its candidate list is
        # the same stale regime) and let the caller try the next successor.
        if self.epoch and welcome.epoch < self.epoch:
            self._inc("live.failover.stale_epoch_rejected")
            s.close()
            raise StreamClosed(
                f"stale-epoch welcome ({welcome.epoch} < {self.epoch}) "
                f"from {s.remote_peer}"
            )
        last_err: Optional[Exception] = None
        candidates = welcome.peers
        if self.host.peerstore.validate_ids:
            # translPeerIDs boundary (subtree.go:228-239): drop malformed
            # base58 ids from the wire-carried candidate list before dialing.
            from ..utils.base58 import transl_peer_ids

            candidates = transl_peer_ids(candidates)
        for cand in candidates:
            if cand == s.remote_peer:
                # The sender admitted me: adopt its epoch and failover view,
                # reuse this stream.
                if welcome.epoch > self.epoch:
                    self.adopt_epoch(welcome.epoch, why="welcome")
                self.absorb_update(welcome)
                return s
            try:
                # Two attempts per candidate: the walk itself is the outer
                # retry (next candidate), so per-hop budget stays small.
                cs = await self.dial_retry(cand, cls="join", max_attempts=2)
                await cs.write_message(
                    Message(type=MessageType.JOIN, replay=want_replay)
                )
                w2 = await cs.read_message()
                if w2.type != MessageType.UPDATE:
                    cs.close()
                    continue
                return await self._join_parents(cs, w2, hops + 1,
                                                want_replay=want_replay)
            except (StreamClosed, KeyError) as e:
                last_err = e
                continue
        s.close()
        raise StreamClosed(f"could not join any candidate parent: {last_err}")

    async def drain_stale_adoptions(self) -> None:
        """Close adoption streams that lost the race with another repair (or
        with rejoin-at-root), sending Part so the would-be adopter drops its
        child record cleanly.  No State ever flowed on these streams, so the
        adopter's record has no grandchildren and its redistribute is a
        no-op — nothing gets double-adopted."""
        while True:
            try:
                s = self.pause.get_nowait()
            except asyncio.QueueEmpty:
                return
            try:
                await s.write_message(Message(type=MessageType.PART))
            except StreamClosed:
                pass
            s.close()

    # -- teardown ------------------------------------------------------------

    async def close(self) -> None:
        """Graceful leave (``subtree.Close``, ``subtree.go:78-98``): close
        child streams, Part upstream."""
        self.closed = True
        for c in self.children.values():
            c.stream.close()
        self.children.clear()
        s = self.parent_stream
        if s is not None and not s.closed:
            try:
                await s.write_message(Message(type=MessageType.PART))
            except StreamClosed:
                pass
            s.close()


class LiveTopic:
    """Root-side topic over the live plane (``Topic``, ``pubsub.go:33-120``)."""

    def __init__(
        self,
        tm: "LiveTopicManager",
        title: str,
        opts: TreeOpts,
        signer_seed: Optional[bytes] = None,
        checkpoint_path: Optional[str] = None,
    ):
        self.tm = tm
        self.title = title
        self.protoid = f"{tm.host.id}/{title}"  # (root, title) namespacing
        self.node = _TreeNode(
            tm.host, self.protoid, opts, metrics=tm.registry, retry=tm.retry,
            ledger=tm.ledger,
        )
        self.node.is_root = True
        # Publisher identity: with a seed, every publish travels as a signed
        # Envelope (crypto/pipeline) inside the Data frame — the fix for the
        # reference's `// TODO: add signature` (pubsub.go:117).
        self.signer_seed = signer_seed
        self._seqno = 0
        # Durable topic state: with a path, {epoch, seq, successors, roster}
        # persists across restarts (atomic temp+fsync+rename), so a
        # restarted root re-enters at the epoch it last saw instead of
        # resurrecting a stale regime.  NOTE: re-occupying the old tree also
        # requires a stable peer identity (the validate_ids regime, where
        # ids derive from keys) — with throwaway ids the checkpoint still
        # protects the epoch/seq counters.
        self.node.checkpoint_path = checkpoint_path
        if self.node.load_checkpoint():
            self._seqno = self.node.checkpoint_meta.get("seq", 0)
        tm.host.set_stream_handler(self.protoid, self._stream_handler)

    async def _stream_handler(self, s: Stream) -> None:
        """Root inbound streams must open with Join (``pubsub.go:74-92``)."""
        try:
            m = await s.read_message()
        except StreamClosed:
            return
        if m.type != MessageType.JOIN:
            s.close()  # "not a join message" (pubsub.go:81-85)
            return
        async with self.node.chlock:  # AddPeer's chlock (pubsub.go:106-108)
            await self.node.handle_join(s, prio=False, want_replay=m.replay)

    async def publish_message(self, data: bytes) -> None:
        """``PublishMessage`` (``pubsub.go:111-120``).

        With a ``signer_seed``, the payload is wrapped in a signed Envelope
        (topic- and seqno-domain-separated ed25519) so subscribers created
        with ``validate=`` batch-verify before delivering or relaying —
        filling the reference's ``// TODO: add signature`` (pubsub.go:117).
        Without a seed, raw bytes flow exactly as v0's unsigned plane does.
        """
        if self.signer_seed is not None:
            env = sign_envelope(
                self.signer_seed, self.title, self._seqno, data, backend="auto"
            )
            self._seqno += 1
            data = env.to_wire()
        else:
            self._seqno += 1  # unsigned plane: seq is the publish count
        self.node.checkpoint_meta["seq"] = self._seqno
        self.node._inc("live.msgs_published")
        _log.debug(
            "publish",
            extra=kv(topic=self.title, root=self.tm.host.id, bytes=len(data)),
        )
        # Distributed tracing (r19): the ORIGIN decides whether this message
        # is traced — the same deterministic hash-mod sampling every host's
        # ledger applies — and marks the frame so downstream hosts stamp hop
        # spans without rehashing untraced traffic.  The frame also carries
        # this host's clock-offset estimate for the cross-host merge.
        traced, clock_off = False, 0.0
        if self.tm.ledger is not None:
            key = live_span_key(self.protoid, data)
            if self.tm.ledger.sampled(key):
                traced = True
                clock_off = self.tm.trace_clock_offset
                self.tm.ledger.stamp(
                    key, "publish", bytes=len(data), epoch=self.node.epoch,
                )
        # Data carries the current epoch (omitted at 0): post-failover
        # receivers fence out anything a deposed root keeps publishing.
        m = Message(
            type=MessageType.DATA, data=data, epoch=self.node.epoch,
            traced=traced, clock_offset=clock_off,
        )
        if traced:
            m.span_key = key
        await self.node.forward_message(m)

    async def close(self) -> None:
        """Reference-parity close (``pubsub.go:99-103``): unregister only;
        the tree is leaked exactly as the reference leaks it (§2.4.6)."""
        self.tm.host.remove_stream_handler(self.protoid)
        self.tm.topics.pop(self.title, None)

    async def close_tree(self) -> None:
        """Fixed-semantics close: also tear the subtree down."""
        await self.close()
        await self.node.close()


class LiveSubscription:
    """Subscriber session over the live plane (``client``, ``client.go:18-34``)."""

    def __init__(
        self,
        tm: "LiveTopicManager",
        root_id: str,
        title: str,
        repair_timeout_s: float,
        out_buffer: int = DELIVERY_BUFFER,
        validate: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        device="cuda",
    ):
        self.tm = tm
        self.protoid = f"{root_id}/{title}"
        self.node = _TreeNode(
            tm.host,
            self.protoid,
            TreeOpts(),
            repair_timeout_s=repair_timeout_s,
            metrics=tm.registry,
            retry=tm.retry,
            ledger=tm.ledger,
        )
        self.node.root_id = root_id
        # Successors checkpoint too (they may be promoted): a restarted
        # successor re-enters at its saved epoch, so stale-regime welcomes
        # are refused from the very first join walk.
        self.node.checkpoint_path = checkpoint_path
        self.node.load_checkpoint()
        # client.out, cap 16 (client.go:79): a full queue blocks the receive
        # loop — backpressure by design.
        self.out: asyncio.Queue = asyncio.Queue(maxsize=out_buffer)
        self._task: Optional[asyncio.Task] = None
        # validate= names a crypto backend ("native"/"device"/"python"): every
        # Data frame must then be a valid signed Envelope for this topic or it
        # is neither delivered nor relayed.
        self.validator = (
            _BatchValidator(self, title, validate, device=device)
            if validate else None
        )
        # Replay dedup for the unsigned plane: payload digests of recently
        # seen Data frames.  A frame carrying the wire ``replay`` flag whose
        # payload is here already arrived through the dead parent before it
        # died — drop it (no deliver, no relay).  Unflagged duplicates are
        # legitimate application traffic and always flow.  (The signed plane
        # needs none of this: the monotonic-seqno guard already drops
        # re-delivered envelopes.)
        self._seen_data: set = set()
        self._seen_order: deque = deque()

    async def start(self) -> None:
        """The Subscribe flow (``client.go:65-94``)."""
        host = self.tm.host
        s = await self.node.dial_retry(self.node.root_id, cls="dial")
        host.set_stream_handler(self.protoid, self._stream_handler)
        self.node.parent_stream = await self.node.join_to_peer(s)
        await self.node.notify_parent_state()
        self._task = host.spawn(self._process_messages())

    async def _stream_handler(self, s: Stream) -> None:
        """Interior-node inbound control (``client.streamHandler``,
        ``client.go:36-63``): Join -> admit under me; Update -> I was adopted
        by a repairer, hand the new parent stream to the receive loop."""
        try:
            m = await s.read_message()
        except StreamClosed:
            return
        if m.type == MessageType.JOIN:
            async with self.node.chlock:
                await self.node.handle_join(s, prio=False, want_replay=m.replay)
        elif m.type == MessageType.UPDATE:
            ps = self.node.parent_stream
            if self.node.is_root or (ps is not None and not ps.closed):
                # Adoption aimed at a node that is not actually orphaned —
                # a partition hid the live parent from the repairer, or we
                # already promoted.  REFUSE with Part instead of queueing:
                # a parked adoption would leave the adopter a phantom child
                # it believes it repaired, and worse, let a recovering
                # ancestor later be redirect-walked into its own (dark)
                # subtree — a delivery cycle that starves the whole
                # component.  Refused, the cut-off component stays one
                # coherent subtree under its parked head and re-merges as
                # a unit when the partition lifts.
                self.node._inc("live.adoption_refused")
                try:
                    await s.write_message(Message(type=MessageType.PART))
                except StreamClosed:
                    pass
                s.close()
                return
            try:
                ns = await self.node._join_parents(s, m, hops=0)
            except StreamClosed:
                return
            await self.node.pause.put(ns)  # sub.pause handoff (client.go:56)
        else:
            s.close()

    def _remember(self, h: bytes) -> bool:
        """Record a payload digest in the dedup window; False if the digest
        was already present (the frame is a duplicate)."""
        if h in self._seen_data:
            return False
        self._seen_data.add(h)
        self._seen_order.append(h)
        if len(self._seen_order) > SEEN_DATA_CAP:
            self._seen_data.discard(self._seen_order.popleft())
        return True

    async def _process_messages(self) -> None:
        """Receive/relay loop (``processMessages``, ``client.go:100-132``):
        deliver before forwarding; on parent death pause for repair, past
        the deadline rejoin at the root (the reference panics here, §2.4.8),
        and — this build's failover extension — past THAT walk the successor
        list: converge on the highest-ranked reachable successor, promote if
        I am next in line and can reach a quorum of the roster, park
        degraded otherwise."""
        node = self.node
        while not node.closed:
            if node.parent_stream is None:
                return  # promoted to root: the server-side handlers take over
            sender = node.parent_stream.remote_peer
            try:
                m = await node.parent_stream.read_message()
            except StreamClosed:
                if node.closed:
                    return
                node.parent_stream = None
                if node.ledger is not None:
                    # Cross-host failover forensics: when this parent death
                    # turns out to be a root kill, the merge pairs the
                    # earliest parent_lost with the promotion to draw the
                    # recovery gap across the hosts that observed it.
                    node.ledger.event(
                        "parent_lost", parent=sender, epoch=node.epoch,
                    )
                try:
                    # Typed wait: a timeout lands in the registry as
                    # live.retry.repair.timeout before the rejoin fallback.
                    node.parent_stream = await node.retry.wait_for(
                        node.pause.get(), node.repair_timeout_s, cls="repair"
                    )
                except asyncio.TimeoutError:
                    if not await self._rejoin_root():
                        if not await self._failover():
                            # Root unreachable and nothing to fail over to:
                            # this subscription is over, but an adoption may
                            # still race in — Part any queued streams so no
                            # repairer retains us as an unread child.
                            node.closed = True
                            await node.drain_stale_adoptions()
                            return
                # A second repairer (or an adoption racing the rejoin) may
                # have queued another stream: keep the parent we have, Part
                # the losers so no node retains us as an unread child.
                await node.drain_stale_adoptions()
                if node.is_root:
                    return  # promoted: no parent to read from
                await node.notify_parent_state()
                continue
            if m.type == MessageType.DATA:
                # Epoch fence before anything else: zombie-regime traffic is
                # neither delivered, relayed, nor validated.
                if not node.fence_frame(m):
                    continue
                node.trace_stamp(
                    m, "recv", replay=m.replay, epoch=m.epoch,
                    origin_offset=m.clock_offset, **{"from": sender},
                )
                if self.validator is not None:
                    # Verdict-gated path: the batch validator delivers and
                    # relays (in arrival order) only what verifies (its
                    # monotonic-seqno guard is the dedup on this plane).
                    await self.validator.submit(m)
                    continue
                # Content-hash dedup on EVERY Data frame (not just flagged
                # replays): a chaos-duplicated frame, a replay overlap, or a
                # post-heal re-merge all collapse to one delivery.
                if not self._remember(hashlib.sha256(m.data).digest()):
                    node._inc("live.dup_suppressed")
                    continue
                await self.out.put(m.data)        # deliver (client.go:124-127)
                node.trace_stamp(m, "deliver")
                await node.forward_message(m)     # then relay (client.go:130)
            elif m.type == MessageType.UPDATE:
                # Mid-stream Update: the failover piggyback channel — the
                # root's successor/roster broadcast riding down the tree.
                # (The reference ignores mid-stream Updates.)
                if not node.fence_frame(m):
                    continue
                node.absorb_update(m)
                await node.forward_message(m)     # propagate to my subtree
                if node.checkpoint_path is not None:
                    await node.save_checkpoint()

    async def _rejoin_root(self, recover: bool = True) -> bool:
        """``rejoinRoot`` — implemented (vs ``panic``, ``client.go:96-98``).

        The whole dial+walk runs under the retry policy with the repair
        timeout as its deadline: a transiently unreachable root costs
        backoff, not the subscription (the reference-shaped single attempt
        gave up on the first refused dial).  ``recover`` marks the Join
        with the replay flag so the admitter closes the loss window from
        its forward log.  Failure no longer ends the subscription — the
        caller escalates to the successor failover."""
        self.node._inc("live.rejoin_root")
        _log.info(
            "rejoin_root",
            extra=kv(peer=self.tm.host.id, root=self.node.root_id),
        )

        async def _attempt() -> Stream:
            s = await self.tm.host.new_stream(self.node.root_id, self.protoid)
            return await self.node.join_to_peer(s, want_replay=recover)

        try:
            self.node.parent_stream = await self.node.retry.run(
                "rejoin", _attempt, deadline_s=self.node.repair_timeout_s
            )
            return True
        except (StreamClosed, KeyError, OSError, asyncio.TimeoutError):
            return False

    # -- root failover (the §2.4.8 rejoin's missing other half) --------------

    async def _failover(self) -> bool:
        """The root is gone past the rejoin deadline.  Walk the successor
        list the root pushed down before dying: join the highest-ranked
        reachable successor; if every higher rank is unreachable and I am
        next in line, quorum-probe the roster and promote myself; if the
        quorum is unreachable (minority side of a partition), park in
        degraded read-only and keep probing until the partition heals or
        the subscription closes.  Returns False only when there is no
        successor knowledge at all (the pre-failover contract: subscription
        over)."""
        node = self.node
        me = self.tm.host.id
        if not node.successors:
            return False
        node._inc("live.failover.engaged")
        while not node.closed:
            epoch_at_walk = node.epoch
            succs = list(node.successors)
            rank = succs.index(me) if me in succs else None
            ahead = succs if rank is None else succs[:rank]
            for cand in ahead:
                if cand == me:
                    continue
                try:
                    s = await node.dial_retry(
                        cand, cls="failover", max_attempts=2
                    )
                    node.parent_stream = await node.join_to_peer(
                        s, want_replay=True
                    )
                except (StreamClosed, KeyError, OSError, asyncio.TimeoutError):
                    continue
                if node.degraded:
                    node.degraded = False
                    node._inc("live.failover.unparked")
                    self._trace_failover_merged("rejoined_successor")
                node._inc("live.failover.rejoined_successor")
                _log.info(
                    "failover_rejoined",
                    extra=kv(peer=me, parent=cand, epoch=node.epoch),
                )
                return True
            # The walk failed — but did the world move while we walked?  A
            # promotion elsewhere surfaces here as (a) an adoption handoff
            # already queued in pause, or (b) an epoch bump absorbed from a
            # welcome mid-walk (the walk itself then died on stale-epoch
            # welcomes from peers the new roster broadcast hadn't reached
            # yet).  Either way a live regime claimed us: promoting now
            # would mint a second root inside a healthy component.  Take
            # the invitation, or re-walk under the new successor list.
            try:
                ns = node.pause.get_nowait()
            except asyncio.QueueEmpty:
                pass
            else:
                node.parent_stream = ns
                if node.degraded:
                    node.degraded = False
                    self._trace_failover_merged("adopted")
                node._inc("live.failover.adopted")
                _log.info(
                    "failover_adopted", extra=kv(peer=me, epoch=node.epoch)
                )
                return True
            if node.epoch != epoch_at_walk:
                continue
            if rank is not None:
                # I am the highest-ranked successor still standing: promote
                # only with a reachable quorum — split-brain rule: the
                # minority side must never mint an epoch.
                if await self._quorum_reachable():
                    await self._promote()
                    return True
                node._inc("live.failover.quorum_lost")
            # Park: degraded read-only.  Wake on an adoption handoff, else
            # re-probe the root and re-walk the successors next round.
            if not node.degraded:
                node.degraded = True
                node._inc("live.failover.parked")
                if node.ledger is not None:
                    # Park opens the cross-host failover window: the merge
                    # draws the gap from here to the matching merge/heal
                    # event, and every in-flight traced message on this
                    # host carries the annotation.
                    node.ledger.event(
                        "failover_parked", epoch=node.epoch,
                        rank=-1 if rank is None else rank,
                    )
                    node.ledger.annotate_open(
                        "failover_park", epoch=node.epoch,
                    )
                _log.info(
                    "failover_parked",
                    extra=kv(peer=me, epoch=node.epoch, rank=rank),
                )
            try:
                ns = await asyncio.wait_for(node.pause.get(), PARK_RETRY_S)
            except asyncio.TimeoutError:
                pass
            else:
                node.parent_stream = ns
                node.degraded = False
                node._inc("live.failover.unparked")
                self._trace_failover_merged("adopted_while_parked")
                return True
            if await self._probe_root_once():
                return True
        return False

    def _trace_failover_merged(self, how: str) -> None:
        """Close the failover window on this host's ledger: the parked
        (degraded read-only) side rejoined a live regime."""
        node = self.node
        if node.ledger is not None:
            node.ledger.event(
                "failover_merged", how=how, epoch=node.epoch,
            )
            node.ledger.annotate_open("failover_merge", epoch=node.epoch)

    async def _probe_root_once(self) -> bool:
        """One cheap rejoin attempt at the original root (park loop): the
        common heal path — the partition lifts and the root is right there."""
        node = self.node

        async def _attempt() -> Stream:
            s = await self.tm.host.new_stream(node.root_id, self.protoid)
            return await node.join_to_peer(s, want_replay=True)

        ns = await node.retry.probe(
            _attempt, timeout_s=max(2 * PARK_RETRY_S, 0.5), cls="park"
        )
        if ns is None:
            return False
        node.parent_stream = ns
        if node.degraded:
            node.degraded = False
            node._inc("live.failover.unparked")
            self._trace_failover_merged("healed")
        _log.info(
            "failover_healed",
            extra=kv(peer=self.tm.host.id, root=node.root_id, epoch=node.epoch),
        )
        return True

    async def _quorum_reachable(self) -> bool:
        """Probe the roster (minus me and the dead root): promotion needs a
        strict majority of the electorate (roster ∪ me) reachable right now.
        Single-attempt short-timeout probes — a quorum check measures the
        present, it does not retry its way into the past."""
        node = self.node
        me = self.tm.host.id
        electorate = [
            r for r in node.roster if r not in (me, node.root_id)
        ]
        total = len(electorate) + 1           # the electorate includes me
        need = total // 2 + 1                 # strict majority
        if not electorate:
            # No roster beyond myself: a 1-member electorate, quorum of one.
            return True

        async def _probe_one(rid: str) -> bool:
            async def _dial() -> Stream:
                return await self.tm.host.new_stream(rid, self.protoid)

            s = await node.retry.probe(_dial, timeout_s=0.25, cls="probe")
            if s is None:
                return False
            s.close()  # reachability only; the receiver sees EOF and moves on
            return True

        results = await asyncio.gather(*(_probe_one(r) for r in electorate))
        reachable = 1 + sum(results)
        ok = reachable >= need
        node._inc("live.failover.quorum_probe")
        _log.info(
            "quorum_probe",
            extra=kv(peer=me, reachable=reachable, total=total, ok=ok),
        )
        return ok

    async def _promote(self) -> None:
        """Successor #1 with a quorum: become the root.  Bump the epoch
        (fencing out the dead/zombie regime), re-adopt the dead root's
        other direct children with the existing repair machinery, replay
        the forward-log uncertainty window, and broadcast the new regime."""
        node = self.node
        me = self.tm.host.id
        node.epoch += 1
        node.is_root = True
        node.degraded = False
        node.parent_stream = None
        node._inc("live.failover.promoted")
        if node.ledger is not None:
            # Promotion closes the recovery window the earliest parent_lost
            # opened — the merged Chrome trace renders the pair as one
            # annotated gap, graded against the runner's heal_s.
            node.ledger.event("promoted", epoch=node.epoch)
        orphans = [x for x in node.successors if x != me]
        _log.info(
            "promoted",
            extra=kv(peer=me, epoch=node.epoch, orphans=len(orphans)),
        )
        # The dead root's OTHER direct children are the orphaned subtree
        # heads; deeper roster members still hang off live parents and must
        # not be re-dialed (double-parenting).  Replay horizon: the whole
        # retained window — what of it the dead root delivered is unknowable,
        # and receiver-side dedup absorbs the overlap.
        since = node._fwd_log[0][0] if node._fwd_log else node._fwd_idx
        await node._redistribute(orphans, since=since)
        node._last_roster_bcast = None  # force the first new-epoch broadcast
        await node.roster_changed()

    async def publish_message(self, data: bytes) -> None:
        """Publish as a PROMOTED root (epoch >= 1).  The original publisher
        is gone; the tree's data plane continues from the successor.  Only
        the unsigned plane can be resumed this way — signing would need the
        dead root's key, which is exactly what a successor must not have."""
        node = self.node
        if not node.is_root:
            raise RuntimeError(
                "publish_message requires a promoted (root) subscription"
            )
        if self.validator is not None:
            raise RuntimeError(
                "cannot publish on the signed plane from a promoted "
                "successor (the root's signing key died with it)"
            )
        self._remember(hashlib.sha256(data).digest())
        node._inc("live.msgs_published")
        traced, clock_off = False, 0.0
        if self.tm.ledger is not None:
            key = live_span_key(self.protoid, data)
            if self.tm.ledger.sampled(key):
                traced = True
                clock_off = self.tm.trace_clock_offset
                self.tm.ledger.stamp(
                    key, "publish", bytes=len(data), epoch=node.epoch,
                    promoted=True,
                )
        m = Message(
            type=MessageType.DATA, data=data, epoch=node.epoch,
            traced=traced, clock_offset=clock_off,
        )
        if traced:
            m.span_key = key
        await self.out.put(data)  # self-delivery: I am still a subscriber
        node.trace_stamp(m, "deliver")
        await node.forward_message(m)

    async def close(self) -> None:
        """Graceful leave (``client.Close``, ``client.go:30-34``)."""
        self.node.closed = True
        self.tm.host.remove_stream_handler(self.protoid)
        if self._task is not None:
            self._task.cancel()
        if self.validator is not None and self.validator._task is not None:
            self.validator._task.cancel()
        await self.node.close()


class LiveTopicManager:
    """Topic registry on one live host (``TopicManager``, ``pubsub.go:19-31``).

    ``registry`` (optional, usually shared across a whole network) collects
    the plane's protocol counters — joins, redirects, drops, repairs,
    publishes — for the ``/metrics`` endpoint.
    """

    def __init__(
        self,
        host: LiveHost,
        repair_timeout_s: float = SUB_REPAIR_TIMEOUT_S,
        registry: Optional[MetricsRegistry] = None,
        retry_opts: Optional[RetryOpts] = None,
        ledger: Optional[SpanLedger] = None,
        trace_clock_offset: float = 0.0,
        device="cuda",
    ):
        self.host = host
        self.repair_timeout_s = repair_timeout_s
        self.registry = registry
        # r19 cross-host tracing: the host's span ledger (None = tracing
        # off) and its host-clock offset estimate relative to the cluster
        # reference clock.  The offset rides traced frames so the merge can
        # normalize skewed timestamps without any clock-sync protocol.
        self.ledger = ledger
        self.trace_clock_offset = trace_clock_offset
        self.device = device
        # One policy per host: breaker state is this host's view of each
        # operation class (dial/join/adopt/rejoin).
        self.retry = RetryPolicy(retry_opts, registry=registry)
        self.topics: Dict[str, LiveTopic] = {}
        self.subscriptions: List[LiveSubscription] = []

    async def new_topic(
        self,
        title: str,
        opts: Optional[TreeOpts] = None,
        signer_seed: Optional[bytes] = None,
        checkpoint_path: Optional[str] = None,
    ) -> LiveTopic:
        t = LiveTopic(self, title, opts or TreeOpts(), signer_seed=signer_seed,
                      checkpoint_path=checkpoint_path)
        self.topics[title] = t
        return t

    async def subscribe(
        self, root_id: str, title: str, validate: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
    ) -> LiveSubscription:
        sub = LiveSubscription(
            self, root_id, title, self.repair_timeout_s, validate=validate,
            checkpoint_path=checkpoint_path, device=self.device,
        )
        await sub.start()
        self.subscriptions.append(sub)
        return sub


# ---------------------------------------------------------------------------
# observability endpoint: /metrics (Prometheus) + /debug/tree (JSON)
# ---------------------------------------------------------------------------


def tree_snapshot(sources: Dict[str, LiveTopicManager]) -> Dict[str, dict]:
    """JSON topology snapshot per topic manager — the servable descendant
    of the reference's private ``printTree`` debugger
    (``pubsub_test.go:204-229``): each topic's children (with subtree
    sizes) and each subscription's current parent.  Pure reads of
    loop-owned state, so the obs server's handler thread may call it
    without touching the event loop."""
    snap: Dict[str, dict] = {}
    for host_id, tm in sources.items():
        topics = {
            title: {
                "subtree_size": t.node.subtree_size(),
                "children": {
                    cid: c.size
                    for cid, c in t.node.children.items()
                    if not c.dead
                },
            }
            for title, t in tm.topics.items()
        }
        subs = {}
        for sub in tm.subscriptions:
            ps = sub.node.parent_stream
            subs[sub.protoid] = {
                "parent": (
                    ps.remote_peer if ps is not None and not ps.closed
                    else None
                ),
                "subtree_size": sub.node.subtree_size(),
                "children": {
                    cid: c.size
                    for cid, c in sub.node.children.items()
                    if not c.dead
                },
            }
        snap[host_id] = {"topics": topics, "subscriptions": subs}
    return snap


# ---------------------------------------------------------------------------
# synchronous facade (one asyncio loop on a background thread)
# ---------------------------------------------------------------------------


class LiveNetwork:
    """Sync facade over the live plane for tests/tools: one event loop on a
    daemon thread; the API mirrors the sim plane's ``SimNetwork``.

    ``device`` is where subscriptions with ``validate="device"`` verify:
    kernel E1 on the card by default (the flush raises without one), the
    plain PyTorch version only when the caller passes ``"cpu"``."""

    def __init__(
        self,
        repair_timeout_s: float = SUB_REPAIR_TIMEOUT_S,
        validate_ids: bool = False,
        chaos=None,
        retry_opts: Optional[RetryOpts] = None,
        trace_sample: Optional[int] = None,
        device="cuda",
    ):
        self.peerstore = Peerstore(validate_ids=validate_ids)
        self.repair_timeout_s = repair_timeout_s
        # Optional net.chaos.ChaosTransport shared by every host, so a
        # (src, dst, proto) link's fault stream is network-global; None
        # leaves every stream un-wrapped (the zero-overhead clean path).
        self.chaos = chaos
        self.retry_opts = retry_opts
        # r19 cross-host tracing: trace 1-in-N messages per the ledger's
        # deterministic hash-mod rule.  None = tracing off — no ledger is
        # created anywhere and the plane stays bit- and counter-identical
        # to the untraced regime.
        self.trace_sample = trace_sample
        self.device = device
        self.registry = MetricsRegistry()
        self._sync_hosts: List["SyncHost"] = []
        self._metrics_server = None  # lazily-started obs.ObsHTTPServer
        self._loop = asyncio.new_event_loop()
        # LIVE_DEBUG=1: asyncio debug mode on the plane's loop — unawaited
        # coroutine warnings, slow-callback reports (anything over 100 ms
        # holding the loop, i.e. anything that would stall every socket on
        # the host), and full task creation tracebacks.  Costs real overhead,
        # so it is opt-in via environment, never default.
        if os.environ.get("LIVE_DEBUG") == "1":
            self._loop.set_debug(True)
            self._loop.slow_callback_duration = 0.1
            _log.info("live_debug_enabled", extra=kv(slow_callback_s=0.1))
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self._counter = 0

    def call(self, coro, timeout: float = 30.0):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except (concurrent.futures.TimeoutError, asyncio.TimeoutError):
            if fut.done():
                # The coroutine itself raised a TimeoutError (e.g. an inner
                # wait_for): that is its result, not a stuck call.
                raise
            # The CALL outlived its deadline: cancel the orphaned coroutine
            # and name it in the failure (the satellite contract — a bare
            # concurrent.futures.TimeoutError says nothing about what hung).
            fut.cancel()
            name = getattr(coro, "__qualname__", None) or repr(coro)
            raise LiveCallTimeout(name, timeout) from None

    def serve_metrics(self, bind: str = "127.0.0.1") -> Tuple[str, int]:
        """Start the ``/metrics`` + ``/debug/tree`` endpoint; return (host, port).

        One endpoint per network: all hosts share the network registry, and
        the topology snapshot covers every host created via :meth:`host`.
        r19: delegates to :class:`~..obs.ObsHTTPServer` — one HTTP serving
        path and one exposition formatter for both planes — with the live
        topology snapshot mounted as an ``extra_json`` endpoint.
        """
        if self._metrics_server is None:
            from ..obs.server import ObsHTTPServer

            srv = ObsHTTPServer(
                self.registry,
                host=bind,
                extra_json={
                    "/debug/tree": lambda: tree_snapshot(
                        {h.id: h.tm for h in self._sync_hosts}
                    ),
                },
            )
            srv.start()
            self._metrics_server = srv
        return self._metrics_server._bind[0], self._metrics_server.port

    def host(self) -> "SyncHost":
        if self.peerstore.validate_ids:
            # Real base58 ids (identity-multihash form) derived from the
            # host counter — the regime the reference operates in.
            from ..utils.base58 import peer_id_from_ed25519_pub

            peer_id = peer_id_from_ed25519_pub(
                self._counter.to_bytes(32, "big")
            )
        else:
            peer_id = f"livepeer-{self._counter}"
        self._counter += 1
        h = LiveHost(peer_id, self.peerstore, chaos=self.chaos)
        self.call(h.start())
        return SyncHost(self, h)

    def make_hosts(self, count: int) -> List["SyncHost"]:
        return [self.host() for _ in range(count)]

    def shutdown(self) -> None:
        if self._metrics_server is not None:
            try:
                self._metrics_server.stop()
            except Exception:
                pass
            self._metrics_server = None
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)


class SyncHost:
    """Sync wrapper over :class:`LiveHost` + its topic manager."""

    def __init__(self, net: LiveNetwork, host: LiveHost):
        self.net = net
        self.live = host
        self.id = host.id
        # Every host builds its OWN ledger: the hash-mod sampling rule is
        # deterministic in the message key, so all hosts agree on which
        # messages to trace with zero coordination; the merge step folds
        # the per-host ledgers back into end-to-end traces.
        self.ledger = (
            SpanLedger(sample_n=net.trace_sample)
            if net.trace_sample is not None else None
        )
        self.tm = LiveTopicManager(
            host, repair_timeout_s=net.repair_timeout_s, registry=net.registry,
            retry_opts=net.retry_opts, ledger=self.ledger,
            device=net.device,
        )
        net._sync_hosts.append(self)

    def new_topic(
        self,
        title: str,
        opts: Optional[TreeOpts] = None,
        signer_seed: Optional[bytes] = None,
        checkpoint_path: Optional[str] = None,
    ) -> "SyncTopic":
        return SyncTopic(
            self.net,
            self.net.call(self.tm.new_topic(
                title, opts, signer_seed=signer_seed,
                checkpoint_path=checkpoint_path,
            )),
        )

    def subscribe(
        self, root_id: str, title: str, validate: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
    ) -> "SyncSubscription":
        return SyncSubscription(
            self.net, self.net.call(self.tm.subscribe(
                root_id, title, validate, checkpoint_path=checkpoint_path,
            ))
        )

    def close(self, graceful: bool = False) -> None:
        """Abrupt kill by default — ``hosts[i].Close()`` in the dropping tests."""
        self.net.call(self.live.aclose(graceful=graceful))


class SyncTopic:
    def __init__(self, net: LiveNetwork, topic: LiveTopic):
        self.net = net
        self.topic = topic

    def publish_message(self, data: bytes) -> None:
        self.net.call(self.topic.publish_message(data))

    def close(self) -> None:
        self.net.call(self.topic.close())

    def close_tree(self) -> None:
        self.net.call(self.topic.close_tree())


class SyncSubscription:
    def __init__(self, net: LiveNetwork, sub: LiveSubscription):
        self.net = net
        self.sub = sub

    def get(self, timeout: float = 5.0) -> bytes:
        """Blocking read under the tests' 5 s deadline (``pubsub_test.go:125``)."""

        async def _get():
            return await asyncio.wait_for(self.sub.out.get(), timeout)

        return self.net.call(_get(), timeout=timeout + 5)

    def try_get(self) -> Optional[bytes]:
        async def _try():
            try:
                return self.sub.out.get_nowait()
            except asyncio.QueueEmpty:
                return None

        return self.net.call(_try())

    def publish_message(self, data: bytes) -> None:
        """Publish from a PROMOTED subscription (post-failover root)."""
        self.net.call(self.sub.publish_message(data))

    def is_promoted(self) -> bool:
        return self.sub.node.is_root

    def clear(self) -> None:
        """Drain pending deliveries (``clearWaitingMessages``,
        ``pubsub_test.go:85-99``)."""
        while self.try_get() is not None:
            pass

    def close(self) -> None:
        self.net.call(self.sub.close())
