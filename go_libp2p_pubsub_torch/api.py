"""Host API: the reference's L3/L4 surface over the tree engine, in PyTorch.

Port of the JAX package's ``api.py``.  Shapes mirror the Go reference's
``pubsub.go:19-120`` (``TopicManager``, ``Topic``) and ``client.go:18-94``
(``client`` -> :class:`Subscription`):

- ``NewTopicManager(h)``           -> ``TopicManager(host)``
- ``tm.NewTopic(ctx, title, opts)``-> ``tm.new_topic(title, opts)``
- ``tm.Subscribe(ctx, root, top)`` -> ``tm.subscribe(root_id, title)``
- ``t.PublishMessage(b)``          -> ``topic.publish_message(b)``
- ``cli.Messages() <-chan []byte`` -> ``sub.get(...)`` / ``sub.try_get()``
- ``cli.Close()`` (Part + teardown)-> ``sub.close()``
- ``t.Close()``                    -> ``topic.close()``

The network backend is :class:`SimNetwork` -- the in-process simulated
fabric (the mocknet analog, ``pubsub_test.go:18-25``) -- owning one
:class:`~.ops.tree.TreeState` per topic on ``device`` (the card by
default; ``device="cpu"`` for the CPU) and advancing every topic in
lockstep steps.  Payload bytes stay host-side in a per-topic registry;
only ``int32`` message ids live on the device.  Joins and reads step the
network one step at a time and read the state back after each, as the
reference's API does.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .config import SimParams, TreeOpts
from .models.gossipsub import resolve_device
from .ops import tree as tree_ops


class TimeoutError_(Exception):
    """Delivery wait exceeded its step budget (the 5 s timeout analog,
    ``pubsub_test.go:125``)."""


@dataclass
class _TopicEngine:
    """Per-topic simulation state + host-side payload registry."""

    protoid: str
    root: int
    opts: TreeOpts
    state: tree_ops.TreeState
    payloads: List[bytes] = field(default_factory=list)
    closed_root: bool = False
    repair_timeout_steps: int = 64

    def publish(self, data: bytes) -> None:
        msg_id = len(self.payloads)
        self.payloads.append(data)
        self.state = tree_ops.publish(self.state, msg_id)

    def step(self) -> None:
        self.state = tree_ops.step(
            self.state, repair_timeout_steps=self.repair_timeout_steps
        )

    def drain(self, peer: int) -> List[bytes]:
        self.state, msgs, count = tree_ops.drain_out(self.state, peer)
        ids = msgs.cpu().numpy()[: int(count)]
        return [self.payloads[i] for i in ids]


class SimNetwork:
    """In-process simulated network of hosts (mocknet analog).

    All hosts share one fabric; per-topic overlay state lives on
    ``device``.  ``step()`` advances every topic one lockstep round;
    delivery waits (``Subscription.get``) auto-step up to a budget, which
    plays the role of wall-clock timeouts in the reference tests.
    """

    def __init__(self, params: Optional[SimParams] = None, device="cuda"):
        self.params = params or SimParams()
        self.device = resolve_device(device)
        self._next_idx = itertools.count()
        self.hosts: Dict[str, "SimHost"] = {}
        self.engines: Dict[str, _TopicEngine] = {}

    def host(self) -> "SimHost":
        idx = next(self._next_idx)
        if idx >= self.params.max_peers:
            raise RuntimeError(
                f"SimNetwork is full ({self.params.max_peers} peers); "
                "raise SimParams.max_peers"
            )
        h = SimHost(self, idx)
        self.hosts[h.id] = h
        return h

    def make_hosts(self, count: int) -> List["SimHost"]:
        """Fixture analog of ``makeNetHosts`` (``pubsub_test.go:27-35``)."""
        return [self.host() for _ in range(count)]

    def step(self, count: int = 1) -> None:
        for _ in range(count):
            for eng in self.engines.values():
                eng.step()

    def set_link_profile(self, delay, drop_prob) -> None:
        """Install per-edge latency/drop tensors on every registered topic's
        fabric (``delay`` i32[N, W] extra steps per (parent, child-slot)
        edge; ``drop_prob`` f32[N, W] silent per-copy loss probability).
        Applies to topics that exist now."""
        d = torch.as_tensor(np.asarray(delay), device=self.device)
        p = torch.as_tensor(np.asarray(drop_prob), device=self.device)
        for eng in self.engines.values():
            eng.state = tree_ops.set_link_profile(eng.state, d, p)

    # -- used by host/topic objects -----------------------------------------
    def _engine(self, protoid: str) -> _TopicEngine:
        try:
            return self.engines[protoid]
        except KeyError:
            raise KeyError(f"no topic registered under protocol id {protoid!r}")


class SimHost:
    """A simulated peer process -- the ``host.Host`` analog.

    ``close()`` is the abrupt kill used by the dropping tests
    (``pubsub_test.go:178,252``): the peer vanishes without sending Part
    and is discovered via write failures.
    """

    def __init__(self, net: SimNetwork, idx: int):
        self.net = net
        self.idx = idx
        self.id = f"simpeer-{idx}"
        self.closed = False

    def close(self) -> None:
        self.closed = True
        for eng in self.net.engines.values():
            eng.state = tree_ops.kill_peer(eng.state, self.idx)

    def __repr__(self) -> str:
        return f"SimHost({self.id})"


class TopicManager:
    """Registry of topics on one host (``pubsub.go:19-31``)."""

    def __init__(self, host: SimHost):
        self.h = host
        self.topics: Dict[str, "Topic"] = {}

    def new_topic(self, title: str, opts: Optional[TreeOpts] = None) -> "Topic":
        """Create a topic rooted at this host (``pubsub.go:54-97``): the
        creator is the permanent root and sole publisher entry point; the
        protocol id namespaces the topic by (root, title)."""
        opts = opts or TreeOpts()
        protoid = f"{self.h.id}/{title}"
        eng = _TopicEngine(
            protoid=protoid,
            root=self.h.idx,
            opts=opts,
            state=tree_ops.init_state(self.net.params, opts, root=self.h.idx,
                                      device=self.net.device),
            repair_timeout_steps=self.net.params.repair_timeout_steps,
        )
        self.net.engines[protoid] = eng
        t = Topic(self, title, protoid)
        self.topics[title] = t
        return t

    def subscribe(
        self, root_id: str, title: str, join_budget: Optional[int] = None
    ) -> "Subscription":
        """Join the tree rooted at ``root_id`` (``client.go:65-94``),
        stepping the network until the join walk lands."""
        protoid = f"{root_id}/{title}"
        eng = self.net._engine(protoid)
        peer = self.h.idx
        eng.state = tree_ops.begin_subscribe(eng.state, peer)
        budget = join_budget or 4 * self.net.params.max_peers
        for _ in range(budget):
            if bool(eng.state.joined[peer]):
                break
            self.net.step()
        else:
            raise TimeoutError_(f"{self.h.id} failed to join {protoid}")
        return Subscription(self, protoid, peer)

    @property
    def net(self) -> SimNetwork:
        return self.h.net


class Topic:
    """Root-side topic handle (``pubsub.go:33-120``)."""

    def __init__(self, tm: TopicManager, title: str, protoid: str):
        self.tm = tm
        self.title = title
        self.protoid = protoid

    def publish_message(self, data: bytes) -> None:
        """``PublishMessage`` (``pubsub.go:111-120``); payloads travel
        unsigned, as in v0."""
        self.tm.net._engine(self.protoid).publish(data)

    def close(self) -> None:
        """Parity with ``Topic.Close`` (``pubsub.go:99-103``): unregisters
        the topic but does NOT tear down the tree (the reference leaks its
        child streams here).  Use :meth:`close_tree` for the fixed
        behavior."""
        self.tm.net._engine(self.protoid).closed_root = True
        self.tm.topics.pop(self.title, None)

    def close_tree(self) -> None:
        """Correct-semantics close: gracefully part the root so children
        are notified."""
        eng = self.tm.net._engine(self.protoid)
        eng.state = tree_ops.leave_peer(eng.state, eng.root)
        self.close()


class Subscription:
    """Subscriber handle -- the ``client`` analog (``client.go:18-34``)."""

    def __init__(self, tm: TopicManager, protoid: str, peer: int):
        self.tm = tm
        self.protoid = protoid
        self.peer = peer
        self._inbox: List[bytes] = []
        self.closed = False

    def _drain(self) -> None:
        self._inbox.extend(self.tm.net._engine(self.protoid).drain(self.peer))

    def try_get(self) -> Optional[bytes]:
        """Non-blocking read -- the ``select/default`` drain in
        ``clearWaitingMessages`` (``pubsub_test.go:85-99``)."""
        self._drain()
        return self._inbox.pop(0) if self._inbox else None

    def get(self, step_budget: int = 256) -> bytes:
        """Blocking read with a step budget -- ``<-ch.Messages()`` under the
        5 s test timeout (``pubsub_test.go:118-126``)."""
        self._drain()
        for _ in range(step_budget):
            if self._inbox:
                return self._inbox.pop(0)
            self.tm.net.step()
            self._drain()
        if self._inbox:
            return self._inbox.pop(0)
        raise TimeoutError_(
            f"timeout waiting for message on peer {self.peer} ({self.protoid})"
        )

    def messages(self) -> Iterator[bytes]:
        """Iterator over currently deliverable messages."""
        while True:
            m = self.try_get()
            if m is None:
                return
            yield m

    def clear(self) -> None:
        self._drain()
        self._inbox.clear()

    def close(self) -> None:
        """Graceful leave (``client.Close``, ``client.go:30-34``): Part to
        the parent; our children are re-adopted by our parent next step."""
        self.closed = True
        eng = self.tm.net._engine(self.protoid)
        eng.state = tree_ops.leave_peer(eng.state, self.peer)
