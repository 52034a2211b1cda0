"""The port's live plane (``net/live.py``) against the JAX package's.

``net/live.py`` is a copy of the reference's with one substitution of
substance, the device: ``LiveNetwork(device=)`` reaches every
``_BatchValidator``'s ``ValidationPipeline``, so ``validate="device"``
verifies on kernel E1 on the card by default and on the plain PyTorch
version only when the caller asks for the CPU.

- ``_BatchValidator`` is driven on a private event loop through a fake
  subscription: no sockets and no wall clock.  Its verdicts are consumed
  in arrival order, so every expectation is exact.
- A few socket cases at 2-4 hosts run here; every socket wait is bounded
  by ``SyncSubscription.get(timeout=)`` or ``LiveNetwork.call(timeout=)``.
  Once a frame published after another has arrived, the earlier frame's
  verdict is final, so its counters are read without sleeping.
- The rest of the reference's ``tests/test_live.py`` (kills, repair
  timeouts, root failover, checkpoints) runs under ``slow``, as the
  reference marks it.
"""

import asyncio
import concurrent.futures
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from go_libp2p_pubsub_torch.config import TreeOpts
from go_libp2p_pubsub_torch.crypto import native
from go_libp2p_pubsub_torch.crypto import pipeline as tpipe
from go_libp2p_pubsub_torch.crypto.pipeline import Envelope, sign_envelope
from go_libp2p_pubsub_torch.net import LiveNetwork
from go_libp2p_pubsub_torch.net.live import _BatchValidator
from go_libp2p_pubsub_torch.ops import cuda_ed25519
from go_libp2p_pubsub_torch.utils import checkpoint as ckpt
from go_libp2p_pubsub_torch.wire import Message, MessageType
from test_torch_wire import assert_copy

_SEED = b"\x07" * 32
_BACKEND = "native" if native.available() else "python"

# The one change of substance to the reference's net/live.py: the device,
# from LiveNetwork through SyncHost and LiveTopicManager to every
# LiveSubscription's _BatchValidator and its ValidationPipeline.
LIVE_DEVICE_SUBSTITUTIONS = (
    ("        max_pending: int = 512,\n    ) -> None:\n",
     "        max_pending: int = 512,\n        device=\"cuda\",\n"
     "    ) -> None:\n"),
    ("        self.pipeline = ValidationPipeline(backend=backend, "
     "flush_threshold=1 << 30)\n",
     "        # ``device`` is where the \"device\" backend verifies: kernel E1 on\n"
     "        # a card; the plain version only when the caller passes \"cpu\".\n"
     "        self.pipeline = ValidationPipeline(\n"
     "            backend=backend, flush_threshold=1 << 30, device=device)\n"),
    ("        validate: Optional[str] = None,\n"
     "        checkpoint_path: Optional[str] = None,\n    ):\n",
     "        validate: Optional[str] = None,\n"
     "        checkpoint_path: Optional[str] = None,\n        device=\"cuda\",\n"
     "    ):\n"),
    ("            _BatchValidator(self, title, validate) if validate else None\n",
     "            _BatchValidator(self, title, validate, device=device)\n"
     "            if validate else None\n"),
    ("        trace_clock_offset: float = 0.0,\n    ):\n",
     "        trace_clock_offset: float = 0.0,\n        device=\"cuda\",\n"
     "    ):\n"),
    ("        self.trace_clock_offset = trace_clock_offset\n",
     "        self.trace_clock_offset = trace_clock_offset\n"
     "        self.device = device\n"),
    ("            checkpoint_path=checkpoint_path,\n        )\n"
     "        await sub.start()\n",
     "            checkpoint_path=checkpoint_path, device=self.device,\n"
     "        )\n        await sub.start()\n"),
    ("    daemon thread; the API mirrors the sim plane's ``SimNetwork``.\"\"\"\n",
     "    daemon thread; the API mirrors the sim plane's ``SimNetwork``.\n\n"
     "    ``device`` is where subscriptions with ``validate=\"device\"`` "
     "verify:\n"
     "    kernel E1 on the card by default (the flush raises without one), "
     "the\n"
     "    plain PyTorch version only when the caller passes ``\"cpu\"``.\"\"\"\n"),
    ("        trace_sample: Optional[int] = None,\n    ):\n",
     "        trace_sample: Optional[int] = None,\n        device=\"cuda\",\n"
     "    ):\n"),
    ("        self.trace_sample = trace_sample\n",
     "        self.trace_sample = trace_sample\n        self.device = device\n"),
    ("            retry_opts=net.retry_opts, ledger=self.ledger,\n",
     "            retry_opts=net.retry_opts, ledger=self.ledger,\n"
     "            device=net.device,\n"),
)


def test_live_module_is_a_copy_with_the_device():
    assert_copy("net/live.py", cites=1,
                substitutions=LIVE_DEVICE_SUBSTITUTIONS)


def test_net_package_is_a_copy_of_the_reference():
    import go_libp2p_pubsub_torch.net as tnet
    import go_libp2p_pubsub_tpu.net as jnet

    assert_copy("net/__init__.py")
    assert sorted(tnet.__all__) == sorted(jnet.__all__)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain verifier is thousands of small ops; one intra-op thread
    keeps it fast beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_thread_executor():
    """The validators flush on their loop's default executor.  A thread's
    first torch op runs with every core's OpenMP threads unless the thread
    pins its own count, and beside other busy test workers that first
    verify then spins for a minute: pin each executor thread to one."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=4, initializer=torch.set_num_threads, initargs=(1,))


# -- E1's launch count under threads -------------------------------------------


def test_e1_launch_count_is_exact_under_threads():
    """8 threads count 1,000 launches each through the wrapper's helper,
    switching threads every microsecond: no count may be lost."""
    saved = cuda_ed25519.verify.launches
    interval = sys.getswitchinterval()
    start = threading.Barrier(8)

    def count():
        start.wait()
        for _ in range(1000):
            cuda_ed25519.count_launch()

    threads = [threading.Thread(target=count) for _ in range(8)]
    try:
        sys.setswitchinterval(1e-6)
        cuda_ed25519.reset_launches()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert cuda_ed25519.verify.launches == 8000
        cuda_ed25519.reset_launches()
        assert cuda_ed25519.verify.launches == 0
    finally:
        sys.setswitchinterval(interval)
        cuda_ed25519.verify.launches = saved


# -- _BatchValidator on a private loop, no sockets ------------------------------


class _FakeNode:
    def __init__(self):
        self.forwarded, self.stamps = [], []

    async def forward_message(self, m):
        self.forwarded.append(m)

    def trace_stamp(self, m, stage, **attrs):
        self.stamps.append((stage, attrs.get("seqno")))


class _FakeSub:
    """What ``_BatchValidator`` reads of its subscription: the host's
    ``spawn``, the ``out`` queue and the node's relay and stamp hooks."""

    def __init__(self, loop):
        self.tm = SimpleNamespace(host=SimpleNamespace(spawn=loop.create_task))
        self.node = _FakeNode()
        self.out = asyncio.Queue()


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    lp.set_default_executor(_one_thread_executor())
    yield lp
    lp.run_until_complete(lp.shutdown_default_executor())
    lp.close()


def _data(raw, replay=False):
    return Message(type=MessageType.DATA, data=raw, replay=replay)


def _signed(seq, payload, topic="sig"):
    return sign_envelope(_SEED, topic, seq, payload, backend=_BACKEND)


def _submit_and_settle(loop, v, frames, timeout=60.0):
    """Submit ``frames`` in order, then run the flusher until its queue is
    empty; returns the flusher's exception (None when it ended cleanly)."""

    async def go():
        for m in frames:
            await v.submit(m)
        task = v._task
        if task is None:
            return None
        await asyncio.wait([task])
        return task.exception()

    return loop.run_until_complete(asyncio.wait_for(go(), timeout))


def _drain(loop, sub):
    async def go():
        out = []
        while not sub.out.empty():
            out.append(sub.out.get_nowait())
        return out

    return loop.run_until_complete(go())


def _mixed_frames():
    """Good, forged, junk, wrong-topic, truncated-key, replayed and stale
    frames, in one publish order; the payloads delivered are p0 p2 p4 p5."""
    good = {i: _signed(i, b"p%d" % i) for i in (0, 2, 4, 5)}
    forged = Envelope("sig", 1, b"evil", good[0].pubkey, b"\x00" * 64)
    wrong_topic = _signed(3, b"sneaky", topic="other")
    raw = good[4].to_wire()
    truncated = raw[:4 + 3 + 8 + 20]          # 20 bytes of a 32-byte key
    stale = _signed(1, b"late but signed")
    return [
        _data(good[0].to_wire()),
        _data(forged.to_wire()),
        _data(good[2].to_wire()),
        _data(b"\xff\xff raw junk"),
        _data(wrong_topic.to_wire()),
        _data(truncated),
        _data(raw),
        _data(good[2].to_wire()),                 # unflagged replay
        _data(good[2].to_wire(), replay=True),    # a repair replay
        _data(stale.to_wire()),                   # non-monotonic seqno
        _data(good[5].to_wire()),
    ]


@pytest.mark.parametrize("cuts", [(), (1,), (2, 6, 9), tuple(range(1, 11))],
                         ids=["one-batch", "two", "four", "frame-by-frame"])
def test_validator_verdicts_in_arrival_order(loop, cuts):
    sub = _FakeSub(loop)
    v = _BatchValidator(sub, "sig", _BACKEND, device="cpu")
    frames = _mixed_frames()
    bounds = [0, *cuts, len(frames)]
    for a, b in zip(bounds, bounds[1:]):
        assert _submit_and_settle(loop, v, frames[a:b]) is None
    assert _drain(loop, sub) == [b"p0", b"p2", b"p4", b"p5"]
    assert sub.node.forwarded == [frames[i] for i in (0, 2, 6, 10)]
    assert sub.node.stamps == [("deliver", s) for s in (0, 2, 4, 5)]
    assert v.rejected_signature == 1
    # junk, wrong topic, truncated key, the unflagged replay, the stale one
    assert v.rejected_structural == 5
    assert v.last_seqno == 5
    assert v.pipeline.stats == {"validated": 8, "accepted": 7,
                                "rejected": 1}
    assert v._queue == [] and v.pipeline._pending == []


def test_validator_requeues_a_batch_whose_backend_raised(loop, monkeypatch):
    calls = []

    def flaky(pks, msgs, sigs, device):
        calls.append(len(pks))
        if len(calls) == 1:
            raise RuntimeError("backend down")
        return native.verify_batch(pks, msgs, sigs)

    monkeypatch.setitem(tpipe._BACKENDS, "flaky", flaky)
    sub = _FakeSub(loop)
    v = _BatchValidator(sub, "sig", "flaky", device="cpu")
    first = [_data(_signed(0, b"a").to_wire()),
             _data(Envelope("sig", 1, b"evil", _signed(0, b"a").pubkey,
                            b"\x01" * 64).to_wire()),
             _data(_signed(2, b"b").to_wire())]
    err = _submit_and_settle(loop, v, first)
    assert isinstance(err, RuntimeError)
    assert _drain(loop, sub) == [] and sub.node.forwarded == []
    assert [m for m, _ in v._queue] == first
    assert v.pipeline._pending == []
    assert v.pipeline.stats["validated"] == 0
    assert v.rejected_signature == v.rejected_structural == 0
    # The next frame starts a new flusher, which pairs every frame of the
    # requeued batch with its own verdict, ahead of the new one.
    late = _data(_signed(3, b"c").to_wire())
    assert _submit_and_settle(loop, v, [late]) is None
    assert calls == [3, 4]
    assert _drain(loop, sub) == [b"a", b"b", b"c"]
    assert sub.node.forwarded == [first[0], first[2], late]
    assert v.rejected_signature == 1 and v.rejected_structural == 0
    assert v.pipeline.stats == {"validated": 4, "accepted": 3, "rejected": 1}


def test_validator_device_backend_on_the_cpu_matches_native(loop):
    envs = [_signed(i, b"payload %d" % i) for i in range(4)]
    envs[2] = Envelope("sig", 2, b"payload 2", envs[2].pubkey,
                       envs[2].signature[:-1] + bytes([envs[2].signature[-1]
                                                       ^ 1]))
    want = native.verify_batch(
        [e.pubkey for e in envs],
        [tpipe.signing_bytes(e.topic, e.seqno, e.payload) for e in envs],
        [e.signature for e in envs])
    assert want.tolist() == [True, True, False, True]
    launches = cuda_ed25519.verify.launches
    sub = _FakeSub(loop)
    v = _BatchValidator(sub, "sig", "device", device="cpu")
    assert v.pipeline.device == "cpu"
    assert _submit_and_settle(loop, v, [_data(e.to_wire()) for e in envs]) \
        is None
    assert _drain(loop, sub) == [e.payload for e, ok in zip(envs, want) if ok]
    assert v.rejected_signature == 1
    assert v.pipeline.stats == {"validated": 4, "accepted": 3, "rejected": 1}
    assert cuda_ed25519.verify.launches == launches


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_validator_device_backend_defaults_to_the_card(loop):
    sub = _FakeSub(loop)
    v = _BatchValidator(sub, "sig", "device")
    assert v.pipeline.device == "cuda"
    frames = [_data(_signed(i, b"x%d" % i).to_wire()) for i in range(2)]
    assert _submit_and_settle(loop, v, frames) is not None
    assert _drain(loop, sub) == [] and sub.node.forwarded == []
    assert [m for m, _ in v._queue] == frames
    assert v.pipeline.stats["validated"] == 0


# -- over sockets -----------------------------------------------------------------


@pytest.fixture(scope="module")
def net():
    n = LiveNetwork(repair_timeout_s=2.0, device="cpu")

    async def pin_executor():
        asyncio.get_running_loop().set_default_executor(
            _one_thread_executor())

    n.call(pin_executor())
    yield n
    n.shutdown()


def init_pubsub(net, n_hosts, title="foobar", validate=None, **topic_kw):
    hosts = net.make_hosts(n_hosts)
    topic = hosts[0].new_topic(title, **topic_kw)
    subs = [h.subscribe(hosts[0].id, title, validate=validate)
            for h in hosts[1:]]
    return hosts, topic, subs


def check_system(topic, subs, skip=None, mid=0):
    """``checkSystem`` (``pubsub_test.go:101-131``): publish, then the exact
    bytes at every subscriber not skipped, within the 5 s deadline."""
    skip = skip or set()
    mes = f"message number {mid}".encode()
    topic.publish_message(mes)
    for i, ch in enumerate(subs):
        if i in skip:
            continue
        data = ch.get(timeout=5.0)
        assert data == mes, f"node {i}: expected {mes!r} got {data!r}"


def test_live_basic_pubsub(net):
    """``TestBasicPubsub`` over sockets: 4 nodes, 10 sequential messages."""
    _, topic, subs = init_pubsub(net, 4)
    for i in range(10):
        check_system(topic, subs, None, i)


def test_live_signed_topic_device_validated_on_the_cpu(net):
    """The root signs; every subscriber verifies on the device backend's
    plain version (``device="cpu"``) and delivers the payloads in order."""
    launches = cuda_ed25519.verify.launches
    hosts, topic, subs = init_pubsub(net, 3, "sig-dev", validate="device",
                                     signer_seed=_SEED)
    sent = [f"signed {i}".encode() for i in range(2)]
    for mes in sent:
        topic.publish_message(mes)
    for s in subs:
        assert [s.get(timeout=30.0) for _ in sent] == sent
    for s in subs:
        v = s.sub.validator
        assert v.pipeline.backend == "device" and v.pipeline.device == "cpu"
        assert v.pipeline.stats == {"validated": 2, "accepted": 2,
                                    "rejected": 0}
        assert v.rejected_signature == v.rejected_structural == 0
        assert not (v._task.done() and v._task.exception() is not None)
    assert cuda_ed25519.verify.launches == launches


def test_live_forged_frames_die_at_the_first_hop(net):
    """Width-1 chain root -> A -> B: A rejects the forged, wrong-topic and
    junk frames and relays none of them; B sees only the good ones."""
    hosts = net.make_hosts(3)
    topic = hosts[0].new_topic("sig-chain",
                               TreeOpts(tree_width=1, tree_max_width=1))
    sub_a = hosts[1].subscribe(hosts[0].id, "sig-chain", validate=_BACKEND)
    sub_b = hosts[2].subscribe(hosts[0].id, "sig-chain", validate=_BACKEND)
    assert sub_b.sub.node.parent_stream.remote_peer == hosts[1].id
    good = sign_envelope(_SEED, "sig-chain", 0, b"good", backend=_BACKEND)
    forged = Envelope("sig-chain", 1, b"evil", good.pubkey, b"\x00" * 64)
    wrong = sign_envelope(_SEED, "other", 2, b"sneaky", backend=_BACKEND)
    good2 = sign_envelope(_SEED, "sig-chain", 3, b"good2", backend=_BACKEND)
    for raw in (good.to_wire(), forged.to_wire(), wrong.to_wire(),
                b"\xff\xff raw junk", good2.to_wire()):
        topic.publish_message(raw)
    for s in (sub_a, sub_b):
        assert s.get(timeout=5.0) == b"good"
        assert s.get(timeout=5.0) == b"good2"
    # good2 came after the three bad frames, so their verdicts are final.
    va, vb = sub_a.sub.validator, sub_b.sub.validator
    assert (va.rejected_signature, va.rejected_structural) == (1, 2)
    assert (vb.rejected_signature, vb.rejected_structural) == (0, 0)
    assert vb.pipeline.stats["validated"] == 2
    assert sub_a.try_get() is None and sub_b.try_get() is None


def test_live_replay_guard(net):
    """An exact replay and a stale seqno are dropped; a later good frame
    is delivered next."""
    hosts = net.make_hosts(2)
    topic = hosts[0].new_topic("sig-replay")
    sub = hosts[1].subscribe(hosts[0].id, "sig-replay", validate=_BACKEND)
    env = sign_envelope(_SEED, "sig-replay", 5, b"once", backend=_BACKEND)
    topic.publish_message(env.to_wire())
    assert sub.get(timeout=5.0) == b"once"
    topic.publish_message(env.to_wire())
    topic.publish_message(sign_envelope(
        _SEED, "sig-replay", 4, b"older", backend=_BACKEND).to_wire())
    topic.publish_message(sign_envelope(
        _SEED, "sig-replay", 6, b"next", backend=_BACKEND).to_wire())
    assert sub.get(timeout=5.0) == b"next"
    v = sub.sub.validator
    assert (v.rejected_signature, v.rejected_structural) == (0, 2)
    assert v.last_seqno == 6 and sub.try_get() is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_live_device_validation_defaults_to_the_card():
    """With no device given, ``validate="device"`` verifies on the card;
    on a machine without one the flush raises, nothing is delivered, and
    the validator's task holds the error: no quiet fallback to the CPU."""
    net = LiveNetwork()
    try:
        assert net.device == "cuda"
        hosts, topic, subs = init_pubsub(net, 2, "sig-card",
                                         validate="device",
                                         signer_seed=_SEED)
        v = subs[0].sub.validator
        assert v.pipeline.device == "cuda"
        topic.publish_message(b"needs a card")

        async def flusher_error():
            while v._task is None:
                await asyncio.sleep(0.01)
            await asyncio.wait([v._task])
            return v._task.exception()

        err = net.call(flusher_error(), timeout=30.0)
        assert err is not None
        assert subs[0].try_get() is None
        assert v.pipeline.stats["validated"] == 0
        assert len(v._queue) == 1
    finally:
        net.shutdown()


# -- slow: the rest of the reference's tests/test_live.py ----------------------


@pytest.fixture
def slow_net():
    n = LiveNetwork(repair_timeout_s=2.0, device="cpu")
    yield n
    n.shutdown()


def settle_and_clear(subs, settle_s=0.2):
    """100 ms settle + ``clearWaitingMessages`` (pubsub_test.go:85-99,191)."""
    time.sleep(settle_s)
    for s in subs:
        s.clear()


def _wait_promoted(subs, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for s in subs:
            if s.is_promoted():
                return s
        time.sleep(0.05)
    return None


@pytest.mark.slow
class TestLiveSlow:
    def test_nodes_dropping(self, slow_net):
        hosts, topic, subs = init_pubsub(slow_net, 4)
        check_system(topic, subs, None, 0)
        hosts[1].close()
        time.sleep(0.05)
        check_system(topic, subs, {0, 2}, 1)
        settle_and_clear(subs)
        for i in range(10):
            check_system(topic, subs, {0}, i + 100)

    def test_lower_nodes_dropping(self, slow_net):
        hosts, topic, subs = init_pubsub(slow_net, 8)
        check_system(topic, subs, None, 0)
        hosts[3].close()
        time.sleep(0.2)
        topic.publish_message(b"lossy")
        settle_and_clear(subs, settle_s=0.5)
        for i in range(10):
            check_system(topic, subs, {2}, i + 100)

    def test_nodes_dropping_gracefully(self, slow_net):
        hosts, topic, subs = init_pubsub(slow_net, 4)
        check_system(topic, subs, None, 0)
        subs[0].close()
        time.sleep(0.2)
        check_system(topic, subs, {0}, 1)
        settle_and_clear(subs)
        for i in range(10):
            check_system(topic, subs, {0}, i + 100)

    def test_fifo_order(self, slow_net):
        _, topic, subs = init_pubsub(slow_net, 5)
        for i in range(8):
            topic.publish_message(f"m{i}".encode())
        for ch in subs:
            assert [ch.get(timeout=5.0) for _ in range(8)] == [
                f"m{i}".encode() for i in range(8)]

    def test_larger_tree(self, slow_net):
        _, topic, subs = init_pubsub(slow_net, 16)
        for i in range(3):
            check_system(topic, subs, None, i)

    def test_multi_topic(self, slow_net):
        hosts = slow_net.make_hosts(4)
        t_a = hosts[0].new_topic("alpha")
        t_b = hosts[1].new_topic("beta")
        subs_a = [hosts[i].subscribe(hosts[0].id, "alpha") for i in (1, 2, 3)]
        subs_b = [hosts[i].subscribe(hosts[1].id, "beta") for i in (0, 2, 3)]
        t_a.publish_message(b"on-alpha")
        t_b.publish_message(b"on-beta")
        assert all(s.get(timeout=5.0) == b"on-alpha" for s in subs_a)
        assert all(s.get(timeout=5.0) == b"on-beta" for s in subs_b)

    def test_repair_timeout_rejoins_at_root(self):
        net = LiveNetwork(repair_timeout_s=0.3, device="cpu")
        try:
            hosts = net.make_hosts(3)
            topic = hosts[0].new_topic(
                "chain", TreeOpts(tree_width=1, tree_max_width=1))
            sub_a = hosts[1].subscribe(hosts[0].id, "chain")
            sub_b = hosts[2].subscribe(hosts[0].id, "chain")
            topic.publish_message(b"pre")
            assert sub_a.get(timeout=5.0) == b"pre"
            assert sub_b.get(timeout=5.0) == b"pre"

            async def cripple_repairer():
                async def no_redistribute(_gids):
                    return None

                topic.topic.node._redistribute = no_redistribute

            net.call(cripple_repairer())
            hosts[1].close()
            time.sleep(0.8)
            sub_b.clear()
            topic.publish_message(b"post")
            assert sub_b.get(timeout=5.0) == b"post"
            assert sub_b.sub.node.parent_stream.remote_peer == hosts[0].id
        finally:
            net.shutdown()

    def test_root_rejects_non_join(self, slow_net):
        from go_libp2p_pubsub_torch.net.transport import StreamClosed

        hosts = slow_net.make_hosts(2)
        hosts[0].new_topic("foobar")

        async def probe():
            s = await hosts[1].live.new_stream(hosts[0].id,
                                               f"{hosts[0].id}/foobar")
            await s.write_message(Message(type=MessageType.DATA, data=b"no"))
            try:
                await asyncio.wait_for(s.read_message(), timeout=2.0)
                return "got-message"
            except StreamClosed:
                return "closed"

        assert slow_net.call(probe()) == "closed"

    def test_wire_bytes_on_socket(self, slow_net):
        _, topic, subs = init_pubsub(slow_net, 2)
        payload = b"\x00\x01binary\xff"
        topic.publish_message(payload)
        assert subs[0].get(timeout=5.0) == payload

    def test_signed_batch_amortization(self, slow_net):
        _, topic, subs = init_pubsub(slow_net, 2, "sig", validate=_BACKEND,
                                     signer_seed=_SEED)
        n = 32
        for i in range(n):
            topic.publish_message(f"burst {i}".encode())
        assert [subs[0].get(timeout=10.0) for _ in range(n)] == [
            f"burst {i}".encode() for i in range(n)]
        assert subs[0].sub.validator.pipeline.stats["accepted"] == n

    def test_root_kill_promotes_successor_and_resumes(self, slow_net):
        hosts, topic, subs = init_pubsub(slow_net, 6)
        check_system(topic, subs, None, 0)
        hosts[0].close()
        promoted = _wait_promoted(subs)
        assert promoted is not None, "no successor promoted after root kill"
        node = promoted.sub.node
        assert node.is_root and node.epoch >= 1
        settle_and_clear(subs, settle_s=0.5)
        promoted.publish_message(b"after failover")
        for s in subs:
            if s is not promoted:
                assert s.get(timeout=8.0) == b"after failover"
        assert {s.sub.node.epoch for s in subs} == {node.epoch}

    def test_zombie_epoch_frames_fenced(self, slow_net):
        hosts, topic, subs = init_pubsub(slow_net, 5)
        check_system(topic, subs, None, 0)
        hosts[0].close()
        promoted = _wait_promoted(subs)
        assert promoted is not None
        settle_and_clear(subs, settle_s=0.5)
        node = next(s for s in subs if s is not promoted).sub.node
        assert node.epoch >= 1
        before = slow_net.registry.counters().get(
            "live.failover.stale_epoch_rejected", 0)
        assert node.fence_frame(
            Message(type=MessageType.DATA, data=b"zombie", epoch=0)) is False
        assert node.fence_frame(Message(
            type=MessageType.DATA, data=b"ok", epoch=node.epoch)) is True
        assert slow_net.registry.counters().get(
            "live.failover.stale_epoch_rejected", 0) == before + 1

    def test_checkpoint_records_promotion(self, slow_net, tmp_path):
        hosts = slow_net.make_hosts(5)
        topic = hosts[0].new_topic(
            "foobar", checkpoint_path=str(tmp_path / "root.json"))
        paths, subs = {}, []
        for i, h in enumerate(hosts[1:], start=1):
            paths[i] = str(tmp_path / f"peer{i}.json")
            subs.append(h.subscribe(hosts[0].id, "foobar",
                                    checkpoint_path=paths[i]))
        check_system(topic, subs, None, 0)
        time.sleep(0.3)
        st = ckpt.load_topic_state(str(tmp_path / "root.json"))
        assert st["epoch"] == 0 and st["successors"]
        hosts[0].close()
        promoted = _wait_promoted(subs)
        assert promoted is not None
        idx = subs.index(promoted) + 1
        st2, deadline = None, time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                st2 = ckpt.load_topic_state(paths[idx])
                if st2["epoch"] >= 1:
                    break
            except (FileNotFoundError, ValueError):
                pass
            time.sleep(0.1)
        assert st2 is not None and st2["epoch"] >= 1
