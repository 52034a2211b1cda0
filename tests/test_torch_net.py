"""The port's live transport, retry policy and chaos layer against the
JAX package's.

``net/transport.py``, ``net/policy.py`` and ``net/chaos.py`` are copies of
the reference's framework-free modules (pinned below).  The fast cases of
the reference's ``tests/test_chaos.py`` run here against the port; the
chaos layer's fault traces and the retry policy's backoff delays are
computed by both packages for the same seeds and must be equal.  Also the
live plane's config constants and ``RetryOpts``, and the topic-state
files of ``utils/checkpoint.py`` read across the two packages.
"""

import asyncio
import dataclasses
import random

import pytest

from go_libp2p_pubsub_torch import config as tcfg
from go_libp2p_pubsub_torch.net import LiveNetwork
from go_libp2p_pubsub_torch.net import chaos as tchaos
from go_libp2p_pubsub_torch.net import policy as tpolicy
from go_libp2p_pubsub_torch.net.chaos import (
    ChaosTransport,
    LinkPolicy,
    LinkPolicyTable,
)
from go_libp2p_pubsub_torch.net.policy import (
    CircuitBreaker,
    CircuitOpen,
    LiveCallTimeout,
    RetryPolicy,
)
from go_libp2p_pubsub_torch.net.transport import (
    MAX_PENDING_BYTES,
    Peerstore,
    Stream,
    StreamClosed,
)
from go_libp2p_pubsub_torch.utils import checkpoint as tckpt
from go_libp2p_pubsub_torch.utils.metrics import MetricsRegistry
from go_libp2p_pubsub_torch.wire import Message, MessageType, encode_message
from go_libp2p_pubsub_tpu import config as jcfg
from go_libp2p_pubsub_tpu.net import chaos as jchaos
from go_libp2p_pubsub_tpu.net import policy as jpolicy
from go_libp2p_pubsub_tpu.utils import checkpoint as jckpt
from test_torch_wire import assert_copy


@pytest.mark.parametrize("rel,cites", [
    ("net/transport.py", 1), ("net/policy.py", 0), ("net/chaos.py", 0)])
def test_module_is_a_copy_of_the_reference(rel, cites):
    assert_copy(rel, cites)


# -- config and topic state -------------------------------------------------------


def test_live_config_matches_the_reference():
    assert (tcfg.SUB_REPAIR_TIMEOUT_S, tcfg.DELIVERY_BUFFER) == (
        jcfg.SUB_REPAIR_TIMEOUT_S, jcfg.DELIVERY_BUFFER) == (15.0, 16)
    rf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(jcfg.RetryOpts)]
    pf = [(f.name, f.type, f.default)
          for f in dataclasses.fields(tcfg.RetryOpts)]
    assert rf == pf
    assert dataclasses.asdict(tcfg.RetryOpts()) == dataclasses.asdict(
        jcfg.RetryOpts())
    for kw in ({"max_attempts": 0}, {"base_delay_s": 0.0},
               {"max_delay_s": 0.01}, {"deadline_s": 0.0},
               {"breaker_reset_s": -1.0}, {"breaker_failures": 0}):
        for cfg in (tcfg, jcfg):
            with pytest.raises(ValueError):
                cfg.RetryOpts(**kw)


_TOPIC_STATE = {"epoch": 3, "seq": 41, "successors": ["livepeer-2", "b"],
                "roster": ["livepeer-1", "livepeer-2"], "root": "livepeer-0"}


@pytest.mark.parametrize("writer,reader", [(tckpt, jckpt), (jckpt, tckpt)],
                         ids=["port-to-reference", "reference-to-port"])
def test_topic_state_round_trips_between_the_packages(tmp_path, writer,
                                                      reader):
    path = str(tmp_path / "topic.json")
    writer.save_topic_state(path, _TOPIC_STATE)
    assert reader.load_topic_state(path) == _TOPIC_STATE
    with open(path, "rb") as f:
        raw = f.read()
    other = str(tmp_path / "other.json")
    reader.save_topic_state(other, _TOPIC_STATE)
    with open(other, "rb") as f:
        assert f.read() == raw
    with open(path, "wb") as f:
        f.write(b'{"format_version": 2, "state": {}}')
    for mod in (tckpt, jckpt):
        with pytest.raises(ValueError):
            mod.load_topic_state(path)


# -- LinkPolicy / LinkPolicyTable ---------------------------------------------


class TestLinkPolicy:
    def test_noop_default(self):
        assert LinkPolicy().is_noop()
        assert not LinkPolicy(delay_s=0.01).is_noop()
        assert not LinkPolicy(blackhole=True).is_noop()

    @pytest.mark.parametrize("kw", [
        {"drop_prob": 1.5},
        {"drop_prob": -0.1},
        {"duplicate_prob": 2.0},
        {"reorder_prob": -1.0},
        {"reset_prob": 1.01},
        {"delay_s": -0.5},
        {"jitter_s": -1e-9},
        {"bandwidth_bytes_per_s": -1.0},
        {"reset_after_msgs": -1},
    ])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            LinkPolicy(**kw)


class TestLinkPolicyTable:
    def test_empty_resolves_none(self):
        assert LinkPolicyTable().policy_for("a", "b", "/p") is None

    def test_wildcard_and_specificity(self):
        t = LinkPolicyTable()
        broad = LinkPolicy(delay_s=0.1)
        narrow = LinkPolicy(drop_prob=0.5)
        t.set(broad)
        t.set(narrow, src="a")
        assert t.policy_for("a", "b", "/p") is narrow
        assert t.policy_for("x", "b", "/p") is broad

    def test_later_entry_breaks_ties(self):
        t = LinkPolicyTable()
        first, second = LinkPolicy(delay_s=0.1), LinkPolicy(delay_s=0.2)
        t.set(first)
        t.set(second)
        assert t.policy_for("a", "b", "/p") is second

    def test_glob_patterns(self):
        t = LinkPolicyTable()
        pol = LinkPolicy(delay_s=0.1)
        t.set(pol, dst="livepeer-*")
        assert t.policy_for("x", "livepeer-7", "/p") is pol
        assert t.policy_for("x", "other", "/p") is None

    def test_remove_exact_triple(self):
        t = LinkPolicyTable()
        broad = LinkPolicy(delay_s=0.1)
        override = LinkPolicy(drop_prob=1.0)
        t.set(broad)
        t.set(override, dst="h1")
        assert t.policy_for("a", "h1", "/p") is override
        assert t.remove(dst="h1") == 1
        assert t.policy_for("a", "h1", "/p") is broad
        assert t.remove(dst="h1") == 0

    def test_clear(self):
        t = LinkPolicyTable()
        t.set(LinkPolicy(delay_s=0.1))
        t.clear()
        assert t.policy_for("a", "b", "/p") is None

    def test_partition_helpers_match_the_reference(self):
        tables = []
        for mod in (tchaos, jchaos):
            t = mod.LinkPolicyTable()
            assert mod.install_partition(t, ["h1", "h2"], ["h3"]) == 4
            tables.append([(r[:3], dataclasses.astuple(r[3]))
                           for r in t._rules])
            assert t.policy_for("h1", "h3", "/p").blackhole
            assert t.policy_for("h3", "h2", "/p").blackhole
            assert t.policy_for("h1", "h2", "/p") is None
            assert mod.remove_partition(t, ["h1", "h2"], ["h3"]) == 4
            assert t.policy_for("h1", "h3", "/p") is None
        assert tables[0] == tables[1]


# -- ChaosTransport determinism ----------------------------------------------------

_GOLDEN_KW = dict(
    drop_prob=0.3, duplicate_prob=0.2, reorder_prob=0.2,
    reorder_extra_s=0.004, delay_s=0.001, jitter_s=0.002, reset_prob=0.05,
)
_GOLDEN_POLICY = LinkPolicy(**_GOLDEN_KW)
_GOLDEN_LINK = ("a", "b", "/x/1.0")

# The reference's golden trace (tests/test_chaos.py): 20 decisions on seed 42.
_GOLDEN_TRACE = [
    ("drop", 0), ("delay", 1, 1186), ("delay", 2, 1742), ("delay", 3, 2579),
    ("drop", 4), ("reorder", 5), ("delay", 5, 5660), ("reorder", 6),
    ("delay", 6, 5402), ("reorder", 7), ("delay", 7, 6117), ("drop", 8),
    ("drop", 9), ("dup", 10), ("delay", 10, 1212), ("delay", 11, 1019),
    ("drop", 12), ("delay", 13, 1941), ("delay", 14, 1961),
    ("delay", 15, 1373), ("dup", 16), ("reorder", 16), ("delay", 16, 6870),
    ("delay", 17, 2760), ("drop", 18), ("delay", 19, 1602),
]


def _fault_trace(mod, seed, links, n, nbytes=100, **kw):
    """Every link's trace and every decision after ``n`` interleaved
    decisions a link, under one package's chaos layer."""
    ct = mod.ChaosTransport(seed=seed)
    pol = mod.LinkPolicy(**(kw or _GOLDEN_KW))
    decisions = []
    for _ in range(n):
        for link in links:
            d = ct.decide(link, pol, nbytes)
            decisions.append(dataclasses.astuple(d))
    return {link: ct.trace(link) for link in links}, decisions


class TestChaosDeterminism:
    def test_golden_trace(self):
        ct = ChaosTransport(seed=42)
        for _ in range(20):
            ct.decide(_GOLDEN_LINK, _GOLDEN_POLICY, 100)
        assert ct.trace(_GOLDEN_LINK) == _GOLDEN_TRACE

    @pytest.mark.parametrize("seed", [0, 7, 42, 2026])
    def test_fault_traces_equal_the_references(self, seed):
        links = [_GOLDEN_LINK, ("a", "c", "/x/1.0"), ("livepeer-3",
                                                       "livepeer-0", "/t")]
        ours = _fault_trace(tchaos, seed, links, 64)
        theirs = _fault_trace(jchaos, seed, links, 64)
        assert ours == theirs
        kw = dict(bandwidth_bytes_per_s=5e4, reset_after_msgs=9,
                  drop_prob=0.1)
        assert _fault_trace(tchaos, seed, links, 16, 700, **kw) == \
            _fault_trace(jchaos, seed, links, 16, 700, **kw)

    def test_seed_changes_trace(self):
        ct = ChaosTransport(seed=43)
        for _ in range(20):
            ct.decide(_GOLDEN_LINK, _GOLDEN_POLICY, 100)
        assert ct.trace(_GOLDEN_LINK) != _GOLDEN_TRACE

    def test_links_are_independent(self):
        la, lb = ("a", "b", "/p"), ("a", "c", "/p")
        ct1 = ChaosTransport(seed=7)
        for _ in range(10):
            ct1.decide(la, _GOLDEN_POLICY, 64)
            ct1.decide(lb, _GOLDEN_POLICY, 64)
        ct2 = ChaosTransport(seed=7)
        for _ in range(10):
            ct2.decide(la, _GOLDEN_POLICY, 64)
        for _ in range(10):
            ct2.decide(lb, _GOLDEN_POLICY, 64)
        assert ct1.trace(la) == ct2.trace(la)
        assert ct1.trace(lb) == ct2.trace(lb)

    def test_reset_after_msgs_fires_once(self):
        ct = ChaosTransport(seed=0)
        pol = LinkPolicy(reset_after_msgs=3)
        link = ("a", "b", "/p")
        decisions = [ct.decide(link, pol, 10) for _ in range(6)]
        assert [d.reset for d in decisions] == [
            False, False, True, False, False, False
        ]
        assert ct.trace(link) == [("reset", 2)]

    def test_bandwidth_serialization_time(self):
        ct = ChaosTransport(seed=0)
        d = ct.decide(("a", "b", "/p"),
                      LinkPolicy(bandwidth_bytes_per_s=1000.0), 500)
        assert d.ser_s == pytest.approx(0.5)

    def test_blackhole_dial(self):
        ct = ChaosTransport(seed=0)
        ct.table.set(LinkPolicy(blackhole=True), dst="b")
        assert not ct.allow_dial("a", "b", "/p")
        assert ct.allow_dial("a", "c", "/p")
        assert ct.trace(("a", "b", "/p")) == [("blackhole_dial",)]


# -- RetryPolicy / CircuitBreaker ----------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fake_policy(opts, registry=None, seed=7):
    clock = _FakeClock()
    sleeps = []

    async def sleep(d):
        sleeps.append(d)
        clock.t += d

    pol = RetryPolicy(opts=opts, registry=registry,
                      rng=random.Random(seed), clock=clock, sleep=sleep)
    return pol, clock, sleeps


class TestRetryPolicy:
    def test_backoff_delays_golden(self):
        pol = RetryPolicy(opts=tcfg.RetryOpts(max_attempts=6),
                          rng=random.Random(7))
        delays = [round(d, 6) for d in pol.backoff_delays()]
        assert delays == [0.082383, 0.07974, 0.17317, 0.084009, 0.158263]
        assert all(0.05 <= d <= 2.0 for d in delays)

    @pytest.mark.parametrize("seed", [0, 7, 19, 2026])
    def test_backoff_delays_equal_the_references(self, seed):
        for kw in ({"max_attempts": 6}, {"max_attempts": 12,
                                          "base_delay_s": 0.01,
                                          "max_delay_s": 0.3}):
            ours = list(tpolicy.RetryPolicy(
                opts=tcfg.RetryOpts(**kw),
                rng=random.Random(seed)).backoff_delays())
            theirs = list(jpolicy.RetryPolicy(
                opts=jcfg.RetryOpts(**kw),
                rng=random.Random(seed)).backoff_delays())
            assert ours == theirs
            assert len(ours) == kw["max_attempts"] - 1

    def test_success_first_attempt(self):
        reg = MetricsRegistry()
        pol, _, sleeps = _fake_policy(tcfg.RetryOpts(), registry=reg)

        async def fn():
            return "ok"

        assert asyncio.run(pol.run("dial", fn)) == "ok"
        assert sleeps == []
        assert reg.counter("live.retry.dial.attempt") == 1
        assert reg.counter("live.retry.dial.success") == 1
        assert reg.counter("live.retry.dial.retry") == 0

    def test_retries_then_succeeds(self):
        reg = MetricsRegistry()
        pol, _, sleeps = _fake_policy(tcfg.RetryOpts(max_attempts=5),
                                      registry=reg)
        calls = []

        async def fn():
            calls.append(1)
            if len(calls) < 3:
                raise StreamClosed("dial failed")
            return "ok"

        assert asyncio.run(pol.run("dial", fn)) == "ok"
        assert len(calls) == 3
        assert len(sleeps) == 2
        assert reg.counter("live.retry.dial.attempt") == 3
        assert reg.counter("live.retry.dial.retry") == 2
        assert reg.counter("live.retry.dial.success") == 1

    def test_exhausted_raises_last_failure(self):
        reg = MetricsRegistry()
        pol, _, _ = _fake_policy(tcfg.RetryOpts(max_attempts=3), registry=reg)

        async def fn():
            raise StreamClosed("always down")

        with pytest.raises(StreamClosed, match="always down"):
            asyncio.run(pol.run("join", fn))
        assert reg.counter("live.retry.join.attempt") == 3
        assert reg.counter("live.retry.join.exhausted") == 1

    def test_non_retryable_propagates_immediately(self):
        reg = MetricsRegistry()
        pol, _, _ = _fake_policy(tcfg.RetryOpts(max_attempts=5), registry=reg)

        async def fn():
            raise RuntimeError("logic bug")

        with pytest.raises(RuntimeError):
            asyncio.run(pol.run("dial", fn))
        assert reg.counter("live.retry.dial.attempt") == 1
        assert reg.counter("live.retry.dial.retry") == 0

    def test_deadline_stops_retry_loop(self):
        reg = MetricsRegistry()
        opts = tcfg.RetryOpts(max_attempts=10, base_delay_s=5.0,
                              max_delay_s=5.0, deadline_s=1.0)
        pol, clock, _ = _fake_policy(opts, registry=reg)
        calls = []

        async def fn():
            calls.append(1)
            raise StreamClosed("down")

        with pytest.raises(StreamClosed):
            asyncio.run(pol.run("adopt", fn))
        assert len(calls) < 3
        assert clock.t <= opts.deadline_s + 1e-9
        assert reg.counter("live.retry.adopt.exhausted") == 1

    def test_wait_for_counts_timeouts(self):
        reg = MetricsRegistry()
        pol = RetryPolicy(opts=tcfg.RetryOpts(), registry=reg)

        async def go():
            await pol.wait_for(asyncio.sleep(5), timeout_s=0.01, cls="repair")

        with pytest.raises(asyncio.TimeoutError):
            asyncio.run(go())
        assert reg.counter("live.retry.repair.timeout") == 1


class TestCircuitBreaker:
    def test_transitions(self):
        clock = _FakeClock()
        reg = MetricsRegistry()
        br = CircuitBreaker("dial", failures_to_open=3, reset_s=10.0,
                            registry=reg, clock=clock)
        assert br.allow()
        for _ in range(3):
            br.record_failure()
        assert br.state == CircuitBreaker.OPEN
        assert not br.allow()
        assert reg.counter("live.breaker.dial.fastfail") == 1
        clock.t = 10.0
        assert br.allow()
        assert br.state == CircuitBreaker.HALF_OPEN
        br.record_failure()
        assert br.state == CircuitBreaker.OPEN
        clock.t = 20.0
        assert br.allow()
        br.record_success()
        assert br.state == CircuitBreaker.CLOSED
        assert reg.counter("live.breaker.dial.opened") == 2
        assert reg.counter("live.breaker.dial.closed") == 1

    def test_policy_fast_fails_when_open(self):
        reg = MetricsRegistry()
        opts = tcfg.RetryOpts(max_attempts=1, breaker_failures=2)
        pol, _, _ = _fake_policy(opts, registry=reg)

        async def fn():
            raise StreamClosed("down")

        for _ in range(2):
            with pytest.raises(StreamClosed):
                asyncio.run(pol.run("dial", fn))

        async def never(_="unreached"):
            raise AssertionError("breaker must fast-fail before the call")

        with pytest.raises(CircuitOpen):
            asyncio.run(pol.run("dial", never))
        assert issubclass(CircuitOpen, StreamClosed)
        assert reg.counter("live.breaker.dial.fastfail") == 1


# -- transport guards --------------------------------------------------------------


class _NullWriter:
    """Just enough writer surface for Stream.close/abort in unit tests."""

    class _T:
        def abort(self):
            pass

    def __init__(self):
        self.transport = self._T()

    def write(self, data):
        pass

    async def drain(self):
        pass

    def close(self):
        pass


class TestStreamGuards:
    @pytest.mark.parametrize("flood", [
        b'"' + b"a" * (MAX_PENDING_BYTES + 2),
        b"[" * (MAX_PENDING_BYTES + 2),
    ], ids=["unterminated", "deep-nesting"])
    def test_oversized_corrupt_stream_aborts(self, flood):
        async def go():
            reader = asyncio.StreamReader()
            s = Stream(reader, _NullWriter(), "peer", "/t/1.0")
            reader.feed_data(flood)
            reader.feed_eof()
            with pytest.raises(StreamClosed, match="oversized"):
                await s.read_message()
            assert s.closed

        asyncio.run(go())

    def test_invalid_utf8_aborts(self):
        async def go():
            reader = asyncio.StreamReader()
            s = Stream(reader, _NullWriter(), "peer", "/t/1.0")
            reader.feed_data(b"\xff\xff")
            reader.feed_eof()
            with pytest.raises(StreamClosed, match="invalid UTF-8"):
                await s.read_message()

        asyncio.run(go())

    def test_frames_read_back_in_order(self):
        async def go():
            reader = asyncio.StreamReader()
            s = Stream(reader, _NullWriter(), "peer", "/t/1.0")
            msgs = [Message(type=MessageType.JOIN),
                    Message(type=MessageType.DATA, data=b"x", replay=True)]
            for m in msgs:
                reader.feed_data(encode_message(m))
            reader.feed_eof()
            return [await s.read_message() for _ in msgs], msgs

        got, want = asyncio.run(go())
        assert got == want


class TestPeerstoreDiagnostics:
    def test_unknown_peer_names_known_ids(self):
        ps = Peerstore()
        for i in range(3):
            ps.add(f"peer-{i}", "127.0.0.1", 4000 + i)
        with pytest.raises(KeyError) as ei:
            ps.addr("ghost")
        msg = str(ei.value)
        assert "ghost" in msg
        for i in range(3):
            assert f"peer-{i}" in msg

    def test_known_id_list_truncates_at_ten(self):
        ps = Peerstore()
        for i in range(14):
            ps.add(f"p{i:02d}", "127.0.0.1", 4000 + i)
        with pytest.raises(KeyError) as ei:
            ps.addr("ghost")
        msg = str(ei.value)
        assert "+4 more" in msg
        assert msg.count("p0") + msg.count("p1") <= 12

    def test_validate_ids_boundary(self):
        from go_libp2p_pubsub_torch.utils.base58 import (
            peer_id_from_ed25519_pub,
        )

        ps = Peerstore(validate_ids=True)
        pid = peer_id_from_ed25519_pub(b"\x05" * 32)
        ps.add(pid, "127.0.0.1", 1234)
        assert ps.addr(pid) == ("127.0.0.1", 1234)
        with pytest.raises(ValueError):
            ps.add("livepeer-0", "127.0.0.1", 1)


class TestLiveCallTimeout:
    def test_names_the_stuck_coroutine(self):
        net = LiveNetwork(device="cpu")
        try:
            with pytest.raises(LiveCallTimeout) as ei:
                net.call(asyncio.sleep(30), timeout=0.1)
            assert ei.value.coro_name == "sleep"
            assert ei.value.timeout_s == 0.1
            assert "sleep" in str(ei.value)
            assert isinstance(ei.value, TimeoutError)
        finally:
            net.shutdown()


class TestLiveDebugFlag:
    def test_env_flag_enables_asyncio_debug(self, monkeypatch):
        monkeypatch.setenv("LIVE_DEBUG", "1")
        net = LiveNetwork(device="cpu")
        try:
            assert net._loop.get_debug()
            assert net._loop.slow_callback_duration == pytest.approx(0.1)
        finally:
            net.shutdown()

    def test_off_by_default(self, monkeypatch):
        monkeypatch.delenv("LIVE_DEBUG", raising=False)
        net = LiveNetwork(device="cpu")
        try:
            assert not net._loop.get_debug()
        finally:
            net.shutdown()


class TestWireReplayFlag:
    def test_round_trip(self):
        m = Message(type=MessageType.DATA, data=b"payload", replay=True)
        out = Message.from_json_obj(m.to_json_obj())
        assert out.replay and out.data == b"payload"

    def test_absent_by_default(self):
        enc = encode_message(Message(type=MessageType.DATA, data=b"x"))
        assert b"replay" not in enc
        assert not Message.from_json_obj({"Type": 0}).replay
