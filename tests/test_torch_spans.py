"""The port's own spans (``go_libp2p_pubsub_torch/utils/trace.py``
``span``/``set_recorder``) on the CPU: off, a span reads no clock and
calls no torch; on, it records names, stamps on the profiler's host
clock, parents and rounds; a closed-loop episode records each layer
boundary the expected number of times; and no span adds an event to a
running profiler."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.crypto.pipeline import (
    Envelope, ValidationPipeline, sign_envelope)
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub
from go_libp2p_pubsub_torch.utils import trace
from go_libp2p_pubsub_torch.utils.trace import StepTimer, span


@pytest.fixture
def timer():
    t = StepTimer()
    before = trace.set_recorder(t)
    yield t
    trace.set_recorder(before)


def _by_name(timer):
    out = {}
    for r in timer.spans:
        out.setdefault(r[0], []).append(r)
    return out


def test_a_span_with_no_recorder_reads_no_clock_and_calls_no_torch(
        monkeypatch):
    assert trace.recorder() is None

    def refuse(*a, **kw):
        raise AssertionError("a span with no recorder did work")

    monkeypatch.setattr(time, "time_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    first = span("round.propagate", 3)
    assert span("publish") is first          # one shared object
    with first as got:
        assert got is None
    # No allocation a span: 100,000 of them leave the heap as it was.
    blocks = sys.getallocatedblocks()
    for _ in range(100_000):
        with span("publish", 7):
            pass
    assert sys.getallocatedblocks() - blocks < 64


def test_nesting_parents_rounds_and_the_bound(timer, monkeypatch):
    with span("rollout", 0):
        with span("round.propagate", 0):
            with span("kernel.k1"):
                pass
        with span("round.heartbeat", 7):
            with span("heartbeat.mesh", 7):
                pass
            with span("heartbeat.gossip", 7):
                with span("kernel.k2"):
                    pass
    with span("publish", 8):
        pass
    names = [r[0] for r in timer.spans]
    assert names == ["rollout", "round.propagate", "kernel.k1",
                     "round.heartbeat", "heartbeat.mesh",
                     "heartbeat.gossip", "kernel.k2", "publish"]
    assert [r[3] for r in timer.spans] == [-1, 0, 1, 0, 3, 3, 5, -1]
    assert [r[4] for r in timer.spans] == [0, 0, None, 7, 7, 7, None, 8]
    for name, start, end, parent, _ in timer.spans:
        assert start <= end
        if parent >= 0:
            _, p0, p1, _, _ = timer.spans[parent]
            assert p0 <= start <= end <= p1
    assert timer.span_seconds("kernel.k2") == [
        (timer.spans[6][2] - timer.spans[6][1]) * 1e-9]
    # Past the bound spans are counted, not kept, and nesting goes on.
    monkeypatch.setattr(trace, "SPAN_CAPACITY", len(timer.spans) + 1)
    with span("round.record", 9):
        with span("dropped"):
            pass
    assert timer.spans[-1][0] == "round.record" and timer.dropped == 1
    # An exception closes its span and leaves the parent pointer right.
    monkeypatch.setattr(trace, "SPAN_CAPACITY", 1 << 20)
    with pytest.raises(ValueError):
        with span("raises"):
            raise ValueError
    with span("after"):
        pass
    assert timer.spans[-1][0] == "after" and timer.spans[-1][3] == -1


def test_each_thread_nests_its_own_spans(timer):
    go = threading.Barrier(4)

    def work(i):
        go.wait()
        for _ in range(50):
            with span(f"outer{i}"):
                with span(f"inner{i}"):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(timer.spans) == 400 and None not in timer.spans
    for name, _, _, parent, _ in timer.spans:
        if name.startswith("inner"):
            assert timer.spans[parent][0] == "outer" + name[-1]
        else:
            assert parent == -1


def _window(n: int = 128, forged=(3, 50, 77, 120)):
    envs = [sign_envelope(bytes([i % 7 + 1]) * 32, "t", i, b"m%d" % i)
            for i in range(n)]
    for i in forged:
        e = envs[i]
        envs[i] = Envelope(e.topic, e.seqno, e.payload + b"x", e.pubkey,
                           e.signature)
    return envs


@pytest.fixture(scope="module")
def episode_setup():
    torch.set_num_threads(1)
    gs = GossipSub(n_peers=300, n_slots=32, conn_degree=16, msg_window=128,
                   device="cpu")
    return gs, gs.init(seed=0), _window()


def _episode(gs, st0, envs):
    """The closed loop's episode: validate the window on the device path,
    publish its 128 messages with their verdicts, a recorded 24-round
    rollout, the delivery statistics."""
    pipe = ValidationPipeline(backend="device", device="cpu",
                              flush_threshold=len(envs) + 1)
    for e in envs:
        pipe.submit(e)
    ok = [v for _, v in pipe.flush()]
    pubs = np.random.default_rng(5).integers(gs.n, size=len(envs))
    st = st0
    for slot, src in enumerate(pubs):
        st = gs.publish(st, int(src), slot, ok[slot])
    out, rec = gs.rollout(st, 24, record=True)
    return ok, out, rec, gs.delivery_stats(out)


def test_a_closed_loop_episode_records_each_boundary(episode_setup):
    gs, st0, envs = episode_setup
    plain = _episode(gs, st0, envs)
    timer = StepTimer()
    trace.set_recorder(timer)
    try:
        traced = _episode(gs, st0, envs)
    finally:
        trace.set_recorder(None)
    # The spans leave the results as they were.
    assert traced[0] == plain[0] and sum(plain[0]) == 124
    for a, b in zip(traced[1], plain[1]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for name in plain[2]:
        assert torch.equal(traced[2][name], plain[2][name])
    counts = {n: len(rs) for n, rs in _by_name(timer).items()}
    assert {n: counts.get(n, 0) for n in (
        "publish", "rollout", "round.propagate", "round.record",
        "round.heartbeat", "heartbeat.scores", "heartbeat.mesh",
        "heartbeat.px", "heartbeat.gossip", "heartbeat.fanout",
        "validate.flush", "validate.prepare_rows", "kernel.k1",
        "kernel.k2", "kernel.e1")} == {
        "publish": 128, "rollout": 1, "round.propagate": 24,
        "round.record": 24, "round.heartbeat": 3, "heartbeat.scores": 3,
        "heartbeat.mesh": 3, "heartbeat.px": 3, "heartbeat.gossip": 3,
        "heartbeat.fanout": 3, "validate.flush": 1,
        "validate.prepare_rows": 1, "kernel.k1": 24, "kernel.k2": 3,
        "kernel.e1": 1}
    assert counts["rng.split"] >= 128 + 3 and timer.dropped == 0
    parent = {"round.propagate": "rollout", "round.record": "rollout",
              "round.heartbeat": "rollout", "heartbeat.mesh":
              "round.heartbeat", "heartbeat.gossip": "round.heartbeat",
              "kernel.k1": "round.propagate", "kernel.k2":
              "heartbeat.gossip", "validate.prepare_rows": "validate.flush",
              "kernel.e1": "validate.flush", "publish": None,
              "validate.flush": None, "rollout": None}
    for name, want in parent.items():
        for r in _by_name(timer)[name]:
            got = timer.spans[r[3]][0] if r[3] >= 0 else None
            assert got == want, (name, got)
    # Each round's spans carry its step: rounds 0..23, heartbeats at 7,
    # 15, 23, and the rollout opens at 0.
    assert [r[4] for r in _by_name(timer)["round.propagate"]] == list(
        range(24))
    assert [r[4] for r in _by_name(timer)["round.record"]] == list(
        range(24))
    assert [r[4] for r in _by_name(timer)["round.heartbeat"]] == [7, 15, 23]


def test_span_stamps_agree_with_the_profilers_host_events(timer):
    from torch.profiler import ProfilerActivity, profile, record_function

    # Five blocks, each a span around a profiler range: the clocks agree
    # when the closest pair of stamps does (a busy host may preempt any
    # one block between the two).
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):   # the first range sets itself up
            pass
        for i in range(5):
            with span("block", i):
                with record_function(f"block{i}"):
                    torch.ones(1000).cumsum(0)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    gaps = []
    for _, s0, s1, _, i in timer.spans:
        e = events[f"block{i}"]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s0 <= start and end <= s1      # the span holds the range
        gaps.append(max(start - s0, s1 - end))
    assert len(gaps) == 5 and min(gaps) < 1_000_000


def test_a_span_adds_no_event_to_a_running_profiler(timer):
    from torch.profiler import ProfilerActivity, profile

    def names(spans_on):
        trace.set_recorder(timer if spans_on else None)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                with span("round.propagate", 1):
                    with span("kernel.k1"):
                        torch.ones(8).add(1)
        return sorted(e.name() for e in prof.profiler.kineto_results.events())

    with_spans, without = names(True), names(False)
    assert with_spans == without
    assert not {"round.propagate", "kernel.k1"} & set(with_spans)
    assert len(timer.spans) == 10


def test_spans_join_a_profiler_trace_on_its_timeline(timer, tmp_path):
    import json

    from torch.profiler import record_function

    with trace.profiler_trace(str(tmp_path), "cpu", "t.json"):
        with record_function("warm"):   # the first range sets itself up
            pass
        for i in range(3):
            with span("block", i), record_function(f"block{i}"):
                torch.ones(1000).cumsum(0)
    path = str(tmp_path / "t.json")
    assert trace.add_spans_to_trace(path, timer) == 3
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    theirs = {e["name"]: e for e in events
              if e.get("name", "").startswith("block")}
    assert [e["args"]["step"] for e in ours] == [0, 1, 2]
    assert min(abs(e["ts"] - theirs[f"block{e['args']['step']}"]["ts"])
               for e in ours) < 1000.0   # µs
