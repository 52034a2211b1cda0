"""The stream cells: their lookup, their traffic, their metric and the
comparison that decides ``correct``, driven on the CPU at a small size.

The stream driver runs its whole run here (set-up, window, drain, the
program's outputs against the plain reference) on the CPU, past the
harness's look for a card.  A sound program reads ``correct``; the control
(the reference in bfloat16, in the program's place) and each fault
planted in the serving path underneath read not correct.

Run from the repository's root: ``python -m pytest pubsub_bench/tests -q``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pubsub_bench.harness import common, registry, stream  # noqa: E402
from pubsub_bench.traffic import stream_arrivals  # noqa: E402

CELLS = ("stream100k_steady", "stream100k_saturated")
SMALL = dict(n_peers=300, msg_window=128, pub_width=4)
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- lookup ------------------------------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_the_registry_finds_each_stream_cell(name):
    cell = registry.cell(name)
    assert cell["entry"]["chips"] == 1
    assert cell["config"]["name"] == "eth_beacon_2t_100k"
    assert registry.driver(cell["config"]) is stream
    assert registry.generator(cell["traffic"]) is stream_arrivals
    names = {m["name"] for m in cell["per_layer"]}
    # The stream's own layers, and the closed loop's span and device
    # metrics read alike on the stream.
    assert {"chunk_ms.stream", "ingest_ms.stream", "fold_ms.stream",
            "publish_ms.sim", "propagate_ms.sim", "heartbeat_ms.sim",
            "hb_mesh_ms.sim", "hb_gossip_ms.sim", "record_ms.sim",
            "device_idle.sim", "launches_per_round.sim"} <= names
    assert ({"k1_roofline.sim", "k2_roofline.sim"} <= names) == (
        name == "stream100k_saturated")
    for m in cell["per_layer"]:
        assert registry.metric_reader(m["name"]) is not None
    assert [m["name"] for m in cell["end_to_end"]] == [
        "validated_msgs_per_s", "setup_s"]


def test_the_deployment_keeps_the_specs_widths():
    cfg = registry.cell(CELLS[0])["config"]
    p = cfg["params"]
    assert (p["d"], p["d_lo"], p["d_hi"], p["d_lazy"]) == (8, 6, 12, 6)
    assert (p["history_length"], p["history_gossip"]) == (6, 3)
    assert p["heartbeat_interval_s"] == 0.7 and p["fanout_ttl_s"] == 60.0
    assert round(p["seen_ttl_s"] / p["heartbeat_interval_s"]) == 550
    assert (cfg["n_topics"], cfg["msg_window"], cfg["reduced"]) == (2, 512, [])
    live = p["history_length"] * cfg["heartbeat_steps"] * cfg["pub_width"]
    assert live <= cfg["msg_window"] < 2 * live
    assert len(cfg["source"]) <= 200


# -- the traffic -------------------------------------------------------------------


def _mix(name):
    return registry.cell(name)["traffic"]


def test_the_stream_is_made_from_the_seed():
    mix = _mix("stream100k_saturated")
    a = stream_arrivals.messages(mix, SEED, 3000, 1000)
    b = stream_arrivals.messages(mix, SEED, 3000, 1000)
    c = stream_arrivals.messages(mix, SEED + 1, 3000, 1000)
    for key in ("topic", "publisher", "forged"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["payload"] == b["payload"] and a["keys"] == b["keys"]
    assert a["payload"] != c["payload"]
    assert not np.array_equal(a["publisher"], c["publisher"])
    assert stream_arrivals.stretch_start(mix, SEED) == \
        stream_arrivals.stretch_start(mix, SEED)
    lo, hi = mix["check_chunks"]
    assert lo <= stream_arrivals.stretch_start(mix, SEED) <= hi


def test_the_topic_mix_and_the_forged_share():
    mix = _mix("stream100k_saturated")
    every = mix["block_every"]
    m = stream_arrivals.messages(mix, SEED, 4 * every, 100_000)
    blocks = np.flatnonzero(m["topic"] == 0)
    assert len(blocks) == 4 and set(np.diff(blocks)) == {every}
    assert set(m["topic"]) == {0, 1}
    per = mix["forged_per"]
    groups = m["forged"][: len(m["forged"]) // per * per].reshape(-1, per)
    assert set(groups.sum(1)) == {mix["forged"]}
    assert m["publisher"].min() >= 0 and m["publisher"].max() < 100_000
    assert all(len(p) == 64 for p in m["payload"])


def test_a_steady_stream_has_fixed_gaps_rotated_by_the_seed():
    mix = dict(_mix("stream100k_steady"), rate_msgs_per_s=200.0)
    t = stream_arrivals.arrivals(mix, SEED, 1000)
    np.testing.assert_allclose(np.diff(t), 1 / 200.0)
    assert 0.0 <= t[0] < 1 / 200.0
    assert t[0] != stream_arrivals.arrivals(mix, SEED + 1, 1)[0]
    assert stream_arrivals.count(mix, 10.0) >= 200 * 10 + mix["warm"]


# -- the metrics' arithmetic ----------------------------------------------------------


def test_the_metric_is_deliveries_over_the_window():
    assert stream.validated_rate(3 * 99_500, 2.0) == pytest.approx(149_250.0)


def test_the_steady_readers_on_a_fake_run():
    lanes = registry.metric_reader("lanes_filled.stream")
    p95 = registry.metric_reader("ingest_p95_ms.stream")
    records = {"counters": {"lanes_filled": 48, "lanes_offered": 64},
               "latencies_s": list(np.linspace(0.1, 0.2, 101))}
    assert lanes(records) == pytest.approx(75.0)
    assert p95(records) == pytest.approx(195.0)
    assert lanes({"counters": {}}) is None and p95({}) is None


def test_the_lanes_of_a_stretch_follow_the_ring():
    pushed = [(i, i % 3 > 0) for i in range(10)]
    assert stream.lane_items(pushed, 2, [3, 0, 4]) == pushed[2:9]


# -- whole runs on the CPU -----------------------------------------------------------


def _run(name="stream100k_saturated", seconds=10.0, pool=800, trace=0,
         **extra):
    cell = registry.cell(name)
    cfg = dict(cell["config"], **SMALL)
    mix = dict(cell["traffic"], check_chunks=[0, 0], warm=16, pool=pool,
               pool_msgs_per_s=0)
    if mix["mode"] == "steady":
        mix["rate_msgs_per_s"] = 12.0
    out = stream.run(dict(
        config=cfg, traffic=mix, seed=SEED, seconds=seconds, trace=trace,
        dev=torch.device("cpu"), card={"kind": "cpu", "sms": 1,
                                       "max_sm_clock_mhz": None},
        t_start=time.perf_counter(), **extra))
    return all(common.check_passes(c) for c in out["checks"]), out


def _failed(out):
    return {c["name"] for c in out["checks"] if not common.check_passes(c)}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_stream_run_is_correct(name):
    ok, out = _run(name)
    assert ok, _failed(out)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["e2e"]["validated_msgs_per_s"] > 0


def test_a_program_faster_than_the_pool_is_still_correct():
    """A saturated window that has used up its signed pool ends at that
    chunk boundary, its metric over the seconds it ran: a program that
    serves faster than the pool provides for is not read as not correct."""
    lanes = SMALL["pub_width"] * registry.cell(CELLS[1])["config"][
        "chunk_steps"]
    ok, out = _run(pool=6 * lanes, seconds=300.0)
    assert ok, _failed(out)
    counters = out["records"]["counters"]
    assert counters["pool_exhausted"] and counters["chunks"] == 6
    assert counters["window_s"] < 300.0
    assert out["e2e"]["validated_msgs_per_s"] > 0


def test_the_saturated_pool_outlasts_a_much_faster_program():
    mix = _mix("stream100k_saturated")
    cfg = registry.cell(CELLS[1])["config"]
    lanes = cfg["chunk_steps"] * cfg["pub_width"]
    # Every lane filled by chunks of 50 ms, four times the card's best
    # rate, for the whole window.
    assert stream_arrivals.count(mix, 51.0) >= lanes * 51.0 / 0.05


def test_a_traced_run_counts_lanes_before_the_trace():
    """The host counters of a traced run are read over the untraced part
    of its window alone, and the readers' recorder is set again after."""
    from go_libp2p_pubsub_torch.utils import trace as program_trace

    timer = program_trace.StepTimer()
    before = program_trace.set_recorder(timer)
    try:
        ok, out = _run("stream100k_steady", seconds=6.0, trace=1)
        assert program_trace.recorder() is timer
    finally:
        program_trace.set_recorder(before)
    assert ok, _failed(out)
    counters = out["records"]["counters"]
    lanes = SMALL["pub_width"] * registry.cell(CELLS[0])["config"][
        "chunk_steps"]
    assert 0 < counters["host_chunks"] < counters["chunks"]
    assert counters["lanes_offered"] == counters["host_chunks"] * lanes
    assert not counters["pool_exhausted"]


def test_the_stream_control_is_not_correct():
    ok, out = _run(control=True)
    assert not ok
    assert "float_gap" in _failed(out)


# -- faults in the serving path ---------------------------------------------------------


def test_a_dropped_valid_publish(monkeypatch):
    from go_libp2p_pubsub_torch.serve.ingest import IngestRing

    pop = IngestRing.pop_batch
    dropped = []

    def lossy(self, max_n):
        items = pop(self, max_n)
        if not dropped:
            for j, item in enumerate(items):
                if item.valid:
                    dropped.append(items.pop(j))
                    break
        return items

    monkeypatch.setattr(IngestRing, "pop_batch", lossy)
    ok, out = _run()
    assert not ok and dropped
    assert "valid_not_completed_once" in _failed(out)


def test_a_forged_message_relayed_past_its_publisher(monkeypatch):
    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub

    publish = MultiTopicGossipSub.publish

    def trusting(self, st, topic, src, slot, valid):
        return publish(self, st, topic, src, slot, True)

    monkeypatch.setattr(MultiTopicGossipSub, "publish", trusting)
    ok, out = _run()
    assert not ok
    assert {"forged_spread", "stretch_mismatches"} <= _failed(out)


def test_one_flipped_state_bit(monkeypatch):
    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub

    step = MultiTopicGossipSub._step_wide

    def flipped(self, st):
        st = step(self, st)
        if st.step % 8 == 4:
            have = st.have_w.clone()
            have[1, 0, 0] ^= 1 << 3
            st = st._replace(have_w=have)
        return st

    monkeypatch.setattr(MultiTopicGossipSub, "_step_wide", flipped)
    ok, out = _run()
    assert not ok and "stretch_mismatches" in _failed(out)


def test_a_float_moved_beyond_the_gap(monkeypatch):
    from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub

    heartbeat = MultiTopicGossipSub._heartbeat

    def drifted(self, st):
        st = heartbeat(self, st)
        c = st.counters
        return st._replace(counters=c._replace(
            time_in_mesh=c.time_in_mesh * 1.001))

    monkeypatch.setattr(MultiTopicGossipSub, "_heartbeat", drifted)
    ok, out = _run()
    assert not ok and "float_gap" in _failed(out)


def test_a_duplicate_completion(monkeypatch):
    from go_libp2p_pubsub_torch.serve.engine import StreamingEngine

    fold = StreamingEngine._fold_completions
    again = []

    def forgetful(self, *args, **kw):
        before = dict(self.pending)
        done = fold(self, *args, **kw)
        if done and not again:
            key = next(k for k in before if k not in self.pending)
            again.append(key)
            self.pending[key] = before[key]
        return done

    monkeypatch.setattr(StreamingEngine, "_fold_completions", forgetful)
    ok, out = _run()
    assert not ok and again
    assert "duplicate_completions" in _failed(out)


def test_an_evicted_slot(monkeypatch):
    from go_libp2p_pubsub_torch.serve.engine import StreamingEngine

    alloc = StreamingEngine._alloc_slot

    def narrow(self, item):
        slot = alloc(self, item)
        self._next_slot[item.topic] %= 3
        return slot

    monkeypatch.setattr(StreamingEngine, "_alloc_slot", narrow)
    ok, out = _run()
    assert not ok and "evicted" in _failed(out)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_of_the_stream_cell_is_correct_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, "pubsub_bench/run.py", "--workload", name,
         "--seed", str(2**31 + 3), "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
