"""The port's streaming serving plane held against the JAX package's: the
engine under one feed and one stepping clock (the same completions,
latencies, flight tails and final state), a JAX-written snapshot restored
into the port's engine (and the other way round), the prepared-program
count, exactly-once across a crash, the refusals, and the copies pinned
to their originals (ring, tuning, export, metrics registry).  The ring's
policy tests are copies of the reference's ``tests/test_serve.py`` on the
port's ring.

The committed 100,000-peer stream trace
(``go_libp2p_pubsub_torch/serve/traces/stream_100000.trace.json``) is the
JAX package's engine on the CPU through the serving bench's three
workloads; the tier-1 tests check its shape, and the ``slow`` one
regenerates it (about ten minutes of CPU) and asserts it is the committed
file byte for byte.  To rewrite it after a deliberate change of the
reference:

    JAX_PLATFORMS=cpu python tests/test_torch_serve.py --write
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from go_libp2p_pubsub_torch.serve import stream_trace as S  # noqa: E402


def reference_replay(n_peers: int):
    """The JAX package's engine on the CPU through the trace's workloads."""
    from go_libp2p_pubsub_tpu.models.multitopic import MultiTopicGossipSub
    from go_libp2p_pubsub_tpu.serve import IngestRing, StreamingEngine

    clock = S.SteppingClock()
    model = MultiTopicGossipSub(**dict(S.CONFIG, n_peers=n_peers))
    ring = IngestRing(capacity=S.CAPACITY, policy="block", clock=clock)
    engine = StreamingEngine(model, ring, seed=0, clock=clock, **S.ENGINE)
    engine.warmup()
    body = S.replay(engine, ring, model, S.workloads(n_peers), np.asarray)
    return dict(S.header(n_peers), **body)


def write_trace(path: str = S.TRACE_PATH) -> None:
    doc = reference_replay(S.CONFIG["n_peers"])
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_serve.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_trace()
    sys.exit(0)


import jax  # noqa: E402
import torch  # noqa: E402

from go_libp2p_pubsub_tpu.models.multitopic import (  # noqa: E402
    MultiTopicGossipSub as JM)
from go_libp2p_pubsub_tpu.serve import IngestRing as JR  # noqa: E402
from go_libp2p_pubsub_tpu.serve import StreamingEngine as JE  # noqa: E402
from go_libp2p_pubsub_tpu.utils import checkpoint as jckpt  # noqa: E402
from go_libp2p_pubsub_tpu.utils import metrics as jmetrics  # noqa: E402
from go_libp2p_pubsub_torch import bridge  # noqa: E402
from go_libp2p_pubsub_torch.models.multitopic import (  # noqa: E402
    MultiTopicGossipSub as TM)
from go_libp2p_pubsub_torch.serve import (  # noqa: E402
    BACKPRESSURE_POLICIES,
    IngestRing,
    StreamingEngine,
)
from go_libp2p_pubsub_torch.serve import engine as tengine  # noqa: E402
from go_libp2p_pubsub_torch.utils import checkpoint  # noqa: E402
from go_libp2p_pubsub_torch.utils.metrics import (  # noqa: E402
    MetricsRegistry,
    quantiles,
)

from test_torch_multitopic import assert_same_state  # noqa: E402

_TINY = dict(n_topics=2, n_peers=16, n_slots=8, conn_degree=4,
             msg_window=32, heartbeat_steps=4)
_CHUNK = dict(chunk_steps=6, pub_width=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of small ops: with several test workers on the same cores,
    torch's intra-op thread pools spin against each other and run them
    several times slower.  One thread per op keeps them fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return TM(device="cpu", **_TINY)


@pytest.fixture(scope="module")
def jmodel():
    return JM(**_TINY)


def _pair(model, clock=time.monotonic, **kw):
    ring = IngestRing(capacity=kw.pop("capacity", 16),
                      policy=kw.pop("policy", "block"), clock=clock)
    return StreamingEngine(model, ring, clock=clock, **_CHUNK, **kw), ring


def _jpair(jmodel, clock, **kw):
    ring = JR(capacity=16, policy="block", clock=clock)
    return JE(jmodel, ring, clock=clock, **_CHUNK, **kw), ring


def _feed(eng, ring, chunks, base=0):
    """A few chunks of pushes (one forged), then a drain; returns each
    chunk's (pending keys, flight tail)."""
    out = []
    for c in range(chunks):
        for i in range(3):
            ring.push(topic=i % 2, payload=b"m %d %d" % (base + c, i),
                      publisher=(c * 5 + i) % 16,
                      valid=not (c == 1 and i == 2))
        eng.run_chunk()
        out.append((sorted(eng.pending), dict(eng.flight_tail)))
    while eng.pending or ring.depth:
        eng.run_chunk()
        out.append((sorted(eng.pending), dict(eng.flight_tail)))
    return out


def _same_tails(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


def _same_runs(ref, out):
    assert len(ref) == len(out)
    for (pa, ta), (pb, tb) in zip(ref, out):
        assert pa == pb
        _same_tails(ta, tb)


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------


def test_engine_matches_reference_under_one_clock(model, jmodel):
    """One feed, one stepping clock: the same completions chunk by chunk,
    latencies, flight tails, invalid publishes and final state."""
    jc, tc = S.SteppingClock(), S.SteppingClock()
    je, jring = _jpair(jmodel, jc)
    te, tring = _pair(model, tc)
    je.warmup()
    te.warmup()
    _same_tails(je.flight_tail, te.flight_tail)
    _same_runs(_feed(je, jring, 4), _feed(te, tring, 4))
    assert te.latencies_s == je.latencies_s and te.completed == 11
    assert te.invalid_published == je.invalid_published
    assert [vars(p) for p in te.publish_log] == [
        vars(p) for p in je.publish_log]
    assert_same_state(je.state, te.state, "engine")


def test_trace_replay_matches_reference_at_small_scale():
    """The trace's three workloads at 300 peers: the port's replay document
    equals the JAX package's, chunk for chunk (0 mismatches)."""
    ref = reference_replay(300)
    out, _ = S.port_replay(300, device="cpu")
    assert S.mismatches(out, ref) == []
    assert out == ref
    assert len(ref["invalid_published"]) == S.N_FORGED
    assert sum(len(w["chunks"]) for w in ref["workloads"].values()) > 10


class _Recorder:
    """A duck-typed tracer and black box that log every call."""

    def __init__(self):
        self.calls = []

    def stamp(self, key, stage, **attrs):
        self.calls.append(("stamp", key, stage, sorted(attrs.items())))

    def close(self, key, **attrs):
        self.calls.append(("close", key, sorted(attrs.items())))

    def record(self, frame):
        self.calls.append(("frame", sorted(frame.items())))


def test_tracer_and_blackbox_hooks_match_reference(model, jmodel):
    """With a tracer and a black box the engine stamps the same spans (the
    exact delivery rounds of ``stream_deliver_steps`` included) and
    records the same frames as the reference, and delivers the same."""
    logs = []
    for eng_of, mdl in ((_jpair, jmodel), (_pair, model)):
        rec = _Recorder()
        clock = S.SteppingClock()
        eng, ring = eng_of(mdl, clock, tracer=rec, blackbox=rec)
        eng.warmup()
        runs = _feed(eng, ring, 3)
        logs.append((rec.calls, eng.latencies_s, eng.latencies_exact_s, runs))
    (jc, jl, jx, jr), (tc, tl, tx, tr) = logs
    assert tc == jc and tl == jl and tx == jx
    assert any(c[0] == "close" for c in tc) and len(tx) == len(tl) > 0
    _same_runs(jr, tr)


def test_profile_every_writes_a_chunk_trace(model, tmp_path):
    eng, ring = _pair(model, profile_every=2, profile_dir=str(tmp_path))
    eng.warmup()
    for c in range(4):
        ring.push(topic=c % 2, payload=b"p%d" % c, publisher=c)
        eng.run_chunk()
    assert eng.profile_captures == 2
    assert sorted(os.listdir(tmp_path)) == [
        "chunk_000001.json", "chunk_000003.json"]


def test_profile_every_captures_through_profiler_trace(model, tmp_path,
                                                       monkeypatch):
    """The engine's capture is ``utils.trace.profiler_trace``: one call a
    chunk, the profiled chunks naming the directory and their file."""
    from go_libp2p_pubsub_torch.serve import engine as engine_mod

    calls = []
    real = engine_mod.profiler_trace

    def spy(log_dir, device="cpu", file_name="trace.json"):
        calls.append((log_dir, file_name))
        return real(log_dir, device, file_name)

    monkeypatch.setattr(engine_mod, "profiler_trace", spy)
    eng, ring = _pair(model, profile_every=2, profile_dir=str(tmp_path))
    eng.warmup()
    calls.clear()
    for c in range(4):
        ring.push(topic=c % 2, payload=b"p%d" % c, publisher=c)
        eng.run_chunk()
    assert [c for c in calls if c[0] is not None] == [
        (str(tmp_path), "chunk_000001.json"),
        (str(tmp_path), "chunk_000003.json")]
    assert len(calls) == 4 and eng.profile_captures == 2
    assert sorted(os.listdir(tmp_path)) == [
        "chunk_000001.json", "chunk_000003.json"]


def test_jax_written_snapshot_continues_in_the_port(model, jmodel,
                                                    tmp_path):
    """A snapshot the JAX engine wrote mid-flight restores into a fresh,
    warmed port engine, which then continues as the JAX engine does; the
    port's snapshot of the same point is the same archive, leaf for leaf,
    and restores into the JAX engine."""
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jc = S.SteppingClock()
    je, jring = _jpair(jmodel, jc)
    je.warmup()
    _feed(je, jring, 1)
    for i in range(4):
        jring.push(topic=i % 2, payload=b"tail %d" % i, publisher=3 + i)
    je.run_chunk()
    jring.push(topic=0, payload=b"queued", publisher=9)
    je.snapshot(jpath)

    tc = S.SteppingClock()
    tc.t = jc.t
    te, _ = _pair(model, tc)
    te.warmup()
    tc.t = jc.t
    info = te.restore(jpath)
    assert info["replayed"] == 1 and info["pending"] == len(je.pending)
    assert_same_state(je.state, te.state, "restored")
    _same_tails(je.flight_tail, te.flight_tail)
    te.snapshot(tpath)
    snapped = te.state
    a, b = np.load(jpath), np.load(tpath)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        if key != checkpoint._META_KEY:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    ma, mb = jckpt.meta(jpath), checkpoint.meta(tpath)
    assert {k: v for k, v in ma.items() if k != "t_wall"} == {
        k: v for k, v in mb.items() if k != "t_wall"}

    tc.t = jc.t
    _same_runs(_feed(je, je.ring, 2, base=10), _feed(te, te.ring, 2, base=10))
    assert te.latencies_s == je.latencies_s
    assert te.duplicate_completions == je.duplicate_completions == 0
    assert_same_state(je.state, te.state, "continued")

    je2, _ = _jpair(jmodel, S.SteppingClock())
    je2.warmup()
    je2.restore(tpath)
    assert_same_state(je2.state, snapped, "port snapshot in JAX")


def test_checkpoint_key_paths_are_the_references(model):
    st = bridge.multitopic_state_to_numpy(model.init(seed=0))
    tree = {"state": st, "flight_tail": {"step": np.int32(3),
                                         "lat_hist": np.zeros(4, np.int32)}}
    pairs, _ = checkpoint._leaf_paths(tree)
    jpairs, _ = jckpt._leaf_paths(tree)
    assert [k for k, _ in pairs] == [k for k, _ in jpairs]
    assert "['state'].counters.first_message_deliveries" in dict(pairs)


# ---------------------------------------------------------------------------
# the engine's own contracts (the reference's serve and crash tests)
# ---------------------------------------------------------------------------


def test_prepared_programs_across_warmup_chunks_and_a_ladder(model):
    """One prepared program per geometry: warmup prepares every rung of a
    two-rung ladder, and chunks, switches and a fresh engine over an equal
    model prepare nothing more."""
    m = TM(device="cpu", **dict(_TINY, msg_window=16))
    assert sum(1 for (k, _) in tengine._PROGRAMS if k == m) == 0
    ladder = [(6, 2), (4, 3)]
    eng, ring = _pair(m, geometry_ladder=ladder)
    eng.warmup()
    assert eng.compile_cache_size() == eng.ladder_size() == 2
    assert eng.geometry.as_tuple() == (6, 2)
    for c in range(3):
        ring.push(topic=c % 2, payload=b"p%d" % c, publisher=c)
        eng.run_chunk()
        eng.set_geometry(*ladder[(c + 1) % 2])
        assert eng.compile_cache_size() == 2
    with pytest.raises(ValueError, match="ladder"):
        eng.set_geometry(5, 5)
    eng2, _ = _pair(TM(device="cpu", **dict(_TINY, msg_window=16)),
                    geometry_ladder=ladder)
    eng2.warmup()
    assert eng2.compile_cache_size() == 2
    assert eng.chunks_run == 5 and eng.geometry_switches == 3


def test_engine_compiles_once_and_timestamps_are_monotone(model):
    eng, ring = _pair(model)
    eng.warmup()
    assert eng.compile_cache_size() == 1
    for chunk in range(3):
        for i in range(3):
            ring.push(topic=0, payload=b"x%d" % chunk,
                      publisher=(chunk * 3 + i) % 16)
        eng.run_chunk()
        assert eng.compile_cache_size() == 1
    steps = [p.step_published for p in eng.publish_log]
    assert steps == sorted(steps)
    assert len({s // eng.chunk_steps for s in steps}) == 3
    for p in eng.publish_log:
        assert p.t_ingest <= p.t_publish
    eng.run_until_drained(max_chunks=16)
    assert not eng.pending
    q = eng.latency_quantiles()
    assert 0 < q["p50"] <= q["p99"]


def test_engine_invalid_publish_never_delivers(model):
    eng, ring = _pair(model)
    eng.warmup()
    ring.push(topic=0, payload=b"good", publisher=1, valid=True)
    ring.push(topic=0, payload=b"forged", publisher=2, valid=False)
    eng.run_until_drained(max_chunks=16)
    assert eng.completed == 1 and len(eng.invalid_published) == 1
    topic, slot = eng.invalid_published[0]
    delivered = model.stream_digest(eng.state)["delivered"].numpy()
    assert int(delivered[topic, slot]) <= 1


def test_engine_rejects_bad_config(model):
    ring = IngestRing(capacity=4)
    for kw in (dict(chunk_steps=0), dict(completion_frac=0.0),
               dict(snapshot_every=1), dict(profile_every=1)):
        with pytest.raises(ValueError):
            StreamingEngine(model, ring, **kw)


def test_snapshot_restore_exactly_once_no_new_program(model, tmp_path):
    path = str(tmp_path / "engine.ckpt")
    eng1, ring1 = _pair(model)
    eng1.warmup()
    for i in range(4):
        ring1.push(topic=i % 2, payload=b"first %d" % i, publisher=i)
    eng1.run_chunk()
    for i in range(4):
        ring1.push(topic=i % 2, payload=b"second %d" % i, publisher=4 + i)
    before = ring1.accounting()
    eng1.snapshot(path)
    eng2, ring2 = _pair(model)
    eng2.warmup()
    info = eng2.restore(path)
    assert info["replayed"] == 4 and info["chunk"] == eng1.chunks_run
    after = ring2.accounting()
    for key in ("accepted", "popped", "in_queue", "dropped_oldest",
                "silent_drops"):
        assert after[key] == before[key], key
    eng2.run_until_drained(max_chunks=16)
    assert eng2.completed == 8 and eng2.duplicate_completions == 0
    assert eng2.compile_cache_size() == 1
    ring2.push(topic=0, payload=b"first 0", publisher=0)
    ring2.push(topic=1, payload=b"first 1", publisher=1)
    eng2.run_until_drained(max_chunks=16)
    assert eng2.replay_deduped == 2 and eng2.completed == 8
    assert ring2.accounting()["silent_drops"] == 0


def test_crash_mid_save_preserves_previous_snapshot(model, tmp_path,
                                                    monkeypatch):
    path = str(tmp_path / "engine.ckpt")
    eng, ring = _pair(model)
    eng.warmup()
    ring.push(topic=0, payload=b"a", publisher=1)
    eng.run_chunk()
    eng.snapshot(path)
    good_chunk = checkpoint.meta(path)["chunks_run"]
    ring.push(topic=1, payload=b"b", publisher=2)
    eng.run_chunk()
    real_savez = checkpoint.np.savez

    def exploding_savez(f, **arrays):
        real_savez(f, **arrays)
        raise OSError("disk gone mid-save")

    monkeypatch.setattr(checkpoint.np, "savez", exploding_savez)
    with pytest.raises(OSError, match="mid-save"):
        eng.snapshot(path)
    monkeypatch.undo()
    assert checkpoint.meta(path)["chunks_run"] == good_chunk
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    eng2, _ = _pair(model)
    eng2.warmup()
    assert eng2.restore(path)["chunk"] == good_chunk


def test_restore_rejects_mismatched_config(model, tmp_path):
    path = str(tmp_path / "engine.ckpt")
    eng, ring = _pair(model)
    eng.warmup()
    ring.push(topic=0, payload=b"x", publisher=1)
    eng.run_chunk()
    eng.snapshot(path)
    other, _ = _pair(TM(device="cpu", **dict(_TINY, msg_window=8)))
    other.warmup()
    with pytest.raises(ValueError, match="mismatch"):
        other.restore(path)
    eng3 = StreamingEngine(model, IngestRing(capacity=16), chunk_steps=4,
                           pub_width=2)
    eng3.warmup()
    with pytest.raises(ValueError, match="chunk shapes"):
        eng3.restore(path)
    not_engine = str(tmp_path / "other.ckpt")
    checkpoint.save(not_engine, {"x": np.zeros(3)}, meta={"kind": "other"})
    with pytest.raises(ValueError, match="streaming-engine"):
        eng.restore(not_engine)
    tree = {"state": bridge.multitopic_state_spec(eng.state),
            "flight_tail": dict(eng.flight_tail)}
    tree["flight_tail"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="missing"):
        checkpoint.restore(path, tree)


def test_cuda_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingEngine(TM(**_TINY), IngestRing(capacity=4))


# ---------------------------------------------------------------------------
# the committed 100k trace
# ---------------------------------------------------------------------------


def test_committed_trace_is_the_bench_configuration():
    doc = S.load_trace()
    assert doc["config"] == S.CONFIG and doc["engine"] == S.ENGINE
    assert doc["capacity"] == S.CAPACITY
    assert sorted(doc["workloads"]) == ["burst", "constant", "hot"]
    assert len(doc["workloads"]["constant"]["chunks"]) >= 12
    assert len(doc["invalid_published"]) == S.N_FORGED
    assert len(doc["latencies_s"]) == (S.N_CONSTANT - S.N_FORGED + S.N_BURST
                                       + S.N_HOT)
    for wl in doc["workloads"].values():
        assert wl["silent_drops"] == 0
        for chunk in wl["chunks"]:
            assert np.asarray(chunk["delivered"]).shape == (2, 128)


def test_workloads_are_the_benchs_draws():
    groups = S.workloads(100_000)
    assert [len(g) for g in groups["constant"]] == [8] * 12
    assert [len(g) for g in groups["burst"]] == [64]
    assert {(i[0], i[1]) for g in groups["hot"] for i in g} == {(1, 3)}
    forged = [i for g in groups["constant"] for i in g if i[2]]
    assert [i[4] for i in forged] == list(range(S.N_FORGED))
    rng = np.random.default_rng(2)
    assert [i[1] for i in groups["constant"][0]] == [
        int(rng.integers(100_000)) for _ in range(8)]


@pytest.mark.slow
def test_trace_regenerates_byte_for_byte(tmp_path):
    path = str(tmp_path / "trace.json")
    write_trace(path)
    with open(path) as a, open(S.TRACE_PATH) as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# copies pinned to their originals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["serve/ingest.py", "serve/tuning.py",
                                 "obs/export.py"])
def test_copied_modules_equal_their_originals(rel):
    with open(os.path.join(REPO, "go_libp2p_pubsub_tpu", rel)) as a, \
            open(os.path.join(REPO, "go_libp2p_pubsub_torch", rel)) as b:
        assert a.read() == b.read()


def test_metrics_registry_renders_as_the_reference():
    regs = [jmetrics.MetricsRegistry(clock=lambda: 1.0),
            MetricsRegistry(clock=lambda: 1.0)]
    for r in regs:
        r.inc("serve.ingest.accepted", 3)
        r.inc("a-b/c", labels={"t": 'q"\n\\x', "1x": "y"})
        r.gauge("serve.ingest.depth", 5)
        r.gauge("serve.ingest.depth", 2.5)
        r.gauge("nan.gauge", float("nan"))
        r.gauge("inf.gauge", float("-inf"))
        r.describe("serve.ingest.depth", "queue\ndepth \\ now")
    assert regs[0].render_prometheus() == regs[1].render_prometheus()
    assert regs[0].export() == regs[1].export()
    assert regs[0].series_max("serve.ingest.depth") == regs[1].series_max(
        "serve.ingest.depth") == 5
    for samples in ([], [1.0], [3.0, 1.0, 2.0, 4.0]):
        a, b = jmetrics.quantiles(samples), quantiles(samples)
        assert str(a) == str(b)


# ---------------------------------------------------------------------------
# the ingest ring (copies of the reference's tests, on the port's ring)
# ---------------------------------------------------------------------------


def test_ring_fifo_wraparound():
    ring = IngestRing(capacity=4, policy="reject")
    seen = []
    for round_ in range(5):
        for i in range(3):
            assert ring.push(topic=0, payload=bytes([round_, i]), publisher=i)
        items = ring.pop_batch(3)
        assert [it.payload for it in items] == [
            bytes([round_, i]) for i in range(3)]
        seen.extend(it.seq for it in items)
    assert seen == sorted(seen) == list(range(15))
    assert ring.depth == 0 and ring.accounting()["silent_drops"] == 0


@pytest.mark.parametrize("policy", ["reject", "drop_oldest"])
def test_ring_policies_conserve(policy):
    ring = IngestRing(capacity=2, policy=policy)
    results = [ring.push(topic=0, payload=p, publisher=0)
               for p in (b"a", b"b", b"c", b"d")]
    acct = ring.accounting()
    assert acct["silent_drops"] == 0
    if policy == "reject":
        assert results == [True, True, False, False]
        assert acct["rejected"] == 2 and acct["accepted"] == 2
        assert [i.payload for i in ring.pop_batch(8)] == [b"a", b"b"]
    else:
        assert all(results)
        assert acct["dropped_oldest"] == 2 and acct["accepted"] == 4
        assert [i.payload for i in ring.pop_batch(8)] == [b"c", b"d"]


def test_ring_policy_block_timeout_and_release():
    ring = IngestRing(capacity=1, policy="block")
    assert ring.push(topic=0, payload=b"a", publisher=0)
    t0 = time.monotonic()
    assert not ring.push(topic=0, payload=b"b", publisher=0, timeout=0.05)
    assert time.monotonic() - t0 >= 0.04
    acct = ring.accounting()
    assert acct["block_waits"] == 1 and acct["rejected"] == 1
    result = {}

    def producer():
        result["ok"] = ring.push(topic=0, payload=b"c", publisher=1,
                                 timeout=5.0)

    th = threading.Thread(target=producer)
    th.start()
    time.sleep(0.05)
    assert ring.pop_batch(1)[0].payload == b"a"
    th.join(timeout=5.0)
    assert result["ok"] and ring.pop_batch(1)[0].payload == b"c"
    assert ring.accounting()["silent_drops"] == 0


def test_ring_zero_length_payload_metrics_and_validation():
    ring = IngestRing(capacity=2)
    assert ring.push(topic=1, payload=b"", publisher=5, valid=False)
    item = ring.pop_batch(1)[0]
    assert item.payload == b"" and item.topic == 1 and not item.valid
    with pytest.raises(ValueError, match="capacity"):
        IngestRing(capacity=0)
    with pytest.raises(ValueError, match="policy"):
        IngestRing(capacity=1, policy="yolo")
    assert set(BACKPRESSURE_POLICIES) == {"block", "drop_oldest", "reject"}
    reg = MetricsRegistry()
    ring = IngestRing(capacity=3, policy="drop_oldest", metrics=reg)
    for i in range(5):
        ring.push(topic=0, payload=b"x", publisher=i)
    ring.pop_batch(3)
    assert reg.counters()["serve.ingest.accepted"] == 5
    assert reg.counters()["serve.ingest.dropped_oldest"] == 2
    assert reg.series_max("serve.ingest.depth") == 3
    assert reg.latest("serve.ingest.depth") == 0 and ring.max_depth == 3
