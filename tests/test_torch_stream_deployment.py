"""The beacon-chain stream deployment (``pubsub_bench/configs/
eth_beacon_2t_100k.json``) on the port's serving path, held to the
benchmark's plain multi-topic reference.

The port's ``StreamingEngine`` over ``MultiTopicGossipSub`` (2 topics,
the deployment's parameters, a 512-message window) runs at 600 peers on
the CPU, fed the deployment's 1 : 1,024 block-to-aggregate stream with
its forged share; after every chunk its whole state and its delivered
counts are compared with ``pubsub_bench/reference/multitopic.py`` and
``stream.py``, run from their own start on the same topology and the
events the engine dispatched: integers and booleans exactly, floats
within 1e-4 of the reference array's magnitude.  The engine's spans,
lane counters and ``last_events`` are checked against what it ran.  The
cuda-marked cases hold kernels K1 and K2 at the deployment's 16 message
words to their plain versions, bit for bit, on a card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from go_libp2p_pubsub_torch.config import GossipSubParams, ScoreParams  # noqa: E402
from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub  # noqa: E402
from go_libp2p_pubsub_torch.ops import cuda_gossip  # noqa: E402
from go_libp2p_pubsub_torch.ops import gossip_packed as tgp  # noqa: E402
from go_libp2p_pubsub_torch.serve.engine import StreamingEngine  # noqa: E402
from go_libp2p_pubsub_torch.serve.ingest import IngestRing  # noqa: E402
from go_libp2p_pubsub_torch.utils import trace  # noqa: E402

from pubsub_bench.harness import inputs  # noqa: E402
from pubsub_bench.harness.stream import program_arrays  # noqa: E402
from pubsub_bench.reference import compare  # noqa: E402
from pubsub_bench.reference import stream as ref_stream  # noqa: E402
from pubsub_bench.reference.multitopic import MultiNetwork  # noqa: E402
from pubsub_bench.traffic import stream_arrivals  # noqa: E402

FLOAT_GAP = 1e-4
CHUNKS = 6
# Seeds whose stream puts a block-topic message inside the chunks run
# (the block topic carries one message in 1,025), so both topics publish.
SEEDS = [11, 2**31 + 5, 4521000303, 4521000305]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bench(name: str) -> dict:
    with open(os.path.join(ROOT, "pubsub_bench", *name.split("/"))) as f:
        return json.load(f)


def _config(n: int, m: int = None) -> dict:
    cfg = _bench("configs/eth_beacon_2t_100k.json")
    cfg.update(n_peers=n)
    if m is not None:
        cfg.update(msg_window=m)
    return cfg


def _engine(cfg: dict, seed: int):
    graph = inputs.topology(seed, cfg["n_peers"], cfg["n_slots"],
                            cfg["conn_degree"])
    model = MultiTopicGossipSub(
        n_topics=cfg["n_topics"], n_peers=cfg["n_peers"],
        n_slots=cfg["n_slots"], conn_degree=cfg["conn_degree"],
        msg_window=cfg["msg_window"],
        params=GossipSubParams(**cfg["params"]),
        score_params=ScoreParams(**cfg["score_params"]),
        heartbeat_steps=cfg["heartbeat_steps"],
        builder=inputs.TopologyBuilder(graph), device="cpu")
    ring = IngestRing(int(cfg["ring_capacity"]))
    eng = StreamingEngine(model, ring, chunk_steps=cfg["chunk_steps"],
                          pub_width=cfg["pub_width"],
                          completion_frac=cfg["completion_frac"],
                          seed=seed % 2**32)
    return graph, model, ring, eng


def _stream(cfg: dict, seed: int, count: int) -> dict:
    mix = _bench("traffic/eth_saturated.json")
    return stream_arrivals.messages(mix, seed, count, cfg["n_peers"])


def _push(ring, msgs, lo: int, hi: int) -> None:
    for i in range(lo, hi):
        ring.push(int(msgs["topic"][i]), msgs["payload"][i],
                  int(msgs["publisher"][i]), valid=not msgs["forged"][i])


def _judge(got: dict, want: dict) -> None:
    judged = compare.judge(got, want)
    assert judged["mismatches"] == {}
    assert judged["float_gap"] <= FLOAT_GAP


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_matches_the_plain_reference_chunk_by_chunk(seed):
    cfg = _config(600)
    m, lanes = cfg["msg_window"], cfg["chunk_steps"] * cfg["pub_width"]
    graph, model, ring, eng = _engine(cfg, seed)
    net = MultiNetwork(cfg, "cpu")
    st = net.start(graph, seed % 2**32)
    _judge(program_arrays(eng.state, m), net.arrays(st))
    eng.warmup()
    ref_stream.run_chunk(net, st, eng.last_events)
    msgs = _stream(cfg, seed, CHUNKS * lanes)
    assert set(msgs["topic"]) == {0, 1}
    for c in range(CHUNKS):
        _push(ring, msgs, c * lanes, (c + 1) * lanes)
        eng.run_chunk()
        ref_stream.run_chunk(net, st, eng.last_events)
        _judge(program_arrays(eng.state, m), net.arrays(st))
        digest = model.stream_digest(eng.state)["delivered"].numpy()
        np.testing.assert_array_equal(digest, net.digest(st))
        tail = {k: v for k, v in eng.flight_tail.items() if k != "step"}
        _judge({"tail." + k: v for k, v in tail.items()},
               {"tail." + k: v for k, v in net.flight_tail(st).items()})
    assert eng.completed > 0 and eng.evicted == 0


def _small_engine():
    cfg = _config(64, 64)
    cfg.update(pub_width=2)
    return cfg, _engine(cfg, 7)


def test_stream_spans_are_recorded_with_a_recorder_only():
    cfg, (_, _, ring, eng) = _small_engine()
    eng.warmup()
    msgs = _stream(cfg, 7, 16)
    timer = trace.StepTimer()
    before = trace.set_recorder(timer)
    try:
        _push(ring, msgs, 0, 8)
        eng.run_chunk()
    finally:
        trace.set_recorder(before)
    spans = [s for s in timer.spans if s is not None]
    names = [s[0] for s in spans]
    for name in ("stream.chunk", "stream.ingest", "stream.fold",
                 "stream.digest", "rollout", "round.heartbeat",
                 "heartbeat.scores", "heartbeat.mesh", "heartbeat.gossip",
                 "heartbeat.fanout", "heartbeat.px", "publish"):
        assert name in names, name
    parent = {i: s[3] for i, s in enumerate(spans)}
    chunk = names.index("stream.chunk")
    for name in ("stream.ingest", "stream.fold", "stream.digest", "rollout"):
        assert parent[names.index(name)] == chunk, name
    heartbeat = names.index("round.heartbeat")
    for name in ("heartbeat.scores", "heartbeat.mesh", "heartbeat.gossip",
                 "heartbeat.fanout", "heartbeat.px"):
        assert parent[names.index(name)] == heartbeat, name
    recorded = len(timer.spans)
    _push(ring, msgs, 8, 16)
    eng.run_chunk()
    assert trace.recorder() is before and len(timer.spans) == recorded


def test_lane_counters_and_last_events_match_the_ring():
    cfg, (_, _, ring, eng) = _small_engine()
    eng.warmup()
    lanes = cfg["chunk_steps"] * cfg["pub_width"]
    msgs = _stream(cfg, 7, 2 * lanes)
    filled = 0
    for count in (5, lanes):
        _push(ring, msgs, filled, filled + count)
        out = eng.run_chunk()
        assert out["items"] == count
        ev = eng.last_events
        steps = cfg["chunk_steps"]
        lanes_run = []
        for cursor in range(lanes):
            r, col = cursor % steps, cursor // steps
            if ev.pub_src[r, col] >= 0:
                lanes_run.append((int(ev.pub_topic[r, col]),
                                  int(ev.pub_src[r, col]),
                                  bool(ev.pub_valid[r, col])))
        assert lanes_run == [
            (int(msgs["topic"][i]), int(msgs["publisher"][i]),
             not bool(msgs["forged"][i]))
            for i in range(filled, filled + count)]
        filled += count
    assert eng.lanes_filled == 5 + lanes
    assert eng.lanes_offered == 2 * lanes
    assert ring.depth == 0


# -- K1 and K2 at the deployment's 16 message words, on a card -----------------

W16_GEOMETRIES = [(30, 589, 32, 16), (31, 1, 32, 16), (32, 589, 16, 16),
                  (33, 4099, 31, 16), (34, 100_000, 32, 16)]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _rand(gen, shape, p=None, high=None):
    if p is not None:
        return torch.rand(shape, generator=gen) < p
    if high is not None:
        return torch.randint(0, high, shape, generator=gen, dtype=torch.int32)
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32)


def _same(out, ref) -> None:
    for a, b in zip(out, ref):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["plain", "idontwant", "fresh_src"])
@pytest.mark.parametrize("seed,n,k,w", W16_GEOMETRIES)
def test_k1_at_sixteen_words_matches_plain(arm, seed, n, k, w):
    dev = _cuda()
    gen = torch.Generator().manual_seed(seed)
    args = (
        _rand(gen, (n, k), p=0.4), _rand(gen, (n, k), high=n + 1) - 1,
        _rand(gen, (n, k), p=0.9), _rand(gen, (n,), p=0.9),
        _rand(gen, (n, w)) & _rand(gen, (n, w)), _rand(gen, (n, w)),
        _rand(gen, (w,)),
    )
    kw = {}
    if arm == "idontwant":
        kw = dict(idontwant=True, idw_have_w=args[4] & _rand(gen, (n, w)))
    elif arm == "fresh_src":
        kw = dict(fresh_src=_rand(gen, (n, k, w)))
    ref = tgp.propagate_packed(*args, **kw)
    on = {key: (v.to(dev) if torch.is_tensor(v) else v)
          for key, v in kw.items()}
    out = cuda_gossip.propagate(*(a.to(dev) for a in args), **on)
    torch.cuda.synchronize()
    _same(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(3, 2), (70, 40), (5000, 5000)])
@pytest.mark.parametrize("seed,n,k,w", W16_GEOMETRIES)
def test_k2_at_sixteen_words_matches_plain(caps, seed, n, k, w):
    dev = _cuda()
    gen = torch.Generator().manual_seed(seed)
    args = (
        _rand(gen, (n, k), high=n), _rand(gen, (n, k), p=0.3),
        _rand(gen, (n, k), p=0.8), _rand(gen, (n, k), p=0.66),
        _rand(gen, (n, w)) & _rand(gen, (n, w)),
        _rand(gen, (n, w)) & _rand(gen, (n, w)), _rand(gen, (n,), p=0.9),
    )
    ref = tgp.exchange_select(*args, *caps)
    out = cuda_gossip.exchange_select(*(a.to(dev) for a in args), *caps)
    torch.cuda.synchronize()
    _same(out, ref)
