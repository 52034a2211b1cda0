"""The latency-histogram kernel (``csrc/latency_hist.cu``) held to the
PyTorch expression it replaces on an NVIDIA card, integer for integer:
T of 1 and 2 topics, M of 128, 512 and one not a multiple of 4, N of 1,
589 and 100,000, stamps never set, all at latency 0 (every count on one
bin), past the last bin, before birth and the recorder's mix, under masks
all on, all off and random.  Each recount is one launch with no host
synchronisation.  A two-topic streaming engine on the card ends each chunk
with the CPU run's flight-recorder tail.

These tests need the card and ``nvcc``; elsewhere they skip.  This file
imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_hist_cuda.py -m cuda``
(``--noconftest``: the repository's conftest imports JAX)."""

import itertools

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub
from go_libp2p_pubsub_torch.ops import cuda_hist
from go_libp2p_pubsub_torch.ops import histogram as hist_ops
from go_libp2p_pubsub_torch.serve.engine import StreamingEngine
from go_libp2p_pubsub_torch.serve.ingest import IngestRing

BINS = 32
STAMPS = ("never", "zero", "tail", "before", "random")
MASKS = ("on", "off", "random")


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _table(stamps: str, masks: str, t: int, n: int, m: int, dev, seed=0):
    """(first_step, msg_birth, msg_mask, peer_mask) on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    birth = ints(0, 60, (t, m))
    lat = ints(0, 45, (t, n, m))
    reached = torch.rand((t, n, m), generator=gen, device=dev) < 0.7
    if stamps == "never":
        first = torch.full((t, n, m), -1, dtype=torch.int32, device=dev)
    elif stamps == "zero":
        first = birth[:, None, :].expand(t, n, m).contiguous()
    elif stamps == "tail":
        first = birth[:, None, :] + BINS + lat
    elif stamps == "before":
        first = torch.clamp(birth[:, None, :] - 1 - lat, min=-1)
    else:
        first = torch.where(reached, birth[:, None, :] + lat, -1)
    if masks == "random":
        msg_mask = torch.rand((t, m), generator=gen, device=dev) < 0.8
        peer_mask = torch.rand((t, n), generator=gen, device=dev) < 0.9
    else:
        on = masks == "on"
        msg_mask = torch.full((t, m), on, dtype=torch.bool, device=dev)
        peer_mask = torch.full((t, n), on, dtype=torch.bool, device=dev)
    return first.to(torch.int32).contiguous(), birth, msg_mask, peer_mask


def _one_launch(fn):
    """``fn()`` with the sync check on; asserts it launched the kernel
    once and returns its result."""
    before = cuda_hist.latency_hist.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_hist.latency_hist.launches == before + 1
    return out


CASES = list(itertools.product((1, 2), (128, 512, 130), (1, 589, 100_000),
                               STAMPS, MASKS))


@pytest.mark.cuda
@pytest.mark.parametrize("t,m,n,stamps,masks", CASES)
def test_kernel_equals_the_torch_expression(t, m, n, stamps, masks):
    dev = _cuda()
    args = _table(stamps, masks, t, n, m, dev, seed=t * 1000 + m + n)
    want = hist_ops._topics_plain(*args, BINS)
    cuda_hist.latency_hist(*args, BINS)             # builds and loads
    torch.cuda.synchronize()
    got = _one_launch(lambda: hist_ops.latency_histogram_topics(*args, BINS))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, want)
    if masks == "off" or stamps == "never":
        assert int(got.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 130])
def test_kernel_on_rows_off_sixteen_bytes(m):
    """A table whose first row starts 4 bytes past 16: scalar heads and
    tails around the vectors."""
    dev = _cuda()
    first, *rest = _table("random", "random", 2, 589, m, dev, seed=m)
    buf = torch.empty(first.numel() + 4, dtype=torch.int32, device=dev)
    view = buf[1:1 + first.numel()].view(first.shape)
    view.copy_(first)
    assert view.data_ptr() % 16 != 0
    got = _one_launch(lambda: cuda_hist.latency_hist(view, *rest, BINS))
    assert torch.equal(got, hist_ops._topics_plain(first, *rest, BINS))


@pytest.mark.cuda
@pytest.mark.parametrize("fresh", [True, False], ids=["cheap", "full"])
def test_single_topic_seed_is_one_launch(fresh):
    dev = _cuda()
    first, birth, msg_mask, peer_mask = (
        x[0] for x in _table("random", "random", 1, 100_000, 128, dev))
    if fresh:
        first = torch.where(first >= 0, birth[None, :], -1)
    want = hist_ops.latency_histogram_seed(first.cpu(), birth.cpu(),
                                           msg_mask.cpu(), peer_mask.cpu(),
                                           BINS)
    got = _one_launch(lambda: hist_ops.latency_histogram_seed(
        first, birth, msg_mask, peer_mask, BINS))
    assert torch.equal(got.cpu(), want)


def _engine_tails(device, chunks: int = 5):
    model = MultiTopicGossipSub(device=device, n_topics=2, n_peers=2000,
                                n_slots=32, conn_degree=16, msg_window=512,
                                heartbeat_steps=8)
    ticks = itertools.count()
    clock = lambda: next(ticks) * 1e-3  # noqa: E731
    ring = IngestRing(capacity=256, clock=clock)
    eng = StreamingEngine(model, ring, chunk_steps=8, pub_width=8, seed=3,
                          clock=clock)
    tails = []
    for c in range(chunks):
        for i in range(40):
            ring.push(topic=int(i % 5 == 0), payload=b"m %d %d" % (c, i),
                      publisher=(c * 131 + i * 17) % 2000,
                      valid=(c * 40 + i) % 23 != 7)
        eng.run_chunk()
        tails.append({k: np.asarray(v) for k, v in eng.flight_tail.items()})
    return tails


@pytest.mark.cuda
def test_two_topic_engine_chunks_end_in_the_cpu_runs_recorder_tail():
    dev = _cuda()
    want = _engine_tails("cpu")
    cuda_hist.reset_launches()
    got = _engine_tails(dev)
    assert cuda_hist.latency_hist.launches == len(got)
    assert int(want[-1]["lat_hist"].sum()) > 0
    for c, (a, b) in enumerate(zip(want, got)):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(b[name], a[name],
                                          err_msg=f"chunk {c} {name}")
