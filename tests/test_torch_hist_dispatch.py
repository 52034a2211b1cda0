"""The recorder's recount by the stamp table's device, and the histogram
kernel's arithmetic on the CPU.

``ops/histogram.py`` launches the latency-histogram kernel
(``ops/cuda_hist.py``, ``csrc/latency_hist.cu``) for a recount of CUDA
tensors and runs the PyTorch expression for CPU tensors.  Here, without a
card:

- the T-topic recount that ``MultiTopicGossipSub.flight_record_round``
  calls equals the expression it had inline and the sum of per-topic
  ``latency_histogram`` calls;
- CPU tensors never load the kernel's library and launch nothing;
- the kernel's source, built for the host with g++ (its
  ``latency_hist_host`` entry runs the card's per-lane work for each
  lane in turn), fed through the wrapper's own checks, equals the PyTorch
  expression integer for integer: odd M, rows that do not start on 16
  bytes, stamps past the last bin, before birth and wrapping at 32 bits;
- routed through that host build, the multi-topic recorder, the
  single-topic seed (both of its branches) and a recorded GossipSub
  rollout equal their CPU runs, one launch a recount.

The card's own test is ``tests/test_torch_hist_cuda.py``."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.models.gossipsub import GossipSub
from go_libp2p_pubsub_torch.models.multitopic import MultiTopicGossipSub
from go_libp2p_pubsub_torch.ops import cuda_hist
from go_libp2p_pubsub_torch.ops import histogram as hist_ops

BINS = 32
I32 = np.iinfo(np.int32)


def _table(kind: str, t: int, n: int, m: int, seed: int = 0):
    """(first_step, msg_birth, msg_mask, peer_mask) as CPU tensors."""
    rng = np.random.default_rng(seed)
    birth = rng.integers(0, 60, (t, m)).astype(np.int32)
    msg_mask = rng.random((t, m)) < 0.8
    peer_mask = rng.random((t, n)) < 0.9
    lat = rng.integers(0, 45, (t, n, m))
    reached = rng.random((t, n, m)) < 0.7
    if kind == "never":
        first = np.full((t, n, m), -1)
    elif kind == "zero":          # every stamp on bin 0: the contended case
        first = np.broadcast_to(birth[:, None, :], (t, n, m))
    elif kind == "tail":          # past the last bin
        first = birth[:, None, :] + BINS + lat
    elif kind == "before":        # before birth: clamped to bin 0
        first = np.maximum(birth[:, None, :] - 1 - lat, -1)
    elif kind == "wrap":          # the difference wraps at 32 bits
        birth = rng.choice([I32.min, I32.min + 1, -5, I32.max],
                           (t, m)).astype(np.int32)
        first = rng.choice([0, 1, I32.max - 1, I32.max, 17], (t, n, m))
    elif kind == "masks_off":
        first = np.where(reached, birth[:, None, :] + lat, -1)
        msg_mask[:] = False
        peer_mask[:] = False
    else:                         # "random": the recorder's mix
        first = np.where(reached, birth[:, None, :] + lat, -1)
    return (torch.from_numpy(np.ascontiguousarray(first, np.int32)),
            torch.from_numpy(birth), torch.from_numpy(msg_mask),
            torch.from_numpy(peer_mask))


def _inline(first, birth, msg_mask, peer_mask, n_bins=BINS):
    """The expression ``flight_record_round`` had inline."""
    lat = first - birth[:, None, :]
    counted = ((first >= 0) & peer_mask[:, :, None] & msg_mask[:, None, :])
    seg = torch.where(counted, torch.clamp(lat, 0, n_bins - 1), n_bins)
    return hist_ops._bin_counts(torch.ones_like(seg), seg, n_bins)


KINDS = ("random", "never", "zero", "tail", "before", "wrap", "masks_off")
SHAPES = [(1, 37, 128), (2, 70, 128), (2, 33, 130), (3, 5, 7), (1, 1, 512)]
CASES = [(k, s) for k in KINDS for s in SHAPES[:2]] + [
    ("random", s) for s in SHAPES[2:]] + [("tail", (2, 33, 130)),
                                          ("wrap", (3, 5, 7))]


def _id(case):
    kind, (t, n, m) = case
    return f"{kind}-{t}x{n}x{m}"


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_topics_recount_equals_inline_and_per_topic(case):
    kind, shape = case
    args = _table(kind, *shape)
    got = hist_ops.latency_histogram_topics(*args, BINS)
    assert got.dtype == torch.int32 and got.shape == (BINS,)
    assert torch.equal(got, _inline(*args))
    per_topic = sum(hist_ops.latency_histogram(*(x[i] for x in args), BINS)
                    for i in range(shape[0]))
    assert torch.equal(got, per_topic)


def _mt():
    return MultiTopicGossipSub(device="cpu", n_topics=2, n_peers=96,
                               n_slots=16, conn_degree=8, msg_window=32)


def _mt_state(mt):
    st = mt.init(seed=3)
    for slot in range(6):
        st = mt.publish(st, slot % 2, (slot * 37) % 96, slot, slot != 4)
    return mt.run(st, 6)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU recount reached ops/cuda_hist.py")

    monkeypatch.setattr(cuda_hist, "_load", refuse)
    monkeypatch.setattr(cuda_hist, "latency_hist", refuse)
    cuda_hist.reset_launches()
    args = _table("random", 2, 40, 128)
    hist_ops.latency_histogram_topics(*args, BINS)
    one = [x[0] for x in args]
    hist_ops.latency_histogram(*one, BINS)
    hist_ops.latency_histogram_seed(*one, BINS)
    mt = _mt()
    mt.flight_record_round(_mt_state(mt))
    gs = GossipSub(device="cpu", n_peers=64, n_slots=8, conn_degree=4,
                   msg_window=16)
    gs.rollout(gs.publish(gs.init(seed=1), 3, 0, True), 4, record=True)
    assert cuda_hist.latency_hist.launches == 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host arithmetic")
    out = str(tmp_path_factory.mktemp("latency_hist_host") / "liblh.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", out, cuda_hist.SOURCE], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    lib.latency_hist_host.argtypes = cuda_hist.ARGTYPES
    lib.latency_hist_host.restype = ctypes.c_int
    return lib


def _host_launch(lib, calls):
    """``cuda_hist.latency_hist`` on the host build, through the wrapper's
    checks; ``calls`` collects each launch's (T, N, M)."""
    def launch(first, birth, msg_mask, peer_mask, n_bins):
        t, n, m = cuda_hist.operands(first, birth, msg_mask, peer_mask,
                                     n_bins)
        out = torch.zeros(n_bins, dtype=torch.int32)
        assert lib.latency_hist_host(
            first.data_ptr(), birth.data_ptr(), msg_mask.data_ptr(),
            peer_mask.data_ptr(), out.data_ptr(), t, n, m, n_bins) == 0
        calls.append((t, n, m))
        return out
    return launch


def _unaligned(first: torch.Tensor) -> torch.Tensor:
    """``first`` as a contiguous view that starts 4 bytes past 16."""
    buf = torch.empty(first.numel() + 8, dtype=torch.int32)
    skip = next(i for i in range(1, 8) if (buf.data_ptr() + 4 * i) % 16)
    view = buf[skip:skip + first.numel()].view(first.shape)
    view.copy_(first)
    return view


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_host_kernel_equals_the_torch_expression(host_lib, case, aligned):
    kind, shape = case
    first, *rest = _table(kind, *shape, seed=7)
    if not aligned:
        first = _unaligned(first)
    calls = []
    got = _host_launch(host_lib, calls)(first, *rest, BINS)
    assert calls == [shape]
    assert torch.equal(got, _inline(first, *rest))


@pytest.mark.parametrize("n_bins", [1, 2, 45])
def test_host_kernel_at_other_bin_counts(host_lib, n_bins):
    args = _table("random", 2, 70, 130, seed=3)
    got = _host_launch(host_lib, [])(*args, n_bins)
    assert torch.equal(got, _inline(*args, n_bins=n_bins))


def _as_card(monkeypatch, launch):
    monkeypatch.setattr(hist_ops, "_on_card", lambda first_step: True)
    monkeypatch.setattr(cuda_hist, "latency_hist", launch)


def test_multitopic_recorder_through_the_host_kernel(monkeypatch, host_lib):
    mt = _mt()
    st = _mt_state(mt)
    want = mt.flight_record_round(st)
    calls = []
    _as_card(monkeypatch, _host_launch(host_lib, calls))
    got = mt.flight_record_round(st)
    assert calls == [(2, 96, 32)]
    assert int(want["lat_hist"].sum()) > 0
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("fresh", [True, False], ids=["cheap", "full"])
def test_seed_on_the_card_is_the_full_histogram(monkeypatch, host_lib, fresh):
    first, birth, msg_mask, peer_mask = (x[0] for x in _table("random", 1,
                                                               70, 128))
    if fresh:     # every counted receipt at latency zero: the cheap branch
        first = torch.where(first >= 0, birth[None, :], -1)
    want = hist_ops.latency_histogram_seed(first, birth, msg_mask, peer_mask,
                                           BINS)
    calls = []
    _as_card(monkeypatch, _host_launch(host_lib, calls))
    got = hist_ops.latency_histogram_seed(first, birth, msg_mask, peer_mask,
                                          BINS)
    assert calls == [(1, 70, 128)]
    assert torch.equal(got, want)


def test_recorded_rollout_through_the_host_kernel(monkeypatch, host_lib):
    gs = GossipSub(device="cpu", n_peers=64, n_slots=8, conn_degree=4,
                   msg_window=16)
    st = gs.init(seed=1)
    for slot in range(5):
        st = gs.publish(st, (slot * 13) % 64, slot, slot != 2)
    st = gs.run(st, 3)
    _, want = gs.rollout(st, 6, record=True)
    calls = []
    _as_card(monkeypatch, _host_launch(host_lib, calls))
    _, got = gs.rollout(st, 6, record=True)
    assert calls == [(1, 64, 16)]          # the seed; rounds add increments
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("t,n,bps,sms,grid", [
    (2, 100_000, 6, 132, 391), (1, 100_000, 6, 132, 391),
    (2, 100_000, 1, 132, 66), (1, 1, 6, 132, 1), (1, 257, 6, 132, 2),
    (1_000, 64, 6, 132, 1), (3, 10**6, 4, 132, 176)])
def test_grid_blocks(t, n, bps, sms, grid):
    assert cuda_hist.grid_blocks(t, n, bps, sms) == grid


@pytest.mark.parametrize("change,error", [
    ("dtype", TypeError), ("shape", ValueError), ("strided", ValueError),
    ("bins", ValueError), ("rank", ValueError)])
def test_operands_refuse_what_the_kernel_does_not_take(change, error):
    first, birth, msg_mask, peer_mask = _table("random", 2, 9, 12)
    n_bins = BINS
    if change == "dtype":
        birth = birth.to(torch.int64)
    elif change == "shape":
        peer_mask = peer_mask[:, :8]
    elif change == "strided":
        first = first.transpose(1, 2).contiguous().transpose(1, 2)
    elif change == "bins":
        n_bins = 0
    else:
        first = first[0]
    with pytest.raises(error):
        cuda_hist.operands(first, birth, msg_mask, peer_mask, n_bins)
