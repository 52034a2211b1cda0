"""The PRNG's threefry kernel (``csrc/threefry.cu``) held to the PyTorch
chain on an NVIDIA card, bit for bit, at every entry point of
``ops/rng.py``: each call on a CUDA key is one launch of the kernel with
no host synchronisation, and equals the same call on the same key on the
CPU.  A GossipSub run on the card draws its whole key chain through the
kernel and ends in the CPU run's state, leaf for leaf.

These tests need the card and ``nvcc``; elsewhere they skip.  This file
imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_rng_cuda.py -m cuda``
(``--noconftest``: the repository's conftest imports JAX)."""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch.config import GossipSubParams
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub
from go_libp2p_pubsub_torch.ops import cuda_rng
from go_libp2p_pubsub_torch.ops import rng

SEED = 4_200_000_321 & 0xFFFFFFFF
UID = np.random.default_rng(7).permutation(100_000)

# name -> (call on a key, the tensors it reads besides, by name)
CASES = {
    "split2": lambda k, t: rng.split(k, 2),
    "split3": lambda k, t: rng.split(k, 3),
    "split6": lambda k, t: rng.split(k, 6),
    "uniform_row": lambda k, t: rng.uniform(k, (1, 32)),
    "uniform_100k": lambda k, t: rng.uniform(k, (100_000, 32)),
    "uniform_narrow": lambda k, t: rng.uniform(k, (100_000, 32), 0.0, 1e-3),
    "uniform_fma": lambda k, t: rng.uniform(k, (1000, 32), -2.5, 3.0),
    "uniform_rows": lambda k, t: rng.uniform_rows(k, t["uid"], (32,)),
    "fold_in": lambda k, t: rng.fold_in(k, t["data"]),
    "randint_pow2": lambda k, t: rng.randint(k, (2000, 32), 0, 256),
    "randint_wide": lambda k, t: rng.randint(k, (2000, 32), -7, 100_000),
    "randint_small": lambda k, t: rng.randint(k, (2000, 32), 3, 250),
    "randint_offset": lambda k, t: rng.randint(k, (500, 32), 0, 256,
                                               row_offset=1234),
    "randint_rows": lambda k, t: rng.randint(k, (1000, 32), 0, 100_000,
                                             rows=t["uid"][:1000]),
    "bits32_high": lambda k, t: rng._bits32(k, (3, 64), row_offset=2**26 + 5),
}


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _tensors(device) -> dict:
    return {"uid": torch.from_numpy(UID).to(torch.int32).to(device),
            "data": torch.tensor([0, 1, 2**31 - 1, -1, -(2**31), 77],
                                 dtype=torch.int64).to(device)}


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu().contiguous()
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_the_torch_chain(name):
    dev = _cuda()
    call = CASES[name]
    cpu_key = rng.split(rng.PRNGKey(SEED), 3)[1]
    want = call(cpu_key, _tensors("cpu"))
    key, tensors = cpu_key.to(dev), _tensors(dev)
    call(key, tensors)                      # builds and loads the library
    torch.cuda.synchronize()
    before = cuda_rng.threefry.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call(key, tensors)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_rng.threefry.launches == before + 1
    assert got.device.type == "cuda"
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_gossipsub_key_chain_and_state_equal_the_cpu_run():
    """2,000 peers, fanout publishes (each draws its targets) and three
    heartbeats: the card's run, every draw through the kernel, ends in
    the CPU run's key and state."""
    dev = _cuda()

    def run(device):
        gs = GossipSub(n_peers=2000, n_slots=32, conn_degree=16,
                       msg_window=64, device=device,
                       params=GossipSubParams(flood_publish=False))
        st = gs.init(seed=11)
        for slot in range(48):
            st = gs.publish(st, (slot * 977) % 2000, slot, slot % 9 != 4)
        return gs.rollout(st, 24, record=False)[0]

    want = bridge.state_to_numpy(run("cpu"))
    cuda_rng.reset_launches()
    got = bridge.state_to_numpy(run(dev))
    assert cuda_rng.threefry.launches > 48
    np.testing.assert_array_equal(np.asarray(got.key), np.asarray(want.key))
    for field, a, b in zip(want._fields, want, got):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=field)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
