"""The PRNG's dispatch by the key's device, and the threefry kernel's
arithmetic on the CPU.

``ops/rng.py`` launches the threefry kernel (``ops/cuda_rng.py``,
``csrc/threefry.cu``) for a CUDA key and runs the PyTorch chain for a CPU
key.  Here, without a card:

- a CPU key never loads the kernel's library and launches nothing;
- each entry point on a card's key plans the launch it should (counter
  form, start, element count, row width, output and its parameters),
  with ``row_offset`` and ``rows``;
- the kernel's source, built for the host with g++ (its
  ``threefry_host`` entry runs the card's element function in a loop),
  fed each entry point's plan and operands through the wrapper's own
  argument marshalling, equals the PyTorch chain bit for bit, and a
  GossipSub run drawing through it equals the chain's run leaf for leaf.

The card's own test is ``tests/test_torch_rng_cuda.py``."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch import bridge
from go_libp2p_pubsub_torch.config import GossipSubParams
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub
from go_libp2p_pubsub_torch.ops import cuda_rng
from go_libp2p_pubsub_torch.ops import rng
from go_libp2p_pubsub_torch.ops.cuda_rng import (BITS, DATA, PAIR, RANDINT,
                                                 RANGE, ROWS, UNIFORM, Plan)

M32 = 0xFFFFFFFF
KEY = rng.split(rng.PRNGKey(4_200_000_123 & M32), 3)[2]
UID = torch.from_numpy(np.random.default_rng(5).permutation(40)).to(
    torch.int32)


def _mult(span):
    return ((((1 << 16) % span) ** 2) & M32) % span


# Each entry point's call on ``KEY`` and the plan a card's key gives it.
PLANS = {
    "split2": (lambda k: rng.split(k, 2), Plan(RANGE, PAIR, 0, 2, 1, (2, 2))),
    "split_shape": (lambda k: rng.split(k, (2, 3)),
                    Plan(RANGE, PAIR, 0, 6, 1, (2, 3, 2))),
    "fold_in_int": (lambda k: rng.fold_in(k, 7),
                    Plan(RANGE, PAIR, 7, 1, 1, (2,))),
    "fold_in_negative": (lambda k: rng.fold_in(k, -3),
                         Plan(RANGE, PAIR, 2**32 - 3, 1, 1, (2,))),
    "fold_in_tensor": (lambda k: rng.fold_in(k, torch.arange(3)),
                       Plan(DATA, PAIR, 0, 3, 1, (3, 2))),
    "uniform": (lambda k: rng.uniform(k, (100_000, 32)),
                Plan(RANGE, UNIFORM, 0, 3_200_000, 1, (100_000, 32),
                     lo=0.0, width=1.0)),
    "uniform_scalar": (lambda k: rng.uniform(k, ()),
                       Plan(RANGE, UNIFORM, 0, 1, 1, (), lo=0.0, width=1.0)),
    "uniform_fma": (lambda k: rng.uniform(k, (4, 8), -2.0, 3.0),
                    Plan(RANGE, UNIFORM, 0, 32, 1, (4, 8), lo=-2.0,
                         width=5.0, use_fma=1)),
    "uniform_rows": (lambda k: rng.uniform_rows(k, UID[:5], (32,)),
                     Plan(ROWS, UNIFORM, 0, 160, 32, (5, 32), lo=0.0,
                          width=1.0)),
    "bits32_offset": (lambda k: rng._bits32(k, (3, 8), row_offset=2**30),
                      Plan(RANGE, BITS, 2**33, 24, 1, (3, 8))),
    "bits_rows": (lambda k: rng._bits_rows(k, UID[:3], (2, 4)),
                  Plan(ROWS, BITS, 0, 24, 8, (3, 2, 4))),
    "randint_offset": (lambda k: rng.randint(k, (6, 8), 0, 256,
                                             row_offset=10),
                       Plan(RANGE, RANDINT, 80, 48, 1, (6, 8), span=256,
                            mult=0, minval=0)),
    "randint_rows": (lambda k: rng.randint(k, (3, 4), -5, 100,
                                           rows=UID[:3]),
                     Plan(ROWS, RANDINT, 0, 12, 4, (3, 4), span=105,
                          mult=_mult(105), minval=2**32 - 5)),
    "randint_empty_span": (lambda k: rng.randint(k, (2,), 9, 9),
                           Plan(RANGE, RANDINT, 0, 2, 1, (2,), span=1,
                                mult=0, minval=9)),
}

# Draws held to the PyTorch chain through the host build.
DRAWS = {
    **{name: call for name, (call, _) in PLANS.items()
       if name != "uniform"},
    "split3": lambda k: rng.split(k, 3),
    "split6": lambda k: rng.split(k, 6),
    "fold_in_int32": lambda k: rng.fold_in(
        k, torch.tensor([-1, 0, 2**31 - 1, -(2**31)], dtype=torch.int32)),
    "fold_in_list": lambda k: rng.fold_in(k, [3, 4]),
    "uniform_row": lambda k: rng.uniform(k, (1, 32)),
    "uniform_block": lambda k: rng.uniform(k, (257, 32)),
    "uniform_narrow": lambda k: rng.uniform(k, (64, 32), 0.0, 1e-3),
    "uniform_shifted": lambda k: rng.uniform(k, (7, 5), 0.5, 0.75),
    "uniform_rows_int64": lambda k: rng.uniform_rows(
        k, UID.to(torch.int64), (3, 5), -1.0, 1.0),
    "bits32": lambda k: rng._bits32(k, (33, 7)),
    "bits_rows_high": lambda k: rng._bits_rows(
        k, torch.tensor([2**29 + 1, 5, 2**30], dtype=torch.int64), (16,)),
    "randint_pow2": lambda k: rng.randint(k, (50, 16), 0, 256),
    "randint_wide": lambda k: rng.randint(k, (50, 16), 0, 100_000),
    "randint_small": lambda k: rng.randint(k, (50, 16), 3, 17),
    "randint_negative": lambda k: rng.randint(k, (9, 3), -2**31, 2**31 - 1),
    "randint_half": lambda k: rng.randint(k, (9, 3), -2**31, 0),
    "randint_rows_offset": lambda k: rng.randint(
        k, (5, 6), 0, 1000, rows=UID[10:15]),
    "randint_high_offset": lambda k: rng.randint(
        k, (2, 8), 0, 77, row_offset=2**29 + 3),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host arithmetic")
    out = str(tmp_path_factory.mktemp("threefry_host") / "libthreefry.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", out,
                    cuda_rng.SOURCE], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.threefry_host.argtypes = cuda_rng.ARGTYPES
    lib.threefry_host.restype = ctypes.c_int
    return lib


def _as_card(monkeypatch, launch):
    """Route every key to the kernel's path, with ``launch`` in place of
    the launch (a CPU key still reaches the plan's operands)."""
    monkeypatch.setattr(rng, "_on_card", lambda key: True)
    monkeypatch.setattr(cuda_rng, "threefry", launch)


def _host_launch(lib, plans):
    def launch(key, plan, idx=None):
        key, idx = cuda_rng.operands(key, plan, idx)
        out = torch.empty(plan.shape, dtype=cuda_rng._OUT_DTYPES[plan.out])
        if plan.n:
            args = cuda_rng.c_args(key, idx, out, plan)
            assert lib.threefry_host(*args) == 0
        plans.append(plan)
        return out
    return launch


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).numpy()


def test_a_cpu_key_never_loads_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("a CPU key loaded the kernel's library")

    monkeypatch.setattr(cuda_rng, "_load", refuse)
    cuda_rng.reset_launches()
    for call in DRAWS.values():
        call(KEY)
    assert cuda_rng.threefry.launches == 0


@pytest.mark.parametrize("name", sorted(PLANS))
def test_each_entry_point_plans_one_launch(monkeypatch, name):
    call, want = PLANS[name]
    plans = []

    def launch(key, plan, idx=None):
        plans.append(plan)
        return torch.empty(plan.shape, dtype=cuda_rng._OUT_DTYPES[plan.out])

    _as_card(monkeypatch, launch)
    out = call(KEY)
    assert plans == [want]
    assert tuple(out.shape) == want.shape


@pytest.mark.parametrize("n,sm,grid", [
    (0, 132, 1), (2, 132, 1), (256, 132, 1), (257, 132, 2),
    (3_200_000, 132, 1056), (10**9, 132, 1056), (5_000, 1, 8)])
def test_grid_blocks(n, sm, grid):
    assert cuda_rng.grid_blocks(n, sm) == grid


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_host_kernel_equals_the_torch_chain(monkeypatch, host_lib, name):
    call = DRAWS[name]
    want = call(KEY)
    plans = []
    _as_card(monkeypatch, _host_launch(host_lib, plans))
    got = call(KEY)
    assert len(plans) == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_host_kernel_gossipsub_run_equals_the_torch_chain(monkeypatch,
                                                         host_lib):
    """Publishes (a fanout publish drawing its targets), rollouts with
    heartbeats: key chain and every state leaf as the chain's."""
    gs = GossipSub(n_peers=150, n_slots=16, conn_degree=8, msg_window=32,
                   heartbeat_steps=2, device="cpu",
                   params=GossipSubParams(flood_publish=False))

    def run():
        st = gs.init(seed=3)
        for slot in range(6):
            st = gs.publish(st, (slot * 37) % 150, slot, slot != 2)
        return gs.rollout(st, 6, record=False)[0]

    want = bridge.state_to_numpy(run())
    plans = []
    _as_card(monkeypatch, _host_launch(host_lib, plans))
    got = bridge.state_to_numpy(run())
    assert len(plans) > 6
    for field, a, b in zip(want._fields, want, got):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=field)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
