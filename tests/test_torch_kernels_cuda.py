"""The port's two CUDA kernels held against their plain PyTorch versions on
an NVIDIA card, bit for bit, in every arm (K1: plain, IDONTWANT, per-edge
sender planes; K2: binding and non-binding caps) at N in {200, 512, 589},
K in {8, 16, 32} and W in {2, 4, 8} message words.

These tests need the card and ``nvcc``; elsewhere they skip.  This file
imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda``
(``--noconftest``: the repository's conftest imports JAX)."""

import pytest
import torch

from go_libp2p_pubsub_torch.ops import cuda_gossip
from go_libp2p_pubsub_torch.ops import gossip_packed as tgp

GEOMETRIES = [(0, 512, 32, 4), (1, 200, 8, 2), (2, 589, 16, 8)]
CAPS = [(3, 2), (70, 40), (5000, 5000)]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _rand(gen, shape, p=None, dtype=torch.int32, high=None):
    """Seeded random CPU tensor: bool with P(True)=p, ints below ``high``,
    or uniformly random int32 bit patterns."""
    if p is not None:
        return torch.rand(shape, generator=gen) < p
    if high is not None:
        return torch.randint(0, high, shape, generator=gen, dtype=dtype)
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32)


def _same(out, ref):
    for a, b in zip(out, ref):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["plain", "idontwant", "fresh_src"])
@pytest.mark.parametrize("seed,n,k,w", GEOMETRIES)
def test_propagate_kernel_matches_plain(arm, seed, n, k, w):
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
    before = cuda_gossip.propagate.launches
    out = cuda_gossip.propagate(*(a.to(dev) for a in args), **on)
    torch.cuda.synchronize()
    assert cuda_gossip.propagate.launches == before + 1
    _same(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", CAPS)
@pytest.mark.parametrize("seed,n,k,w", GEOMETRIES)
def test_exchange_kernel_matches_plain(caps, seed, n, k, w):
    dev = _cuda()
    gen = torch.Generator().manual_seed(seed)
    args = (
        _rand(gen, (n, k), high=n), _rand(gen, (n, k), p=0.3),
        _rand(gen, (n, k), p=0.8), _rand(gen, (n, k), p=0.66),
        _rand(gen, (n, w)) & _rand(gen, (n, w)),
        _rand(gen, (n, w)) & _rand(gen, (n, w)), _rand(gen, (n,), p=0.9),
    )
    ref = tgp.exchange_select(*args, *caps)
    before = cuda_gossip.exchange_select.launches
    out = cuda_gossip.exchange_select(*(a.to(dev) for a in args), *caps)
    torch.cuda.synchronize()
    assert cuda_gossip.exchange_select.launches == before + 1
    _same(out, ref)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _cuda()
    n, k = 4, 33
    z = lambda *s, dt=torch.bool: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    with pytest.raises(ValueError, match="slots"):
        cuda_gossip.propagate(
            z(n, k), z(n, k, dt=torch.int32), z(n, k), z(n),
            z(n, 1, dt=torch.int32), z(n, 1, dt=torch.int32),
            z(1, dt=torch.int32))
    with pytest.raises(TypeError):
        cuda_gossip.exchange_select(
            z(n, 8, dt=torch.int64), z(n, 8), z(n, 8), z(n, 8),
            z(n, 1, dt=torch.int32), z(n, 1, dt=torch.int32), z(n), 5, 5)
