"""The port's two CUDA kernels held against their plain PyTorch versions on
an NVIDIA card, bit for bit, in every arm (K1: plain, IDONTWANT, per-edge
sender planes; K2: binding and non-binding caps).  The geometries reach
every instantiation (W in {1, 2, 4, 8, 16} message words, and W = 3
through the generic one), K in {1, 8, 16, 31, 32} slots, and N from one peer
through a grid whose persistent blocks walk several tiles each and end on
a ragged one ("many"); tables read through a misaligned view take the
generic instantiation.

These tests need the card and ``nvcc``; elsewhere they skip.  This file
imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda``
(``--noconftest``: the repository's conftest imports JAX)."""

import pytest
import torch

from go_libp2p_pubsub_torch.ops import cuda_gossip
from go_libp2p_pubsub_torch.ops import gossip_packed as tgp

# (seed, N, K, W); N "many" is sized on the card (_peers).
GEOMETRIES = [
    (0, 512, 32, 4), (1, 200, 8, 2), (2, 589, 16, 8),
    # every W instantiation, and W = 3 through the generic one
    (3, 589, 32, 1), (4, 589, 32, 2), (5, 589, 32, 3), (6, 589, 32, 8),
    (19, 589, 32, 16),
    # K below a warp, down to one slot
    (7, 589, 1, 4), (8, 589, 8, 4), (9, 589, 16, 4), (10, 589, 31, 4),
    # one peer
    (11, 1, 32, 4), (12, 1, 31, 3), (13, 1, 1, 1),
    # several tiles a block and a ragged last tile
    (14, "many", 32, 4), (15, "many", 16, 8), (16, "many", 31, 3),
    (17, "many", 8, 1), (18, "many", 1, 2), (20, "many", 32, 16),
]
CAPS = [(3, 2), (70, 40), (5000, 5000)]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _peers(n, dev) -> int:
    """``n``, or for "many" a count that gives every persistent block of
    any instantiation's grid two full tiles and the last block a third of
    17 peers."""
    if n != "many":
        return n
    shapes = [cuda_gossip.launch_shape(kernel, v, 1, dev)
              for kernel in cuda_gossip.KERNELS
              for v in (0, *cuda_gossip.VECTOR_WIDTHS)]
    most = max(s.blocks_per_sm for s in shapes)
    return 2 * most * cuda_gossip.sm_count(dev) * shapes[0].tile_peers + 17


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


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
    n = _peers(n, dev)
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
    n = _peers(n, dev)
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
@pytest.mark.parametrize("w", [2, 4, 8])
def test_misaligned_tables_take_the_generic_kernel(w):
    """Every input of both kernels through a view one element past a
    16-byte boundary: the W-word tables send the call to the generic
    instantiation, the byte masks to the byte-at-a-time mask build."""
    dev = _cuda()
    n, k = 700, 32
    gen = torch.Generator().manual_seed(40 + w)
    args = (
        _rand(gen, (n, k), p=0.4), _rand(gen, (n, k), high=n + 1) - 1,
        _rand(gen, (n, k), p=0.9), _rand(gen, (n,), p=0.9),
        _rand(gen, (n, w)) & _rand(gen, (n, w)), _rand(gen, (n, w)),
        _rand(gen, (w,)),
    )
    idw = args[4] & _rand(gen, (n, w))
    on = [_misaligned(a.to(dev)) for a in args]
    assert cuda_gossip.kernel_variant(w, [on[5].data_ptr()]) == 0
    out = cuda_gossip.propagate(*on, idontwant=True,
                                idw_have_w=_misaligned(idw.to(dev)))
    _same(out, tgp.propagate_packed(*args, idontwant=True, idw_have_w=idw))
    xargs = (
        _rand(gen, (n, k), high=n), _rand(gen, (n, k), p=0.3),
        _rand(gen, (n, k), p=0.8), _rand(gen, (n, k), p=0.66),
        _rand(gen, (n, w)) & _rand(gen, (n, w)),
        _rand(gen, (n, w)) & _rand(gen, (n, w)), _rand(gen, (n,), p=0.9),
    )
    out = cuda_gossip.exchange_select(
        *(_misaligned(a.to(dev)) for a in xargs), 70, 40)
    _same(out, tgp.exchange_select(*xargs, 70, 40))


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
