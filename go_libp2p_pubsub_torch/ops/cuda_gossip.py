"""The two CUDA kernels of the GossipSub hot loop, and their wrappers.

Source: ``csrc/gossip_kernels.cu``, built with ``nvcc`` for ``sm_90a``
into the package's ``build/`` directory on first use and loaded with
ctypes (a plain C interface: pointers from ``data_ptr()``, PyTorch's
current stream, ``cudaGetLastError()`` returned and checked).

- :func:`propagate` (kernel K1) replaces the JAX package's
  ``ops/pallas_gossip.py:_propagate_kernel`` (launched by
  ``propagate_packed_pallas``).  Bound on the card: device-memory bytes --
  per peer it reads K neighbor ids, two [K] byte masks and W words of
  possession, and writes W words thrice and K float counters thrice (the
  sender words come from a table of N*W words that stays in L2).  Its
  design moves the neighbor gather inside the kernel (a thread per peer
  walks its delivering slots), so the [N, K, W] incoming cube that the TPU
  design writes to device memory and reads back is never stored.
- :func:`exchange_select` (kernel K2) replaces
  ``ops/pallas_gossip.py:_exchange_kernel`` (launched by
  ``_exchange_call`` from ``gossip_exchange_packed_pallas``).  Bound:
  device-memory bytes -- K advertiser ids and three [K] byte masks in, W
  words of dedup view, K float promise counts out.  It takes the accept
  and serve masks per slot ([N, K] bytes) and gathers the advertised
  words itself, where the TPU design reads three [N, K*W] word cubes.

Both kernels give each peer a thread and run on a persistent grid of a
few blocks per SM that walk tiles of peers (see the source).  The host
side of a launch is plain Python here, so the CPU tests reach it:
:func:`kernel_variant` picks W's instantiation and :func:`grid_blocks`
sizes the grid from the card's SM count and the instantiation's launch
shape (:func:`launch_shape`: its tile, and how many of its blocks an SM
holds, which the CUDA occupancy calculator reads from its registers and
shared memory).

Beside each kernel is its plain PyTorch version (``ops/gossip_packed.py``:
``propagate_packed`` and ``exchange_select``, in the kernel's layout).  A
wrapper runs the plain version only when its tensors lie on the CPU; on
CUDA tensors it launches the kernel or raises.  Each wrapper counts its
launches in ``<wrapper>.launches``.

The sharded rollout's wrappers (the reference's ``shard_map`` forms,
``ops/pallas_gossip.py:422-492`` and ``:373-384``) run the same two
kernels on a rank's block of rows: :func:`propagate_sharded` gathers the
senders' words through the mesh into K1's ``fresh_src``, and
:func:`exchange_select_sharded` gathers the advertisers' words table for
K2 (whose words table may have any row count).  Their launches count in
:func:`propagate` and :func:`exchange_select`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_build, gossip_packed
from .cuda_build import KernelBuildError  # noqa: F401  (re-exported)
from .cuda_build import device_index as _index
from .cuda_build import raise_on as _raise_on
from .cuda_build import sm_count
from .gossip_packed import PropagatePackedOut
from ..utils.trace import span

SOURCE = os.path.join(cuda_build.CSRC_DIR, "gossip_kernels.cu")
LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libgossip_kernels.so")
MAX_SLOTS = 32  # a peer's slots are the bits of one 32-bit mask
VECTOR_WIDTHS = (1, 2, 4, 8, 16)  # W with an instantiation of their own
KERNELS = ("propagate", "exchange")  # K1, K2: the library's kernel index


class LaunchShape(NamedTuple):
    """One instantiation's launch shape on a card (``gossip_launch_shape``)."""

    tile_peers: int     # peers a block takes per tile (one a thread)
    blocks_per_sm: int  # blocks an SM holds at once


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_shapes: Dict[Tuple[str, int, int, int], LaunchShape] = {}


def kernel_variant(w: int, addresses: Sequence[Optional[int]]) -> int:
    """W's instantiation (1, 2, 4, 8 or 16), or 0 for the generic one.

    ``addresses`` are the device addresses of the tensors the kernel reads
    as W-word vectors (the gathered table and the other [N, W] and [W]
    inputs).  The generic instantiation takes any other W, and any address
    a vector load would fault on (not a multiple of ``min(16, 4 * w)``
    bytes)."""
    if w not in VECTOR_WIDTHS:
        return 0
    align = min(16, 4 * w)
    if any(a is not None and a % align for a in addresses):
        return 0
    return w


def grid_blocks(n: int, shape: LaunchShape, sm_count: int) -> int:
    """Persistent blocks for ``n`` peers: one per tile, at most
    ``blocks_per_sm`` on each of ``sm_count`` SMs (each block then walks
    every ``grid``-th tile)."""
    tiles = -(-n // shape.tile_peers)
    return max(1, min(tiles, shape.blocks_per_sm * sm_count))


def build(verbose: bool = False) -> str:
    """Compile ``csrc/gossip_kernels.cu`` into ``build/`` (always) and
    return nvcc's output (``-Xptxas -v`` register/spill report when
    ``verbose``)."""
    return cuda_build.build(SOURCE, LIB_PATH, verbose)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if cuda_build.stale(SOURCE, LIB_PATH):
            build()
        lib = ctypes.CDLL(LIB_PATH)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gossip_propagate.argtypes = [vp] * 15 + [ci] * 5 + [vp]
        lib.gossip_propagate.restype = ci
        lib.gossip_exchange.argtypes = [vp] * 9 + [ci] * 8 + [vp]
        lib.gossip_exchange.restype = ci
        lib.gossip_launch_shape.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
        lib.gossip_launch_shape.restype = ci
        _lib = lib
        return lib


def launch_shape(kernel: str, variant: int, k: int,
                 dev: torch.device) -> LaunchShape:
    """The launch shape of ``kernel``'s (``"propagate"`` or ``"exchange"``)
    instantiation ``variant`` at ``k`` slots on CUDA device ``dev``
    (cached)."""
    key = (kernel, variant, k, _index(dev))
    if key not in _shapes:
        lib = _load()
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(key[3]):
            _raise_on(lib.gossip_launch_shape(KERNELS.index(kernel), variant,
                                              k, out), "gossip_launch_shape")
        _shapes[key] = LaunchShape(*out)
    return _shapes[key]


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def propagate(
    mesh: torch.Tensor,       # bool[N, K]
    nbrs: torch.Tensor,       # int32[N, K]
    edge_live: torch.Tensor,  # bool[N, K]
    alive: torch.Tensor,      # bool[N]
    have_w: torch.Tensor,     # int32[N, W]
    fresh_w: torch.Tensor,    # int32[N, W]
    valid_w: torch.Tensor,    # int32[W]
    fresh_src: Optional[torch.Tensor] = None,  # int32[N, K, W]
    idontwant: bool = False,
    idw_have_w: Optional[torch.Tensor] = None,  # int32[N, W]
) -> PropagatePackedOut:
    """One eager-push round (kernel K1; same contract as
    ``gossip_packed.propagate_packed``)."""
    with span("kernel.k1"):
        if have_w.device.type == "cpu":
            return gossip_packed.propagate_packed(
                mesh, nbrs, edge_live, alive, have_w, fresh_w, valid_w,
                fresh_src=fresh_src, idontwant=idontwant,
                idw_have_w=idw_have_w)
        if have_w.device.type != "cuda":
            raise ValueError(f"propagate: unsupported device {have_w.device}")
        n, k = nbrs.shape
        w = have_w.shape[1]
        if k > MAX_SLOTS:
            raise ValueError(f"propagate: K={k} > {MAX_SLOTS} slots per peer")
        dev = have_w.device
        for name, t, dt, shape in (
            ("mesh", mesh, torch.bool, (n, k)),
            ("nbrs", nbrs, torch.int32, (n, k)),
            ("edge_live", edge_live, torch.bool, (n, k)),
            ("alive", alive, torch.bool, (n,)),
            ("have_w", have_w, torch.int32, (n, w)),
            ("fresh_w", fresh_w, torch.int32, (n, w)),
            ("valid_w", valid_w, torch.int32, (w,)),
        ):
            _check(name, t, dt, shape, dev)
        if fresh_src is not None:
            _check("fresh_src", fresh_src, torch.int32, (n, k, w), dev)
        idw = None
        if idontwant:
            idw = have_w if idw_have_w is None else idw_have_w
            _check("idw_have_w", idw, torch.int32, (n, w), dev)
        lib = _load()
        variant = kernel_variant(w, [
            (fresh_w if fresh_src is None else fresh_src).data_ptr(),
            valid_w.data_ptr(), have_w.data_ptr(),
            None if idw is None else idw.data_ptr()])
        grid = grid_blocks(n, launch_shape("propagate", variant, k, dev),
                           sm_count(dev))
        new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
        out = PropagatePackedOut(
            have_w=new((n, w), torch.int32), fresh_w=new((n, w), torch.int32),
            new_w=new((n, w), torch.int32), fmd_inc=new((n, k), torch.float32),
            mmd_inc=new((n, k), torch.float32),
            invalid_inc=new((n, k), torch.float32),
        )
        code = lib.gossip_propagate(
            _ptr(mesh), _ptr(edge_live), _ptr(nbrs), _ptr(alive), _ptr(have_w),
            _ptr(fresh_w), _ptr(fresh_src), _ptr(idw), _ptr(valid_w),
            _ptr(out.have_w), _ptr(out.fresh_w), _ptr(out.new_w),
            _ptr(out.fmd_inc), _ptr(out.mmd_inc), _ptr(out.invalid_inc),
            n, k, w, variant, grid, torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(code, "gossip_propagate launch")
        propagate.launches += 1
        return out


propagate.launches = 0


def exchange_select(
    jidx_p: torch.Tensor,        # int32[N, K] rows of ``rows``
    adv_ok_p: torch.Tensor,      # bool[N, K]
    accept_p: torch.Tensor,      # bool[N, K]
    serve_p: torch.Tensor,       # bool[N, K]
    rows: torch.Tensor,          # int32[R, W] (R = N on one device)
    have_dedup_w: torch.Tensor,  # int32[N, W]
    alive: torch.Tensor,         # bool[N]
    max_ihave: int,
    max_iwant: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IHAVE cap + IWANT select over priority-ordered slots (kernel K2;
    same contract as ``gossip_packed.exchange_select``).  The words table
    ``rows`` may hold any number of rows; ``jidx_p`` indexes it (the
    kernel clamps to its row count)."""
    with span("kernel.k2"):
        if rows.device.type == "cpu":
            return gossip_packed.exchange_select(
                jidx_p, adv_ok_p, accept_p, serve_p, rows, have_dedup_w, alive,
                max_ihave, max_iwant)
        if rows.device.type != "cuda":
            raise ValueError(
                f"exchange_select: unsupported device {rows.device}")
        n, k = jidx_p.shape
        w = rows.shape[1]
        if k > MAX_SLOTS:
            raise ValueError(
                f"exchange_select: K={k} > {MAX_SLOTS} slots per peer")
        dev = rows.device
        for name, t, dt, shape in (
            ("jidx_p", jidx_p, torch.int32, (n, k)),
            ("adv_ok_p", adv_ok_p, torch.bool, (n, k)),
            ("accept_p", accept_p, torch.bool, (n, k)),
            ("serve_p", serve_p, torch.bool, (n, k)),
            ("rows", rows, torch.int32, (max(rows.shape[0], 1), w)),
            ("have_dedup_w", have_dedup_w, torch.int32, (n, w)),
            ("alive", alive, torch.bool, (n,)),
        ):
            _check(name, t, dt, shape, dev)
        # The kernel's running popcounts are C ints.
        max_ihave = min(int(max_ihave), 2**31 - 1)
        max_iwant = min(int(max_iwant), 2**31 - 1)
        lib = _load()
        variant = kernel_variant(w, [rows.data_ptr(), have_dedup_w.data_ptr()])
        grid = grid_blocks(n, launch_shape("exchange", variant, k, dev),
                           sm_count(dev))
        pend = torch.empty((n, w), dtype=torch.int32, device=dev)
        broken_p = torch.empty((n, k), dtype=torch.float32, device=dev)
        code = lib.gossip_exchange(
            _ptr(jidx_p), _ptr(adv_ok_p), _ptr(accept_p), _ptr(serve_p),
            _ptr(rows), _ptr(have_dedup_w), _ptr(alive), _ptr(pend),
            _ptr(broken_p), n, rows.shape[0], k, w, max_ihave, max_iwant,
            variant, grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(code, "gossip_exchange launch")
        exchange_select.launches += 1
        return pend, broken_p


exchange_select.launches = 0


# -- the sharded rollout's wrappers (a rank's block of rows) -----------------


def propagate_sharded(
    pm,                       # parallel.mesh.PeerMesh
    mesh: torch.Tensor,       # bool[B, K]  (the rank's block)
    nbrs: torch.Tensor,       # int32[B, K] GLOBAL peer ids
    edge_live: torch.Tensor,  # bool[B, K]
    alive: torch.Tensor,      # bool[B]
    have_w: torch.Tensor,     # int32[B, W]
    fresh_w: torch.Tensor,    # int32[B, W]
    valid_w: torch.Tensor,    # int32[W]
    fresh_src: Optional[torch.Tensor] = None,  # int32[B, K, W]
    idontwant: bool = False,
    idw_have_w: Optional[torch.Tensor] = None,  # int32[B, W]
) -> PropagatePackedOut:
    """One eager-push round on a rank's block (the reference's
    ``propagate_packed_pallas_sharded``, ``ops/pallas_gossip.py:422-492``):
    the one cross-rank read, the senders' fresh words ``fresh_w[nbrs]`` at
    global ids, is gathered through the mesh (all-gather, or the
    split-gather ring when ``pm.ring``) into ``fresh_src`` [B, K, W], which
    the unchanged K1 (:func:`propagate`) reads on the block.  In per-edge
    delay mode the caller's ``fresh_src`` passes straight through."""
    if fresh_src is None:
        fresh_src = pm.gather(fresh_w, torch.clamp(nbrs, 0, pm.n - 1))
    return propagate(mesh, nbrs, edge_live, alive, have_w, fresh_w, valid_w,
                     fresh_src=fresh_src.contiguous(), idontwant=idontwant,
                     idw_have_w=idw_have_w)


def exchange_select_sharded(
    pm,                          # parallel.mesh.PeerMesh
    jidx_p: torch.Tensor,        # int32[B, K] GLOBAL advertiser ids
    adv_ok_p: torch.Tensor,      # bool[B, K]
    accept_p: torch.Tensor,      # bool[B, K]
    serve_p: torch.Tensor,       # bool[B, K]
    rows: torch.Tensor,          # int32[B, W] the block's advertisable words
    have_dedup_w: torch.Tensor,  # int32[B, W]
    alive: torch.Tensor,         # bool[B]
    max_ihave: int,
    max_iwant: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on a rank's block (the ``device_mesh`` arm of the reference's
    ``gossip_exchange_packed_pallas``, ``ops/pallas_gossip.py:373-384``):
    the prep's cross-rank read of the advertisers' words goes through the
    mesh first -- the whole table by all-gather, or under ``pm.ring`` the
    [B, K, W] cube of the block's advertisers by the ring, indexed in
    place -- then :func:`exchange_select` runs row-locally on the block,
    with no collective inside."""
    b, k = jidx_p.shape
    if pm.ring:
        table = pm.gather(rows, jidx_p).reshape(b * k, rows.shape[1])
        idx = torch.arange(b * k, dtype=torch.int32,
                           device=rows.device).reshape(b, k)
    else:
        table = pm.all_gather_rows(rows)
        idx = jidx_p
    return exchange_select(idx, adv_ok_p, accept_p, serve_p,
                           table.contiguous(), have_dedup_w, alive,
                           max_ihave, max_iwant)


def reset_launches() -> None:
    """Set both kernels' launch counts to 0."""
    propagate.launches = 0
    exchange_select.launches = 0
