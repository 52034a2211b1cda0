"""Bit-packed GossipSub hot-loop ops: the plain PyTorch versions.

Port of the JAX package's ``ops/gossip_packed.py``.  Message windows are
int32 words holding the reference's uint32 bit patterns
(``ops/bitpack.py``).  These functions are the plain versions of the two
CUDA kernels in ``ops/cuda_gossip.py``:

- :func:`propagate_packed` -- one eager-push round (kernel K1's plain
  version, in its layout and signature);
- :func:`exchange_select` -- the heartbeat's IHAVE cap, IWANT select and
  promise count over slots already in the receiver's priority order
  (kernel K2's plain version, in its layout).  :func:`exchange_prep`
  builds its inputs and :func:`gossip_exchange_packed` is the whole
  exchange, prep + select + un-permute, as the reference computes it.

The unfused :func:`ihave_advertise_packed` / :func:`iwant_select_packed`
pair stays as the reference the fused exchange is tested against.

:func:`ring_gather_rows` is the sharded rollout's split gather (the
reference's ``ring_gather_rows``, over a ``parallel.mesh.PeerMesh``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GossipSubParams
from . import bitpack
from .bitpack import as_mask, popcount_words
from .gossip import gossip_emission_mask, iwant_priority
from .graphs import take_rows

FULL = bitpack.FULL  # the all-ones word, as the int32 bit pattern -1


def ring_gather_rows(table: torch.Tensor, idx: torch.Tensor, mesh
                     ) -> torch.Tensor:
    """``whole[clip(idx)]`` for this rank's block ``table`` of a row-sharded
    ``whole`` table (``mesh.world * table.shape[0]`` rows), at global row
    ids ``idx``, as local indexing plus a ring of block exchanges.

    Round r has rank d hold the block owned by rank (d + r) mod R and
    resolve exactly the indices that land in it: round 0 is the
    intra-shard half (local indexing, no communication; a locality-aware
    placement makes it resolve most rows), rounds 1 ... R-1 the
    cross-shard half.  The next block is posted (``PeerMesh.shift``:
    ``batch_isend_irecv``, send to d - 1, receive from d + 1) BEFORE the
    current block's gather runs, so the transfer overlaps the local
    compute, with never more than one extra block resident.  Every index
    is resolved by exactly one round, so the result is ``whole[clip(idx)]``
    bit for bit (the reference's callers clip; this clips itself)."""
    n_sh = mesh.world
    blk = table.shape[0]
    idx = torch.clamp(idx, 0, n_sh * blk - 1).long()
    out = torch.zeros(idx.shape + table.shape[1:], dtype=table.dtype,
                      device=table.device)
    buf = table.contiguous()
    for r in range(n_sh):
        nxt = mesh.shift(buf) if r + 1 < n_sh else None
        owner = (mesh.rank + r) % n_sh
        loc = idx - owner * blk
        hit = (loc >= 0) & (loc < blk)
        rows = take_rows(buf, torch.clamp(loc, 0, blk - 1))
        shape_up = hit.reshape(hit.shape + (1,) * (rows.ndim - hit.ndim))
        out = torch.where(shape_up, rows, out)
        if nxt is not None:
            buf = nxt()
    return out


def _gather_packed_bits(
    plane: torch.Tensor, jidx: torch.Tensor, ridx: torch.Tensor
) -> torch.Tensor:
    """``plane[jidx, ridx]`` for a bool[N, K] plane, gathered bit-packed
    along the slot axis (the reference's word-plane idiom; bit-exact)."""
    words = bitpack.pack(plane)                      # int32[N, ceil(K/32)]
    ridx = ridx.long()
    w = words[jidx.long(), ridx // 32]
    return (bitpack.srl(w, ridx % 32) & 1) > 0


def exclusive_or_scan(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exclusive cumulative bitwise-OR along ``axis`` (log-step prefix)."""
    k = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    p = torch.cat([zero, x.narrow(axis, 0, k - 1)], dim=axis)
    sh = 1
    while sh < k:
        zeros = torch.zeros_like(x.narrow(axis, 0, min(sh, k)))
        shifted = torch.cat([zeros, p.narrow(axis, 0, k - sh)], dim=axis)
        p = p | shifted
        sh *= 2
    return p


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (torch has no OR reduction)."""
    out = x.select(dim, 0).clone()
    for s in range(1, x.shape[dim]):
        out |= x.select(dim, s)
    return out


def _pc_sum(x: torch.Tensor) -> torch.Tensor:
    """Popcount summed over the last (word) axis, as f32."""
    return popcount_words(x).sum(dim=-1).to(torch.float32)


class PropagatePackedOut(NamedTuple):
    have_w: torch.Tensor       # int32[N, W]
    fresh_w: torch.Tensor      # int32[N, W]
    new_w: torch.Tensor        # int32[N, W] first receipts this round
    fmd_inc: torch.Tensor      # f32[N, K]
    mmd_inc: torch.Tensor      # f32[N, K]
    invalid_inc: torch.Tensor  # f32[N, K]


def propagate_packed(
    mesh: torch.Tensor,       # bool[N, K]
    nbrs: torch.Tensor,       # int32[N, K]
    edge_live: torch.Tensor,  # bool[N, K]
    alive: torch.Tensor,      # bool[N]
    have_w: torch.Tensor,     # int32[N, W]
    fresh_w: torch.Tensor,    # int32[N, W]
    valid_w: torch.Tensor,    # int32[W] packed (msg_valid & msg_active)
    fresh_src: Optional[torch.Tensor] = None,  # int32[N, K, W] per-edge planes
    idontwant: bool = False,
    idw_have_w: Optional[torch.Tensor] = None,  # int32[N, W]
) -> PropagatePackedOut:
    """One eager-push round over packed windows: mesh neighbors relay last
    round's first receipts; each receiver deduplicates, credits the
    lowest delivering slot, and keeps valid messages for relay."""
    n = nbrs.shape[0]
    edge_ok = mesh & edge_live
    if fresh_src is None:
        src = fresh_w[torch.clamp(nbrs, 0, n - 1).long()]
    else:
        src = fresh_src
    inc = as_mask(edge_ok)[:, :, None] & src                 # int32[N, K, W]

    before = exclusive_or_scan(inc, axis=1)
    first_sender = inc & ~before
    arrived = _or_reduce(inc, dim=1)                         # int32[N, W]
    new_w = arrived & ~have_w & as_mask(alive)[:, None]
    newly = first_sender & new_w[:, None, :]

    fmd_inc = _pc_sum(newly & valid_w)
    invalid_inc = _pc_sum(newly & ~valid_w)
    idw = have_w if idw_have_w is None else idw_have_w
    counted = inc if not idontwant else (inc & ~idw[:, None, :])
    mmd_inc = _pc_sum(counted & valid_w)

    return PropagatePackedOut(
        have_w=have_w | (new_w & valid_w),
        fresh_w=new_w & valid_w,
        new_w=new_w,
        fmd_inc=fmd_inc,
        mmd_inc=mmd_inc,
        invalid_inc=invalid_inc,
    )


def cap_ihave_packed(adv_w: torch.Tensor, max_len: int) -> torch.Tensor:
    """Word-granular length cap over packed advertisements (int32[..., W]):
    keep whole words while the cumulative popcount fits."""
    cum = torch.cumsum(popcount_words(adv_w), dim=-1)
    return adv_w & as_mask(cum <= max_len)


def ihave_advertise_packed(
    key: torch.Tensor,
    have_w: torch.Tensor,     # int32[N, W]
    mesh: torch.Tensor,       # bool[N, K]
    nbrs: torch.Tensor,       # int32[N, K]
    rev: torch.Tensor,        # int32[N, K]
    edge_live: torch.Tensor,  # bool[N, K]
    alive: torch.Tensor,      # bool[N]
    scores: torch.Tensor,     # f32[N, K]
    gossip_w: torch.Tensor,   # int32[W]
    p: GossipSubParams,
    gossip_threshold: float,
    uid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Heartbeat IHAVE phase -> adv int32[N, K, W]: ``adv[i, s]`` is what
    neighbor slot s advertised to peer i (target-side reverse gather)."""
    n, k = nbrs.shape
    if min(p.d_lazy, k) <= 0:
        return torch.zeros((n, k, have_w.shape[1]), dtype=torch.int32,
                           device=have_w.device)
    chosen = gossip_emission_mask(
        key, mesh, edge_live, alive, scores, p, gossip_threshold, uid
    )
    jidx = torch.clamp(nbrs, 0, n - 1)
    ridx = torch.clamp(rev, 0, k - 1)
    towards_me = _gather_packed_bits(chosen, jidx, ridx) & edge_live
    adv = as_mask(towards_me)[:, :, None] & (have_w & gossip_w[None, :])[
        jidx.long()]
    return cap_ihave_packed(adv, p.max_ihave_length)


def iwant_select_packed(
    key: torch.Tensor,
    adv_w: torch.Tensor,      # int32[N, K, W]
    have_w: torch.Tensor,     # int32[N, W]
    edge_live: torch.Tensor,  # bool[N, K]
    scores: torch.Tensor,     # f32[N, K]
    serve_ok: torch.Tensor,   # bool[N, K]
    alive: torch.Tensor,      # bool[N]
    max_iwant_length: int,
    gossip_threshold: float,
    uid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IWANT phase with promise accounting -> (pend int32[N, W], broken
    f32[N, K]): one ask per wanted id at a keyed random advertiser
    priority, capped per advertiser; asks to non-serving advertisers are
    broken promises."""
    n, k = edge_live.shape
    accept = edge_live & (scores >= gossip_threshold)
    want = adv_w & ~have_w[:, None, :] & as_mask(accept)[:, :, None]
    perm, inv = iwant_priority(key, n, k, uid)
    perm_l = perm.long()
    want_p = want.gather(1, perm_l[:, :, None].expand_as(want))
    first_p = want_p & ~exclusive_or_scan(want_p, axis=1)
    asked_p = cap_ihave_packed(first_p, max_iwant_length)
    serve_p = as_mask(serve_ok.gather(1, perm_l))[:, :, None]
    pend = _or_reduce(asked_p & serve_p, dim=1)
    broken_p = _pc_sum(asked_p & ~serve_p)
    broken = broken_p.gather(1, inv.long())
    return pend & as_mask(alive)[:, None], broken


class ExchangeInputs(NamedTuple):
    """Kernel K2's inputs: [N, K] planes in the receiver's priority order."""

    jidx_p: torch.Tensor    # int32[N, K] advertiser peer id (clipped)
    adv_ok_p: torch.Tensor  # bool[N, K] the advertiser chose me this heartbeat
    accept_p: torch.Tensor  # bool[N, K] I accept its IHAVEs (score gate)
    serve_p: torch.Tensor   # bool[N, K] it serves IWANTs
    rows: torch.Tensor      # int32[N, W] advertisable words of every peer
    inv: torch.Tensor       # int32[N, K] inverse of the priority order


def exchange_prep(
    key_adv, key_iwant, have_w, mesh, nbrs, rev, edge_live, alive, scores,
    gossip_w, p: GossipSubParams, gossip_threshold: float, serve_ok,
    uid=None, pm=None,
) -> ExchangeInputs:
    """Emission choice, priority permutation and the permuted [N, K]
    planes: everything of the fused exchange that stays in PyTorch.  On a
    rank of the sharded rollout (``pm``; the planes are its block, ``nbrs``
    hold global ids) the advertisers' choice bits cross ranks bit-packed
    along the slot axis; ``rows`` stays the block's own words, which K2's
    sharded wrapper gathers."""
    n, k = nbrs.shape
    if pm is not None:
        n_all = pm.n
    chosen = gossip_emission_mask(
        key_adv, mesh, edge_live, alive, scores, p, gossip_threshold, uid
    )
    perm, inv = iwant_priority(key_iwant, n, k, uid)
    perm_l = perm.long()
    take = lambda x: x.gather(1, perm_l)  # noqa: E731
    jidx_p = take(torch.clamp(nbrs, 0, (n if pm is None else n_all) - 1))
    ridx_p = take(torch.clamp(rev, 0, k - 1))
    edge_live_p = take(edge_live)
    if pm is None:
        towards = _gather_packed_bits(chosen, jidx_p, ridx_p)
    else:
        ridx_l = ridx_p.long()
        words = pm.gather(bitpack.pack(chosen), jidx_p)  # [B, K, ceil(K/32)]
        w = words.gather(2, (ridx_l // 32)[:, :, None])[..., 0]
        towards = (bitpack.srl(w, ridx_l % 32) & 1) > 0
    adv_ok_p = towards & edge_live_p
    accept_p = edge_live_p & (take(scores) >= gossip_threshold)
    return ExchangeInputs(
        jidx_p=jidx_p.to(torch.int32).contiguous(),
        adv_ok_p=adv_ok_p.contiguous(),
        accept_p=accept_p.contiguous(),
        serve_p=take(serve_ok).contiguous(),
        rows=(have_w & gossip_w[None, :]).contiguous(),
        inv=inv,
    )


def exchange_select(
    jidx_p: torch.Tensor,      # int32[N, K]
    adv_ok_p: torch.Tensor,    # bool[N, K]
    accept_p: torch.Tensor,    # bool[N, K]
    serve_p: torch.Tensor,     # bool[N, K]
    rows: torch.Tensor,        # int32[N, W]
    have_dedup_w: torch.Tensor,  # int32[N, W]
    alive: torch.Tensor,       # bool[N]
    max_ihave: int,
    max_iwant: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IHAVE cap + IWANT select over priority-ordered slots -> (pend
    int32[N, W], broken_p f32[N, K] in priority order).  Kernel K2's plain
    version."""
    adv = as_mask(adv_ok_p)[:, :, None] & rows[jidx_p.long()]
    adv = cap_ihave_packed(adv, max_ihave)
    want = adv & ~have_dedup_w[:, None, :] & as_mask(accept_p)[:, :, None]
    first = want & ~exclusive_or_scan(want, axis=1)
    asked = cap_ihave_packed(first, max_iwant)
    serve = as_mask(serve_p)[:, :, None]
    pend = _or_reduce(asked & serve, dim=1)
    broken_p = _pc_sum(asked & ~serve)
    return pend & as_mask(alive)[:, None], broken_p


def gossip_exchange_packed(
    key_adv, key_iwant,
    have_w: torch.Tensor,        # int32[N, W] advertise source
    have_dedup_w: torch.Tensor,  # int32[N, W] IWANT dedup view
    mesh, nbrs, rev, edge_live, alive, scores,
    gossip_w: torch.Tensor,      # int32[W]
    p: GossipSubParams,
    gossip_threshold: float,
    serve_ok: torch.Tensor,      # bool[N, K]
    max_iwant_length: int,
    uid=None,
    select=exchange_select,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused IHAVE advertise + IWANT select -> (pend int32[N, W], broken
    f32[N, K]), bit-exact with ``iwant_select_packed(ihave_advertise_packed
    (...))`` under the same keys.  ``select`` is :func:`exchange_select`
    or kernel K2's wrapper (``cuda_gossip.exchange_select``), which the
    model runs in its place."""
    n, k = nbrs.shape
    if min(p.d_lazy, k) <= 0:
        return (
            torch.zeros_like(have_w),
            torch.zeros((n, k), dtype=torch.float32, device=have_w.device),
        )
    x = exchange_prep(
        key_adv, key_iwant, have_w, mesh, nbrs, rev, edge_live, alive,
        scores, gossip_w, p, gossip_threshold, serve_ok, uid,
    )
    pend, broken_p = select(
        x.jidx_p, x.adv_ok_p, x.accept_p, x.serve_p, x.rows, have_dedup_w,
        alive, p.max_ihave_length, max_iwant_length,
    )
    return pend, broken_p.gather(1, x.inv.long())
