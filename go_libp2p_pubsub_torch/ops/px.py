"""Peer exchange on prune (GossipSub v1.1 PX) as a topology rewire.

Port of the JAX package's ``ops/px.py``.  A pruned peer may open one new
connection to a random mesh neighbor of its pruner, gated on both sides
by score.  At most one PX connection forms per initiator and per
acceptor per heartbeat, an acceptor is never an initiator, and winners
come from a scatter-min over initiator ids, so every write below touches
a distinct (row, slot).  Writes aimed at row N (the losers) land in a
scratch row that is cut off afterwards -- the form of the reference's
``mode="drop"`` scatters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .gossip import uniform_by_uid


class PxOut(NamedTuple):
    nbrs: torch.Tensor       # int32[N, K]
    rev: torch.Tensor        # int32[N, K]
    nbr_valid: torch.Tensor  # bool[N, K]
    outbound: torch.Tensor   # bool[N, K]
    backoff: torch.Tensor    # int32[N, K]
    connected: torch.Tensor  # bool[N] peer initiated a PX edge


def _set_two(plane: torch.Tensor, rows_i, cols_i, val_i, rows_m, cols_m,
             val_m) -> torch.Tensor:
    """``plane.at[rows_i, cols_i].set(val_i).at[rows_m, cols_m].set(val_m)``
    with rows == N dropped: the writes go to a scratch row N."""
    n, k = plane.shape
    ext = torch.cat([plane, plane.new_zeros((1, k))], dim=0)
    for rows, cols, val in ((rows_i, cols_i, val_i), (rows_m, cols_m, val_m)):
        if not isinstance(val, torch.Tensor):  # a device fill, not a copy
            val = plane.new_full((), val)
        ext.index_put_((rows, cols), val)
    return ext[:n]


def px_rewire(
    key: torch.Tensor,
    nbrs: torch.Tensor,       # int32[N, K]
    rev: torch.Tensor,        # int32[N, K]
    nbr_valid: torch.Tensor,  # bool[N, K]
    outbound: torch.Tensor,   # bool[N, K]
    backoff: torch.Tensor,    # int32[N, K]
    mesh: torch.Tensor,       # bool[N, K] post-heartbeat mesh
    pruned: torch.Tensor,     # bool[N, K] edges pruned this heartbeat
    scores: torch.Tensor,     # f32[N, K]
    alive: torch.Tensor,      # bool[N]
    accept_px_threshold: float,
    uid: Optional[torch.Tensor] = None,
    edge_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    offer_ok: Optional[torch.Tensor] = None,  # bool[N, K] precomputed gate
    pm=None,
) -> PxOut:
    """One PX round; returns the rewired adjacency (on a rank of the
    sharded rollout, ``pm``, its block: :func:`_px_rewire_sharded`)."""
    if pm is not None:
        return _px_rewire_sharded(
            pm, key, nbrs, rev, nbr_valid, outbound, backoff, mesh, pruned,
            scores, alive, accept_px_threshold, uid, edge_idx, offer_ok)
    n, k = nbrs.shape
    dev = nbrs.device
    if edge_idx is None:
        jidx = torch.clamp(nbrs, 0, n - 1)
        ridx = torch.clamp(rev, 0, k - 1)
    else:
        jidx, ridx = edge_idx
    jidx_l = jidx.long()
    peer_ids = torch.arange(n, dtype=torch.int32, device=dev)
    peer_l = peer_ids.long()

    if offer_ok is None:
        offer_ok = scores[jidx_l, ridx.long()] >= 0.0
    accept_ok = scores >= accept_px_threshold
    px_edge = pruned & offer_ok & accept_ok & nbr_valid
    has_px = px_edge.any(dim=1)
    s_sel = torch.argmax(px_edge.to(torch.uint8), dim=1)    # first offer
    j_sel = jidx_l[peer_l, s_sel]                           # the pruner

    # Candidate m: a uniformly random current mesh neighbor of the pruner.
    mesh_j = mesh[j_sel]
    rnd = uniform_by_uid(key, (n, k), uid)
    cand_slot = torch.argmax(torch.where(mesh_j, rnd, -torch.inf), dim=1)
    has_cand = mesh_j.any(dim=1)
    m = jidx[j_sel, cand_slot]                              # int32[N]
    m_l = m.long()

    already = ((nbrs == m[:, None]) & nbr_valid).any(dim=1)
    free_cnt = (~nbr_valid).sum(dim=1)
    init = (
        has_px
        & has_cand
        & alive
        & alive[m_l]
        & (m != peer_ids)
        & ~already
        & (free_cnt > 0)
    )
    init = init & ~init[m_l]
    init = init & (free_cnt[m_l] > 0)

    # One initiator per acceptor: scatter-min of (canonical) initiator ids.
    uid_vals = peer_ids if uid is None else uid.to(torch.int32)
    tgt = torch.where(init, m, n).long()
    winner = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce(0, tgt, uid_vals, reduce="amin",
                                   include_self=True)
    win = init & (winner[tgt] == uid_vals)

    fi = torch.argmax((~nbr_valid).to(torch.uint8), dim=1)  # my free slot
    fm = fi[m_l]                                            # the acceptor's

    rows_i = torch.where(win, peer_ids, n).long()
    rows_m = torch.where(win, m, n).long()
    fi32, fm32 = fi.to(torch.int32), fm.to(torch.int32)

    nbrs = _set_two(nbrs, rows_i, fi, m, rows_m, fm, peer_ids)
    rev = _set_two(rev, rows_i, fi, fm32, rows_m, fm, fi32)
    nbr_valid = _set_two(nbr_valid, rows_i, fi, True, rows_m, fm, True)
    outbound = _set_two(outbound, rows_i, fi, True, rows_m, fm, False)
    backoff = _set_two(backoff, rows_i, fi, 0, rows_m, fm, 0)
    return PxOut(nbrs, rev, nbr_valid, outbound, backoff, win)


def _px_rewire_sharded(pm, key, nbrs, rev, nbr_valid, outbound, backoff, mesh,
                       pruned, scores, alive, accept_px_threshold, uid,
                       edge_idx, offer_ok) -> PxOut:
    """:func:`px_rewire` on a rank's block of B rows (``nbrs`` hold global
    ids; ``uid`` the block's canonical ids).  Every read at a remote row
    (the pruner's mesh row and neighbor id, the candidate's liveness,
    free slot and own initiative) goes through the mesh; the winners'
    scatter-min is a local scatter then an integer all-reduce MIN; and the
    acceptors' writes, which land on other ranks' rows, travel as one
    integer all-reduce MIN of ``initiator * K + its free slot`` per
    acceptor (each acceptor has at most one winner, and no winner is an
    acceptor, so the writes of the two sides touch disjoint rows as in the
    unsharded scatter)."""
    b, k = nbrs.shape
    n = pm.n
    dev = nbrs.device
    if edge_idx is None:
        jidx = torch.clamp(nbrs, 0, n - 1)
        ridx = torch.clamp(rev, 0, k - 1)
    else:
        jidx, ridx = edge_idx
    jidx_l = jidx.long()
    local = torch.arange(b, dtype=torch.int64, device=dev)
    peer_ids = (local + pm.row0).to(torch.int32)

    if offer_ok is None:
        offer_ok = pm.gather_elems(scores, jidx, ridx) >= 0.0
    accept_ok = scores >= accept_px_threshold
    px_edge = pruned & offer_ok & accept_ok & nbr_valid
    has_px = px_edge.any(dim=1)
    s_sel = torch.argmax(px_edge.to(torch.uint8), dim=1)    # first offer
    j_sel = jidx_l[local, s_sel]                            # the pruner

    mesh_j = pm.gather(mesh, j_sel)
    rnd = uniform_by_uid(key, (b, k), uid)
    cand_slot = torch.argmax(torch.where(mesh_j, rnd, -torch.inf), dim=1)
    has_cand = mesh_j.any(dim=1)
    m = pm.gather_elems(jidx.to(torch.int32), j_sel, cand_slot)  # int32[B]
    m_l = m.long()

    already = ((nbrs == m[:, None]) & nbr_valid).any(dim=1)
    free_cnt = (~nbr_valid).sum(dim=1)
    fi = torch.argmax((~nbr_valid).to(torch.uint8), dim=1)  # my free slot
    # The candidate's free slot, liveness and free-slot test in one word.
    word = (fi.to(torch.int32) | (alive.to(torch.int32) << 8)
            | ((free_cnt > 0).to(torch.int32) << 9))
    at_m = pm.gather(word, m_l)
    fm = at_m & 0xFF                                        # the acceptor's
    init = (
        has_px
        & has_cand
        & alive
        & ((at_m >> 8) & 1).bool()
        & (m != peer_ids)
        & ~already
        & (free_cnt > 0)
    )
    init = init & ~pm.gather(init, m_l)
    init = init & ((at_m >> 9) & 1).bool()

    # One initiator per acceptor: scatter-min of (canonical) initiator ids.
    uid_vals = peer_ids if uid is None else uid.to(torch.int32)
    tgt = torch.where(init, m, n).long()
    winner = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce(0, tgt, uid_vals, reduce="amin",
                                   include_self=True)
    winner = pm.min(winner)
    win = init & (winner[tgt] == uid_vals)

    # Acceptor side: ``initiator * K + initiator's free slot`` at its row.
    big = n * k
    offer = torch.full((n + 1,), big, dtype=torch.int64, device=dev)
    offer = offer.scatter_reduce(
        0, torch.where(win, m, n).long(),
        peer_ids.to(torch.int64) * k + fi, reduce="amin", include_self=True)
    offer = pm.min(offer)[pm.row0:pm.row0 + b]
    acc = offer < big
    init_id = (offer // k).to(torch.int32)
    init_fi = (offer % k).to(torch.int32)

    rows_i = torch.where(win, local, b)
    rows_m = torch.where(acc, local, b)
    nbrs = _set_two(nbrs, rows_i, fi, m, rows_m, fi, init_id)
    rev = _set_two(rev, rows_i, fi, fm.to(rev.dtype), rows_m, fi,
                   init_fi.to(rev.dtype))
    nbr_valid = _set_two(nbr_valid, rows_i, fi, True, rows_m, fi, True)
    outbound = _set_two(outbound, rows_i, fi, True, rows_m, fi, False)
    backoff = _set_two(backoff, rows_i, fi, 0, rows_m, fi, 0)
    return PxOut(nbrs, rev, nbr_valid, outbound, backoff, win)
