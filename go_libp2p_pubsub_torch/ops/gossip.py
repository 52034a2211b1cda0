"""GossipSub mesh ops: gossip emission, IWANT priority, heartbeat maintenance.

Port of the JAX package's ``ops/gossip.py`` (the parts the packed model
runs): ``uniform_by_uid``, ``gossip_emission_mask``, ``iwant_priority``,
``masked_median`` and ``heartbeat_mesh``.  The representation is the
reference's: ``nbrs`` int32[N, K] maps each peer's K connection slots to
remote peer ids, ``rev`` int32[N, K] gives the remote's slot pointing
back, and mesh membership and scores are dense [N, K] planes.

Random draws come from ``ops/rng.py`` (threefry, bit for bit with
``jax.random``), so every keyed choice equals the reference's.  The
opportunistic-graft branch that the reference runs under ``lax.cond`` is
taken by a host ``if``: the model derives the tick from the step count the
host owns, so the branch never syncs with the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import GossipSubParams
from . import rng
from .graphs import top_mask


def uniform_by_uid(
    key: torch.Tensor,
    shape: Tuple[int, ...],
    uid: Optional[torch.Tensor],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """Per-peer uniform draw keyed on canonical peer identity: row i of the
    draw is peer id i.  Under a renumbering (``uid`` given, one canonical id
    per row of ``shape``) the rows ``uid`` of the draw are drawn alone
    (``rng.uniform_rows``), bit for bit the reference's ``r[uid]``: a rank
    of the sharded rollout draws only the rows it owns."""
    if uid is None:
        return rng.uniform(key, shape, minval=minval, maxval=maxval)
    if uid.shape[0] != shape[0]:
        raise ValueError(f"uniform_by_uid: {uid.shape[0]} ids for {shape}")
    return rng.uniform_rows(key, uid, shape[1:], minval=minval,
                            maxval=maxval)


def gossip_emission_mask(
    key: torch.Tensor,
    mesh: torch.Tensor,        # bool[N, K]
    edge_live: torch.Tensor,   # bool[N, K]
    alive: torch.Tensor,       # bool[N]
    scores: torch.Tensor,      # f32[N, K]
    p: GossipSubParams,
    gossip_threshold: float,
    uid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bool[N, K]: the neighbor slots each peer advertises to this heartbeat.
    Emission degree is ``max(d_lazy, ceil(gossip_factor * n_eligible))``."""
    n, k = mesh.shape
    eligible = edge_live & ~mesh & alive[:, None] & (scores >= gossip_threshold)
    d_lazy = min(p.d_lazy, k)
    if d_lazy <= 0:
        return torch.zeros((n, k), dtype=torch.bool, device=mesh.device)
    n_eligible = eligible.sum(dim=1).to(torch.float32)
    emit = torch.clamp(
        torch.ceil(p.gossip_factor * n_eligible).to(torch.int32), min=d_lazy
    )
    r = uniform_by_uid(key, (n, k), uid)
    return top_mask(torch.where(eligible, r, -torch.inf), emit, kmax=k)


def iwant_priority(
    key: torch.Tensor, n: int, k: int, uid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-heartbeat random advertiser priority -> (perm, inv), int32[N, K]:
    ``perm[i]`` is a keyed random order of peer i's slots, ``inv`` its
    inverse.  Both argsorts are stable, as ``jnp.argsort`` is."""
    r = uniform_by_uid(key, (n, k), uid)
    perm = torch.argsort(r, dim=1, stable=True)
    inv = torch.argsort(perm, dim=1, stable=True)
    return perm.to(torch.int32), inv.to(torch.int32)


def masked_median(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row median of ``vals`` over ``mask`` -> f32[N]; +inf where the
    mask is empty."""
    k = vals.shape[1]
    cnt = mask.sum(dim=1)
    s = torch.sort(torch.where(mask, vals, torch.inf), dim=1).values
    idx = torch.clamp((cnt - 1) // 2, 0, k - 1)
    med = s.gather(1, idx[:, None])[:, 0]
    return torch.where(cnt > 0, med, torch.inf)


def heartbeat_mesh(
    key: torch.Tensor,
    mesh: torch.Tensor,       # bool[N, K]
    scores: torch.Tensor,     # f32[N, K]
    nbrs: torch.Tensor,       # int32[N, K]
    rev: torch.Tensor,        # int32[N, K]
    edge_live: torch.Tensor,  # bool[N, K]
    alive: torch.Tensor,      # bool[N]
    p: GossipSubParams,
    backoff: Optional[torch.Tensor] = None,   # int32[N, K]
    outbound: Optional[torch.Tensor] = None,  # bool[N, K]
    do_opportunistic: bool = False,  # opportunistic-graft tick
    og_threshold: float = 1.0,
    ignore_backoff: Optional[torch.Tensor] = None,  # bool[N]
    uid: Optional[torch.Tensor] = None,
    edge_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    with_px_offer: bool = False,
    pm=None,
) -> Tuple[torch.Tensor, ...]:
    """Mesh maintenance: prune negative-score and over-degree links, graft
    toward D, then agree on each edge from both endpoints' views.

    Returns (new_mesh, grafted, pruned, new_backoff, bo_violations), plus
    ``score_rev_ok`` when ``with_px_offer``; the rules are the reference's
    (see its docstring in the JAX package).  On a rank of the sharded
    rollout (``pm``, a ``parallel.mesh.PeerMesh``; the planes are the
    rank's block and ``edge_idx`` is required, clipped to the global N)
    the remote's views cross ranks through ``pm.gather_elems``."""
    n, k = nbrs.shape
    dev = nbrs.device
    if backoff is None:
        backoff = torch.zeros((n, k), dtype=torch.int32, device=dev)
    if outbound is None:
        outbound = torch.zeros((n, k), dtype=torch.bool, device=dev)
    kmask = edge_live & alive[:, None]

    keep = mesh & kmask & (scores >= 0.0)
    deg = keep.sum(dim=1)

    kkeep, kgraft, kog = rng.split(key, 3)

    # Oversubscription: the d_score best plus a random fill back to D, with
    # the outbound quota enforced by swapping random inbound fills out.
    noise = uniform_by_uid(kkeep, (n, k), uid, minval=0.0, maxval=1e-3)
    best = top_mask(torch.where(keep, scores + noise, -torch.inf), p.d_score)
    fill = top_mask(
        torch.where(keep & ~best, noise, -torch.inf), max(p.d - p.d_score, 0)
    )
    chosen = best | fill
    if p.d_out > 0:
        ob_short = torch.clamp(
            p.d_out - (chosen & outbound).sum(dim=1), 0, p.d_out
        ).to(torch.int32)
        droppable = (fill & ~outbound).sum(dim=1).to(torch.int32)
        add_ob = top_mask(
            torch.where(keep & outbound & ~chosen, noise, -torch.inf),
            torch.minimum(ob_short, droppable),
            kmax=p.d_out,
        )
        n_added = add_ob.sum(dim=1).to(torch.int32)
        drop = top_mask(
            torch.where(fill & ~outbound, noise, -torch.inf), n_added,
            kmax=p.d_out,
        )
        chosen = (chosen | add_ob) & ~drop
    over = deg > p.d_hi
    keep = keep & torch.where(over[:, None], chosen, True)

    # Grafting below d_lo, gated by my own backoff; the remote's backoff
    # vetoes acceptance below.
    deg_now = keep.sum(dim=1)
    score_ok = scores >= 0.0
    bo_ok = backoff <= 0
    cand_bo = bo_ok if ignore_backoff is None else (
        bo_ok | ignore_backoff[:, None]
    )
    cand = kmask & ~keep & score_ok & cand_bo
    r = uniform_by_uid(kgraft, (n, k), uid)
    want_more = torch.where(
        deg_now < p.d_lo, torch.clamp(p.d - deg_now, min=0), 0
    ).to(torch.int32)
    graft = top_mask(torch.where(cand, r, -torch.inf), want_more, kmax=p.d)

    if p.d_out > 0:
        ob_have = ((keep | graft) & outbound).sum(dim=1)
        want_ob = torch.clamp(p.d_out - ob_have, 0, p.d_out).to(torch.int32)
        graft = graft | top_mask(
            torch.where(cand & outbound & ~graft, r, -torch.inf),
            want_ob,
            kmax=p.d_out,
        )

    # Opportunistic grafting on the ticks the caller flags.
    if p.opportunistic_graft_peers > 0 and do_opportunistic:
        med = masked_median(scores, keep)
        og_want = torch.where(
            med < og_threshold, p.opportunistic_graft_peers, 0
        ).to(torch.int32)
        rog = uniform_by_uid(kog, (n, k), uid)
        graft = graft | top_mask(
            torch.where(cand & ~graft & (scores > med[:, None]), rog,
                        -torch.inf),
            og_want,
            kmax=p.opportunistic_graft_peers,
        )

    # Edge agreement: the remote's four views ride one int32 bitfield
    # gathered at the paired slot (jidx, ridx).
    if edge_idx is None:
        if pm is not None:
            raise ValueError("heartbeat_mesh: a sharded call needs edge_idx")
        jidx = torch.clamp(nbrs, 0, n - 1)
        ridx = torch.clamp(rev, 0, k - 1)
    else:
        jidx, ridx = edge_idx
    flags = (
        keep.to(torch.int32)
        | (graft.to(torch.int32) << 1)
        | (score_ok.to(torch.int32) << 2)
        | (bo_ok.to(torch.int32) << 3)
    )
    if pm is None:
        flags_rev = flags[jidx.long(), ridx.long()]
    else:  # four bits: the plane crosses ranks as bytes
        flags_rev = pm.gather_elems(
            flags.to(torch.uint8), jidx, ridx).to(torch.int32)
    keep_rev = (flags_rev & 1) > 0
    graft_rev = (flags_rev & 2) > 0
    score_rev_ok = (flags_rev & 4) > 0
    bo_rev_ok = (flags_rev & 8) > 0

    survives = mesh & keep & keep_rev
    forms = ~mesh & (
        (graft & score_rev_ok & bo_rev_ok) | (graft_rev & score_ok & bo_ok)
    )
    new_mesh = kmask & (survives | forms)

    grafted = new_mesh & ~mesh
    pruned = mesh & ~new_mesh
    new_backoff = torch.where(
        pruned,
        p.prune_backoff_heartbeats,
        torch.clamp(backoff - 1, min=0),
    ).to(torch.int32)
    bo_violations = (graft & ~bo_rev_ok).sum(dim=1).to(torch.float32)
    if with_px_offer:
        return (
            new_mesh, grafted, pruned, new_backoff, bo_violations,
            score_rev_ok,
        )
    return new_mesh, grafted, pruned, new_backoff, bo_violations
