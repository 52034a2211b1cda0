"""GossipSub mesh ops: eager push, lazy gossip, heartbeat maintenance.

Port of the JAX package's ``ops/gossip.py``, whole: ``uniform_by_uid``,
``gossip_emission_mask``, ``iwant_priority``, ``masked_median`` and
``heartbeat_mesh``, which the packed model runs, and the unpacked boolean
[N, K, M] forms of the eager push and the IHAVE/IWANT exchange
(``PropagateOut``/``propagate``, ``cap_ihave``, ``ihave_advertise``,
``iwant_select``).  The unpacked forms are reference code that no model
path calls: they are the semantics the packed ops of
``ops/gossip_packed.py`` and kernels K1/K2 are held to, independent of the
word layout.  The representation is the reference's: ``nbrs``
int32[N, K] maps each peer's K connection slots to remote peer ids,
``rev`` int32[N, K] gives the remote's slot pointing back, and mesh
membership and scores are dense [N, K] planes.

Random draws come from ``ops/rng.py`` (threefry, bit for bit with
``jax.random``), so every keyed choice equals the reference's.  The
opportunistic-graft branch that the reference runs under ``lax.cond`` is
taken by a host ``if``: the model derives the tick from the step count the
host owns, so the branch never syncs with the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GossipSubParams
from . import rng
from .graphs import safe_gather, top_mask


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


class PropagateOut(NamedTuple):
    have: torch.Tensor
    fresh: torch.Tensor
    first_step: torch.Tensor
    fmd_inc: torch.Tensor      # f32[N, K] first-delivery increments (valid msgs)
    mmd_inc: torch.Tensor      # f32[N, K] mesh-delivery increments
    invalid_inc: torch.Tensor  # f32[N, K] invalid first-delivery increments


def propagate(
    mesh: torch.Tensor,        # bool[N, K] symmetric mesh membership
    nbrs: torch.Tensor,        # int32[N, K]
    nbr_valid: torch.Tensor,   # bool[N, K]
    alive: torch.Tensor,       # bool[N]
    have: torch.Tensor,        # bool[N, M]
    fresh: torch.Tensor,       # bool[N, M] first-received last round
    first_step: torch.Tensor,  # int32[N, M] step of first receipt, -1 = never
    msg_valid: torch.Tensor,   # bool[M] validation verdict per message
    step,                      # int or 0-d int32 tensor: the current step
    idontwant: bool = False,   # v1.2: senders skip ids the receiver had
    idw_have: Optional[torch.Tensor] = None,  # bool[N, M] pre-fold view
) -> PropagateOut:
    """One eager-push round over the unpacked [N, K, M] incoming cube:
    mesh neighbors relay last round's first receipts; receivers
    deduplicate, credit the lowest delivering slot, and keep valid
    messages for relay next round.  Under ``idontwant`` the copies of ids
    the receiver held in ``idw_have`` (default ``have``) leave the P3
    count only.  The increments are sums of at most M booleans, exact in
    f32."""
    n, k = nbrs.shape

    j = torch.clamp(nbrs, 0, n - 1).long()
    edge_ok = mesh & nbr_valid & safe_gather(alive, nbrs, False)
    incoming = edge_ok[:, :, None] & fresh[j]                 # bool[N, K, M]

    arrived = incoming.any(dim=1)                             # bool[N, M]
    new = arrived & ~have & alive[:, None]

    # First-delivering slot per (peer, msg): the lowest slot among senders.
    prefix = torch.cumsum(incoming.to(torch.int32), dim=1)
    first_sender = incoming & (prefix == 1)
    newly = first_sender & new[:, None, :]

    fmd_inc = (newly & msg_valid[None, None, :]).sum(dim=2).to(torch.float32)
    invalid_inc = (newly & ~msg_valid[None, None, :]).sum(dim=2).to(
        torch.float32)
    idw = have if idw_have is None else idw_have
    counted = incoming if not idontwant else (incoming & ~idw[:, None, :])
    mmd_inc = (counted & msg_valid[None, None, :]).sum(dim=2).to(
        torch.float32)

    have_next = have | (new & msg_valid[None, :])
    fresh_next = new & msg_valid[None, :]
    first_step_next = torch.where(new & (first_step < 0), step, first_step)

    return PropagateOut(
        have_next, fresh_next, first_step_next, fmd_inc, mmd_inc, invalid_inc
    )


def cap_ihave(adv: torch.Tensor, max_len: int) -> torch.Tensor:
    """Truncate each IHAVE (bool[..., M] advertisement) to at most
    ``max_len`` ids at 32-bit-word granularity: whole words are kept while
    the cumulative id count fits (the packed ops' cap, bit for bit)."""
    m = adv.shape[-1]
    w = (m + 31) // 32
    padded = torch.nn.functional.pad(adv, (0, w * 32 - m))
    words = padded.reshape(adv.shape[:-1] + (w, 32))
    counts = words.sum(dim=-1)
    cum = torch.cumsum(counts, dim=-1)
    keep = (cum <= max_len)[..., None]
    return (words & keep).reshape(adv.shape[:-1] + (w * 32,))[..., :m]


def ihave_advertise(
    key: torch.Tensor,
    have: torch.Tensor,        # bool[N, M]
    mesh: torch.Tensor,        # bool[N, K]
    nbrs: torch.Tensor,        # int32[N, K]
    rev: torch.Tensor,         # int32[N, K]
    edge_live: torch.Tensor,   # bool[N, K]
    alive: torch.Tensor,       # bool[N]
    scores: torch.Tensor,      # f32[N, K] my view of each neighbor slot
    gossip_msgs: torch.Tensor,  # bool[M] advertisable window
    p: GossipSubParams,
    gossip_threshold: float,
    uid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Heartbeat IHAVE phase -> adv bool[N, K, M]: ``adv[i, s]`` is the set
    of ids advertised TO peer i BY its neighbor slot s, restricted to
    ``gossip_msgs`` and capped at ``max_ihave_length`` (target-side
    reverse gather)."""
    n, k = nbrs.shape
    chosen = gossip_emission_mask(
        key, mesh, edge_live, alive, scores, p, gossip_threshold, uid
    )
    jidx = torch.clamp(nbrs, 0, n - 1).long()
    ridx = torch.clamp(rev, 0, k - 1).long()
    towards_me = chosen[jidx, ridx] & edge_live
    adv = towards_me[:, :, None] & (have & gossip_msgs[None, :])[jidx]
    return cap_ihave(adv, p.max_ihave_length)


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


def iwant_select(
    key: torch.Tensor,
    adv: torch.Tensor,        # bool[N, K, M] advertisements this heartbeat
    have: torch.Tensor,       # bool[N, M]
    edge_live: torch.Tensor,  # bool[N, K]
    scores: torch.Tensor,     # f32[N, K] receiver's score of each advertiser
    serve_ok: torch.Tensor,   # bool[N, K] the advertiser will serve
    alive: torch.Tensor,      # bool[N]
    max_iwant_length: int,
    gossip_threshold: float,
    uid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IWANT phase with promise accounting -> (pend bool[N, M], broken
    f32[N, K]): IHAVEs from advertisers scored below ``gossip_threshold``
    are ignored; each wanted id is asked of its first advertiser in a keyed
    random slot order, asks are capped per advertiser at
    ``max_iwant_length`` (word-granular), and asks to advertisers that do
    not serve count as broken promises."""
    n, k = edge_live.shape
    accept = edge_live & (scores >= gossip_threshold)
    want = adv & ~have[:, None, :] & accept[:, :, None]
    perm, inv = iwant_priority(key, n, k, uid)
    want_p = want.gather(1, perm.long()[:, :, None].expand_as(want))
    prefix = torch.cumsum(want_p.to(torch.int32), dim=1)
    first_p = want_p & (prefix == 1)
    first = first_p.gather(1, inv.long()[:, :, None].expand_as(first_p))
    asked = cap_ihave(first, max_iwant_length)
    served = asked & serve_ok[:, :, None]
    pend = served.any(dim=1) & alive[:, None]
    broken = (asked & ~serve_ok[:, :, None]).sum(dim=2).to(torch.float32)
    return pend, broken


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
