"""The dissemination-tree overlay as a data-parallel lockstep state machine.

Port of the JAX package's ``ops/tree.py``, phase for phase: all N
simulated peers are rows of device-resident tensors, and one :func:`step`
advances the whole network synchronously (graceful Parts, the orphan
watchdog, concurrent admission and redirect, the data plane with its
write-failure detection, repair, and the subtree-size fixed point).  The
reference's documented deviations from the Go code are copied, not
fixed: real subtree sizes, full grandchild repair, rejoin at the root
instead of a panic, validated wire fanout params.

Differences of form, none of which changes a bit of state:

- ``jax.jit`` functions are eager functions of the state; the five
  host-triggered single-peer events take a host ``int`` peer.
- torch has no ``mode="drop"`` scatter, and on CUDA an out-of-range index
  is a device-side assert.  Every such scatter writes into a buffer with
  one pad cell past the end and slices it off (:func:`_scatter_drop`), so
  the row ``N`` / column ``W`` drop targets land in the pad.
- ``index_put_`` with duplicate indices is undefined on CUDA, and XLA's
  CPU scatter applies updates in order, so the last one wins.
  :func:`_drop_index` keeps only the last source of each cell, which
  makes every kept pair unique.  In the common case they are unique
  already (admissions by admit rank, out rings by row, child queues
  because a child has one parent).  Two cases repeat a cell: a child that
  two popping parents list (a stale row revived by a rejoin), and
  admissions above ~46,340 rows, where ``segment_rank``'s int32 composite
  key wraps in both packages and two joiners can share an admit rank.
- ``lax.fori_loop`` in the size fixed point is a Python loop; nothing in
  :func:`step` reads the device.

Messages are device-side ``int32`` ids; payload bytes stay host-side in
the engine (``api.py``).  ``root``, ``width``, ``max_width`` and
``step_num`` are 0-d int32 tensors, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import SimParams, TreeOpts
from ..models.gossipsub import resolve_device
from . import rng
from .graphs import nth_free_slot, safe_gather, segment_rank

NO_PEER = -1  # empty slot / no parent / no target
NO_MSG = -1
_I32_MAX = 2**31 - 1


class TreeState(NamedTuple):
    """Device-resident per-peer state of one topic tree (the reference's
    ``TreeState``, field for field).

    Shapes: N = max_peers, W = max_width, Q = queue_cap, OC = out_cap.
    """

    parent: torch.Tensor        # i32[N]  parent peer or NO_PEER
    children: torch.Tensor      # i32[N, W] child peers, NO_PEER = empty slot
    alive: torch.Tensor         # bool[N] process liveness
    joined: torch.Tensor        # bool[N] attached to the tree
    leaving: torch.Tensor       # bool[N] graceful Part requested
    join_target: torch.Tensor   # i32[N]  join/redirect candidate or NO_PEER
    join_prio: torch.Tensor     # bool[N] priority join (repair adoption)
    join_wait: torch.Tensor     # i32[N]  steps spent waiting to be (re)joined
    subtree_size: torch.Tensor  # i32[N]  peers in own subtree incl. self
    q: torch.Tensor             # i32[N, Q] inbound message ring
    q_when: torch.Tensor        # i32[N, Q] earliest step each entry may pop
    q_head: torch.Tensor        # i32[N]
    q_len: torch.Tensor         # i32[N]
    out: torch.Tensor           # i32[N, OC] delivered-message ring
    out_len: torch.Tensor       # i32[N]  total delivered (monotonic)
    out_drained: torch.Tensor   # i32[N]  host-consumed count
    edge_delay: torch.Tensor    # i32[N, W] extra steps on (parent, slot) edge
    edge_drop: torch.Tensor     # f32[N, W] per-copy drop probability
    key: torch.Tensor           # int32[2] threefry key (uint32 bit patterns)
    root: torch.Tensor          # i32[]   topic root peer
    width: torch.Tensor         # i32[]   steady-state fanout (TreeWidth)
    max_width: torch.Tensor     # i32[]   priority fanout (TreeMaxWidth)
    step_num: torch.Tensor      # i32[]


# Field-name classification for the peer-dimension parallel path (the
# reference's, kept so the sharded port finds it).
TREE_REPLICATED_FIELDS = frozenset(
    {"key", "root", "width", "max_width", "step_num"}
)
TREE_PEER_DIMS = {
    name: 0
    for name in (
        "parent", "children", "alive", "joined", "leaving", "join_target",
        "join_prio", "join_wait", "subtree_size", "q", "q_when", "q_head",
        "q_len", "out", "out_len", "out_drained", "edge_delay", "edge_drop",
    )
}


def init_state(
    params: SimParams, opts: TreeOpts, root: int = 0, seed: int = 0,
    device="cuda",
) -> TreeState:
    """A fresh tree holding only its root, on ``device`` (the card by
    default; raises without one)."""
    if params.max_width < opts.tree_max_width:
        raise ValueError(
            f"SimParams.max_width ({params.max_width}) must be >= "
            f"TreeOpts.tree_max_width ({opts.tree_max_width})"
        )
    dev = resolve_device(device)
    n, w = params.max_peers, params.max_width
    i32 = torch.int32

    def full(shape, value, dtype=i32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def scalar(value):
        return torch.tensor(value, dtype=i32, device=dev)

    alive = full((n,), False, torch.bool)
    alive[root].fill_(True)
    size = full((n,), 0)
    size[root].fill_(1)
    return TreeState(
        parent=full((n,), NO_PEER),
        children=full((n, w), NO_PEER),
        alive=alive,
        joined=alive.clone(),
        leaving=full((n,), False, torch.bool),
        join_target=full((n,), NO_PEER),
        join_prio=full((n,), False, torch.bool),
        join_wait=full((n,), 0),
        subtree_size=size,
        q=full((n, params.queue_cap), NO_MSG),
        q_when=full((n, params.queue_cap), 0),
        q_head=full((n,), 0),
        q_len=full((n,), 0),
        out=full((n, params.out_cap), NO_MSG),
        out_len=full((n,), 0),
        out_drained=full((n,), 0),
        edge_delay=full((n, w), 0),
        edge_drop=full((n, w), 0.0, torch.float32),
        key=rng.PRNGKey(seed, device=dev),
        root=scalar(root),
        width=scalar(opts.tree_width),
        max_width=scalar(opts.tree_max_width),
        step_num=scalar(0),
    )


# ---------------------------------------------------------------------------
# drop-mode scatters
# ---------------------------------------------------------------------------


def _drop_index(shape, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Flat indices of (rows, cols) into ``shape`` for ``_scatter_drop``:
    pairs outside it (the reference's ``mode="drop"``; every index here is
    non-negative, so JAX's negative wraparound never applies) and every
    source but the last one of a repeated cell map to the pad index
    ``n * w``."""
    n, w = shape
    pad = n * w
    keep = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < w)
    flat = torch.where(keep, rows.long() * w + cols.long(), pad)
    src = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((pad + 1,), -1, dtype=torch.int64, device=flat.device)
    last.scatter_reduce_(0, flat, src, reduce="amax")
    return torch.where(last[flat] == src, flat, pad)


def _scatter_drop(buf: torch.Tensor, flat: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``vals`` written at the ``_drop_index`` indices (the pad
    cell ``buf.numel()`` is sliced off)."""
    ext = torch.cat([buf.reshape(-1), buf.new_empty(1)])
    ext.index_put_((flat,), vals.to(buf.dtype).expand(flat.shape))
    return ext[:-1].reshape(buf.shape)


def _at(t: torch.Tensor, peer: torch.Tensor) -> torch.Tensor:
    """``t[peer]`` for a 0-d device index, as a [1] tensor (indexing with a
    0-d tensor would read it to the host)."""
    return t.index_select(0, peer.reshape(1).long())


def _set_at(t: torch.Tensor, peer: torch.Tensor, value) -> torch.Tensor:
    """``t.at[peer].set(value)`` for a 0-d device index."""
    hit = torch.arange(t.shape[0], device=t.device) == peer
    return torch.where(hit, value, t)


# ---------------------------------------------------------------------------
# host-triggered events
# ---------------------------------------------------------------------------


def begin_subscribe(st: TreeState, peer: int) -> TreeState:
    """Peer dials the root and starts the join walk (client.go:65-94); the
    walk advances one redirect hop per :func:`step`.  Element stores of
    Python scalars go through ``fill_`` (no host-to-device copy)."""
    peer = int(peer)
    alive, jt = st.alive.clone(), st.join_target.clone()
    prio, wait = st.join_prio.clone(), st.join_wait.clone()
    alive[peer].fill_(True)
    jt[peer] = st.root
    prio[peer].fill_(False)
    wait[peer].fill_(0)
    return st._replace(alive=alive, join_target=jt, join_prio=prio,
                       join_wait=wait)


def begin_subscribe_many(st: TreeState, peers_mask) -> TreeState:
    """Start the join walk for every masked peer at once; phase B
    serializes concurrent joiners by segment rank."""
    peers_mask = torch.as_tensor(peers_mask, device=st.alive.device).to(
        torch.bool)
    new = peers_mask & ~st.joined
    return st._replace(
        alive=st.alive | peers_mask,
        join_target=torch.where(new, st.root, st.join_target),
        join_prio=torch.where(new, False, st.join_prio),
        join_wait=torch.where(new, 0, st.join_wait),
    )


def set_link_profile(st: TreeState, delay, drop_prob) -> TreeState:
    """Install per-edge latency (i32[N, W] extra rounds) and drop
    probability (f32[N, W]) tensors, addressed by the parent's child slot."""
    dev = st.alive.device
    return st._replace(
        edge_delay=torch.as_tensor(delay, device=dev).to(torch.int32),
        edge_drop=torch.as_tensor(drop_prob, device=dev).to(torch.float32),
    )


def publish_many(st: TreeState, msg_ids) -> TreeState:
    """Enqueue a batch of messages at the root (ids >= 0; NO_MSG entries
    skipped).  Caller is responsible for queue capacity."""
    dev = st.alive.device
    msg_ids = torch.as_tensor(msg_ids, device=dev).to(torch.int32)
    r = st.root
    n, qcap = st.q.shape
    valid = msg_ids >= 0
    offsets = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    tails = (_at(st.q_head, r) + _at(st.q_len, r) + offsets) % qcap
    rows = torch.where(valid, r, n)
    flat = _drop_index(st.q.shape, rows, tails)
    return st._replace(
        q=_scatter_drop(st.q, flat, msg_ids),
        q_when=_scatter_drop(st.q_when, flat, st.step_num),
        q_len=_set_at(st.q_len, r, _at(st.q_len, r)
                      + valid.sum(dtype=torch.int32)),
    )


def kill_peer(st: TreeState, peer: int) -> TreeState:
    """Abrupt death -- no Part is sent; detection happens at the next
    forward attempt (``subtree.go:333-336``)."""
    alive = st.alive.clone()
    alive[int(peer)].fill_(False)
    return st._replace(alive=alive)


def leave_peer(st: TreeState, peer: int) -> TreeState:
    """Graceful leave -- Part to parent next step (``subtree.go:78-98``)."""
    leaving = st.leaving.clone()
    leaving[int(peer)].fill_(True)
    return st._replace(leaving=leaving)


def publish(st: TreeState, msg_id: int) -> TreeState:
    """Root-side ``PublishMessage`` (``pubsub.go:111-120``): enqueue at the
    root, whose queue feeds phase C; the root never delivers to itself."""
    r = st.root
    n, qcap = st.q.shape
    tail = (_at(st.q_head, r) + _at(st.q_len, r)) % qcap
    flat = r.long() * qcap + tail.long()
    msg = torch.full((1,), int(msg_id), dtype=torch.int32, device=r.device)
    return st._replace(
        q=_scatter_drop(st.q, flat, msg),
        q_when=_scatter_drop(st.q_when, flat, st.step_num),
        q_len=_set_at(st.q_len, r, _at(st.q_len, r) + 1),
    )


def drain_out(st: TreeState, peer: int):
    """Host reads a subscriber's delivered-message ring (client.Messages()).

    Returns (new_state, msgs i32[OC], count): ``msgs[:count]`` are the ids
    delivered since the last drain, oldest first.  Draining releases
    backpressure (``client.go:124-127``)."""
    peer = int(peer)
    oc = st.out.shape[1]
    start = st.out_drained[peer]
    count = st.out_len[peer] - start
    ar = torch.arange(oc, dtype=torch.int32, device=st.out.device)
    idx = (start + ar) % oc
    msgs = torch.where(ar < count, st.out[peer][idx.long()], NO_MSG)
    drained = st.out_drained.clone()
    drained[peer] = st.out_len[peer]
    return st._replace(out_drained=drained), msgs, count


# ---------------------------------------------------------------------------
# the lockstep transition
# ---------------------------------------------------------------------------


def _gather_rows(arr: torch.Tensor, children: torch.Tensor, fill):
    """``safe_gather(arr, children.reshape(-1), fill).reshape(N, W)``."""
    return safe_gather(arr, children.reshape(-1), fill).reshape(
        children.shape)


def _phase_part(st: TreeState) -> TreeState:
    """Graceful leaves: Part to parent, parent re-adopts *all* grandchildren
    with priority (``subtree.go:62-98``, ``:356-375``; §2.4.4 fixed)."""
    n = st.parent.shape[0]
    ids = torch.arange(n, device=st.parent.device)
    leaver = st.leaving & st.alive & st.joined & (ids != st.root)

    ch_is_leaver = _gather_rows(leaver, st.children, False)
    children = torch.where(ch_is_leaver, NO_PEER, st.children)

    parent_is_leaver = safe_gather(leaver, st.parent, False)
    orphan = st.joined & st.alive & parent_is_leaver
    grandp = safe_gather(st.parent, st.parent, NO_PEER)
    grandp = torch.where(grandp >= 0, grandp, st.root)
    join_target = torch.where(orphan, grandp, st.join_target)
    join_prio = torch.where(orphan, True, st.join_prio)
    join_wait = torch.where(orphan, 0, st.join_wait)
    parent = torch.where(orphan, NO_PEER, st.parent)

    parent = torch.where(leaver, NO_PEER, parent)
    children = torch.where(leaver[:, None], NO_PEER, children)
    return st._replace(
        parent=parent,
        children=children,
        alive=st.alive & ~leaver,
        joined=st.joined & ~leaver,
        leaving=torch.zeros_like(st.leaving),
        join_target=join_target,
        join_prio=join_prio,
        join_wait=join_wait,
    )


def _phase_watchdog(st: TreeState, timeout_steps: int) -> TreeState:
    """Orphan pause/timeout (``client.go:105-122``): past ``timeout_steps``
    an orphan or a stuck joiner rejoins at the root."""
    n = st.parent.shape[0]
    is_root = torch.arange(n, device=st.parent.device) == st.root
    parent_ok = safe_gather(st.alive & st.joined, st.parent, False)
    orphan = (st.joined & st.alive & ~is_root
              & ((st.parent < 0) | ~parent_ok) & (st.join_target < 0))
    waiting = orphan | (st.join_target >= 0)
    join_wait = torch.where(waiting, st.join_wait + 1, 0)
    timed_out = waiting & (join_wait > timeout_steps)
    return st._replace(
        join_wait=torch.where(timed_out, 0, join_wait),
        join_target=torch.where(timed_out, st.root, st.join_target),
        join_prio=torch.where(timed_out, False, st.join_prio),
    )


def _phase_join(st: TreeState) -> TreeState:
    """Concurrent admission/redirect: ``handleJoin`` + ``redirectJoin``,
    concurrent joiners at one target ordered by segment rank."""
    n, w = st.children.shape
    dev = st.children.device
    joiner = (st.join_target >= 0) & st.alive

    t_ok = safe_gather(st.alive & st.joined, st.join_target, False)
    target = torch.where(joiner & ~t_ok, st.root, st.join_target)

    n_children = (st.children >= 0).sum(dim=1, dtype=torch.int32)
    cap_w = torch.where(st.join_prio, st.max_width, st.width)
    capacity = torch.clamp(cap_w - safe_gather(n_children, target, 0), min=0)

    rank = segment_rank(target, joiner)
    admitted = joiner & (rank < capacity)

    # Admissions fill the target's free slots in admit-rank order: distinct
    # ranks at one target give distinct slots, so the kept pairs are unique.
    admit_rank = segment_rank(target, admitted)
    used = st.children >= 0
    target_c = torch.clamp(target, 0, n - 1)
    target_used = safe_gather(used, target_c, True)
    slots = nth_free_slot(target_used, admit_rank)
    scatter_t = torch.where(admitted, target, n)
    scatter_s = torch.where(admitted, slots, w)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    children = _scatter_drop(
        st.children, _drop_index((n, w), scatter_t, scatter_s), ids)
    parent = torch.where(admitted, target, st.parent)
    joined = st.joined | admitted
    join_target = torch.where(admitted, NO_PEER, target)
    join_prio = torch.where(admitted, False, st.join_prio)
    join_wait = torch.where(admitted, 0, st.join_wait)

    # Redirects hop to a live child of the target, round-robin by redirect
    # rank over its children in (size, slot) order.
    redirected = joiner & ~admitted
    redir_rank = segment_rank(target, redirected)
    t_children = st.children[target_c.long()]
    t_ch_live = _gather_rows(st.alive & st.joined, t_children, False)
    t_ch_live &= t_children >= 0
    t_ch_size = _gather_rows(st.subtree_size, t_children, 0)
    has_live_child = t_ch_live.any(dim=1)
    n_live = t_ch_live.sum(dim=1, dtype=torch.int32)
    sort_key = torch.where(t_ch_live, t_ch_size, _I32_MAX)
    slot_order = torch.argsort(sort_key, dim=1, stable=True)
    pick = redir_rank % torch.clamp(n_live, min=1)
    chosen_slot = slot_order.gather(1, pick.long()[:, None])
    redir_to = t_children.gather(1, chosen_slot)[:, 0]
    join_target = torch.where(redirected & has_live_child, redir_to,
                              join_target)

    return st._replace(
        parent=parent,
        children=children,
        joined=joined,
        join_target=join_target,
        join_prio=join_prio,
        join_wait=join_wait,
    )


def _phase_data(st: TreeState):
    """Data plane: pop one message per peer, deliver, fan out to children
    (``client.go:100-132``), backpressured by the out ring and every live
    child queue; writes to dead children are dropped and flagged
    (``subtree.go:333-336``).  A forwarded copy is poppable at ``now + 1 +
    edge_delay`` and silently lost with probability ``edge_drop``.

    Returns (state, dead_detect bool[N, W])."""
    n, w = st.children.shape
    qcap = st.q.shape[1]
    oc = st.out.shape[1]
    dev = st.children.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    is_root = ids == st.root

    ch_ok = _gather_rows(st.alive & st.joined, st.children, False)
    ch_ok &= st.children >= 0
    ch_qlen = _gather_rows(st.q_len, st.children, 0)
    child_room = torch.where(ch_ok, ch_qlen < qcap, True).all(dim=1)
    out_room = is_root | ((st.out_len - st.out_drained) < oc)

    head = (st.q_head % qcap).long()[:, None]
    head_ready = st.q_when.gather(1, head)[:, 0] <= st.step_num
    popper = (
        st.alive & st.joined & (st.q_len > 0) & head_ready
        & out_room & child_room
    )
    msg = st.q.gather(1, head)[:, 0]
    q_head = torch.where(popper, (st.q_head + 1) % qcap, st.q_head)
    q_len = torch.where(popper, st.q_len - 1, st.q_len)

    # Deliver (non-root): append to the out ring, one row each.
    deliver = popper & ~is_root
    out = _scatter_drop(
        st.out,
        _drop_index(st.out.shape, torch.where(deliver, ids, n),
                   st.out_len % oc),
        msg)
    out_len = torch.where(deliver, st.out_len + 1, st.out_len)

    # Forward into each live child's queue tail.
    key, kdrop = rng.split(st.key, 2).unbind(0)
    lost = rng.uniform(kdrop, (n, w)) < st.edge_drop
    fwd = popper[:, None] & (st.children >= 0)
    fwd_live = fwd & ch_ok & ~lost
    cidx = torch.where(fwd_live, st.children, n).reshape(-1)
    ctail = (safe_gather(q_head, cidx, 0) + safe_gather(q_len, cidx, 0)) % qcap
    flat = _drop_index(st.q.shape, cidx, ctail)
    q = _scatter_drop(st.q, flat, msg.repeat_interleave(w))
    arrive = (st.step_num + 1 + st.edge_delay).reshape(-1)
    q_when = _scatter_drop(st.q_when, flat, arrive)
    q_len = torch.cat([q_len, q_len.new_zeros(1)]).index_add_(
        0, cidx.long(), (cidx < n).to(torch.int32))[:n]

    dead_detect = fwd & ~ch_ok
    return (
        st._replace(
            q=q, q_when=q_when, q_head=q_head, q_len=q_len, out=out,
            out_len=out_len, key=key,
        ),
        dead_detect,
    )


def _phase_repair(st: TreeState, dead_detect: torch.Tensor) -> TreeState:
    """Write-failure repair (``subtree.go:342-350, 356-375``): the detecting
    parent drops the dead child and adopts *all* its children with
    priority joins; orphan rows keep their children and backlog."""
    n, w = st.children.shape
    dead_ids = torch.where(dead_detect, st.children, n).reshape(-1)
    dead_set = torch.zeros(n + 1, dtype=torch.bool, device=st.children.device)
    dead_set = dead_set.index_fill_(0, dead_ids.long(), True)
    dead_set = dead_set[:n] & ~(st.alive & st.joined)

    parent_dead = safe_gather(dead_set, st.parent, False)
    orphan = st.joined & st.alive & parent_dead
    adopter = safe_gather(st.parent, st.parent, NO_PEER)
    adopter = torch.where(adopter >= 0, adopter, st.root)
    join_target = torch.where(orphan, adopter, st.join_target)
    join_prio = torch.where(orphan, True, st.join_prio)
    join_wait = torch.where(orphan, 0, st.join_wait)
    parent = torch.where(orphan, NO_PEER, st.parent)

    ch_dead = _gather_rows(dead_set, st.children, False)
    children = torch.where(ch_dead, NO_PEER, st.children)
    children = torch.where(dead_set[:, None], NO_PEER, children)
    parent = torch.where(dead_set, NO_PEER, parent)
    return st._replace(
        parent=parent,
        children=children,
        joined=st.joined & ~dead_set,
        join_target=join_target,
        join_prio=join_prio,
        join_wait=join_wait,
    )


def _phase_sizes(st: TreeState, iters: int) -> TreeState:
    """Recompute subtree sizes bottom-up (``iters`` rounds of the fixed
    point; real sizes, §2.4.3 fixed)."""
    member = st.alive & st.joined
    has_child = st.children >= 0
    sizes = member.to(torch.int32)
    for _ in range(iters):
        ch = torch.where(has_child, _gather_rows(sizes, st.children, 0), 0)
        sizes = torch.where(member, 1 + ch.sum(dim=1, dtype=torch.int32), 0)
    return st._replace(subtree_size=sizes.to(torch.int32))


def default_size_iters(n: int) -> int:
    """The fixed point's rounds for ``n`` rows: ``ceil(log2 n) + 1``, at
    least 2 (the reference's ``size_iters=0`` default)."""
    return max(2, int(math.ceil(math.log2(max(2, n)))) + 1)


def step(st: TreeState, size_iters: int = 0,
         repair_timeout_steps: int = 64) -> TreeState:
    """One lockstep transition of the whole network, in the reference's
    phase order: graceful Parts, watchdog, join/redirect, data with
    write-failure detection, repair, subtree sizes."""
    if size_iters <= 0:
        size_iters = default_size_iters(st.parent.shape[0])
    st = _phase_part(st)
    st = _phase_watchdog(st, repair_timeout_steps)
    st = _phase_join(st)
    st, dead_detect = _phase_data(st)
    st = _phase_repair(st, dead_detect)
    st = _phase_sizes(st, size_iters)
    return st._replace(step_num=st.step_num + 1)


def run_steps(st: TreeState, n_steps: int, size_iters: int = 0,
              repair_timeout_steps: int = 64) -> TreeState:
    """Advance ``n_steps`` lockstep rounds (no host sync inside)."""
    for _ in range(n_steps):
        st = step(st, size_iters, repair_timeout_steps)
    return st

