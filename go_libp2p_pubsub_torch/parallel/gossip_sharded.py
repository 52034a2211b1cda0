"""The sharded GossipSub rollout over ``torch.distributed``.

Port of the JAX package's ``parallel/gossip_sharded.py`` (BASELINE.json
config (e), "100k-peer ICI-sharded epidemic sim").  There the peer
dimension of ``GossipState`` is sharded over a device mesh and GSPMD
partitions the jitted step.  Here one process runs each rank (SPMD): the
model (``models.gossipsub.GossipSub(mesh=...)``) keeps the rank's block
of every peer-dim leaf and reads across ranks through the
``parallel.mesh.PeerMesh``; K1 and K2 run on the block through their
sharded wrappers (``ops.cuda_gossip.propagate_sharded`` /
``exchange_select_sharded``).

``GossipState`` mixes peer-dim arrays ([N, ...]: adjacency, windows,
scores) with message-window arrays ([M] metadata) and scalars.  The
classification (beside ``GossipState`` in ``models/gossipsub.py``) names
BOTH sets exhaustively and by NAME (never by
shape: ``msg_window == n_peers`` must not shard the metadata), so an
unclassified new field is an error.

:class:`ShardedGossipSub` takes CANONICAL peer ids at its API (publish
sources, kill masks) and renumbers peers at init under a placement
(``"bfs"``: blocks of the connection graph land on one rank; ``"random"``:
the edge-cut baseline); the rollout is the unplaced one under the inverse
permutation, because the model's ``peer_uid`` keys every draw on canonical
identity.  :func:`run_plan` is one rank's scripted run of it, for
``parallel.mesh.run_ranks``.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..models.gossipsub import (
    _PEER_DIM_FIELDS, _REPLICATED_FIELDS, GOSSIP_PEER_DIMS, GossipState,
    GossipSub, build_topology, build_topology_fast,
)
from ..ops import cuda_gossip
from .mesh import PeerMesh, make_mesh, state_blocks
from .placement import (
    partition_bfs, placement_report, random_placement, relabel_topology,
)

# Leaves that hold physical peer ids (mapped back through ``perm`` in
# canonical views).
ID_FIELDS = ("nbrs",)


def gossip_state_shardings(st: GossipState, n_peers: int, world: int
                           ) -> Dict[str, Optional[int]]:
    """Per ``GossipState`` field: 0 (its leading dim is the peer dim and
    shards) or None (replicated).  Validates that the classification
    (``models.gossipsub._PEER_DIM_FIELDS`` / ``_REPLICATED_FIELDS``) is
    exhaustive (an unclassified field is an error) and that every
    peer-dim leaf has leading dim ``n_peers``, divisible by ``world``."""
    if n_peers % world != 0:
        raise ValueError(
            f"n_peers ({n_peers}) must divide by mesh axis size ({world})")
    unclassified = set(st._fields) - _PEER_DIM_FIELDS - _REPLICATED_FIELDS
    if unclassified:
        raise ValueError(
            f"GossipState fields without a sharding rule: "
            f"{sorted(unclassified)}; classify them in models/gossipsub.py")
    return state_blocks(st, n_peers, world, replicated=_REPLICATED_FIELDS,
                        peer_dim={f: 0 for f in _PEER_DIM_FIELDS})


class ShardedGossipSub:
    """A ``GossipSub`` whose state is split into row blocks over the ranks
    of a ``PeerMesh`` (one process a rank).

    Usage, on every rank::

        sg = ShardedGossipSub(n_peers=204800, mesh=make_mesh(204800, dev),
                              placement="bfs", split_gather=True)
        st = sg.init(seed=0)            # this rank's block
        st = sg.publish(st, src, slot, valid)   # canonical src
        st, rec = sg.rollout(st, 48)
    """

    def __init__(
        self,
        n_peers: int,
        mesh: PeerMesh,
        placement: Optional[str] = None,
        split_gather: bool = False,
        **gossip_kwargs,
    ):
        # placement: None keeps id-order peer assignment; "bfs" renumbers
        # peers at init so most mesh edges land on one rank; "random" is
        # the edge-cut baseline.  Either way the rollout is the unplaced
        # model's under the inverse permutation (``self.inv``).
        #
        # split_gather: the row gathers take the ring
        # (``ops.gossip_packed.ring_gather_rows``) instead of an all-gather;
        # it selects the mesh view the model reads (``PeerMesh.ring``).
        if placement not in (None, "bfs", "random"):
            raise ValueError(f"unknown placement: {placement!r}")
        if n_peers % mesh.world != 0:
            raise ValueError(
                f"n_peers ({n_peers}) must divide by device count "
                f"({mesh.world})")
        self.mesh = mesh.using_ring(split_gather)
        self.placement = placement
        self._n = n_peers
        self._gossip_kwargs = dict(gossip_kwargs)
        self.perm: Optional[np.ndarray] = None
        self.inv: Optional[np.ndarray] = None
        self.placement_report: Optional[dict] = None
        self.n_devices = mesh.world
        self.model = self._make_model(builder=gossip_kwargs.get("builder"))

    @property
    def split_gather(self) -> bool:
        return self.mesh.ring

    def _make_model(self, builder, peer_uid=None) -> GossipSub:
        kw = dict(self._gossip_kwargs)
        kw["builder"] = builder
        return GossipSub(n_peers=self._n, mesh=self.mesh, peer_uid=peer_uid,
                         device=self.mesh.device, **kw)

    # -- state placement ----------------------------------------------------

    def _apply_placement(self, seed: int) -> None:
        """Build the canonical graph host-side, compute the renumbering, and
        swap in a model pinned to the relabeled topology + ``peer_uid``."""
        m = self.model
        base = self._gossip_kwargs.get("builder") or (
            build_topology if m.n <= 4096 else build_topology_fast)
        rng = np.random.default_rng(seed)
        nbrs, rev, valid, outbound = (
            np.asarray(a) for a in base(rng, m.n, m.k, m.conn_degree))
        if self.placement == "bfs":
            perm, inv = partition_bfs(nbrs, valid, self.n_devices)
        else:
            perm, inv = random_placement(m.n, seed=seed)
        self.perm, self.inv = perm, inv
        self.placement_report = placement_report(
            nbrs, valid, self.n_devices, perm, seed=seed)
        rtopo = relabel_topology(nbrs, rev, valid, outbound, perm)
        self.model = self._make_model(
            builder=lambda _rng, _n, _k, _d: rtopo, peer_uid=perm)

    def to_physical(self, canonical_ids):
        """Canonical peer id(s) -> physical row(s) under the placement."""
        if self.inv is None:
            return canonical_ids
        return np.asarray(self.inv)[np.asarray(canonical_ids)]

    def to_canonical(self, x):
        """Canonical-order view of a physical per-peer array (leading dim N,
        the whole array)."""
        if self.inv is None:
            return x
        return x[np.asarray(self.inv)]

    def init(self, seed: int = 0) -> GossipState:
        if self.placement is not None:
            self._apply_placement(seed)
        return self.model.init(seed)

    # -- the rollout (every rank calls each of these) -------------------------

    def publish(self, st, src, slot, valid) -> GossipState:
        # ``src`` is a CANONICAL id; under a placement the publisher lives
        # at physical row inv[src].
        return self.model.publish(st, int(self.to_physical(int(src))),
                                  int(slot), valid)

    def step(self, st: GossipState) -> GossipState:
        return self.model.step(st)

    def run(self, st: GossipState, n_steps: int) -> GossipState:
        return self.model.rollout(st, n_steps, record=False)[0]

    def kill_peers(self, st, mask) -> GossipState:
        # ``mask`` indexes canonical peers; physical row i is canonical
        # peer perm[i], so the physical mask is mask[perm].
        mask = np.asarray(mask, bool)
        if self.perm is not None:
            mask = mask[np.asarray(self.perm)]
        return self.model.kill_peers(st, mask)

    def rollout(self, st: GossipState, n_steps: int, record: bool = True):
        """Recorded rollout -> (final state, flight record | None).  The
        flight-record channels are placement-invariant (per-round sums,
        extrema and histograms over all peers), the same on every rank."""
        return self.model.rollout(st, n_steps, record)

    def delivery_stats(self, st: GossipState):
        return self.model.delivery_stats(st)

    # -- whole-state views (collectives: every rank calls them) ---------------

    def gather_state(self, st: GossipState) -> Dict[str, np.ndarray]:
        """The whole physical state as host numpy, by dotted leaf name."""
        return self.mesh.gather_canonical(st, GOSSIP_PEER_DIMS)

    def gather_canonical(self, st: GossipState) -> Dict[str, np.ndarray]:
        """The whole state in canonical order (rows at ``inv``, neighbor
        ids through ``perm``) as host numpy, by dotted leaf name."""
        return self.mesh.gather_canonical(
            st, GOSSIP_PEER_DIMS, inv=self.inv, perm=self.perm,
            id_fields=ID_FIELDS)


def digest(leaves: Dict[str, np.ndarray]) -> Dict[str, str]:
    """sha256 of each leaf's dtype, shape and bytes (whole-state checks
    between runs that need not ship the state)."""
    out = {}
    for name, a in leaves.items():
        a = np.ascontiguousarray(a)
        h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
        out[name] = h.hexdigest()
    return out


def run_plan(device, plan: dict, group=None) -> dict:
    """One rank's scripted run of a :class:`ShardedGossipSub` (for
    ``parallel.mesh.run_ranks``; ``plan`` pickles: numbers, lists, numpy).

    Plan keys: ``n_peers``; ``model`` (GossipSub keyword arguments);
    ``topology`` (the four arrays a builder returns); ``placement``;
    ``split_gather``; ``seed``; ``publishes`` ([(canonical src, slot,
    valid)]); ``steps`` (a recorded rollout); ``kill`` (canonical ids
    killed after it).  ``group`` is the process group (the default group
    when None).

    Returns, on every rank: ``perm``, ``placement_report``, ``record`` and
    ``stats`` (frac, p50, p99) as host numpy, ``state`` (the whole
    physical state), ``alive_after_kill`` (the whole physical mask),
    ``wrappers`` (the two sharded wrappers held against the unsharded
    plain functions on the final state's gathered inputs), ``launches``
    (this rank's K1/K2 launches in the rollout), ``staged`` and
    ``rollout_s``."""
    import time

    topo = tuple(np.asarray(a) for a in plan["topology"])
    pm = make_mesh(plan["n_peers"], device=device, group=group)
    sg = ShardedGossipSub(
        plan["n_peers"], pm, placement=plan["placement"],
        split_gather=plan["split_gather"],
        builder=lambda _rng, _n, _k, _d: topo, **plan["model"])
    st = sg.init(plan["seed"])
    for src, slot, valid in plan["publishes"]:
        st = sg.publish(st, src, slot, bool(valid))
    cuda_gossip.reset_launches()
    if pm.device.type == "cuda":
        torch.cuda.synchronize(pm.device)
    t0 = time.perf_counter()
    st, rec = sg.rollout(st, plan["steps"], record=True)
    if pm.device.type == "cuda":
        torch.cuda.synchronize(pm.device)
    mask = np.zeros(plan["n_peers"], bool)
    mask[list(plan["kill"])] = True
    return {
        "rollout_s": time.perf_counter() - t0,
        "launches": {"gossip_propagate": cuda_gossip.propagate.launches,
                     "gossip_exchange": cuda_gossip.exchange_select.launches},
        "perm": sg.perm,
        "placement_report": sg.placement_report,
        "record": {name: v.cpu().numpy() for name, v in rec.items()},
        "stats": tuple(x.cpu().numpy() for x in sg.delivery_stats(st)),
        "state": sg.gather_state(st),
        "wrappers": _check_wrappers(sg, st),
        "alive_after_kill": pm.all_gather_rows(
            sg.kill_peers(st, mask).alive).cpu().numpy(),
        "staged": dict(pm.staged),
    }


def _check_wrappers(sg: ShardedGossipSub, st: GossipState) -> Dict[str, bool]:
    """Hold ``propagate_sharded`` and ``exchange_select_sharded`` (their
    plain versions off a card) against the unsharded plain functions on
    this state's gathered inputs: the rank's block of the unsharded
    result must equal the sharded wrapper's, leaf for leaf."""
    from ..ops import bitpack, gossip_packed
    from ..ops.graphs import decode_index_plane

    pm = sg.model.peer_mesh
    m = sg.model
    wide = m._widen_indices(st)
    whole = lambda x: pm.all_gather_rows(x)  # noqa: E731
    valid_w = bitpack.pack(st.msg_valid & st.msg_active)
    relay = wide.mesh & (wide.scores >= 0.0)
    got = cuda_gossip.propagate_sharded(
        pm, relay, wide.nbrs, wide.edge_live, wide.alive, wide.have_w,
        wide.fresh_w, valid_w)
    ref = gossip_packed.propagate_packed(
        whole(relay), whole(wide.nbrs), whole(wide.edge_live),
        whole(wide.alive), whole(wide.have_w), whole(wide.fresh_w), valid_w)
    k1 = all(torch.equal(pm.local(r.cpu()), g.cpu())
             for r, g in zip(ref, got))
    # K2 on the block's own exchange inputs (a heartbeat's prep).
    gen = torch.Generator().manual_seed(pm.n)
    k, w = m.k, m.w
    jidx = torch.clamp(decode_index_plane(wide.nbrs), 0, pm.n - 1)
    rand = lambda p: (torch.rand((pm.n, k), generator=gen) < p)  # noqa: E731
    adv, acc, srv = (pm.local(rand(q)).to(pm.device) for q in (0.3, 0.9, 0.9))
    rows = wide.have_w
    dedup = pm.local(torch.randint(-2**31, 2**31 - 1, (pm.n, w),
                                   generator=gen, dtype=torch.int32)).to(
        pm.device) & rows
    got2 = cuda_gossip.exchange_select_sharded(
        pm, jidx.to(torch.int32), adv, acc, srv, rows, dedup, wide.alive,
        m.params.max_ihave_length, m.params.max_iwant_length)
    ref2 = gossip_packed.exchange_select(
        whole(jidx.to(torch.int32)), whole(adv), whole(acc), whole(srv),
        whole(rows), whole(dedup), whole(wide.alive),
        m.params.max_ihave_length, m.params.max_iwant_length)
    k2 = all(torch.equal(pm.local(r.cpu()), g.cpu())
             for r, g in zip(ref2, got2))
    return {"propagate_sharded": k1, "exchange_select_sharded": k2}

