"""Topology-aware peer placement for the sharded rollout.

A numpy copy of the JAX package's ``parallel/placement.py`` (framework-free
there too; the port cannot import it, ``go_libp2p_pubsub_tpu/__init__``
imports JAX).  ``tests/test_torch_placement.py`` pins every function below
to its original, line for line after this docstring and the import.

The 1-D peer-dim sharding assigns peers to ranks by id order, so with the
default random relabeling every mesh edge is cross-shard with probability
(1 - 1/n_shards) and the propagate/gossip row gathers become almost
entirely traffic between ranks.  GossipSub meshes carry locality in
practice; this module recovers it host-side at init: partition the
connection graph into rank-sized blocks by greedy frontier BFS, renumber
peers so block b occupies the contiguous id range of shard b, and carry
the permutation so results relabel back exactly (the model's ``peer_uid``
keys every per-peer draw on canonical identity).

Conventions:

- ``perm`` i64[N] maps NEW (physical) id -> OLD (canonical) id: physical row
  ``i`` of the relabeled state is canonical peer ``perm[i]``.
- ``inv`` i64[N] is the inverse: canonical peer ``o`` lives at physical row
  ``inv[o]``.  Canonical-order views of a physical per-peer array ``x`` are
  ``x[inv]``.
- Shard of physical id ``i`` is ``i // (n // n_shards)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.graphs import decode_index_plane, encode_index_plane


def _edge_list(nbrs: np.ndarray, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Directed (src, dst) arrays of the masked slots of a neighbor table.

    Accepts both the legacy signed (-1 invalid) and the narrow wrap-encoded
    storage form — the decode restores the sentinel before the sign test.
    """
    n, k = nbrs.shape
    nb = np.asarray(decode_index_plane(nbrs), np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), k).reshape(n, k)
    sel = mask & (nb >= 0)
    return src[sel], nb[sel]


def _csr(n: int, src: np.ndarray, dst: np.ndarray):
    """CSR adjacency (indptr, indices) from directed edge arrays."""
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    counts = np.bincount(src, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, indices


def partition_bfs(
    nbrs: np.ndarray,
    mask: np.ndarray,
    n_shards: int,
    start: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy BFS blocking of the connection graph -> (perm, inv).

    Visits peers in frontier-BFS order (restarting at the lowest unvisited id
    when a component exhausts) and fills shards with contiguous runs of that
    order: neighbors tend to be visited together, so a graph with any cluster
    structure lands most of its edges inside one block.  The frontier
    expansion is vectorized per level (concatenate-adjacency + dedup), so the
    whole pass is O(E) NumPy — ~1 s at 100k peers, degree 16.

    On a structureless expander (the default random-pairing topology) BFS
    order is no better than random — measure with :func:`edge_cut` and report
    honestly rather than assuming a win.
    """
    n = nbrs.shape[0]
    if n % n_shards != 0:
        raise ValueError(f"n ({n}) must divide by n_shards ({n_shards})")
    src, dst = _edge_list(nbrs, mask)
    indptr, indices = _csr(n, src, dst)

    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    filled = 0
    frontier = np.array([start], np.int64)
    visited[start] = True
    while filled < n:
        if frontier.size == 0:
            nxt = int(np.argmin(visited))  # lowest unvisited id
            visited[nxt] = True
            frontier = np.array([nxt], np.int64)
        order[filled : filled + frontier.size] = frontier
        filled += frontier.size
        # Expand: all neighbors of the frontier, deduped, unvisited only.
        # Ragged-range enumeration keeps the level vectorized: element t of
        # the flat gather reads offset (t - level_start) into its row's
        # adjacency range.
        starts = indptr[frontier]
        lens = indptr[frontier + 1] - starts
        total = int(lens.sum())
        if total:
            row_base = np.repeat(np.cumsum(lens) - lens, lens)
            idx = np.repeat(starts, lens) + (np.arange(total) - row_base)
            cand = np.unique(indices[idx])
        else:
            cand = np.empty(0, np.int64)
        cand = cand[~visited[cand]]
        visited[cand] = True
        frontier = cand
    perm = order
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return perm, inv


def random_placement(
    n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniformly random renumbering -> (perm, inv); the edge-cut baseline a
    topology-aware placement is measured against."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return perm, inv


def relabel_topology(
    nbrs: np.ndarray,
    rev: np.ndarray,
    nbr_valid: np.ndarray,
    outbound: np.ndarray,
    perm: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Apply a renumbering to a slot-form topology.

    Physical row ``i`` takes canonical peer ``perm[i]``'s slots in their
    original order (slots are NOT permuted — every per-row, slot-indexed
    computation is untouched by the relabeling), with neighbor ids mapped
    into the new numbering.  Invalid slots (-1) stay -1; the slot-pairing
    invariant ``nbrs[nbrs[i, s], rev[i, s]] == i`` is preserved.

    The output keeps the input's storage form: a narrow wrap-encoded table
    relabels to the same narrow dtype (with range validation — no silent
    wrap), the legacy signed form stays signed.
    """
    n = nbrs.shape[0]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    old_rows = np.asarray(decode_index_plane(nbrs), np.int64)[perm]
    new_nbrs = np.where(old_rows >= 0, inv[np.clip(old_rows, 0, n - 1)], -1)
    return (
        encode_index_plane(new_nbrs, n, dtype=nbrs.dtype),
        rev[perm].copy(),
        nbr_valid[perm].copy(),
        outbound[perm].copy(),
    )


def edge_cut(
    nbrs: np.ndarray,
    mask: np.ndarray,
    n_shards: int,
    perm: Optional[np.ndarray] = None,
) -> Tuple[int, int]:
    """(cross_shard_edges, total_edges) of the masked graph under the shard
    assignment ``id // block`` — optionally after renumbering by ``perm``
    (without materializing the relabeled topology).  Directed slot count
    halved: each undirected edge appears on both endpoints' rows.
    """
    n = nbrs.shape[0]
    src, dst = _edge_list(nbrs, mask)
    if perm is not None:
        inv = np.empty(n, np.int64)
        inv[np.asarray(perm)] = np.arange(n, dtype=np.int64)
        src, dst = inv[src], inv[dst]
    block = n // n_shards
    cross = int(((src // block) != (dst // block)).sum())
    return cross // 2, int(len(src)) // 2


def placement_report(
    nbrs: np.ndarray,
    mask: np.ndarray,
    n_shards: int,
    perm: np.ndarray,
    seed: int = 0,
) -> dict:
    """Measured cross-shard edge-cut of ``perm`` vs a random placement on the
    same graph — the honesty numbers the bench's ``sharded`` section and
    PERF.md carry."""
    rperm, _ = random_placement(nbrs.shape[0], seed=seed)
    cut, total = edge_cut(nbrs, mask, n_shards, perm)
    rcut, _ = edge_cut(nbrs, mask, n_shards, rperm)
    return {
        "total_edges": total,
        "cross_shard_edges": cut,
        "cross_shard_edges_random": rcut,
        "cut_frac": round(cut / max(total, 1), 4),
        "cut_frac_random": round(rcut / max(total, 1), 4),
        "cut_reduction_vs_random": round(1.0 - cut / max(rcut, 1), 4),
        "n_shards": n_shards,
    }
