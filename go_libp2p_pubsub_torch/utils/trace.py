"""Topology snapshot exports (the ``printTree`` analog), host side.

The tree and mesh exports of the JAX package's ``utils/trace.py``, reading
the port's tensors back to numpy.  ``StepTimer`` and the profiler hooks
are not ported here.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..ops.graphs import decode_index_plane


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def export_tree(st) -> Dict[int, Any]:
    """TreeState -> nested {peer: {child: {...}}} dict rooted at ``st.root``.

    Host-side, for debugging and golden-topology assertions; the recursive
    shape mirrors what ``printTree`` printed from private Go state.
    """
    parent = _host(st.parent)
    joined = _host(st.joined)
    root = int(st.root)
    kids: Dict[int, List[int]] = {}
    for p in range(parent.shape[0]):
        if joined[p] and parent[p] >= 0:
            kids.setdefault(int(parent[p]), []).append(p)

    # Iterative DFS: a width-1 chain is a legal topology, so depth can reach
    # N -- far past Python's recursion limit at sim scale.
    out: Dict[int, Any] = {root: {}}
    stack: List[tuple] = [(root, out[root])]
    visited = {root}
    while stack:
        node, slot = stack.pop()
        for c in kids.get(node, []):
            if c in visited:  # cycle -- never legal in a tree
                raise ValueError(f"cycle detected at peer {c}")
            visited.add(c)
            slot[c] = {}
            stack.append((c, slot[c]))
    return out


def tree_text(st) -> str:
    """Indented text rendering of ``export_tree`` (one peer per line)."""
    lines: List[str] = []
    stack: List[tuple] = [(node, 0, d) for node, d in
                          sorted(export_tree(st).items(), reverse=True)]
    while stack:
        node, depth, d = stack.pop()
        lines.append("  " * depth + str(node))
        stack.extend((c, depth + 1, d[c]) for c in sorted(d, reverse=True))
    return "\n".join(lines)


def export_mesh(st) -> Dict[int, List[int]]:
    """GossipState -> {peer: sorted mesh-neighbor ids} adjacency dict."""
    mesh = _host(st.mesh & st.nbr_valid)
    nbrs = _host(decode_index_plane(st.nbrs))
    alive = _host(st.alive)
    out: Dict[int, List[int]] = {}
    for p in range(mesh.shape[0]):
        if alive[p]:
            out[p] = sorted(int(nbrs[p, s]) for s in np.nonzero(mesh[p])[0])
    return out
