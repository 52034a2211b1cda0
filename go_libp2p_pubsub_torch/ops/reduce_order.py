"""A full f32 sum in the order the reference's XLA CPU backend adds it.

XLA's CPU pipeline rewrites a reduction over a dimension of 32 or more
elements into a tree (its tree-reduction rewriter, window 32): every
reduced dimension of size >= 32 is padded with zeros to a multiple of 32,
split evenly before and after, and cut into windows of 32; a reduced
dimension shorter than 32 is taken whole.  Each window is added
sequentially in row-major order from 0.0, the window sums form the next
level's array, and the rewrite repeats until no reduced dimension reaches
32, when the rest is added sequentially.

The port's flight record sums sparse masks this way (the adversary's
score means of ``GossipSub.rollout_events``): zeros add nothing to a
sequential f32 sum, so the sum of an array whose non-zero entries are
known (flat index and value) follows the same tree over those entries
alone.  Host numpy; checked against ``jnp.sum`` under ``jax.jit`` in the
tests.  :func:`xla_sum` takes the same tree over a dense tensor on its
device (the hybrid's mean loss estimate): one add per window position,
each across all the windows of a level at once.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

WINDOW = 32


def _run_sums(keys: np.ndarray, vals: np.ndarray):
    """Sequential f32 sums, each from 0.0, of the runs of equal ``keys``
    (sorted) -> (the keys, their sums).  The runs are added side by side,
    one position at a time; a shorter run's padding adds 0.0, which leaves
    a sum that starts at +0.0 as it was."""
    uniq, start, counts = np.unique(keys, return_index=True,
                                    return_counts=True)
    grid = np.zeros((uniq.size, counts.max(initial=0)), np.float32)
    grid[np.repeat(np.arange(uniq.size), counts),
         np.arange(keys.size) - np.repeat(start, counts)] = vals
    acc = np.zeros(uniq.size, np.float32)
    for col in grid.T:
        acc = acc + col
    return uniq, acc


def sparse_sum(shape: Sequence[int], flat_idx, vals) -> np.float32:
    """f32 sum of an array of ``shape`` that is zero except at the
    row-major ``flat_idx`` (distinct) where it holds ``vals``."""
    shape = tuple(int(d) for d in shape)
    idx = np.asarray(flat_idx, np.int64).reshape(-1)
    vals = np.asarray(vals, np.float32).reshape(-1)
    coords = np.stack(np.unravel_index(idx, shape), 1) if idx.size else (
        np.zeros((0, len(shape)), np.int64))
    while any(d >= WINDOW for d in shape):
        win, out_shape, pos = [], [], []
        for a, d in enumerate(shape):
            if d >= WINDOW:
                pad = -d % WINDOW
                win.append(WINDOW)
                out_shape.append((d + pad) // WINDOW)
                pos.append(coords[:, a] + pad // 2)
            else:
                win.append(d)
                out_shape.append(1)
                pos.append(coords[:, a])
        outer = np.stack([p // w for p, w in zip(pos, win)], 1)
        inner = np.stack([p % w for p, w in zip(pos, win)], 1)
        okey = np.ravel_multi_index(outer.T, out_shape) if idx.size else idx
        ikey = np.ravel_multi_index(inner.T, win) if idx.size else idx
        order = np.lexsort((ikey, okey))
        uniq, vals = _run_sums(okey[order], vals[order])
        shape = tuple(out_shape)
        coords = (np.stack(np.unravel_index(uniq, shape), 1) if uniq.size
                  else np.zeros((0, len(shape)), np.int64))
        idx = uniq
    order = np.argsort(
        np.ravel_multi_index(coords.T, shape) if idx.size else idx,
        kind="stable")
    total = _run_sums(np.zeros(idx.size, np.int64), vals[order])[1]
    return total[0] if total.size else np.float32(0.0)


def masked_mean(shape: Sequence[int], flat_idx, vals, count: int):
    """``GossipSub.masked_mean`` of the reference from the mask's entries:
    the XLA-ordered sum over ``count`` (f32 division), NaN when empty."""
    if count <= 0:
        return np.float32(np.nan)
    return np.float32(sparse_sum(shape, flat_idx, vals) / np.float32(count))


def _seq_cols(x: torch.Tensor) -> torch.Tensor:
    """Sequential f32 sums from 0.0 of the rows of ``x`` [R, C], column
    by column."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for c in range(x.shape[1]):
        acc = acc + x[:, c]
    return acc


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """0-d f32 sum of the dense f32 tensor ``x`` in the reference's XLA
    CPU order (the tree of :func:`sparse_sum`), on ``x``'s device."""
    x = x.to(torch.float32)
    while any(d >= WINDOW for d in x.shape):
        nd = x.ndim
        parts, outer = [], []
        for a, d in enumerate(x.shape):
            if d >= WINDOW:
                pad = -d % WINDOW
                if pad:
                    before = [0] * (2 * (nd - a - 1)) + [pad // 2, pad - pad // 2]
                    x = torch.nn.functional.pad(x, before)
                parts.append(((d + pad) // WINDOW, WINDOW))
            else:
                parts.append((1, d))
            outer.append(parts[-1][0])
        x = x.reshape([v for p in parts for v in p])
        x = x.permute(list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
        n_out = int(np.prod(outer))
        x = _seq_cols(x.reshape(n_out, -1)).reshape(outer)
    return _seq_cols(x.reshape(1, -1))[0]
