"""A full f32 sum in the order the reference's XLA CPU backend adds it.

XLA's CPU pipeline rewrites a reduction over a dimension of 32 or more
elements into a tree (its tree-reduction rewriter, window 32): every
reduced dimension of size >= 32 is padded with zeros to a multiple of 32,
split evenly before and after, and cut into windows of 32; a reduced
dimension shorter than 32 is taken whole.  The window sums form the next
level's array, and the rewrite repeats until no reduced dimension reaches
32, when the rest is reduced whole.  Dimensions of size 1 take no part.

Each window (and the last reduction) is a loop nest in row-major order
over its dimensions that adds into one f32 accumulator from 0.0, and XLA
marks these adds reassociable.  LLVM fully unrolls the innermost loop
(``cols`` elements) and its loop vectoriser may then run the loop above it
(``rows`` iterations) ``vf`` rows at a time.  Lane ``j`` of a vector
accumulator, which starts as (accumulator, -0.0, ..., -0.0), adds rows
``j, j + vf, ...`` each a row's ``cols`` elements in order; the lanes are
then folded by halves (``l[i] + l[i + vf/2]`` until one is left) and the
rows past the last whole group of ``vf`` are added one by one.  Outer
loops carry the accumulator from one such block to the next.  The loop is
vectorised only when its body is straight-line code: a window padded in
either of its last two dimensions tests each index there and stays
scalar (padding further out skips whole blocks).  The one exception is the
innermost dimension padded only by one at its high end (a size of 31
modulo 32): its loop runs to 31 for every window, and its last index
follows the rest of the window as a nest of its own, where the window
has it.

``vf`` is LLVM's choice on the x86 host with 256-bit vectors that XLA
targets, found by compiling ``jnp.sum`` over every ``rows`` x ``cols``
from 2 x 1 to 32 x 10 and reading the vector width of the optimised IR
(:func:`vector_width`).  It holds for a reduction whose operand is a
materialised array, as in every reference reduction the port copies
(``HybridGossipSub.flight_record_round``, ``gossip_metrics``); a select
fused into the reduction's loop weighs the loop differently and can pick
another width.

Every add runs under flush-to-zero and denormals-are-zero (``ops/fma``):
a subnormal element counts as zero and a subnormal partial sum is stored
as zero (one element alone is passed on as it is).

:func:`xla_sum` follows this order over a dense tensor on its device;
:func:`sparse_sum` is the same sum on the host of an array given by its
non-zero entries (the adversary's score means of
``GossipSub.rollout_events``), where zeros add nothing.  Both are checked
against ``jnp.sum`` under ``jax.jit`` in the tests.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from .fma import FLT_MIN, ftz

WINDOW = 32
_SUBNORMAL_MAX = float(np.nextafter(np.float32(FLT_MIN), np.float32(0)))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """:func:`ops.fma.ftz` in one launch, the zero unsigned.  A sum here
    cannot show the sign: each lane's chain ends in the one that starts
    from the accumulator, and a chain from +0.0 never holds -0.0."""
    return torch.nn.functional.hardshrink(x, _SUBNORMAL_MAX)


def vector_width(rows: int, cols: int) -> int:
    """The lanes LLVM's loop vectoriser gives a reduction loop of ``rows``
    iterations whose unrolled body adds ``cols`` contiguous floats (1:
    the loop stays scalar).  Below 16 iterations only a loop that one
    vector iteration covers exactly is vectorised; above, the width
    trades the vector body's cost against the scalar rows left over."""
    if not 2 <= cols <= 8:
        return 1
    if rows < 16:
        return rows if rows in (2, 4, 8) else 1
    if cols >= 7:
        return 4
    groups, left = divmod(rows, 8)
    if left < 4 or (cols == 2 and groups >= 3):
        return 8
    return 4


def _block(acc: torch.Tensor, x: torch.Tensor, straight: bool
           ) -> torch.Tensor:
    """``acc`` [W] plus the blocks ``x`` [W, rows, cols], each added as one
    row loop, vectorised if its body is ``straight``-line code."""
    w, rows, cols = x.shape
    vf = vector_width(rows, cols) if straight else 1
    main = rows // vf * vf if vf > 1 else 0
    if main:
        lanes = torch.full((w, vf), -0.0, dtype=torch.float32,
                           device=x.device)
        lanes[:, 0] = acc
        groups = x[:, :main].reshape(w, main // vf, vf, cols)
        for g in range(main // vf):
            for c in range(cols):
                lanes = _flush(lanes + groups[:, g, :, c])
        while lanes.shape[1] > 1:
            half = lanes.shape[1] // 2
            lanes = _flush(lanes[:, :half] + lanes[:, half:])
        acc = lanes[:, 0]
    for r in range(main, rows):
        for c in range(cols):
            acc = _flush(acc + x[:, r, c])
    return acc


def _nest(acc: torch.Tensor, x: torch.Tensor, tested, peeled=None
          ) -> torch.Tensor:
    """``acc`` [W] plus the windows ``x`` [W, *window] in the loop order of
    the module docstring.  ``tested[i]``: window dimension ``i``'s loop
    tests each index against the padding; ``peeled``: the dimension whose
    last index is taken after the rest of the window."""
    if peeled is not None:
        a, last = peeled, x.shape[1 + peeled] - 1
        acc = _nest(acc, x.narrow(1 + a, 0, last), tested)
        return _nest(acc, x.select(1 + a, last), tested[:a] + tested[a + 1:])
    if x.ndim == 1:
        return _flush(acc + x)
    if x.ndim == 2:
        x, tested = x[:, None, :], [False] + list(tested)
    straight = not (tested[-1] or tested[-2])
    for idx in itertools.product(*(range(d) for d in x.shape[1:-2])):
        acc = _block(acc, x[(slice(None),) + idx], straight)
    return acc


def _level(shape):
    """One level of the tree over an array of ``shape`` (no dimension of
    size 1) -> (window, outer shape, pads, tested, peeled): each
    dimension's window and (low, high) padding, which window dimensions
    test their indices, and the one peeled (or None).  Without a
    dimension of 32 or more the window is the whole array."""
    pads, wins, outer = [], [], []
    for d in shape:
        pad = -d % WINDOW if d >= WINDOW else 0
        pads.append((pad // 2, pad - pad // 2))
        wins.append(WINDOW if d >= WINDOW else d)
        outer.append((d + pad) // wins[-1])
    # The innermost dimension padded by one at the high end is peeled;
    # every other padded dimension tests its indices.
    peeled = max((a for a, p in enumerate(pads) if p == (0, 1)),
                 default=None)
    tested = [p != (0, 0) and a != peeled for a, p in enumerate(pads)]
    return wins, outer, pads, tested, peeled


def _vectorises(wins, tested, peeled) -> bool:
    """Whether any row loop of a window's nest (:func:`_nest`) runs
    vectorised."""
    if peeled is not None:
        main = list(wins)
        main[peeled] -= 1
        return (_vectorises(main, tested, None) or _vectorises(
            wins[:peeled] + wins[peeled + 1:],
            tested[:peeled] + tested[peeled + 1:], None))
    return (len(wins) >= 2 and not (tested[-1] or tested[-2])
            and vector_width(wins[-2], wins[-1]) > 1)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """0-d f32 sum of the dense tensor ``x`` in the reference's XLA CPU
    order (module docstring), on ``x``'s device."""
    x = x.to(torch.float32)
    if x.numel() <= 1:
        # XLA folds a reduction of one element to the element itself.
        return x.reshape(()).clone() if x.numel() else torch.zeros(
            (), dtype=torch.float32, device=x.device)
    x = _flush(x)
    while True:
        x = x.reshape([d for d in x.shape if d != 1])
        wins, outer, pads, tested, peeled = _level(x.shape)
        nd = x.ndim
        if any(p != (0, 0) for p in pads):
            x = torch.nn.functional.pad(
                x, [p for lo_hi in reversed(pads) for p in lo_hi])
        x = x.reshape([v for pair in zip(outer, wins) for v in pair])
        x = x.permute(list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
        x = x.reshape([-1] + wins)
        acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        x = _nest(acc, x, tested, peeled)
        if outer == [1] * nd:
            return x[0]
        x = x.reshape(outer)


def _run_sums(keys: np.ndarray, vals: np.ndarray):
    """Sequential f32 sums, each from 0.0 and flushed as they go, of the
    runs of equal ``keys`` (sorted) -> (the keys, their sums).  The runs
    are added side by side, one position at a time; a shorter run's
    padding adds 0.0, which changes no sum."""
    uniq, start, counts = np.unique(keys, return_index=True,
                                    return_counts=True)
    grid = np.zeros((uniq.size, counts.max(initial=0)), np.float32)
    grid[np.repeat(np.arange(uniq.size), counts),
         np.arange(keys.size) - np.repeat(start, counts)] = vals
    acc = np.zeros(uniq.size, np.float32)
    for col in grid.T:
        acc = acc + col
        acc[np.abs(acc) < FLT_MIN] = 0.0
    return uniq, acc


def sparse_sum(shape: Sequence[int], flat_idx, vals) -> np.float32:
    """f32 sum of an array of ``shape`` that is zero except at the
    row-major ``flat_idx`` (distinct) where it holds ``vals``: the tree of
    :func:`xla_sum` over the entries alone, as zeros add nothing.  A
    window whose nest runs only scalar loops adds its entries in loop
    order; one with a vectorised row loop is filled in dense and summed
    by :func:`xla_sum`'s own nest."""
    shape = [int(d) for d in shape]
    idx = np.asarray(flat_idx, np.int64).reshape(-1)
    vals = np.asarray(vals, np.float32).reshape(-1)
    if int(np.prod(shape)) <= 1:
        return vals[0] if vals.size else np.float32(0.0)
    vals = np.where(np.abs(vals) < FLT_MIN, np.float32(0.0), vals)
    coords = np.stack(np.unravel_index(idx, shape), 1).reshape(-1, len(shape))
    while True:
        keep = [a for a, d in enumerate(shape) if d != 1]
        shape, coords = [shape[a] for a in keep], coords[:, keep]
        wins, outer, pads, tested, peeled = _level(shape)
        pos = coords + np.array([lo for lo, _ in pads], np.int64)
        win_id = np.ravel_multi_index((pos // wins).T, outer)
        inner = pos % wins
        if _vectorises(wins, tested, peeled):
            uniq, at = np.unique(win_id, return_inverse=True)
            dense = np.zeros([uniq.size] + wins, np.float32)
            dense[(at,) + tuple(inner.T)] = vals
            sums = _nest(torch.zeros(uniq.size), torch.from_numpy(dense),
                         tested, peeled).numpy()
        else:
            key = np.ravel_multi_index(inner.T, wins)
            if peeled is not None:
                key = key + (inner[:, peeled] == wins[peeled] - 1) * int(
                    np.prod(wins))
            order = np.lexsort((key, win_id))
            uniq, sums = _run_sums(win_id[order], vals[order])
        if outer == [1] * len(shape):
            return sums[0] if sums.size else np.float32(0.0)
        shape, vals = outer, sums
        coords = np.stack(np.unravel_index(uniq, shape), 1).reshape(
            -1, len(shape))


def masked_mean(shape: Sequence[int], flat_idx, vals, count: int):
    """``GossipSub.masked_mean`` of the reference from the mask's entries:
    the XLA-ordered sum over ``count`` (f32 division, flushed), NaN when
    empty."""
    if count <= 0:
        return np.float32(np.nan)
    mean = np.float32(sparse_sum(shape, flat_idx, vals) / np.float32(count))
    return np.float32(ftz(torch.tensor(mean)).item())
