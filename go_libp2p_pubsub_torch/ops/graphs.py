"""Graph/segment utilities shared by the overlay and gossip ops.

Port of the JAX package's ``ops/graphs.py``.  ``jnp.argsort`` is stable
and ``torch.argsort`` is not by default, so every sort here passes
``stable=True``; ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does, which is what the lowest-slot tie-break relies on.
"""

from __future__ import annotations

import numpy as np
import torch

INVALID = -1
BIG_I32 = 2**31 - 1

_TORCH_DTYPE = {
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
}


def index_dtype(n: int) -> np.dtype:
    """Narrowest storage dtype that holds every peer-index value for ``n``
    peers: ids ``0..n-1``, the sentinel row ``n`` and the wrap-encoded
    ``-1``.  uint16 for ``n <= 65534``, int32 above."""
    if n < 0:
        raise ValueError(f"index_dtype: peer count must be >= 0, got {n}")
    if n + 1 <= np.iinfo(np.uint16).max:
        return np.dtype(np.uint16)
    if n + 1 <= np.iinfo(np.int32).max:
        return np.dtype(np.int32)
    raise ValueError(
        f"index_dtype: n + 1 = {n + 1} exceeds int32; no supported index "
        f"storage dtype can hold it"
    )


def torch_dtype(dt) -> torch.dtype:
    """numpy index dtype -> the torch dtype that stores it."""
    return _TORCH_DTYPE[np.dtype(dt)]


def encode_index_plane(arr, n: int, dtype=None) -> np.ndarray:
    """Host-side: a ``-1``-sentinel signed index plane -> narrow storage
    (numpy).  Values outside ``[-1, n - 1]`` raise instead of wrapping."""
    dt = np.dtype(dtype) if dtype is not None else index_dtype(n)
    if dt.kind == "u" and n + 1 > np.iinfo(dt).max:
        raise ValueError(
            f"encode_index_plane: n + 1 = {n + 1} exceeds {dt.name} storage "
            f"(max {np.iinfo(dt).max}); use index_dtype(n) or int32"
        )
    a = np.asarray(arr)
    if a.dtype.kind == "u":  # already wrap-encoded: restore -1 first
        a = decode_index_plane(a)
    if a.size and (a.min() < -1 or a.max() >= n):
        raise ValueError(
            f"encode_index_plane: values outside [-1, {n - 1}] "
            f"(got min={a.min()}, max={a.max()}) would wrap silently"
        )
    return a.astype(dt)


def decode_index_plane(arr):
    """Narrow index storage -> int32 with the ``-1`` sentinel restored.
    Works on numpy arrays and torch tensors; signed input is a plain cast."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.uint16:
            # Through the int16 view: CUDA kernels cover uint16 sparsely.
            wide = arr.view(torch.int16).to(torch.int32) & 0xFFFF
            return torch.where(wide == 65535, -1, wide)
        return arr.to(torch.int32)
    if np.dtype(arr.dtype).kind == "u":
        sentinel = np.iinfo(arr.dtype).max
        wide = arr.astype(np.int32)
        return np.where(wide == sentinel, np.int32(-1), wide)
    return arr.astype(np.int32)


def narrow_index_plane(wide: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 index plane with values in [-1, max) -> ``dtype`` storage; for
    uint16 the two's-complement wrap of -1 is the encode (65535)."""
    if dtype == torch.uint16:
        return wide.to(torch.int16).view(torch.uint16)
    return wide.to(dtype)


def segment_rank(targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank of each masked element among elements sharing its target
    (0-based, stable by element index); unmasked elements get 0."""
    n = targets.shape[0]
    dev = targets.device
    key = torch.where(mask, targets, n).to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    composite = key * (n + 1) + pos
    order = torch.argsort(composite, stable=True)
    sorted_key = key[order]
    is_first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=dev),
         sorted_key[1:] != sorted_key[:-1]]
    )
    seg_start = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    rank_sorted = pos - seg_start
    return torch.zeros(n, dtype=torch.int32, device=dev).index_put(
        (order,), rank_sorted
    )


def masked_argmin(values: torch.Tensor, mask: torch.Tensor, axis: int = -1):
    """Index of the minimum among masked entries (ties -> lowest index);
    0 for an all-false mask."""
    v = torch.where(mask, values, BIG_I32)
    return torch.argmin(v, dim=axis).to(torch.int32)


def safe_gather(arr: torch.Tensor, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """``arr[idx]`` treating negative indices as invalid -> ``fill``."""
    valid = idx >= 0
    clipped = idx.clamp(0, arr.shape[0] - 1).long()
    out = arr[clipped]
    if out.ndim > valid.ndim:  # row gather from a 2D table
        valid = valid.reshape(valid.shape + (1,) * (out.ndim - valid.ndim))
    return torch.where(valid, out, fill)


def top_mask(vals: torch.Tensor, count, kmax=None) -> torch.Tensor:
    """bool[N, K] mask of the per-row top-``count`` finite entries of
    ``vals`` (ineligible entries must be -inf; ties break to the lowest
    slot).  ``count`` is an int or an int32[N] per-row quota; ``kmax``
    bounds the iteration count when it is a tensor (defaults to K)."""
    n, k = vals.shape
    static = isinstance(count, int)
    iters = count if static else min(int(kmax if kmax is not None else k), k)
    chosen = torch.zeros((n, k), dtype=torch.bool, device=vals.device)
    if static and iters <= 0:
        return chosen
    col = torch.arange(k, device=vals.device)
    for t in range(iters):
        v = torch.where(chosen, -torch.inf, vals)
        idx = torch.argmax(v, dim=1)
        best = v.gather(1, idx[:, None])[:, 0]
        ok = torch.isfinite(best)
        if not static:
            ok = ok & (t < count)
        chosen = chosen | ((col[None, :] == idx[:, None]) & ok[:, None])
    return chosen


def nth_free_slot(row_used: torch.Tensor, rank) -> torch.Tensor:
    """Index of the ``rank``-th free (False) slot of a bool[W] row; W when
    there is none.  Batched over leading axes: bool[N, W] rows with an
    int[N] rank give int32[N] (the reference's ``jax.vmap`` of it)."""
    w = row_used.shape[-1]
    slot_ids = torch.where(
        ~row_used, torch.arange(w, dtype=torch.int32, device=row_used.device), w
    )
    ordered = torch.sort(slot_ids, dim=-1, stable=True).values
    rank = torch.as_tensor(rank, device=row_used.device)
    idx = rank.clamp(0, w - 1).long().unsqueeze(-1)
    pick = ordered.gather(-1, idx).squeeze(-1)
    return torch.where(rank < w, pick, w).to(torch.int32)
