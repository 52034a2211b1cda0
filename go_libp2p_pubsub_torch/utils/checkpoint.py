"""Checkpoint / resume of simulator state, in the JAX package's file format.

Port of ``save``, ``meta``, ``restore``, ``warm_serialize`` and the atomic
write of the JAX package's ``utils/checkpoint.py``.  A checkpoint is one
``.npz`` archive whose leaves are addressed by the reference's
``jax.tree_util.keystr`` path strings (``['state'].counters.time_in_mesh``:
``[key]`` for a dict entry, ``.field`` for a NamedTuple field, ``[i]`` for
a list or tuple item), plus a JSON header under ``_META_KEY``.  The two
packages write the same archive for the same tree, so a snapshot written
by either restores into the other.

Trees hold numpy arrays, numpy or Python scalars, or tensors (read to the
host as they are); callers that keep packed words as int32 bit patterns
map them to the reference's uint32 first (``bridge.multitopic_state_to_
numpy``).  Restore is template-driven: the structure, every leaf's shape
and dtype come from the template, and extra or missing leaves are errors.
``save_topic_state``/``load_topic_state`` keep the live plane's topic
control state (``net/live.py``) as small JSON, in the reference's format.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_META_KEY = "__pubsub_ckpt_meta__"
_FORMAT_VERSION = 1
_TOPIC_STATE_VERSION = 1


def _atomic_write(path: str, write_fn) -> None:
    """Write a file atomically: temp file in the target directory, fsync,
    then ``os.replace``.  A crash at any point leaves either the previous
    file intact or the new one complete -- never a torn write."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: str, out: List[Tuple[str, Any]]
             ) -> Callable[[Any], Any]:
    """Append ``tree``'s (keystr, leaf) pairs to ``out`` in the order jax
    flattens them (dict keys sorted, NamedTuple fields in order, ``None``
    an empty subtree); returns a function that rebuilds the structure from
    an iterator over new leaves."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten(tree[k], f"{prefix}[{k!r}]", out) for k in keys]
        return lambda it: {k: f(it) for k, f in zip(keys, subs)}
    if _is_namedtuple(tree):
        subs = [_flatten(getattr(tree, f), f"{prefix}.{f}", out)
                for f in tree._fields]
        cls = type(tree)
        return lambda it: cls(*(f(it) for f in subs))
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v, f"{prefix}[{i}]", out) for i, v in enumerate(tree)]
        cls = type(tree)
        return lambda it: cls(f(it) for f in subs)
    out.append((prefix, tree))
    return lambda it: next(it)


def _leaf_paths(tree: Any):
    """[(keystr, leaf)] for every leaf in jax's flatten order, and the
    function that rebuilds the tree from an iterator over leaves."""
    pairs: List[Tuple[str, Any]] = []
    rebuild = _flatten(tree, "", pairs)
    return pairs, rebuild


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def warm_serialize(state: Any) -> int:
    """Pay ``save``'s first-call serialization cost against an in-memory
    buffer (the host copies, the tree walk and the zip machinery).  Writes
    nothing to disk; returns the serialized byte count."""
    pairs, _ = _leaf_paths(state)
    buf = io.BytesIO()
    np.savez(buf, **{key: _host(leaf) for key, leaf in pairs})
    return buf.tell()


def save(path: str, state: Any, meta: Optional[Dict[str, Any]] = None) -> None:
    """Snapshot ``state`` (a tree of arrays) to ``path`` atomically, with
    ``meta`` (JSON-serializable) in the header."""
    pairs, _ = _leaf_paths(state)
    arrays = {}
    for key, leaf in pairs:
        if key in arrays:
            raise ValueError(f"duplicate keypath {key!r} in state tree")
        arrays[key] = _host(leaf)
    header = {"format_version": _FORMAT_VERSION, "meta": meta or {}}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8)
    _atomic_write(path, lambda f: np.savez(f, **arrays))


def meta(path: str) -> Dict[str, Any]:
    """Read just the metadata header of a checkpoint."""
    with np.load(path) as z:
        header = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
    return header["meta"]


def restore(path: str, template: Any) -> Any:
    """Load a checkpoint into the structure of ``template`` (numpy leaves).
    Every leaf in the file must match the template leaf's shape and dtype;
    extra or missing leaves are errors."""
    pairs, rebuild = _leaf_paths(template)
    with np.load(path) as z:
        header = json.loads(bytes(z[_META_KEY]).decode("utf-8"))
        if header["format_version"] != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} != "
                f"supported {_FORMAT_VERSION}")
        file_keys = {k for k in z.files if k != _META_KEY}
        want_keys = {k for k, _ in pairs}
        if file_keys != want_keys:
            missing = sorted(want_keys - file_keys)
            extra = sorted(file_keys - want_keys)
            raise ValueError(
                f"checkpoint/template mismatch: missing={missing} "
                f"extra={extra}")
        leaves = []
        for key, tmpl_leaf in pairs:
            arr = z[key]
            t = _host(tmpl_leaf)
            if arr.shape != t.shape or arr.dtype != t.dtype:
                raise ValueError(
                    f"leaf {key!r}: checkpoint {arr.shape}/{arr.dtype} != "
                    f"template {t.shape}/{t.dtype}")
            leaves.append(arr)
    return rebuild(iter(leaves))


# ---------------------------------------------------------------------------
# durable topic state (live-plane root failover, net/live.py)
# ---------------------------------------------------------------------------


def save_topic_state(path: str, state: Dict[str, Any]) -> None:
    """Persist a live topic's control state ``{epoch, seq, successors,
    roster, ...}`` atomically (same write-temp/fsync/rename discipline as
    :func:`save`).  The payload is small JSON, not arrays: a restarted host
    reads it before joining so it re-enters at the *current* epoch instead
    of resurrecting a stale tree."""
    doc = {"format_version": _TOPIC_STATE_VERSION, "state": state}
    body = json.dumps(doc, sort_keys=True).encode("utf-8")
    _atomic_write(path, lambda f: f.write(body))


def load_topic_state(path: str) -> Dict[str, Any]:
    """Read a topic-state file written by :func:`save_topic_state`."""
    with open(path, "rb") as f:
        doc = json.loads(f.read().decode("utf-8"))
    if doc.get("format_version") != _TOPIC_STATE_VERSION:
        raise ValueError(
            f"topic state format {doc.get('format_version')} != "
            f"supported {_TOPIC_STATE_VERSION}"
        )
    return doc["state"]
