"""State and parameter bridge between the JAX package and the port.

A JAX ``GossipState``, ``MultiTopicState``, ``TreeState``, ``FloodState``,
``RandomSubState``, ``RLNCState`` or ``HybridState`` (any NamedTuple with
its fields, leaves as numpy or JAX arrays) converts into the port's state of the same name and back
through numpy, without importing JAX: it is how both sides start from one
state, and how the streaming engine's snapshots keep the reference's file
format.

- uint32 leaves (the packed message windows and the threefry keys) become
  int32 tensors with the same bit patterns (``.view``);
- index planes keep their storage dtype (uint16 or int32);
- ``step`` becomes the host int the port keeps (the tree's ``step_num``,
  ``root``, ``width`` and ``max_width`` stay 0-d int32 tensors);
- ``GossipSubParams`` / ``ScoreParams`` convert by their field dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .config import GossipSubParams, ScoreParams
from .models.floodsub import FloodState
from .models.gossipsub import GossipState, resolve_device
from .models.hybrid import HybridState
from .models.multitopic import MultiTopicState
from .models.randomsub import RandomSubState
from .models.rlnc import RLNCState
from .ops.tree import TreeState
from .ops.scoring import GlobalCounters, TopicCounters

# Leaves the JAX package stores as uint32 and the port as int32 patterns.
U32_FIELDS = frozenset({"have_w", "fresh_w", "gossip_pend_w", "iwant_pend_w",
                        "fresh_hist", "key", "keys", "key_coded",
                        "key_loss"})
_NESTED = {"counters": TopicCounters, "gcounters": GlobalCounters}


def params_from(cfg: Any):
    """A ``GossipSubParams`` or ``ScoreParams`` of either package -> the
    port's class of the same name, field for field."""
    cls = {"GossipSubParams": GossipSubParams,
           "ScoreParams": ScoreParams}[type(cfg).__name__]
    return cls(**dataclasses.asdict(cfg))


def _to_torch(name: str, leaf, device) -> torch.Tensor:
    a = np.asarray(leaf)
    if name in U32_FIELDS:
        a = a.astype(np.uint32, copy=False).view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _from_jax(cls, st: Any, device):
    device = resolve_device(device)
    fields: Dict[str, Any] = {}
    for name in cls._fields:
        leaf = getattr(st, name)
        if name == "step":
            fields[name] = int(np.asarray(leaf))
        elif name in _NESTED:
            nested = _NESTED[name]
            fields[name] = nested(*(
                _to_torch(f, getattr(leaf, f), device)
                for f in nested._fields))
        else:
            fields[name] = _to_torch(name, leaf, device)
    return cls(**fields)


def state_from_jax(st: Any, device="cuda") -> GossipState:
    """Reference ``GossipState`` -> the port's, on ``device`` (the card by
    default, like ``GossipSub``; raises without one)."""
    return _from_jax(GossipState, st, device)


def multitopic_state_from_jax(st: Any, device="cuda") -> MultiTopicState:
    """Reference ``MultiTopicState`` (or its numpy form) -> the port's, on
    ``device`` (the card by default; raises without one)."""
    return _from_jax(MultiTopicState, st, device)


def tree_state_from_jax(st: Any, device="cuda") -> TreeState:
    """Reference ``TreeState`` -> the port's, on ``device`` (the card by
    default; raises without one).  The uint32 key becomes its int32 bit
    pattern."""
    return _from_jax(TreeState, st, device)


def flood_state_from_jax(st: Any, device="cuda"):
    """Reference ``FloodState`` or ``RandomSubState`` (told apart by the
    ``key`` field) -> the port's, on ``device``."""
    cls = RandomSubState if hasattr(st, "key") else FloodState
    return _from_jax(cls, st, device)


def rlnc_state_from_numpy(st: Any, device="cuda") -> RLNCState:
    """Reference ``RLNCState`` (or its numpy form) -> the port's, on
    ``device`` (the card by default; raises without one)."""
    return _from_jax(RLNCState, st, device)


def hybrid_state_from_numpy(st: Any, device="cuda") -> HybridState:
    """Reference ``HybridState`` (or its numpy form) -> the port's, on
    ``device``: the embedded ``GossipState`` as :func:`state_from_jax`
    converts it, the coded plane's keys as int32 bit patterns."""
    device = resolve_device(device)
    return HybridState(**{
        name: (_from_jax(GossipState, st.gossip, device) if name == "gossip"
               else _to_torch(name, getattr(st, name), device))
        for name in HybridState._fields})


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in U32_FIELDS:
        a = a.view(np.uint32)
    return a


def _spec(name: str, t: torch.Tensor) -> np.ndarray:
    dt = np.uint32 if name in U32_FIELDS else t.new_empty(0).cpu().numpy().dtype
    return np.empty(tuple(t.shape), dt)


def _numpy_of(st, leaf_fn=_to_numpy):
    fields: Dict[str, Any] = {}
    for name in type(st)._fields:
        leaf = getattr(st, name)
        if name == "step":
            fields[name] = np.asarray(leaf, np.int32)
        elif name in _NESTED:
            nested = _NESTED[name]
            fields[name] = nested(*(
                leaf_fn(f, getattr(leaf, f)) for f in nested._fields))
        else:
            fields[name] = leaf_fn(name, leaf)
    return type(st)(**fields)


def state_to_numpy(st: GossipState) -> GossipState:
    """The port's state (either model's) -> the same NamedTuple with numpy
    leaves in the reference's dtypes (uint32 windows and keys, ``step`` as
    int32), ready for ``jax_GossipState(*...)`` after ``jnp.asarray`` of
    each leaf."""
    return _numpy_of(st)


def state_spec(st: GossipState) -> GossipState:
    """:func:`state_to_numpy`'s shapes and dtypes without reading the
    device: each leaf an uninitialised array."""
    return _numpy_of(st, _spec)


def tree_state_to_numpy(st: TreeState) -> TreeState:
    """The port's ``TreeState`` -> numpy leaves in the reference's dtypes
    (the uint32 key; ``root``, ``width``, ``max_width`` and ``step_num`` as
    0-d int32)."""
    return _numpy_of(st)


def flood_state_to_numpy(st):
    """The port's ``FloodState`` / ``RandomSubState`` -> numpy leaves in
    the reference's dtypes (``step`` as int32, the uint32 key)."""
    return _numpy_of(st)


def multitopic_state_to_numpy(st: MultiTopicState) -> MultiTopicState:
    """The port's ``MultiTopicState`` -> numpy leaves in the reference's
    dtypes (uint32 windows and keys, ``step`` as int32)."""
    return _numpy_of(st)


def multitopic_state_spec(st: MultiTopicState) -> MultiTopicState:
    """The numpy form's shapes and dtypes without reading the device: each
    leaf an uninitialised array (a checkpoint restore's template)."""
    return _numpy_of(st, _spec)


def rlnc_state_to_numpy(st: RLNCState) -> RLNCState:
    """The port's ``RLNCState`` -> numpy leaves in the reference's dtypes
    (the uint32 key, ``step`` as int32)."""
    return _numpy_of(st)


def rlnc_state_spec(st: RLNCState) -> RLNCState:
    """:func:`rlnc_state_to_numpy`'s shapes and dtypes without reading the
    device."""
    return _numpy_of(st, _spec)


def _hybrid_numpy(st: HybridState, leaf_fn) -> HybridState:
    return HybridState(**{
        name: (_numpy_of(st.gossip, leaf_fn) if name == "gossip"
               else leaf_fn(name, getattr(st, name)))
        for name in HybridState._fields})


def hybrid_state_to_numpy(st: HybridState) -> HybridState:
    """The port's ``HybridState`` -> numpy leaves in the reference's dtypes
    (uint32 windows and keys, the gossip ``step`` as int32)."""
    return _hybrid_numpy(st, _to_numpy)


def hybrid_state_spec(st: HybridState) -> HybridState:
    """:func:`hybrid_state_to_numpy`'s shapes and dtypes without reading
    the device (a checkpoint restore's template)."""
    return _hybrid_numpy(st, _spec)
