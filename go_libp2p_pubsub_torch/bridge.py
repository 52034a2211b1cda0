"""State and parameter bridge between the JAX package and the port.

A JAX ``GossipState`` (any NamedTuple with its fields, leaves as numpy or
JAX arrays) converts into the port's ``GossipState`` and back through
numpy, without importing JAX: it is how both sides start from one state.

- uint32 leaves (the packed message windows and the threefry key) become
  int32 tensors with the same bit patterns (``.view``);
- index planes keep their storage dtype (uint16 or int32);
- ``step`` becomes the host int the port keeps;
- ``GossipSubParams`` / ``ScoreParams`` convert by their field dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .config import GossipSubParams, ScoreParams
from .models.gossipsub import GossipState, resolve_device
from .ops.scoring import GlobalCounters, TopicCounters

# Leaves the JAX package stores as uint32 and the port as int32 patterns.
U32_FIELDS = frozenset(
    {"have_w", "fresh_w", "gossip_pend_w", "iwant_pend_w", "fresh_hist", "key"}
)
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


def state_from_jax(st: Any, device="cuda") -> GossipState:
    """Reference ``GossipState`` -> the port's, on ``device`` (the card by
    default, like ``GossipSub``; raises without one)."""
    device = resolve_device(device)
    fields: Dict[str, Any] = {}
    for name in GossipState._fields:
        leaf = getattr(st, name)
        if name == "step":
            fields[name] = int(np.asarray(leaf))
        elif name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(*(
                _to_torch(f, getattr(leaf, f), device) for f in cls._fields))
        else:
            fields[name] = _to_torch(name, leaf, device)
    return GossipState(**fields)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in U32_FIELDS:
        a = a.view(np.uint32)
    return a


def state_to_numpy(st: GossipState) -> GossipState:
    """The port's state -> the same NamedTuple with numpy leaves in the
    reference's dtypes (uint32 windows and key, ``step`` as int32), ready
    for ``jax_GossipState(*...)`` after ``jnp.asarray`` of each leaf."""
    fields: Dict[str, Any] = {}
    for name in GossipState._fields:
        leaf = getattr(st, name)
        if name == "step":
            fields[name] = np.asarray(leaf, np.int32)
        elif name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(*(
                _to_numpy(f, getattr(leaf, f)) for f in cls._fields))
        else:
            fields[name] = _to_numpy(name, leaf)
    return GossipState(**fields)
