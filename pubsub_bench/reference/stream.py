"""The reference's side of a stream cell: the warm start, and a replay of
recorded chunks.

A chunk is what the serving engine dispatched: ``chunk_steps`` rounds,
each opened by its row of publishes (topic, publisher, window slot,
verdict; a lane with a negative publisher or topic is empty), applied in
lane order before the round.  The replay starts from a state the
comparison hands it (the program's, read back as plain arrays at a chunk
boundary), runs the chunks on ``reference/multitopic.py`` and returns
the end state, each chunk's delivered counts and the last round's
telemetry.  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .multitopic import SHARED_PLANES, TOPIC_PLANES, MultiNetwork

# Event rows the stream cells never fire (kills, mutes, ingress delays).
QUIET_ROWS = ("kill", "mute_on", "mute_off")


def start(config: dict, model_seed: int, topology, device,
          control: bool = False) -> Dict[str, np.ndarray]:
    """The warm start state's arrays (``MultiNetwork.start``)."""
    net = MultiNetwork(config, device, _dtype(control))
    return net.arrays(net.start(topology, model_seed))


def _dtype(control: bool):
    return torch.bfloat16 if control else torch.float32


def from_arrays(net: MultiNetwork, arrays: Dict[str, np.ndarray],
                pre: str = "state.") -> Dict[str, object]:
    """A state from plain arrays by name (as ``MultiNetwork.arrays``
    gives them): floats in the network's float type, integers as int64."""
    def dev(a):
        t = torch.as_tensor(np.asarray(a), device=net.dev)
        if t.is_floating_point():
            return t.to(net.F)
        return t if t.dtype == torch.bool else t.long()

    st = {name: dev(arrays[pre + name]) for name in SHARED_PLANES}
    st["step"] = int(arrays[pre + "step"])
    keys = np.asarray(arrays[pre + "keys"]).astype(np.int64)
    st["topics"] = [
        dict({name: dev(arrays[pre + name][t]) for name in TOPIC_PLANES},
             key=torch.as_tensor(keys[t], device=net.dev))
        for t in range(net.t)]
    return st


def run_chunk(net: MultiNetwork, st, events) -> None:
    """One dispatched chunk: each round's publishes in lane order, then
    the round."""
    for name in QUIET_ROWS:
        if np.asarray(getattr(events, name)).any():
            raise ValueError(f"the replay runs no {name} events")
    if (np.asarray(events.delay) >= 0).any():
        raise ValueError("the replay runs no ingress delays")
    topics, srcs = np.asarray(events.pub_topic), np.asarray(events.pub_src)
    slots, valid = np.asarray(events.pub_slot), np.asarray(events.pub_valid)
    for r in range(topics.shape[0]):
        for lane in range(topics.shape[1]):
            if srcs[r, lane] >= 0 and topics[r, lane] >= 0:
                net.publish(st, min(int(topics[r, lane]), net.t - 1),
                            int(srcs[r, lane]),
                            min(max(int(slots[r, lane]), 0), net.m - 1),
                            bool(valid[r, lane]))
        net.round(st)


def replay(config: dict, start_arrays: Dict[str, np.ndarray],
           chunks: Sequence, device, control: bool = False
           ) -> Dict[str, object]:
    """``chunks`` (each a chunk's events) run from ``start_arrays``.
    Returns ``end`` (the end state's arrays), ``digests`` (each chunk's
    delivered counts, int[T, M]) and ``tail`` (the last round's
    telemetry)."""
    net = MultiNetwork(config, device, _dtype(control))
    st = from_arrays(net, start_arrays)
    digests: List[np.ndarray] = []
    for events in chunks:
        run_chunk(net, st, events)
        digests.append(net.digest(st))
    return {"end": net.arrays(st), "digests": digests,
            "tail": net.flight_tail(st)}
