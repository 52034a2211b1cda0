"""The reference's side of a closed-loop episode.

From the benchmark's inputs alone (the seed, the deployment's topology,
each episode's signed window and its publishers) the reference verifies
every envelope itself, builds the warm state itself (``Network.start``),
publishes the window's messages with its own verdicts, runs the recorded
rollout and takes the delivery statistics.  It reads nothing the program
made, and imports nothing of it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import compare, ed25519
from .gossipsub import Network


def verdicts(window: Sequence) -> np.ndarray:
    """Each envelope (``topic``, ``seqno``, ``payload``, ``pubkey``,
    ``signature``) verified by the reference's ed25519."""
    return np.array([
        ed25519.verify(s.pubkey, ed25519.signing_bytes(
            s.topic, s.seqno, s.payload), s.signature) for s in window])


def episodes(config: dict, model_seed: int, topology, inputs: List[dict],
             device, control: bool = False) -> Dict[str, object]:
    """``inputs``: one dict an episode with ``window`` (signed envelopes)
    and ``publishers`` (int[window]).  Returns the warm start state's
    arrays and, an episode, its verdicts and the arrays of its final
    state, flight record and delivery statistics.  ``control`` computes
    the reference in bfloat16, one precision below the configuration's
    float32."""
    net = Network(config, device,
                  torch.bfloat16 if control else torch.float32)
    m = config["msg_window"]
    st0 = net.start(topology, model_seed)
    out = {"start": compare.reference_state(st0, m), "episodes": []}
    for ep in inputs:
        ok = verdicts(ep["window"])
        st = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in st0.items()}
        for slot, (src, good) in enumerate(zip(ep["publishers"], ok)):
            net.publish(st, int(src), slot, bool(good))
        rec = net.rollout(st, config["rollout_rounds"])
        widths = rec.pop("score_bin_width")
        frac, p50, p99 = net.delivery_stats(st)
        arrays = compare.reference_state(st, m)
        arrays.update(compare.named(rec, "record."))
        arrays.update(compare.named(
            {"frac": frac, "p50": p50, "p99": p99}, "stats."))
        out["episodes"].append({"verdicts": ok, "arrays": arrays,
                                "widths": compare.to_host(widths)})
    return out
