"""Generator ``episodes``: a closed loop of simulation episodes.

A mix that names this generator (``"generator": "episodes"`` in
``traffic/<mix>.json``) gives ``pool`` (signed windows made in set-up),
``forged`` (envelopes of each window tampered after signing) and
``check_episodes`` (episodes of the window held against the reference,
drawn from the seed).  Episode ``e`` validates window ``e % pool`` and
publishes its messages from publishers drawn uniformly over the peers.
Every seed gets the same sizes and counts; only what is drawn differs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from pubsub_bench.harness.common import rng_for


def windows(mix: dict, seed: int, window: int) -> List[dict]:
    """The signed windows' contents: per window, ``keys`` and
    ``payloads`` (32 and 64 random bytes an envelope) and ``forged``
    (bool[window], exactly ``forged`` of them)."""
    rng = rng_for(seed, 10)
    out = []
    for _ in range(int(mix["pool"])):
        keys = [rng.bytes(32) for _ in range(window)]
        payloads = [rng.bytes(64) for _ in range(window)]
        forged = np.zeros(window, bool)
        forged[rng.choice(window, size=int(mix["forged"]),
                          replace=False)] = True
        out.append({"keys": keys, "payloads": payloads, "forged": forged})
    return out


def publishers(mix: dict, seed: int, episode: int, window: int,
               n_peers: int) -> np.ndarray:
    """The publishers of episode ``episode``'s messages, uniform."""
    return rng_for(seed, 1_000_000 + int(episode)).integers(
        0, n_peers, size=window)
