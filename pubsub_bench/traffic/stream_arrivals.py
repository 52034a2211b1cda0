"""Generator ``stream_arrivals``: a stream of signed publishes for the
serving engine.

A mix that names this generator (``"generator": "stream_arrivals"`` in
``traffic/<mix>.json``) gives:

- ``mode``: ``"steady"`` (an open loop: message i arrives at ``(i + φ) /
  rate_msgs_per_s`` seconds into the window, φ in [0, 1) drawn from the
  seed, so the gaps are fixed and the seed rotates them) or
  ``"saturated"`` (the ring is topped up to a full chunk before every
  chunk);
- ``block_every``: one message in this many is on topic 0 (the block
  topic), at a position drawn from the seed, the rest on topic 1 (the
  aggregate topic): the beacon chain's 1 block to 1,024 aggregates a slot
  is 1,025;
- ``forged`` in every ``forged_per`` consecutive messages are tampered
  after signing, at positions drawn from the seed;
- ``pool``: the messages signed in set-up, or, when that is more, what
  the mix's rate gives over the window and the drain's margin: a steady
  mix's ``rate_msgs_per_s``, a saturated mix's ``pool_msgs_per_s`` (the
  most it provides for; its window ends early if a program serves
  faster); ``keys``: the publishers' signing keys, used in turn;
- ``warm``: messages published and drained before the window;
- ``check_chunks`` [lo, hi] and ``check_length``: the stretch of chunks
  held against the reference starts at a window chunk drawn from the seed
  in [lo, hi].

Publishers are uniform over the peers.  Every seed gets the same sizes and
counts; only what is drawn differs.  ``windows`` and ``publishers``, the
calls every generator answers, cut the stream into consecutive windows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pubsub_bench.harness.common import rng_for


def count(mix: dict, seconds: float) -> int:
    """Messages to sign for a window of ``seconds``."""
    rate = float(mix["rate_msgs_per_s"] if mix["mode"] == "steady"
                 else mix.get("pool_msgs_per_s", 0))
    pool = max(int(mix["pool"]), int(np.ceil(rate * (seconds + 2.0))) + 1)
    return pool + int(mix["warm"])


def messages(mix: dict, seed: int, total: int, n_peers: int
             ) -> Dict[str, object]:
    """The first ``total`` messages of the seed's stream: ``topic``
    (int[total]), ``publisher`` (int[total]), ``forged`` (bool[total]),
    ``payload`` (64 random bytes each), ``key`` (the index of its signing
    key) and ``keys`` (the signing keys' 32-byte seeds)."""
    every = int(mix["block_every"])
    phase = int(rng_for(seed, 40).integers(0, every))
    idx = np.arange(total)
    topic = np.where((idx + phase) % every == 0, 0, 1)
    per, bad = int(mix["forged_per"]), int(mix["forged"])
    forged = np.zeros(-(-total // per) * per, bool)
    draw = rng_for(seed, 44)
    for g in range(0, forged.size, per):
        forged[g + draw.choice(per, size=bad, replace=False)] = True
    n_keys = int(mix["keys"])
    payloads = rng_for(seed, 45)
    keys = rng_for(seed, 46)
    return {
        "topic": topic,
        "publisher": rng_for(seed, 41).integers(0, n_peers, size=total),
        "forged": forged[:total],
        "payload": [payloads.bytes(64) for _ in range(total)],
        "key": idx % n_keys,
        "keys": [keys.bytes(32) for _ in range(n_keys)],
    }


def arrivals(mix: dict, seed: int, total: int) -> np.ndarray:
    """A steady mix's arrival times in seconds from the window's start
    (float64[total])."""
    phase = rng_for(seed, 42).random()
    return (np.arange(total) + phase) / float(mix["rate_msgs_per_s"])


def stretch_start(mix: dict, seed: int) -> int:
    """The window chunk at which the checked stretch starts."""
    lo, hi = mix["check_chunks"]
    return int(rng_for(seed, 43).integers(int(lo), int(hi) + 1))


def windows(mix: dict, seed: int, window: int) -> List[dict]:
    """The stream's first ``pool`` messages (at least one window) as
    consecutive windows of ``window``: ``keys`` (each message's signing
    key), ``payloads``, ``forged`` and ``topics``."""
    size = max(int(mix["pool"]), window) // window * window
    m = messages(mix, seed, size, 1)
    return [{"keys": [m["keys"][k] for k in m["key"][lo:lo + window]],
             "payloads": m["payload"][lo:lo + window],
             "forged": m["forged"][lo:lo + window],
             "topics": m["topic"][lo:lo + window]}
            for lo in range(0, size, window)]


def publishers(mix: dict, seed: int, episode: int, window: int,
               n_peers: int) -> np.ndarray:
    """The publishers of the messages of window ``episode``."""
    hi = (int(episode) + 1) * window
    return messages(mix, seed, hi, n_peers)["publisher"][hi - window:hi]
