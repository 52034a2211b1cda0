"""Signed envelopes made from the seed, in bulk, during set-up.

The keys and payloads come from the seed; the signatures from the port's
native signer (``crypto/native.py``, one batched call), which is the
publisher's side of the system.  A forged envelope is tampered after
signing, so its signature must fail.  The reference verifies what it
checks with its own ed25519 (``reference/ed25519.py``) and never reads a
verdict the program made.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

from .common import rng_for


class Signed(NamedTuple):
    topic: str
    seqno: int
    payload: bytes
    pubkey: bytes
    signature: bytes
    forged: bool


def _sign(topics: Sequence[str], seqnos: Sequence[int],
          payloads: Sequence[bytes], keys: Sequence[bytes],
          forged: Sequence[bool]) -> List[Signed]:
    from go_libp2p_pubsub_torch.crypto import native

    msgs = [native.signing_bytes(t, s, p)
            for t, s, p in zip(topics, seqnos, payloads)]
    pks = native.public_key_batch(list(keys))
    sigs = native.sign_batch(list(keys), msgs)
    out = []
    for t, s, p, pk, sig, bad in zip(topics, seqnos, payloads, pks, sigs,
                                     forged):
        if bad:
            p = bytes([p[0] ^ 0xFF]) + p[1:]
        out.append(Signed(t, int(s), p, pk, sig, bool(bad)))
    return out


def sign_windows(contents: Sequence[dict], topic: str = "bench"
                 ) -> List[List[Signed]]:
    """Each window of a generator's ``windows`` signed, the forged
    envelopes tampered after signing."""
    out = []
    for w, c in enumerate(contents):
        size = len(c["keys"])
        out.append(_sign([topic] * size,
                         [w * size + i for i in range(size)],
                         c["payloads"], c["keys"], c["forged"]))
    return out


def to_envelope(s: Signed):
    """The program's envelope type for one signed message."""
    from go_libp2p_pubsub_torch.crypto.pipeline import Envelope

    return Envelope(s.topic, s.seqno, s.payload, s.pubkey, s.signature)


def expected_verdicts(window: Sequence[Signed]) -> np.ndarray:
    return np.array([not s.forged for s in window])


def topology(seed: int, n: int, k: int, degree: int):
    """The deployment's connection graph, made from the seed: the union of
    ``degree`` random pairings of the peers (a pair drawn twice is one
    connection), each connection dialled by a random end.  A peer's
    connections fill its first slots in the order of the sorted list of
    connections.  Returns (nbrs, rev, nbr_valid, outbound) [n, k]: the
    remote of each slot (-1 when empty), the remote's slot pointing back,
    and whether the slot is wired and was dialled by this peer."""
    if degree >= k:
        raise ValueError(f"degree {degree} must be below the {k} slots")
    rng = rng_for(seed, 30)
    pairs = []
    for _ in range(degree):
        perm = rng.permutation(n)
        a, b = perm[0:n - 1:2], perm[1:n:2]
        pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], 1))
    edges = np.unique(np.concatenate(pairs), axis=0)
    dialled_by_first = rng.integers(0, 2, len(edges)).astype(bool)
    e = len(edges)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    dials = np.concatenate([dialled_by_first, ~dialled_by_first])
    order = np.argsort(src, kind="stable")
    first_of = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))])
    slot = np.empty(2 * e, np.int64)
    slot[order] = np.arange(2 * e) - first_of[src[order]]
    partner = np.concatenate([np.arange(e, 2 * e), np.arange(e)])
    nbrs = np.full((n, k), -1, np.int64)
    rev = np.full((n, k), -1, np.int64)
    outbound = np.zeros((n, k), bool)
    nbrs[src, slot] = dst
    rev[src, slot] = slot[partner]
    outbound[src, slot] = dials
    return nbrs, rev, nbrs >= 0, outbound


class TopologyBuilder:
    """The program's topology hook (``GossipSub(builder=...)``): hands it
    the benchmark's graph, the same one the reference is given."""

    def __init__(self, graph):
        self.graph = graph

    def __call__(self, _rng, n, k, degree):
        nbrs = self.graph[0]
        if nbrs.shape != (n, k):
            raise ValueError(f"the graph is {nbrs.shape}, the model {n}x{k}")
        return tuple(a.copy() for a in self.graph)
