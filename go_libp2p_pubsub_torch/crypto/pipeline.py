"""Batched message-validation pipeline.

The port of the JAX package's ``crypto/pipeline.py``: envelopes accumulate
and verify in one shot on the chosen backend --

- ``"native"``  — the C++ threaded batch verifier (host data plane default);
- ``"device"``  — ``ops/ed25519.verify_batch`` on the pipeline's device:
  kernel E1 on a CUDA card (the default ``device="cuda"``; without a card
  the flush raises after re-queueing), the plain PyTorch version on the CPU;
- ``"python"``  — the pure-Python oracle (tests, last-resort fallback).

Envelope format: the signature covers ``topic_len_u32 || topic ||
seqno_u64 || payload``, so a signature cannot be replayed across topics or
sequence numbers.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass
from typing import Callable, List, Literal, Sequence, Tuple

import numpy as np

from . import ed25519_ref
from ..obs.spans import envelope_span_key

Backend = Literal["native", "device", "python"]


def signing_bytes(topic: str, seqno: int, payload: bytes) -> bytes:
    """The exact byte string a publisher signs (domain-separated by topic and
    sequence number)."""
    t = topic.encode()
    return struct.pack("<I", len(t)) + t + struct.pack("<Q", seqno) + payload


@dataclass(frozen=True)
class Envelope:
    """A signed message as it travels the wire: payload + authenticator."""

    topic: str
    seqno: int
    payload: bytes
    pubkey: bytes  # 32B ed25519
    signature: bytes  # 64B

    def to_wire(self) -> bytes:
        # Header layout == signature domain (one definition, can't drift).
        return (
            signing_bytes(self.topic, self.seqno, b"")
            + self.pubkey
            + self.signature
            + self.payload
        )

    @classmethod
    def from_wire(cls, raw: bytes) -> "Envelope":
        (tlen,) = struct.unpack_from("<I", raw, 0)
        topic = raw[4 : 4 + tlen].decode()
        off = 4 + tlen
        (seqno,) = struct.unpack_from("<Q", raw, off)
        off += 8
        pubkey = raw[off : off + 32]
        signature = raw[off + 32 : off + 96]
        payload = raw[off + 96 :]
        return cls(topic, seqno, payload, pubkey, signature)


def sign_envelope(
    seed: bytes,
    topic: str,
    seqno: int,
    payload: bytes,
    backend: Literal["python", "native", "auto"] = "python",
) -> Envelope:
    """Publisher-side signing.  ``backend="python"`` uses the oracle (tests);
    ``"native"`` the C++ implementation; ``"auto"`` picks native when its
    build is available.  Batch signing lives in ``native.sign_batch``."""
    if backend == "auto":
        from . import native

        backend = "native" if native.available() else "python"
    if backend == "native":
        from . import native

        msg = signing_bytes(topic, seqno, payload)
        return Envelope(
            topic, seqno, payload, native.public_key(seed), native.sign(seed, msg)
        )
    pk = ed25519_ref.public_key(seed)
    sig = ed25519_ref.sign(seed, signing_bytes(topic, seqno, payload))
    return Envelope(topic, seqno, payload, pk, sig)


def _verify_native(pks, msgs, sigs, device) -> np.ndarray:
    from . import native

    return native.verify_batch(pks, msgs, sigs)


def _verify_device(pks, msgs, sigs, device) -> np.ndarray:
    from ..ops import ed25519 as dev

    # ladder=None / window=None take the measured defaults for the device.
    return dev.verify_batch(pks, msgs, sigs, ladder=None, device=device)


def _verify_python(pks, msgs, sigs, device) -> np.ndarray:
    return np.array(
        [ed25519_ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)], bool
    )


_BACKENDS: dict = {
    "native": _verify_native,
    "device": _verify_device,
    "python": _verify_python,
}


class ValidationPipeline:
    """Accumulate envelopes, verify in batches, deliver verdicts.

    Producers ``submit`` envelopes, the owner calls ``flush()`` at its
    cadence (heartbeat, step boundary, or queue-depth trigger), and verdicts
    come back as (envelope, bool) pairs in submit order.  ``device`` is
    where the ``"device"`` backend verifies (default ``"cuda"``).
    """

    def __init__(
        self,
        backend: Backend = "native",
        flush_threshold: int = 256,
        on_verdict: Callable[[Envelope, bool], None] | None = None,
        on_verdict_ctx: Callable[[Envelope, bool, object], None] | None = None,
        tracer=None,
        metrics=None,
        device="cuda",
    ) -> None:
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.flush_threshold = flush_threshold
        self.on_verdict = on_verdict
        self.on_verdict_ctx = on_verdict_ctx
        # An optional tracer (``stamp``/``close``) stamps
        # verify_submit/verify_verdict when ctx carries the streaming
        # plane's (topic, src) routing tuple; an optional metrics registry
        # (``inc``/``gauge``) gets verdict counters and the batch verify
        # wall time under ``crypto.pipeline.*``.
        self.tracer = tracer
        self.metrics = metrics
        self.device = device
        self._pending: List[Tuple[Envelope, object]] = []
        self.stats = {"validated": 0, "accepted": 0, "rejected": 0}

    def submit(self, env: Envelope, ctx: object = None) -> None:
        """Queue an envelope; ``ctx`` is opaque caller state (e.g. the
        streaming plane's routing tuple) handed back via ``on_verdict_ctx``
        so verdict delivery needs no side-channel lookup."""
        if self.tracer is not None:
            key = envelope_span_key(env.payload, ctx)
            if key is not None:
                self.tracer.stamp(key, "verify_submit",
                                  seqno=env.seqno, topic=env.topic)
        self._pending.append((env, ctx))
        if len(self._pending) >= self.flush_threshold:
            self.flush()

    def drop_pending(self) -> List[Envelope]:
        """Discard and return envelopes awaiting verification.

        For callers that keep their own copy of the batch: after a backend
        failure ``flush`` re-queues internally, and a caller that will retry
        by re-submitting must drop that requeue first or every envelope
        would be verified (and its ``on_verdict`` fired) twice.
        """
        dropped, self._pending = self._pending, []
        return [e for e, _ in dropped]

    def flush(self) -> List[Tuple[Envelope, bool]]:
        if not self._pending:
            return []
        pairs, self._pending = self._pending, []
        batch = [e for e, _ in pairs]
        # Structural screen BEFORE the backend call: a truncated/oversized key
        # or signature (attacker-crafted wire bytes) gets a False verdict —
        # it must not raise out of the batched backends and drop everyone
        # else's verdicts with it.
        well_formed = [
            len(e.pubkey) == 32 and len(e.signature) == 64 for e in batch
        ]
        good = [e for e, w in zip(batch, well_formed) if w]
        t_v0 = time.monotonic()
        try:
            verdicts = (
                _BACKENDS[self.backend](
                    [e.pubkey for e in good],
                    [signing_bytes(e.topic, e.seqno, e.payload) for e in good],
                    [e.signature for e in good],
                    self.device,
                )
                if good
                else []
            )
        except Exception:
            # Backend failure (no card, native build unavailable): re-queue
            # the batch so no envelope silently loses its verdict, then
            # propagate so the caller can pick another backend.
            self._pending = pairs + self._pending
            raise
        verify_s = time.monotonic() - t_v0
        oks_good = iter(verdicts)
        oks = np.array(
            [bool(next(oks_good)) if w else False for w in well_formed], bool
        )
        out = list(zip(batch, (bool(o) for o in oks)))
        self.stats["validated"] += len(batch)
        self.stats["accepted"] += int(np.sum(oks))
        self.stats["rejected"] += len(batch) - int(np.sum(oks))
        if self.metrics is not None:
            self.metrics.inc("crypto.pipeline.validated", len(batch))
            self.metrics.inc("crypto.pipeline.accepted", int(np.sum(oks)))
            self.metrics.inc(
                "crypto.pipeline.rejected", len(batch) - int(np.sum(oks))
            )
            self.metrics.gauge("crypto.pipeline.verify_s", verify_s)
            self.metrics.gauge("crypto.pipeline.batch", len(batch))
        if self.tracer is not None:
            for (env, ctx), ok in zip(pairs, oks):
                key = envelope_span_key(env.payload, ctx)
                if key is not None:
                    self.tracer.stamp(key, "verify_verdict", ok=bool(ok))
                    if not ok:
                        # A rejected envelope never publishes: its span
                        # ends here, explicitly, instead of dangling open.
                        self.tracer.close(key, status="rejected")
        if self.on_verdict is not None:
            for env, ok in out:
                self.on_verdict(env, ok)
        if self.on_verdict_ctx is not None:
            for (env, ctx), ok in zip(pairs, (bool(o) for o in oks)):
                self.on_verdict_ctx(env, ok, ctx)
        return out


def verify_envelopes(
    envs: Sequence[Envelope], backend: Backend = "native", device="cuda"
) -> np.ndarray:
    """One-shot batch verify of prepared envelopes -> bool[n]."""
    pks = [e.pubkey for e in envs]
    msgs = [signing_bytes(e.topic, e.seqno, e.payload) for e in envs]
    sigs = [e.signature for e in envs]
    return _BACKENDS[backend](pks, msgs, sigs, device)
