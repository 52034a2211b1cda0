"""Span identities of the observability plane.

The port's copy of ``content_hash`` and ``envelope_span_key`` from the JAX
package's ``obs/spans.py``: the validation pipeline
(``crypto/pipeline.py``) stamps a tracer under these keys.  The span
ledger itself is not ported; a pipeline's ``tracer`` is any object with
``stamp(key, stage, **attrs)`` and ``close(key, status=...)``.
"""

from __future__ import annotations

import hashlib
from typing import Optional


def content_hash(topic: int, publisher: int, payload: bytes) -> str:
    """Stable identity of a publish for exactly-once dedup (hex).  Keyed on
    content, not ring seq — a resubmitted message gets a fresh seq but the
    same hash."""
    h = hashlib.sha256()
    h.update(int(topic).to_bytes(4, "little"))
    h.update(int(publisher).to_bytes(8, "little"))
    h.update(payload)
    return h.hexdigest()[:32]


def envelope_span_key(payload: bytes, ctx: object) -> Optional[str]:
    """Span key for a pipeline envelope.  The streaming plane's routing
    ``ctx`` is ``(topic, src)``, which together with the payload is exactly
    the engine's content identity; any other ctx shape has no span."""
    if isinstance(ctx, (tuple, list)) and len(ctx) == 2:
        try:
            return content_hash(int(ctx[0]), int(ctx[1]), payload)
        except (TypeError, ValueError):
            return None
    return None
