"""Structured logging: the ``go-log`` "pubsub" logger, done host-side.

The reference logs through a package-level ``go-log`` logger named
``"pubsub"`` (``client.go:16``) with ~20 Error/Info call sites and no
structure (SURVEY.md §5.5).  The framework's device engines never log (pure
functions); the host plane (live transport, API layer, benchmarks) logs here
— stdlib ``logging`` with a key=value formatter so lines stay grep-able and
machine-parseable.
"""

from __future__ import annotations

import logging
import sys
from typing import Any

_CONFIGURED = False


class _KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        kvs = getattr(record, "kv", None)
        if kvs:
            pairs = " ".join(f"{k}={v}" for k, v in sorted(kvs.items()))
            return f"{base} {pairs}"
        return base


def get_logger(name: str = "pubsub") -> logging.Logger:
    """A logger under the ``pubsub`` hierarchy; idempotent handler setup.

    Any requested name is rooted under ``pubsub`` (``get_logger("bench")``
    -> ``pubsub.bench``) so every framework logger shares the one configured
    handler instead of silently propagating to a handler-less root.
    """
    global _CONFIGURED
    if name != "pubsub" and not name.startswith("pubsub."):
        name = f"pubsub.{name}"
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _KVFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root = logging.getLogger("pubsub")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logger


def kv(**fields: Any) -> dict:
    """Structured-field helper: ``log.info("joined", extra=kv(peer=3))``."""
    return {"kv": fields}
