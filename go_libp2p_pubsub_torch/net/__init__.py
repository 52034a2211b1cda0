"""Live host plane: asyncio TCP transport + the tree protocol over real
sockets, byte-compatible with the reference's JSON wire format (SURVEY.md
§2.2, §5.8).  The in-array simulated fabric lives in ``api.SimNetwork``.
Fault injection for this plane lives in :mod:`.chaos`; the retry/backoff
policy every control path runs under lives in :mod:`.policy`."""

from .chaos import ChaosStream, ChaosTransport, LinkPolicy, LinkPolicyTable
from .live import (
    LiveNetwork,
    LiveSubscription,
    LiveTopic,
    LiveTopicManager,
    SyncHost,
    SyncSubscription,
    SyncTopic,
)
from .policy import (
    CircuitBreaker,
    CircuitOpen,
    LiveCallTimeout,
    RetryPolicy,
)
from .transport import LiveHost, Peerstore, Stream, StreamClosed

__all__ = [
    "ChaosStream",
    "ChaosTransport",
    "CircuitBreaker",
    "CircuitOpen",
    "LinkPolicy",
    "LinkPolicyTable",
    "LiveCallTimeout",
    "LiveHost",
    "LiveNetwork",
    "LiveSubscription",
    "LiveTopic",
    "LiveTopicManager",
    "Peerstore",
    "RetryPolicy",
    "Stream",
    "StreamClosed",
    "SyncHost",
    "SyncSubscription",
    "SyncTopic",
]
