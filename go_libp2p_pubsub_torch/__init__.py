"""PyTorch / CUDA port of the GossipSub simulator.

A second package beside ``go_libp2p_pubsub_tpu`` (the JAX reference, which
stays unchanged).  It imports ``torch`` and ``numpy``, never JAX.  Its
entry points run on the CUDA device unless the caller passes
``device="cpu"``; the two hot-loop kernels are hand-written CUDA for
Hopper (``csrc/gossip_kernels.cu``, wrapped in ``ops/cuda_gossip.py``).

Public API mirrors the reference's L3/L4 surface (``pubsub.go:19-120``,
``client.go:18-94``) over the tree engine: ``SimNetwork``,
``TopicManager``, ``Topic``, ``Subscription``, ``SimHost``; the wire codec
(``Message``, ``encode_message``, ``MessageDecoder``) is byte-compatible
with the reference's JSON frames, and ``net.LiveNetwork`` runs the same
tree protocol over loopback sockets.
"""

from .config import GossipSubParams, ScoreParams, SimParams, TreeOpts
from .wire import Message, MessageType, encode_message, decode_message, MessageDecoder
from .api import SimHost, SimNetwork, Subscription, Topic, TopicManager

__all__ = [
    "TreeOpts",
    "SimParams",
    "GossipSubParams",
    "ScoreParams",
    "Message",
    "MessageType",
    "encode_message",
    "decode_message",
    "MessageDecoder",
    "TopicManager",
    "Topic",
    "Subscription",
    "SimHost",
    "SimNetwork",
]
