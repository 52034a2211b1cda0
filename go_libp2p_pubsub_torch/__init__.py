"""PyTorch / CUDA port of the GossipSub simulator.

A second package beside ``go_libp2p_pubsub_tpu`` (the JAX reference, which
stays unchanged).  It imports ``torch`` and ``numpy``, never JAX.  Its
entry points run on the CUDA device unless the caller passes
``device="cpu"``; the two hot-loop kernels are hand-written CUDA for
Hopper (``csrc/gossip_kernels.cu``, wrapped in ``ops/cuda_gossip.py``).

Public API mirrors the reference's L3/L4 surface (``pubsub.go:19-120``,
``client.go:18-94``) over the tree engine: ``SimNetwork``,
``TopicManager``, ``Topic``, ``Subscription``, ``SimHost``.
"""

from .config import GossipSubParams, ScoreParams, SimParams, TreeOpts
from .api import SimHost, SimNetwork, Subscription, Topic, TopicManager

__all__ = [
    "TreeOpts",
    "SimParams",
    "GossipSubParams",
    "ScoreParams",
    "TopicManager",
    "Topic",
    "Subscription",
    "SimHost",
    "SimNetwork",
]
