"""PyTorch / CUDA port of the GossipSub simulator.

A second package beside ``go_libp2p_pubsub_tpu`` (the JAX reference, which
stays unchanged).  It imports ``torch`` and ``numpy``, never JAX.  Its
entry points run on the CUDA device unless the caller passes
``device="cpu"``; the two hot-loop kernels are hand-written CUDA for
Hopper (``csrc/gossip_kernels.cu``, wrapped in ``ops/cuda_gossip.py``).
"""
