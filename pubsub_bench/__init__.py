"""The benchmark of go_libp2p_pubsub_torch on an NVIDIA H100 (see run.py)."""
