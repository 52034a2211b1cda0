"""Kernels in the traced window over the rounds simulated in it."""

from pubsub_bench.harness import readers


def read(records):
    return readers.launches_per_round(records)
