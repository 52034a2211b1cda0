"""Kernel K1's least time as a share of its device time in the traced episodes, in %."""

from pubsub_bench.harness import readers


def read(records):
    return readers.roofline_pct(records, "propagate")
