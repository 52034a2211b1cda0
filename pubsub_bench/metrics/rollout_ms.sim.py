"""Median host ms of an episode's recorded rollout, ending in a synchronise."""

from pubsub_bench.harness import readers


def read(records):
    return readers.span_median_ms(records, "rollout")
