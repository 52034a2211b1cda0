"""Median host ms of an episode's device validation (submit, flush, verdicts on the host)."""

from pubsub_bench.harness import readers


def read(records):
    return readers.span_median_ms(records, "validate")
