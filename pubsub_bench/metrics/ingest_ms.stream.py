"""Median host ms of a chunk's ingest (the ring's pop, the window slots,
the event rows): the program's span ``stream.ingest``, no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "stream.ingest")
