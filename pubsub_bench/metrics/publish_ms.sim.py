"""Median host ms of one ``GossipSub.publish`` call: the program's span
``publish``, no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "publish")
