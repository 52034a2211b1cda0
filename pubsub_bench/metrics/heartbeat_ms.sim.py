"""Median host ms of one ``GossipSub._heartbeat``: the program's span
``round.heartbeat``, no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "round.heartbeat")
