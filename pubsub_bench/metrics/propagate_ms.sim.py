"""Median host ms of one round's ``GossipSub._propagate`` (the pend fold
and K1): the program's span ``round.propagate``, no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "round.propagate")
