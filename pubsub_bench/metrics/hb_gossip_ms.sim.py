"""Median host ms of the heartbeat's IHAVE/IWANT exchange
(``exchange_prep``, K2, the P7 charges): the program's span
``heartbeat.gossip``, no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "heartbeat.gossip")
