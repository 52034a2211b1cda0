"""Median host ms of the heartbeat's mesh maintenance (``heartbeat_mesh``
and the graft and prune counters): the program's span ``heartbeat.mesh``,
no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "heartbeat.mesh")
