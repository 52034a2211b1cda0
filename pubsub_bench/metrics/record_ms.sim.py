"""Median host ms of one round of the flight recorder (the histogram
increment and ``flight_record_round``): the program's span
``round.record``, no synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "round.record")
