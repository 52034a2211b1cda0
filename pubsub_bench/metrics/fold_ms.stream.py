"""Median host ms of a chunk's completion fold (``_fold_completions`` over
the pending messages): the program's span ``stream.fold``, no
synchronise."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "stream.fold")
