"""Median host ms of one ``StreamingEngine.run_chunk`` (its ingest, the
chunk program's rollout, the digest read, which waits for the chunk's
device work, and the completion fold): the program's span
``stream.chunk``."""

from pubsub_bench.harness import program_spans

program_spans.enable()


def read(records):
    return program_spans.median_ms(records, "stream.chunk")
