"""Share of the traced window in which no device operation runs, in %."""

from pubsub_bench.harness import readers


def read(records):
    return readers.device_idle_pct(records)
