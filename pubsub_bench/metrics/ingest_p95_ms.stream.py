"""The 95th percentile, in ms, of the host time from a message's push into
the ring to the chunk boundary at which its completion was read, over the
messages completed in the window (the engine's ``latencies_s``)."""

import numpy as np


def read(records):
    latencies = records.get("latencies_s")
    if not latencies:
        return None
    return float(np.percentile(np.asarray(latencies), 95.0)) * 1e3
