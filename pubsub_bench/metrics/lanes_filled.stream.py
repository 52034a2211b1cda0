"""Publish lanes that carried a publish, over every lane of the window's
chunks, in %: the engine's counts ``StreamingEngine.lanes_filled`` and
``lanes_offered``."""


def read(records):
    counters = records.get("counters", {})
    offered = counters.get("lanes_offered", 0)
    if not offered:
        return None
    return 100.0 * counters["lanes_filled"] / offered
