"""The program's own spans, read in a traced run.

``go_libp2p_pubsub_torch`` marks its layer boundaries with
``utils.trace.span`` (``publish``, ``round.propagate``,
``round.heartbeat``, ``heartbeat.mesh``, ``heartbeat.gossip``,
``round.record``, ...).  They record only while a ``StepTimer`` is the
process's recorder.  ``enable()`` sets one.  Each reader of a span metric
(``metrics/*.py``) calls it when it is imported, and ``run.py`` imports
the readers of a ``--trace 1`` run before the cell starts and none in a
``--trace 0`` run.  So the program records through the whole traced run
(set-up, the warm episode and every episode of the window, of which
three are profiled), and the untraced run, the one timed for the
end-to-end metrics, runs with every span off.

A span is host time: the enqueueing and launching of its device work,
and whatever synchronisation the program does itself; it never waits for
the device.  Its stamps are ``time.time_ns()``, the profiler's host clock.

A program without spans (no ``utils.trace.set_recorder``) records
nothing, and every span metric is left out.
"""

from __future__ import annotations

import statistics
from typing import Optional


def enable():
    """Make a fresh ``StepTimer`` the process's span recorder unless one
    is set; returns the recorder (None for a program without spans)."""
    from go_libp2p_pubsub_torch.utils import trace

    if not hasattr(trace, "set_recorder"):
        return None
    if trace.recorder() is None:
        trace.set_recorder(trace.StepTimer())
    return trace.recorder()


def median_ms(records: dict, span: str) -> Optional[float]:
    """The median host ms of the program's span ``span`` over the run,
    set-up included; None outside a traced run's records (no
    ``rounds_traced``), with no recorder, or with no such span."""
    from go_libp2p_pubsub_torch.utils import trace

    if "rounds_traced" not in records:
        return None
    timer = trace.recorder() if hasattr(trace, "recorder") else None
    if timer is None:
        return None
    seconds = timer.span_seconds(span)
    return statistics.median(seconds) * 1e3 if seconds else None
