"""Arithmetic shared by the per-layer metrics' readers (``metrics/``).

Each reader takes the traced run's records and returns a number, or None
when the records hold nothing for it (the metric is then left out).  A
share of a roofline is never made up: with no device time for the kernel
there is no share.
"""

from __future__ import annotations

import statistics
from typing import Optional


def span_median_ms(records: dict, span: str) -> Optional[float]:
    values = records.get("spans", {}).get(span)
    return statistics.median(values) * 1e3 if values else None


def roofline_pct(records: dict, kernel: str) -> Optional[float]:
    """The kernel's least time (``roofline/counts.py`` over the tapped
    launches) as a share of its device time in the trace, in %."""
    trace = records.get("trace")
    least = records.get("least_s", {}).get(kernel, 0.0)
    if not trace or least <= 0:
        return None
    device_s = trace["kernel_s"].get(kernel, 0.0)
    if device_s <= 0:
        return None
    return 100.0 * least / device_s


def launches_per_round(records: dict) -> Optional[float]:
    trace, rounds = records.get("trace"), records.get("rounds_traced", 0)
    if not trace or rounds <= 0:
        return None
    return trace["device_kernels"] / rounds


def device_idle_pct(records: dict) -> Optional[float]:
    trace = records.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
