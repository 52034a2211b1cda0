"""How ``profile_rollout`` puts device time down to the program's spans,
on a hand-built trace: a kernel counts in every span open on the host at
its launch call's stamp (found through the correlation id), once a name;
an idle gap goes to the innermost span open at its midpoint."""

from types import SimpleNamespace

import pytest

from go_libp2p_pubsub_torch.profile_rollout import (
    _idle_by_span, _range_device_ms, _trace_events)

US = 1000   # ns


def _spans():
    """A rollout (0-1000 µs) of two rounds (K1 launched at 110 and 410
    µs) and a heartbeat (600-900 µs, K2 launched at 700 µs) whose gossip
    part holds K2; a publish after the rollout (1100-1200 µs)."""
    return [
        ("rollout", 0, 1000 * US, -1, 0),
        ("round.propagate", 100 * US, 300 * US, 0, 0),
        ("kernel.k1", 105 * US, 120 * US, 1, None),
        ("round.propagate", 400 * US, 500 * US, 0, 1),
        ("kernel.k1", 405 * US, 420 * US, 3, None),
        ("round.heartbeat", 600 * US, 900 * US, 0, 1),
        ("heartbeat.gossip", 650 * US, 800 * US, 5, 1),
        ("kernel.k2", 690 * US, 710 * US, 6, None),
        None,                              # still open: skipped
        ("publish", 1100 * US, 1200 * US, -1, 2),
    ]


# (name, correlation id, device start, device end), and the launch calls'
# host stamps by correlation id.
DEVICE = [
    ("void propagate_kernel<4>(int)", 1, 150 * US, 180 * US),
    ("aten_fill", 2, 200 * US, 1200 * US),     # launched in round 1
    ("void propagate_kernel<4>(int)", 3, 450 * US, 490 * US),
    ("exchange_kernel<4>", 4, 720 * US, 740 * US),
    ("aten_sum", 5, 1150 * US, 1160 * US),     # launched by publish
    ("Memcpy DtoD", 6, 1300 * US, 1310 * US),  # launched after every span
    ("orphan", 7, 0, 5 * US),                  # no launch call in the trace
]
LAUNCHES = {1: 110 * US, 2: 200 * US, 3: 410 * US, 4: 700 * US,
            5: 1150 * US, 6: 1250 * US}


def test_kernels_count_in_every_span_open_at_their_launch():
    ranges = _range_device_ms(DEVICE, LAUNCHES, _spans())
    ms = {name: r["device_ms"] for name, r in ranges.items()}
    assert ms == pytest.approx({
        "rollout": 0.030 + 1.0 + 0.040 + 0.020,
        "round.propagate": 0.030 + 1.0 + 0.040,
        "kernel.k1": 0.070, "round.heartbeat": 0.020,
        "heartbeat.gossip": 0.020, "kernel.k2": 0.020, "publish": 0.010})
    assert {name: r["calls"] for name, r in ranges.items()} == {
        "rollout": 1, "round.propagate": 2, "kernel.k1": 2,
        "round.heartbeat": 1, "heartbeat.gossip": 1, "kernel.k2": 1,
        "publish": 1}


def test_a_kernel_counts_once_a_name_and_unlinked_ones_nowhere():
    # A span nested in one of its own name (a wrapper calling the same
    # layer) does not count the kernel twice.
    spans = [("rollout", 0, 500 * US, -1, 0),
             ("rollout", 100 * US, 200 * US, 0, 0)]
    device = [("k", 1, 150 * US, 170 * US), ("k", 2, 300 * US, 310 * US),
              ("k", 3, 400 * US, 900 * US)]
    ranges = _range_device_ms(device, {1: 150 * US, 2: 300 * US}, spans)
    assert ranges == {"rollout": {"device_ms": pytest.approx(0.030),
                                  "calls": 2}}
    assert _range_device_ms(device, {}, spans)["rollout"]["device_ms"] == 0


def test_idle_gaps_go_to_the_innermost_span_at_their_midpoint():
    idle = _idle_by_span(DEVICE, _spans(), 0, 1400 * US)
    # Busy: 0-5, 150-180, 200-1200, 1300-1310 µs.  Gaps: 5-150 (mid 77:
    # the rollout), 180-200 (190: round 1), 1200-1300 (1250: no span),
    # 1310-1400 (1355: no span).
    assert idle["total_ms"] == pytest.approx({
        "rollout": 0.145, "round.propagate": 0.020,
        "outside_spans": 0.100 + 0.090})
    assert idle["longest"] == [
        ["rollout", pytest.approx(0.145)],
        ["outside_spans", pytest.approx(0.100)],
        ["outside_spans", pytest.approx(0.090)],
        ["round.propagate", pytest.approx(0.020)]]
    # Clipped to the window; with no span every gap is outside.
    none = _idle_by_span(DEVICE, [], 100 * US, 250 * US)
    assert none["total_ms"] == pytest.approx({"outside_spans": 0.070})


class _Kineto:
    def __init__(self, name, cuda, corr, start, dur):
        self._v = (name, cuda, corr, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


@pytest.mark.parametrize("launch", ["cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaMemcpyAsync"])
def test_trace_events_pair_device_work_with_its_launch_call(launch):
    events = [
        _Kineto("propagate_kernel<4>", True, 9, 5000, 300),
        _Kineto(launch, False, 9, 4000, 50),
        _Kineto("aten::add", False, 9, 3900, 200),   # an op, not a launch
        _Kineto("rollout", False, 0, 0, 9000),
        _Kineto("empty_marker", True, 11, 6000, 0),  # no duration
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    device, launches = _trace_events(prof)
    assert device == [("propagate_kernel<4>", 9, 5000, 5300)]
    assert launches == {9: 4000}
