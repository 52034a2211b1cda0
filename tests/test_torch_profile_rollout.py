"""How ``profile_rollout`` attributes device time to its ranges, on a
hand-built trace: kernels the trace links to a CPU event count in every
range around that event, and the port's ctypes-launched kernels, which a
trace may link to nothing, count in the ranges around their wrapper's
call, matched in launch order."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from go_libp2p_pubsub_torch.profile_rollout import _range_device_ms

LABELS = ["gossip_propagate", "gossip_exchange", "_propagate", "_heartbeat"]


def _cpu(name, start, parent=None, kernels=()):
    """A CPU range; ``kernels`` are (name, µs) the trace links to it."""
    e = SimpleNamespace(
        name=name, device_type=DeviceType.CPU, cpu_parent=parent,
        cpu_children=[], time_range=SimpleNamespace(start=start),
        kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def _total(e):
    return (sum(k.duration for k in e.kernels)
            + sum(_total(c) for c in e.cpu_children))


def _device(name, start, us):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA,
        time_range=SimpleNamespace(start=start, elapsed_us=lambda: us))


def _trace(link_port_kernels: bool):
    """Two rounds (K1 of 30 and 40 µs) and one heartbeat (K2 of 20 µs),
    each half with an aten kernel of 1000 µs linked to it."""
    cpu, dev = [], []
    for r, (t0, k1_us) in enumerate(((0, 30.0), (100, 40.0))):
        prop = _cpu("_propagate", t0, kernels=[("aten_fill", 1000.0)])
        name = f"void propagate_kernel<4>(int) #{r}"
        k1 = _cpu("gossip_propagate", t0 + 1, prop,
                  kernels=[(name, k1_us)] if link_port_kernels else [])
        cpu += [prop, k1]
        dev.append(_device(name, t0 + 50, k1_us))
    beat = _cpu("_heartbeat", 200, kernels=[("aten_index_add", 1000.0)])
    k2 = _cpu("gossip_exchange", 201, beat,
              kernels=[("exchange_kernel<4>", 20.0)]
              if link_port_kernels else [])
    cpu += [beat, k2]
    dev.append(_device("exchange_kernel<4>", 250, 20.0))
    for e in cpu:
        e.device_time_total = _total(e)
    return cpu + dev


@pytest.mark.parametrize("linked", [False, True])
def test_port_kernels_count_in_the_ranges_around_their_wrapper(linked):
    ranges, port = _range_device_ms(_trace(linked), LABELS)
    ms = {label: r["device_ms"] for label, r in ranges.items()}
    assert ms == pytest.approx({
        "gossip_propagate": 0.070, "gossip_exchange": 0.020,
        "_propagate": 2.070, "_heartbeat": 1.020})
    assert {label: r["calls"] for label, r in ranges.items()} == {
        "gossip_propagate": 2, "gossip_exchange": 1, "_propagate": 2,
        "_heartbeat": 1}
    assert port == {
        "gossip_propagate": {"launches": 2, "linked": 2 if linked else 0},
        "gossip_exchange": {"launches": 1, "linked": 1 if linked else 0}}


def test_launches_that_do_not_match_the_wrapper_calls_are_refused():
    events = _trace(False)
    extra = _device("void propagate_kernel<4>(int)", 400, 10.0)
    with pytest.raises(SystemExit, match="cannot attribute"):
        _range_device_ms(events + [extra], LABELS)
