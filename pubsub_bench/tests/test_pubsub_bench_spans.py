"""The six readers of the program's spans (``metrics/*_ms.sim.py`` over
``harness/program_spans.py``), on the CPU.

Run from the repository's root: ``python -m pytest pubsub_bench/tests -q``.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pubsub_bench import run as bench_run  # noqa: E402
from pubsub_bench.harness import (  # noqa: E402
    closed_loop, common, program_spans, registry)

from go_libp2p_pubsub_torch.utils import trace  # noqa: E402

READERS = {"publish_ms.sim": "publish",
           "propagate_ms.sim": "round.propagate",
           "heartbeat_ms.sim": "round.heartbeat",
           "hb_mesh_ms.sim": "heartbeat.mesh",
           "hb_gossip_ms.sim": "heartbeat.gossip",
           "record_ms.sim": "round.record"}


def test_readers_on_synthetic_recorder_data():
    readers = {m: registry.metric_reader(m) for m in READERS}
    timer = trace.recorder()
    assert timer is not None                     # importing turned it on
    ms = {"publish": [1.0, 3.0, 2.0], "round.propagate": [4.0, 5.0],
          "round.heartbeat": [30.0], "heartbeat.mesh": [7.0, 9.0, 8.0],
          "heartbeat.gossip": [12.0, 10.0, 11.0, 13.0]}
    t = 10**18
    for name, values in ms.items():
        for v in values:
            timer.spans.append((name, t, t + int(v * 1e6), -1, None))
            t += 10**9
    timer.spans.append(None)                     # a span still open
    rec = {"rounds_traced": 48}
    for metric, span in READERS.items():
        want = statistics.median(ms[span]) if span in ms else None
        got = readers[metric](rec)
        assert got == (None if want is None else pytest.approx(want)), metric
    # ``round.record`` holds nothing: None, not 0.  Records of a run that
    # traced nothing give None whatever the recorder holds.
    assert readers["record_ms.sim"](rec) is None
    for metric in READERS:
        assert readers[metric]({}) is None
        assert readers[metric]({"spans": {"publish": [0.1]}}) is None
    trace.set_recorder(None)
    assert readers["publish_ms.sim"](rec) is None


def test_a_program_without_spans_leaves_the_metrics_out(monkeypatch):
    monkeypatch.delattr(trace, "set_recorder")
    monkeypatch.delattr(trace, "recorder")
    assert program_spans.enable() is None
    reader = registry.metric_reader("publish_ms.sim")
    assert reader({"rounds_traced": 24}) is None


@pytest.mark.parametrize("traced", [0, 1])
def test_only_a_traced_run_turns_the_spans_on(traced, monkeypatch):
    def no_card(chips):
        raise common.RunError("no card")

    monkeypatch.setattr(common, "require_cards", no_card)
    trace.set_recorder(None)
    rc = bench_run.main(["--workload", "gs100k_closed_loop", "--seed", "5",
                         "--seconds", "1", "--trace", str(traced)])
    assert rc == 2
    assert (trace.recorder() is not None) == bool(traced)


def test_a_traced_cpu_run_reads_all_six():
    from test_pubsub_bench_faults import _config

    readers = {m: registry.metric_reader(m) for m in READERS}
    cfg = _config("gossipsub_v11_100k", rollout_rounds=16, msg_window=32)
    mix = {"generator": "episodes", "pool": 2, "forged": 2,
           "check_episodes": 1}
    out = closed_loop.run(dict(
        config=cfg, traffic=mix, seed=2**33 + 5, seconds=0.5, trace=1,
        dev=torch.device("cpu"), card={"kind": "cpu", "sms": 1,
                                       "max_sm_clock_mhz": None},
        t_start=time.perf_counter()))
    assert all(common.check_passes(c) for c in out["checks"])
    values = {m: r(out["records"]) for m, r in readers.items()}
    assert all(v is not None and v > 0 for v in values.values()), values
    timer = trace.recorder()
    assert timer.dropped == 0
    # The warm episode and every one of the window's: 32 publishes, 16
    # rounds and 2 heartbeats an episode, after init's 3 warm heartbeats.
    episodes = out["attempted"] + 1
    count = {s: len(timer.span_seconds(s)) for s in READERS.values()}
    assert count == {"publish": 32 * episodes,
                     "round.propagate": 16 * episodes,
                     "round.heartbeat": 3 + 2 * episodes,
                     "heartbeat.mesh": 3 + 2 * episodes,
                     "heartbeat.gossip": 3 + 2 * episodes,
                     "round.record": 16 * episodes}
