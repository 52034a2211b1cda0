"""The comparison that decides ``correct``, driven on the CPU at a small size.

The closed loop's driver runs its whole run here (set-up, window, the
program's outputs against the plain reference) on the CPU, past the
harness's look for a card.  A sound program reads ``correct``; the control (the
reference in bfloat16, in the program's place) and each fault planted in
the timed path underneath read not correct.

Run from the repository's root: ``python -m pytest pubsub_bench/tests -q``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pubsub_bench.harness import closed_loop, common  # noqa: E402

SMALL = dict(n_peers=300, n_slots=16, conn_degree=8, msg_window=32)


def _config(name, **over):
    with open(os.path.join(ROOT, "pubsub_bench", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL, **over)
    return cfg


def _run(driver, cfg, mix, seconds, **extra):
    out = driver.run(dict(
        config=cfg, traffic=mix, seed=2**31 + 77, seconds=seconds, trace=0,
        dev=torch.device("cpu"), card={"kind": "cpu", "sms": 1,
                                       "max_sm_clock_mhz": None},
        t_start=time.perf_counter(), **extra))
    return all(common.check_passes(c) for c in out["checks"]), out


def closed(**extra):
    cfg = _config("gossipsub_v11_100k", rollout_rounds=8)
    mix = {"generator": "episodes", "pool": 2, "forged": 2,
           "check_episodes": 2}
    return _run(closed_loop, cfg, mix, 0.5, **extra)


def _failed(out):
    return {c["name"] for c in out["checks"] if not common.check_passes(c)}


# -- sound runs --------------------------------------------------------------------


def test_closed_loop_program_equals_reference():
    ok, out = closed()
    assert ok, _failed(out)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["e2e"]["validated_msgs_per_s"] > 0


# -- the control ------------------------------------------------------------------


def test_the_control_is_not_correct():
    ok, out = closed(control=True)
    assert not ok
    assert "float_gap" in _failed(out)


# -- faults in the timed path --------------------------------------------------


def _unchanged_step(self, st, with_receipts=False):
    """A round that returns its state unchanged (but for the round count)."""
    out = st._replace(step=st.step + 1)
    return (out, torch.zeros(self.m, dtype=torch.int32)) if with_receipts \
        else out


def test_closed_loop_step_returning_its_state_unchanged(monkeypatch):
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub

    ok, _ = closed()                       # build the start state first
    assert ok
    monkeypatch.setattr(GossipSub, "_step_wide", _unchanged_step)
    ok, out = closed()
    assert not ok and "episode_mismatches" in _failed(out)


def test_closed_loop_half_the_window_left_out(monkeypatch):
    from go_libp2p_pubsub_torch.models.gossipsub import GossipSub

    publish = GossipSub.publish

    def half(self, st, src, slot, valid):
        return st if slot % 2 else publish(self, st, src, slot, valid)

    monkeypatch.setattr(GossipSub, "publish", half)
    ok, out = closed()
    assert not ok and "episode_mismatches" in _failed(out)


def test_closed_loop_verdict_altered(monkeypatch):
    from go_libp2p_pubsub_torch.crypto.pipeline import ValidationPipeline

    flush = ValidationPipeline.flush

    def flipped(self):
        out = flush(self)
        return [(e, not v) if i == 0 else (e, v) for i, (e, v) in
                enumerate(out)]

    monkeypatch.setattr(ValidationPipeline, "flush", flipped)
    ok, out = closed()
    assert not ok
    assert {"verdict_mismatches", "verdicts_vs_forged_set"} <= _failed(out)


def test_closed_loop_delivery_altered_in_k1(monkeypatch):
    from go_libp2p_pubsub_torch.ops import cuda_gossip

    propagate = cuda_gossip.propagate

    def dropped(*args, **kw):
        out = propagate(*args, **kw)
        have = out.have_w.clone()
        have[0] = 0
        return out._replace(have_w=have)

    monkeypatch.setattr(cuda_gossip, "propagate", dropped)
    ok, out = closed()
    assert not ok and "episode_mismatches" in _failed(out)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gs100k_closed_loop"])
def test_a_short_run_of_the_cell_is_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "pubsub_bench/run.py", "--workload", cell,
         "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gs100k_closed_loop"])
def test_the_control_is_not_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "pubsub_bench/control.py", "--workload", cell,
         "--seed", str(2**31 + 4), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not line["correct"]
