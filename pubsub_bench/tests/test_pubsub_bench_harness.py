"""CPU tests of the benchmark's harness (``pubsub_bench/``).

Run from the repository's root:

    python -m pytest pubsub_bench/tests -q

The tests that need the card carry the ``cuda`` marker and skip here.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pubsub_bench.harness import (  # noqa: E402
    common, inputs, readers, registry, tracing)
from pubsub_bench.roofline import counts  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per")


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark()


# -- BENCHMARK.json against the contract --------------------------------------


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "pubsub_bench/run.py"]
    assert bench["paths"] == ["pubsub_bench"]
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_benchmark_entries_have_only_the_contracts_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pubsub_bench/")
        for k in c["reduced"]:
            assert not any(w in k for w in WIDTH_WORDS)
            assert not k.endswith(("_dim", "_rank"))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for text in ([c["source"] for c in bench["configs"]]
                 + [c["why"] for c in bench["configs"]]):
        assert 1 <= len(text) <= 200 and "\t" not in text


def test_every_cell_reports_what_the_contract_asks(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in names
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_run_seconds_fit_the_full_check(bench):
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51 and rs == int(rs)
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_config_files_hold_the_configurations(bench):
    from go_libp2p_pubsub_torch.config import GossipSubParams, ScoreParams

    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    folder = os.path.join(ROOT, "pubsub_bench", "configs")
    for name in sorted(os.listdir(folder)):
        cfg = registry.data_file("configs", name[:-len(".json")])
        assert cfg["name"] + ".json" == name
        assert cfg["n_peers"] == 100_000 and cfg["reduced"] == []
        assert "assumed" in cfg and "guarantees" in cfg
        assert registry.driver(cfg).run
        GossipSubParams(**cfg["params"])
        ScoreParams(**cfg["score_params"])


def test_every_reader_and_mix_file_loads():
    folder = os.path.join(ROOT, "pubsub_bench", "metrics")
    names = [f[:-3] for f in sorted(os.listdir(folder)) if f.endswith(".py")]
    assert len(names) >= 7
    for name in names:
        assert NAME.match(name)
        assert registry.metric_reader(name)({}) is None
    folder = os.path.join(ROOT, "pubsub_bench", "traffic")
    mixes = [f[:-5] for f in sorted(os.listdir(folder))
             if f.endswith(".json")]
    assert mixes
    for mix in mixes:
        gen = registry.generator(registry.data_file("traffic", mix))
        assert callable(gen.windows) and callable(gen.publishers)


# -- found by name, unknown names refused ---------------------------------------


def test_registry_finds_each_cell_and_refuses_unknown_names(bench):
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        assert registry.driver(cell["config"]).run
        for m in cell["per_layer"]:
            assert callable(registry.metric_reader(m["name"]))
    with pytest.raises(common.RunError):
        registry.cell("no_such_cell", bench)
    with pytest.raises(common.RunError):
        registry.metric_reader("no_such_metric")
    with pytest.raises(common.RunError):
        registry.driver({"driver": "no_such_driver"})
    with pytest.raises(common.RunError):
        registry.generator({"generator": "no_such_generator"})
    with pytest.raises(common.RunError):
        registry.generator({"pool": 16})
    broken = dict(bench, workloads=[dict(bench["workloads"][0],
                                         traffic="no_such_mix")])
    with pytest.raises(common.RunError):
        registry.cell(bench["workloads"][0]["name"], broken)


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "pubsub_bench/run.py", "--workload",
         "gs100k_closed_loop", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no card" in proc.stderr


def test_run_refuses_an_unknown_cell():
    proc = subprocess.run(
        [sys.executable, "pubsub_bench/run.py", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


# -- the generator --------------------------------------------------------------


def _mix(name):
    with open(os.path.join(ROOT, "pubsub_bench", "traffic",
                           f"{name}.json")) as f:
        return json.load(f)


def test_episode_windows_are_seeded_and_hold_the_stated_forgeries():
    mix = _mix("signed_windows")
    gen = registry.generator(mix)
    seed = 2**31 + 12345
    a = gen.windows(mix, seed, 128)
    b = gen.windows(mix, seed, 128)
    c = gen.windows(mix, seed + 1, 128)
    assert len(a) == mix["pool"]
    for wa, wb, wc in zip(a, b, c):
        assert wa["keys"] == wb["keys"] and wa["payloads"] == wb["payloads"]
        assert np.array_equal(wa["forged"], wb["forged"])
        assert wa["keys"] != wc["keys"]
        for w in (wa, wc):
            assert int(w["forged"].sum()) == mix["forged"]
            assert len(w["keys"]) == len(w["payloads"]) == 128
            assert all(len(k) == 32 for k in w["keys"])


def test_episode_publishers_are_seeded():
    mix = _mix("signed_windows")
    gen = registry.generator(mix)
    a = gen.publishers(mix, 9, 3, 128, 100_000)
    assert np.array_equal(a, gen.publishers(mix, 9, 3, 128, 100_000))
    assert not np.array_equal(a, gen.publishers(mix, 9, 4, 128, 100_000))
    assert not np.array_equal(a, gen.publishers(mix, 10, 3, 128, 100_000))
    assert a.min() >= 0 and a.max() < 100_000


@pytest.mark.parametrize("n,k,degree", [(300, 16, 8), (5001, 32, 16)])
def test_topology_is_seeded_paired_and_dialled_from_one_end(n, k, degree):
    nbrs, rev, valid, outbound = inputs.topology(77, n, k, degree)
    again = inputs.topology(77, n, k, degree)
    assert all(np.array_equal(x, y) for x, y in
               zip((nbrs, rev, valid, outbound), again))
    assert not np.array_equal(nbrs, inputs.topology(78, n, k, degree)[0])
    i, s = np.nonzero(valid)
    j, r = nbrs[i, s], rev[i, s]
    assert np.array_equal(nbrs[j, r], i) and np.array_equal(rev[j, r], s)
    assert np.all(outbound[i, s] != outbound[j, r])
    assert np.all(j != i)
    assert len(set(zip(i.tolist(), j.tolist()))) == len(i)   # no multi-edge
    deg = valid.sum(1)
    assert deg.max() <= degree and deg.mean() > 0.95 * degree
    # A peer's connections fill its first slots.
    assert np.array_equal(valid, np.arange(k)[None, :] < deg[:, None])
    assert np.all(nbrs[~valid] == -1) and not outbound[~valid].any()


def test_seeds_past_32_bits_and_below_zero():
    for s in (0, 2**31 + 5, 2**40, -3):
        words = common.seed_words(s)
        assert all(w >= 0 for w in words)
        assert 0 <= common.model_seed(s) < 2**32
    assert common.seed_words(2**32 + 1) != common.seed_words(1)


# -- the metric arithmetic ------------------------------------------------------


def test_validated_rate_falls_with_a_stall():
    from pubsub_bench.harness.closed_loop import validated_rate

    delivered = [12.4e6] * 50
    assert validated_rate(delivered, 10.0) == pytest.approx(62e6)
    assert validated_rate(delivered, 12.0) < validated_rate(delivered, 10.0)


def test_readers_on_synthetic_records():
    rec = {"spans": {"validate": [0.003, 0.001, 0.002]},
           "trace": {"busy_s": 0.6, "window_s": 1.0, "device_kernels": 480,
                     "kernel_s": {"propagate": 0.002, "exchange": 0.0,
                                  "ed25519": 0.001}},
           "least_s": {"propagate": 0.001, "exchange": 0.0005,
                       "ed25519": 0.0},
           "rounds_traced": 48}
    assert readers.span_median_ms(rec, "validate") == pytest.approx(2.0)
    assert readers.span_median_ms(rec, "rollout") is None
    assert readers.roofline_pct(rec, "propagate") == pytest.approx(50.0)
    assert readers.roofline_pct(rec, "exchange") is None   # no device time
    assert readers.roofline_pct(rec, "ed25519") is None    # no least time
    assert readers.launches_per_round(rec) == pytest.approx(10.0)
    assert readers.device_idle_pct(rec) == pytest.approx(40.0)
    assert registry.metric_reader("device_idle.sim")({}) is None


class _Event:
    def __init__(self, name, cuda, start_us, dur_us):
        self._n, self._c, self._s, self._d = name, cuda, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)


class _Prof:
    def __init__(self, events):
        class K:
            pass

        self.profiler = K()
        self.profiler.kineto_results = K()
        self.profiler.kineto_results.events = lambda: events


def test_trace_reduction_busy_idle_and_named_gaps():
    ev = [
        _Event(tracing.WINDOW_SPAN, False, 0, 1000),
        _Event(tracing.WINDOW_SPAN, True, 0, 1000),    # the device mirror
        _Event("pubsub_bench.publish", False, 0, 400),
        _Event("pubsub_bench.rollout", False, 400, 600),
        _Event("propagate_kernel<4>", True, 100, 100),
        _Event("exchange_kernel<4>", True, 150, 100),   # overlaps the first
        _Event("Memcpy DtoH", True, 700, 50),
        _Event("ed25519_verify_kernel<5>", True, 900, 200),  # past the end
    ]
    r = tracing.reduce_trace(_Prof(ev))
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx((150 + 50 + 100) * 1e-6)
    assert r["device_kernels"] == 3              # the copy is no kernel
    assert r["kernel_s"]["propagate"] == pytest.approx(1e-4)
    assert r["kernel_s"]["ed25519"] == pytest.approx(1e-4)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "rollout"                      # 250..700
    assert gaps[0][1] == pytest.approx(450e-6)
    assert [n for n, _ in gaps] == ["rollout", "rollout", "publish"]
    assert len(r["breakdown"]["device_ops"]) <= 10
    assert tracing.reduce_trace(_Prof(ev[:1] + ev[2:4])) is None


# -- the frozen yardstick --------------------------------------------------------


def test_byte_counts_equal_chip_smokes():
    import chip_smoke

    gen = torch.Generator().manual_seed(3)
    for arm in ("plain", "idontwant", "fresh_src"):
        args, kw = chip_smoke.propagate_inputs(gen, 517, 32, 4, "cpu", arm)
        from go_libp2p_pubsub_torch.ops import gossip_packed

        out = tuple(gossip_packed.propagate_packed(*args, **kw))
        assert counts.propagate_bytes(args, kw, out) == \
            chip_smoke.propagate_bytes(args, kw, out)
    args = chip_smoke.exchange_inputs(gen, 517, 32, 4, "cpu")
    from go_libp2p_pubsub_torch.ops import gossip_packed

    out = gossip_packed.exchange_select(*args, 5000, 5000)
    assert counts.exchange_bytes(args, out) == \
        chip_smoke.exchange_bytes(args, out)


def test_e1_count_is_frozen():
    # 3,685 field multiplies of 125 IMADs, 64 IMADs a clock on 132 SMs at
    # 1,980 MHz: 128 verifications need at least 3.52 microseconds.
    least = counts.e1_least_s(128, 132, 1980.0)
    assert least == pytest.approx(3685 * 125 * 128 / (64 * 132 * 1.98e9))
    assert counts.e1_least_s(1, 132, 1980.0) > 129 / 3.35e12
    assert counts.HBM_BYTES_PER_S == 3.35e12


# -- nothing of JAX ---------------------------------------------------------------


def _modules_after(imports: str):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_the_harness_loads_no_jax():
    tops = _modules_after(
        "import pubsub_bench.run, pubsub_bench.harness.closed_loop, "
        "pubsub_bench.harness.inputs, pubsub_bench.traffic.episodes, "
        "pubsub_bench.reference.closed_loop;"
        "import go_libp2p_pubsub_torch.models.gossipsub, "
        "go_libp2p_pubsub_torch.crypto.pipeline")
    assert not tops & set(common.FORBIDDEN_MODULES)


def test_the_reference_imports_nothing_of_the_program():
    tops = _modules_after(
        "import pubsub_bench.reference.closed_loop, "
        "pubsub_bench.reference.gossipsub, pubsub_bench.reference.rng")
    assert not tops & (set(common.FORBIDDEN_MODULES)
                       | {"go_libp2p_pubsub_torch"})


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "go_libp2p_pubsub_tpux", object())
    assert "go_libp2p_pubsub_tpu" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in common.forbidden_loaded()


def test_checks_and_result_line(capsys):
    checks = [common.check("a", 0, 0), common.check("b", 2, 1),
              common.check("c", 3, 1, op=">=")]
    assert [common.check_passes(c) for c in checks] == [True, False, True]
    assert not common.check_passes(common.check("d", math.nan, 1))
    common.emit({"correct": False}, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["checks"]["b"] == {"value": 2, "limit": "<= 1"}
    assert err.strip().splitlines()[-1].startswith("check c = 3")


def test_median_helper_matches_statistics():
    assert readers.span_median_ms({"spans": {"x": [1.0, 3.0]}}, "x") == \
        statistics.median([1.0, 3.0]) * 1e3
