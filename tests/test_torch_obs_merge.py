"""The port's cross-host span merge and HTTP endpoint against the JAX
package's.

``obs/merge.py`` and ``obs/server.py`` are copies of the reference's
(pinned below).  The synthetic host artifacts of the reference's
``tests/test_obs_merge.py`` are built and merged by both packages, and the
merged documents must be byte-identical as ``json.dumps(...,
sort_keys=True)``: clock-offset normalisation, the recovery-gap kinds,
the Chrome trace and the OTLP record included.  The reference's content
checks then run on the port's output.
"""

import json
import random
from types import SimpleNamespace

import pytest

import go_libp2p_pubsub_torch.obs as tobs
import go_libp2p_pubsub_tpu.obs as jobs
from test_torch_wire import assert_copy

PKGS = {"port": tobs, "reference": jobs}


@pytest.mark.parametrize("rel", ["obs/merge.py", "obs/server.py"])
def test_module_is_a_copy_of_the_reference(rel):
    assert_copy(rel)


def _dump(doc):
    return json.dumps(doc, sort_keys=True)


# -- sampling agreement -------------------------------------------------------


def test_live_span_key_is_host_independent():
    k1 = tobs.live_span_key("root7/updates", b"payload bytes")
    assert k1 == jobs.live_span_key("root7/updates", b"payload bytes")
    assert len(k1) == 32 and int(k1, 16) >= 0
    assert tobs.live_span_key("root8/updates", b"payload bytes") != k1
    assert tobs.live_span_key("root7/updates", b"payload bytez") != k1
    assert tobs.live_span_key("ab", b"c") != tobs.live_span_key("a", b"bc")


def test_cross_host_sampling_agreement():
    ledgers = [mod.SpanLedger(sample_n=8) for mod in (tobs, jobs)
               for _ in range(8)]
    keys = [tobs.live_span_key("r/t", b"msg:%d" % i) for i in range(256)]
    verdicts = [[led.sampled(k) for k in keys] for led in ledgers]
    assert all(v == verdicts[0] for v in verdicts[1:])
    assert 0 < sum(verdicts[0]) < len(keys)


# -- synthetic multi-host fixtures, built by either package --------------------


def _mk_host(obs, host, stamps, events=(), clock_offset_s=0.0, sample_n=1,
             open_annotations=()):
    led = obs.SpanLedger(sample_n=sample_n)
    for key, stage, t, attrs in stamps:
        assert led.stamp(key, stage, t=t, **attrs)
    for name, t, attrs in open_annotations:
        led.annotate_open(name, t=t, **attrs)
    for name, t, attrs in events:
        led.event(name, t=t, **attrs)
    return obs.build_host_span_artifact(host, led,
                                        clock_offset_s=clock_offset_s)


def _keys(obs):
    return SimpleNamespace(a=obs.live_span_key("r/t", b"alpha"),
                           b=obs.live_span_key("r/t", b"beta"))


def _three_host_artifacts(obs):
    """Origin h0 publishes two messages; h1 relays; h1 and h2 deliver."""
    k = _keys(obs)
    h0 = _mk_host(obs, "h0", [
        (k.a, "publish", 1.000, {"bytes": 5}),
        (k.a, "send", 1.001, {"fanout": 1}),
        (k.b, "publish", 2.000, {"bytes": 4}),
        (k.b, "send", 2.001, {"fanout": 1}),
    ])
    h1 = _mk_host(obs, "h1", [
        (k.a, "recv", 1.011, {"from": "h0"}),
        (k.a, "deliver", 1.012, {}),
        (k.a, "send", 1.013, {"fanout": 1}),
        (k.b, "recv", 2.021, {"from": "h0"}),
        (k.b, "deliver", 2.022, {}),
        (k.b, "send", 2.023, {"fanout": 1}),
    ])
    h2 = _mk_host(obs, "h2", [
        (k.a, "recv", 1.030, {"from": "h1"}),
        (k.a, "deliver", 1.032, {}),
        (k.b, "recv", 2.040, {"from": "h1"}),
        (k.b, "deliver", 2.041, {}),
    ])
    return [h0, h1, h2]


def _skewed(obs):
    arts = _three_host_artifacts(obs)
    for span in arts[2]["spans"]:
        for rec in span["stamps"]:
            rec["t"] += 5.0
    arts[2]["clock_offset_s"] = 5.0
    return arts


def _promotion(obs):
    arts = _three_host_artifacts(obs)
    arts[1]["events"] = [{"name": "parent_lost", "t": 3.0, "peer": "h0"}]
    arts[2]["events"] = [
        {"name": "parent_lost", "t": 3.2, "peer": "h0"},
        {"name": "promoted", "t": 3.5, "epoch": 1},
    ]
    return arts


def _park_merge(obs):
    arts = _three_host_artifacts(obs)
    arts[2]["events"] = [
        {"name": "failover_parked", "t": 4.0, "epoch": 0, "rank": -1},
        {"name": "failover_merged", "t": 6.5, "how": "healed"},
    ]
    return arts


def _open_annotation(obs):
    k = _keys(obs)
    parked = _mk_host(obs, "h3", [(k.a, "recv", 3.9, {"from": "h1"})],
                      open_annotations=[("failover_park", 4.0, {"epoch": 0})])
    return _three_host_artifacts(obs) + [parked]


def _sampled(obs):
    """A 1/4-sampled window over four hosts, with drops and a replay."""
    rng = random.Random(4)
    stamps = {f"h{i}": [] for i in range(4)}
    for m in range(40):
        key = obs.live_span_key("r/t", b"m:%d" % m)
        t = 10.0 + m * 0.01
        stamps["h0"] += [(key, "publish", t, {"bytes": 9}),
                         (key, "send", t + 0.0005, {"fanout": 2})]
        for h, parent in (("h1", "h0"), ("h2", "h0"), ("h3", "h1")):
            if rng.random() < 0.1:
                continue
            t_r = t + rng.uniform(0.001, 0.02)
            stamps[h] += [(key, "recv", t_r, {"from": parent}),
                          (key, "deliver", t_r + 0.0002, {})]
            if h == "h1":
                stamps[h].append((key, "replay_send", t_r + 0.001, {}))
    arts = []
    for h, st in stamps.items():
        led = obs.SpanLedger(sample_n=4)
        for key, stage, t, attrs in st:
            led.stamp(key, stage, t=t, **attrs)
        arts.append(obs.build_host_span_artifact(h, led,
                                                 clock_offset_s=0.001))
    return arts


CASES = [_three_host_artifacts, _skewed, _promotion, _park_merge,
         _open_annotation, _sampled]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_merged_artifacts_are_byte_identical(case):
    port_arts, ref_arts = case(tobs), case(jobs)
    assert _dump(port_arts) == _dump(ref_arts)
    merged = {name: obs.merge_host_artifacts(arts)
              for (name, obs), arts in zip(PKGS.items(),
                                           (port_arts, ref_arts))}
    assert _dump(merged["port"]) == _dump(merged["reference"])
    # Each package merges the other's host artifacts the same way.
    assert _dump(tobs.merge_host_artifacts(case(jobs))) == \
        _dump(merged["reference"])
    assert tobs.propagation_latencies(merged["port"]) == \
        jobs.propagation_latencies(merged["reference"])
    assert merged["port"]["propagation"]["deliveries"] > 0


def test_merge_end_to_end_traces_and_per_hop():
    k = _keys(tobs)
    merged = tobs.merge_host_artifacts(_three_host_artifacts(tobs))
    assert merged["format"] == "obs-span-merged/1"
    assert merged["hosts"] == ["h0", "h1", "h2"]
    prop = merged["propagation"]
    assert (prop["messages"], prop["deliveries"]) == (2, 4)
    tr = {t["key"]: t for t in merged["traces"]}
    lat_a = {d["host"]: d["latency_s"] for d in tr[k.a]["deliveries"]}
    assert lat_a["h1"] == pytest.approx(0.012)
    assert lat_a["h2"] == pytest.approx(0.032)
    assert tr[k.a]["publish"]["host"] == "h0"
    hops = prop["per_hop"]
    assert hops["send->recv"]["count"] == 4
    assert 0.01 <= hops["send->recv"]["p50"] <= 0.02
    assert hops["publish->send"]["count"] == 2
    assert hops["recv->deliver"]["count"] == 4
    assert hops["recv->send"]["count"] == 2
    assert len(tobs.propagation_latencies(merged)) == 4
    seen = {r["stage"] for t in merged["traces"] for r in t["hops"]}
    assert seen <= set(tobs.HOP_STAGES)


def test_merge_shuffled_input_is_byte_identical():
    ref = _dump(jobs.merge_host_artifacts(_three_host_artifacts(jobs)))
    rng = random.Random(19)
    for _ in range(4):
        arts = _three_host_artifacts(tobs)
        rng.shuffle(arts)
        for art in arts:
            rng.shuffle(art["spans"])
            for span in art["spans"]:
                rng.shuffle(span["stamps"])
        assert _dump(tobs.merge_host_artifacts(arts)) == ref


def test_merge_normalizes_clock_offsets():
    base = tobs.merge_host_artifacts(_three_host_artifacts(tobs))
    merged = tobs.merge_host_artifacts(_skewed(tobs))
    for field in ("p50_s", "p99_s", "max_s"):
        assert merged["propagation"][field] == \
            pytest.approx(base["propagation"][field], abs=1e-9)
    assert sorted(r[2] for r in tobs.propagation_latencies(merged)) == \
        pytest.approx(sorted(r[2] for r in tobs.propagation_latencies(base)),
                      abs=1e-9)


def test_merge_input_validation():
    arts = _three_host_artifacts(tobs)
    mixed = _three_host_artifacts(tobs)
    mixed[1]["sample_n"] = 4
    for bad, match in (([], "at least one"),
                       ([{"format": "obs-blackbox/1"}],
                        "not an obs-span-host/1"),
                       ([arts[0], arts[0]], "duplicate host"),
                       (mixed, "sample_n")):
        for obs in (tobs, jobs):
            with pytest.raises(ValueError, match=match):
                obs.merge_host_artifacts(bad)


def test_recovery_gap_kinds():
    gap = tobs.merge_host_artifacts(_promotion(tobs))["recovery_gap"]
    assert gap["kind"] == "promotion" and gap["hosts"] == ["h1", "h2"]
    assert gap["gap_s"] == pytest.approx(0.5)
    gap = tobs.merge_host_artifacts(_park_merge(tobs))["recovery_gap"]
    assert gap["kind"] == "park_merge" and gap["hosts"] == ["h2"]
    assert gap["gap_s"] == pytest.approx(2.5)
    assert tobs.merge_host_artifacts(
        _three_host_artifacts(tobs))["recovery_gap"] is None
    merged = tobs.merge_host_artifacts(_promotion(tobs))
    anns = [e for e in merged["chrome_trace"]["traceEvents"]
            if e.get("cat") == "annotation"]
    assert len(anns) == 1 and anns[0]["name"] == "failover_gap"
    k = _keys(tobs)
    evs = [e for e in tobs.merge_host_artifacts(_open_annotation(tobs))[
        "events"] if e.get("span") == k.a and e["name"] == "failover_park"]
    assert len(evs) == 1 and evs[0]["host"] == "h3"


def test_chrome_and_otlp_renderings():
    merged = tobs.merge_host_artifacts(_three_host_artifacts(tobs))
    evs = merged["chrome_trace"]["traceEvents"]
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == {
        "cluster", "host h0", "host h1", "host h2"}
    segs = [e for e in evs if e["ph"] == "X" and e.get("cat") == "message"]
    assert len(segs) == 6 and all(e["dur"] >= 0 for e in segs)
    ids = {}
    for rs in merged["otlp"]["resourceSpans"]:
        for span in rs["scopeSpans"][0]["spans"]:
            ids.setdefault(span["traceId"], set()).add(span["spanId"])
    assert len(ids) == 2 and all(len(s) == 3 for s in ids.values())


# -- the HTTP endpoint -------------------------------------------------------------


def test_obs_http_server_metrics_and_debug():
    from urllib.error import HTTPError
    from urllib.request import urlopen

    from go_libp2p_pubsub_torch.utils.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.inc("serve.engine.chunks", 5)
    led = tobs.SpanLedger(sample_n=1)
    led.stamp(tobs.content_hash(0, 0, b"x"), "ring_accept")
    box = tobs.BlackBox(capacity=4)
    box.record({"chunk": 0})
    srv = tobs.ObsHTTPServer(reg, ledger=led, blackbox=box,
                             extra_json={"/debug/extra": lambda: {"k": 1}})
    port = srv.start()
    try:
        with urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            body = r.read().decode()
        assert "serve_engine_chunks_total 5" in body
        with urlopen(f"http://127.0.0.1:{port}/debug/obs", timeout=10) as r:
            dbg = json.loads(r.read().decode())
        assert dbg["spans"]["spans"] == 1
        assert dbg["blackbox"]["recorded"] == 1
        assert len(dbg["blackbox"]["frames"]) == 1
        with urlopen(f"http://127.0.0.1:{port}/debug/extra", timeout=10) as r:
            assert json.loads(r.read().decode()) == {"k": 1}
        with pytest.raises(HTTPError):
            urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    finally:
        srv.stop()
