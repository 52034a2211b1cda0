"""Coded-plane rollouts and their committed trace.

Two runs, each at the reference bench's widths with the peer count of
the trace's header:

- ``rlnc``: ``bench.py``'s ``RLNC_SCALE`` (16 slots, degree 8,
  ``gen_size`` 8, a 128-generation window, 24 steps, topology seed 0),
  clean and then with a quarter of the peers at ingress decimation 2;
  128 publishes at step 0 from ``default_rng(1)``'s draw, two of them
  failing validation (so they never enter relay);
- ``hybrid``: ``HYBRID_SCALE`` (16 slots, degree 8, ``gen_size`` 4, a
  32-message window, heartbeat 4, 32 steps, topology seed 0), 32
  publishes at step 0 from ``default_rng(3)``'s draw, under decimation
  d = 2 and under Bernoulli loss p = 0.375 (both cross the switch, so
  coded edges carry fragments and decodes merge into the eager plane).

Every step records the new receipts per message (``per_msg``), the
histogram of decode ranks over (peer, generation), a digest of
``first_step``, the count of coded edges and a digest of ``loss_ewma``'s
float32 bits (hybrid); each run ends with ``delivery_stats`` and a digest
of every state leaf in the reference's dtypes.  Engine-agnostic: the JAX
package's models wrote ``traces/coded.trace.json`` through this code (a
test does, outside the package) and the port's must reproduce it on any
device.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

TRACE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "traces", "coded.trace.json")
RLNC = dict(n_slots=16, conn_degree=8, msg_window=128, gen_size=8)
RLNC_RUN = dict(steps=24, topo_seed=0, pub_seed=1, forged=[5, 77],
                degraded_frac=0.25, degraded_delay=2)
HYBRID = dict(n_slots=16, conn_degree=8, msg_window=32, heartbeat_steps=4,
              gen_size=4)
HYBRID_RUN = dict(steps=32, topo_seed=0, pub_seed=3, delay=2, bern_p=0.375)
RLNC_RUNS = ("rlnc_clean", "rlnc_degraded")
HYBRID_RUNS = ("hybrid_decimation", "hybrid_bernoulli")


def header(n_rlnc: int, n_hybrid: int) -> Dict[str, Any]:
    """The trace's configuration block."""
    return {
        "trace_version": 1,
        "rlnc": dict(RLNC, n_peers=n_rlnc), "rlnc_run": dict(RLNC_RUN),
        "hybrid": dict(HYBRID, n_peers=n_hybrid),
        "hybrid_run": dict(HYBRID_RUN),
    }


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digest(leaves: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    """Each leaf's dtype, shape and sha256 of its bytes."""
    return {k: {"dtype": str(v.dtype), "shape": list(v.shape),
                "sha256": _sha(v)} for k, v in sorted(leaves.items())}


def _hex(x) -> str:
    return float(x).hex()


def rlnc_plan(hdr: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Publishers, validity and the degraded cohort's delay vector."""
    n, run = hdr["rlnc"]["n_peers"], hdr["rlnc_run"]
    g = hdr["rlnc"]["msg_window"]
    rng = np.random.default_rng(run["pub_seed"])
    srcs = rng.integers(n, size=g)
    cohort = rng.choice(n, size=max(1, round(run["degraded_frac"] * n)),
                        replace=False)
    delay = np.zeros(n, np.int32)
    delay[cohort] = run["degraded_delay"]
    valid = np.ones(g, bool)
    valid[list(run["forged"])] = False
    return {"srcs": srcs, "valid": valid, "delay": delay}


def hybrid_plan(hdr: Dict[str, Any]) -> Dict[str, np.ndarray]:
    n, run = hdr["hybrid"]["n_peers"], hdr["hybrid_run"]
    rng = np.random.default_rng(run["pub_seed"])
    return {"srcs": rng.integers(n, size=hdr["hybrid"]["msg_window"])}


def _sample(eng, model, st, per_msg: np.ndarray, kg: int) -> Dict[str, Any]:
    v = eng.views(model, st)
    out = {
        "per_msg": [int(x) for x in per_msg],
        "rank_hist": np.bincount(v["rank"].reshape(-1),
                                 minlength=kg + 1).tolist(),
        "first_step": _sha(v["first_step"].astype(np.int32)),
    }
    if "coded" in v:
        out["coded_edges"] = int(v["coded"].sum())
        out["loss_ewma"] = _sha(v["loss_ewma"].astype(np.float32))
    return out


def _finish(eng, model, st, steps: List[Dict[str, Any]]) -> Dict[str, Any]:
    frac, p50, p99 = eng.delivery_stats(model, st)
    return {
        "steps": steps,
        "delivery_frac": [_hex(x) for x in np.asarray(frac).reshape(-1)],
        "p50": _hex(p50), "p99": _hex(p99),
        "leaves": digest(eng.leaves(model, st)),
    }


def _roll(eng, model, st, n_steps: int, kg: int, timings):
    steps = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        st, per_msg = eng.step_recorded(model, st)
        timings.append(time.perf_counter() - t0)
        steps.append(_sample(eng, model, st, per_msg, kg))
    return st, steps


def run(eng, hdr: Dict[str, Any], timings: Optional[Dict[str, List[float]]]
        = None, runs=RLNC_RUNS + HYBRID_RUNS) -> Dict[str, Any]:
    """The ``runs`` (all four by default) through ``eng`` -> the trace
    document.  ``timings`` collects each run's per-step host walls
    (``eng.step_recorded`` returns once the step's receipts are on the
    host)."""
    timings = {} if timings is None else timings
    doc: Dict[str, Any] = {"header": hdr, "runs": {}}
    rp = rlnc_plan(hdr)
    model = eng.rlnc(hdr["rlnc"]) if set(runs) & set(RLNC_RUNS) else None
    kg = hdr["rlnc"]["gen_size"]
    for name in RLNC_RUNS:
        if name not in runs:
            continue
        st = eng.init(model, hdr["rlnc_run"]["topo_seed"])
        if name == "rlnc_degraded":
            st = eng.set_delay(model, st, rp["delay"])
        for slot, (src, ok) in enumerate(zip(rp["srcs"], rp["valid"])):
            st = eng.publish(model, st, int(src), slot, bool(ok))
        st, steps = _roll(eng, model, st, hdr["rlnc_run"]["steps"], kg,
                          timings.setdefault(name, []))
        doc["runs"][name] = _finish(eng, model, st, steps)
    hp = hybrid_plan(hdr)
    model = eng.hybrid(hdr["hybrid"])
    kg = hdr["hybrid"]["gen_size"]
    run_cfg = hdr["hybrid_run"]
    for name in HYBRID_RUNS:
        if name not in runs:
            continue
        st = eng.init(model, run_cfg["topo_seed"])
        if name == "hybrid_decimation":
            st = eng.set_loss(model, st, run_cfg["delay"])
        else:
            st = eng.set_loss_p(model, st, run_cfg["bern_p"])
        for slot, src in enumerate(hp["srcs"]):
            st = eng.publish(model, st, int(src), slot, True)
        st, steps = _roll(eng, model, st, run_cfg["steps"], kg,
                          timings.setdefault(name, []))
        doc["runs"][name] = _finish(eng, model, st, steps)
    return doc


def mismatches(doc: Dict[str, Any], ref: Dict[str, Any]) -> List[str]:
    """Where two trace documents differ: ``run/step i/channel`` or
    ``run/<final key>``."""
    out = [] if doc["header"] == ref["header"] else ["header"]
    for name, want in ref["runs"].items():
        got = doc["runs"].get(name)
        if got is None:
            out.append(f"{name}: missing")
            continue
        if len(got["steps"]) != len(want["steps"]):
            out.append(f"{name}: {len(got['steps'])} steps")
        for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
            out.extend(f"{name}/step {i}/{k}" for k in b if a.get(k) != b[k])
        out.extend(f"{name}/{k}" for k in want
                   if k != "steps" and got.get(k) != want[k])
    return out


def load_trace(path: str = TRACE_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def write_trace(eng, hdr: Dict[str, Any], path: str = TRACE_PATH
                ) -> Dict[str, Any]:
    doc = run(eng, hdr)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    return doc


class PortEngine:
    """The port's ``RLNC``/``HybridGossipSub`` behind the trace's engine
    interface, on ``device``."""

    def __init__(self, device="cuda"):
        self.device = device

    def rlnc(self, cfg):
        from .rlnc import RLNC

        return RLNC(device=self.device, **cfg)

    def hybrid(self, cfg):
        from .hybrid import HybridGossipSub

        return HybridGossipSub(device=self.device, **cfg)

    def init(self, model, seed):
        return model.init(seed)

    def set_delay(self, model, st, delay):
        return model.set_gossip_delay(st, delay)

    def set_loss(self, model, st, d):
        return model.set_ingress_loss(st, d)

    def set_loss_p(self, model, st, p):
        return model.set_ingress_loss_p(st, p)

    def publish(self, model, st, src, slot, valid):
        return model.publish(st, src, slot, valid)

    def step_recorded(self, model, st):
        st, per_msg = model.step_recorded(st)
        return st, per_msg.cpu().numpy()

    def views(self, model, st):
        from ..ops import gf256

        out = {"rank": gf256.gf_rank(st.basis).cpu().numpy()}
        if hasattr(st, "gossip"):
            out["first_step"] = st.gossip.first_step.cpu().numpy()
            out["coded"] = (st.coded & st.gossip.nbr_valid).cpu().numpy()
            out["loss_ewma"] = st.loss_ewma.cpu().numpy()
        else:
            out["first_step"] = st.first_step.cpu().numpy()
        return out

    def delivery_stats(self, model, st):
        return tuple(x.cpu().numpy() for x in model.delivery_stats(st))

    def leaves(self, model, st):
        from .. import bridge

        return flatten(bridge.hybrid_state_to_numpy(st) if hasattr(
            st, "gossip") else bridge.rlnc_state_to_numpy(st))


def flatten(st) -> Dict[str, np.ndarray]:
    """A NamedTuple state (nested NamedTuples included) -> {dotted path:
    numpy leaf}."""
    out: Dict[str, np.ndarray] = {}
    for name in st._fields:
        leaf = getattr(st, name)
        if hasattr(leaf, "_fields"):
            out.update({f"{name}.{k}": v for k, v in flatten(leaf).items()})
        else:
            out[name] = np.asarray(leaf)
    return out


def port_replay(doc: Dict[str, Any], device="cuda"):
    """The port on ``device`` through the trace's header -> (its document,
    the mismatches against ``doc``, per-run step walls)."""
    timings: Dict[str, List[float]] = {}
    got = run(PortEngine(device), doc["header"], timings)
    return got, mismatches(got, doc), timings
