"""The 100,000-peer tree run and its committed trace.

The configuration is ``bench.py``'s ``bench_treecast`` (config (a),
``bench.py:561-590``: a width-2 tree, ``max_width`` 8, ``queue_cap`` and
``out_cap`` 128) scaled from 10 peers to the headline's 100,000, with the
reference's fanout defaults (``TreeOpts()``: width 2, max width 5,
``pubsub.go:16-17``) and root 0.  The run has three phases:

- ``join``: every peer subscribes at once (``begin_subscribe_many``);
  one step at a time until every peer has joined (at most ``join_bound``
  steps);
- ``drain``: 64 root publishes, then steps until the queues are empty;
- ``churn``: at one step, 1% of the peers die abruptly and 1% leave
  gracefully (drawn from ``churn_seed``, never the root), 32 more root
  publishes, then steps until the network has healed: no peer orphaned,
  the queues empty and every live peer joined under a live, joined
  parent with no join walk pending (at most ``heal_bound`` steps).

Every step's ``tree_metrics`` sample and, at the end of each phase, a
digest of every ``TreeState`` leaf (dtype, shape, sha256 of its bytes in
the reference's dtypes) make the document.  Engine-agnostic: the
engine object supplies ``init``, ``begin_many``, ``publish_many``,
``churn``, ``rollout(state, n) -> (state, host record)`` and ``host(state,
names)`` (numpy leaves).  Without a ``plan`` the drain and heal phases
step one at a time and stop at their condition (how the JAX package wrote
``traces/tree_100000.trace.json``); with the trace as ``plan`` each runs
as one timed ``rollout`` of the trace's step count, and the condition is
checked at its end.

At 100,000 rows the reference's ``segment_rank`` composite key
(``key * (n + 1) + index`` in int32) wraps, so a few joiners share an
admit rank and are marked joined under a parent whose child slots do not
list them; they never receive a message.  Both packages compute the same
wrapped keys, so the trace holds them (``stranded`` in each phase's
summary); the drain's condition is the empty queues, not every member
holding 64.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

TRACE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "traces", "tree_100000.trace.json")
N_PEERS = 100_000
CONFIG = dict(max_width=8, queue_cap=128, out_cap=128)
OPTS = dict(tree_width=2, tree_max_width=5)
ROOT, SEED, CHURN_SEED = 0, 0, 8
N_DRAIN, N_HEAL = 64, 32
JOIN_BOUND = HEAL_BOUND = 256


def header(n_peers: int) -> Dict[str, Any]:
    """The trace's configuration block at ``n_peers``."""
    churn = max(1, n_peers // 100)
    return {
        "trace_version": 1,
        "config": dict(CONFIG, max_peers=n_peers),
        "opts": dict(OPTS), "root": ROOT, "seed": SEED,
        "churn_seed": CHURN_SEED, "n_kill": churn, "n_leave": churn,
        "n_drain": N_DRAIN, "n_heal": N_HEAL,
        "join_bound": JOIN_BOUND, "heal_bound": HEAL_BOUND,
    }


def churn_masks(hdr: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """(kill, leave) bool[N] masks: disjoint draws of non-root peers."""
    n = hdr["config"]["max_peers"]
    rng = np.random.default_rng(hdr["churn_seed"])
    pool = np.flatnonzero(np.arange(n) != hdr["root"])
    pick = rng.choice(pool, size=hdr["n_kill"] + hdr["n_leave"],
                      replace=False)
    kill, leave = np.zeros(n, bool), np.zeros(n, bool)
    kill[pick[: hdr["n_kill"]]] = True
    leave[pick[hdr["n_kill"]:]] = True
    return kill, leave


def digest(leaves: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    """Every leaf's dtype, shape and sha256."""
    return {
        name: {"dtype": str(a.dtype), "shape": list(a.shape),
               "sha256": hashlib.sha256(
                   np.ascontiguousarray(a).tobytes()).hexdigest()}
        for name, a in sorted(leaves.items())
    }


def _membership(eng, st) -> Dict[str, int]:
    """Counts the heal condition and the summary read from the state."""
    h = eng.host(st, ("alive", "joined", "join_target", "parent",
                      "children", "root"))
    n = h["alive"].shape[0]
    root = int(h["root"])
    member = h["alive"] & h["joined"]
    p = np.clip(h["parent"], 0, n - 1)
    parent_ok = (h["parent"] >= 0) & member[p]
    others = h["alive"] & (np.arange(n) != root)
    listed = np.zeros(n + 1, bool)
    listed[np.where(h["children"] >= 0, h["children"], n).reshape(-1)] = True
    return {
        "waiting": int((others & ~(h["joined"] & (h["join_target"] < 0)
                                   & parent_ok)).sum()),
        "stranded": int((others & member & parent_ok & ~listed[:n]).sum()),
    }


def _cat(records: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {name: np.concatenate([r[name] for r in records])
            for name in records[0]}


def _channels(rec: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {name: {"dtype": str(a.dtype), "data": a.tolist()}
            for name, a in sorted(rec.items())}


def _advance(eng, st, done: Callable, bound: int, steps: Optional[int],
             clock):
    """Step until ``done(state, last record)`` (one step at a time, at most
    ``bound``), or, with ``steps``, one timed rollout of that many.
    Returns (state, record, steps, wall seconds or None)."""
    if steps is not None:
        t0 = clock()
        st, rec = eng.rollout(st, steps)
        return st, rec, steps, clock() - t0
    records = []
    for _ in range(bound):
        st, rec = eng.rollout(st, 1)
        records.append(rec)
        if done(st, rec):
            break
    return st, _cat(records), len(records), None


def run(eng, hdr: Dict[str, Any], plan: Optional[Dict[str, Any]] = None,
        clock=time.perf_counter, until: Optional[str] = None,
        cut_steps: Optional[int] = None):
    """The three phases on ``eng`` -> (document body, extras).  ``extras``
    holds the states at each phase boundary and, with ``plan``, the wall
    seconds of the drain and heal rollouts.  ``until`` names the last
    phase to run (a run cut in depth; the document then holds the phases
    up to it, and ``extras`` no ``conditions``); ``cut_steps`` runs only
    the first that many steps of that phase when it is ``drain`` or
    ``churn`` (the phase's record is then a prefix of the whole run's)."""
    n = hdr["config"]["max_peers"]
    phases: Dict[str, Any] = {}
    extras: Dict[str, Any] = {"states": {}, "wall_s": {}}

    def planned(name):
        if name == until and cut_steps is not None:
            return cut_steps
        return None if plan is None else plan["phases"][name]["steps"]

    def finish(name, st, rec, steps):
        summary = _membership(eng, st)
        phases[name] = {"steps": steps, "record": _channels(rec),
                        "digest": digest(eng.host(st)), **summary}
        extras["states"][name] = st

    st = eng.init()
    st = eng.begin_many(st, np.ones(n, bool))
    st, rec, steps, _ = _advance(
        eng, st, lambda s, r: int(r["peers_joined"][-1]) == n,
        hdr["join_bound"], None, clock)
    finish("join", st, rec, steps)
    if until == "join":
        return {"phases": phases}, extras

    def emptied(s, r):
        return int(r["queue_backlog"][-1]) == 0

    st = eng.publish_many(st, np.arange(hdr["n_drain"], dtype=np.int32))
    extras["states"]["published"] = st
    st, rec, steps, wall = _advance(
        eng, st, emptied, hdr["heal_bound"], planned("drain"), clock)
    extras["wall_s"]["drain"] = wall
    finish("drain", st, rec, steps)
    if until == "drain":
        return {"phases": phases}, extras

    def healed(s, r):
        return (int(r["peers_orphaned"][-1]) == 0 and emptied(s, r)
                and _membership(eng, s)["waiting"] == 0)

    kill, leave = churn_masks(hdr)
    st = eng.churn(st, kill, leave)
    st = eng.publish_many(st, np.arange(
        hdr["n_drain"], hdr["n_drain"] + hdr["n_heal"], dtype=np.int32))
    extras["states"]["churned"] = st
    st, rec, steps, wall = _advance(
        eng, st, healed, hdr["heal_bound"], planned("churn"), clock)
    extras["wall_s"]["churn"] = wall
    finish("churn", st, rec, steps)
    extras["conditions"] = {
        "joined": int(rec["peers_joined"][-1]),
        "drained": phases["drain"]["record"]["queue_backlog"]["data"][-1] == 0,
        "healed": healed(st, rec),
    }
    return {"phases": phases}, extras


def mismatches(doc: Dict[str, Any], ref: Dict[str, Any],
               phases=None) -> Dict[str, int]:
    """Where two documents differ, counted by channel: ``<phase>.steps``,
    ``<phase>.record.<channel>`` (differing steps), ``<phase>.digest.<leaf>``
    and the summary counts; an empty dict when they agree.  ``phases``
    restricts the comparison to those phases (a run cut in depth)."""
    out: Dict[str, int] = {}
    for name, b in ref["phases"].items():
        if phases is not None and name not in phases:
            continue
        a = doc["phases"].get(name, {})
        for key in ("steps", "waiting", "stranded"):
            if a.get(key) != b[key]:
                out[f"{name}.{key}"] = 1
        arec = a.get("record", {})
        for ch, want in b["record"].items():
            got = arec.get(ch, {"dtype": None, "data": []})
            diff = sum(x != y for x, y in zip(got["data"], want["data"]))
            diff += abs(len(got["data"]) - len(want["data"]))
            diff += got["dtype"] != want["dtype"]
            if diff:
                out[f"{name}.record.{ch}"] = diff
        for leaf, want in b["digest"].items():
            if a.get("digest", {}).get(leaf) != want:
                out[f"{name}.digest.{leaf}"] = 1
    for key in ("config", "opts", "root", "seed", "churn_seed", "n_kill",
                "n_leave", "n_drain", "n_heal"):
        if doc.get(key) != ref.get(key):
            out[key] = 1
    return out


def load_trace(path: str = TRACE_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class PortEngine:
    """The port's ``TreeCast`` on ``device`` behind the engine interface;
    with ``mesh`` (a ``parallel.mesh.PeerMesh``) this rank's block of the
    sharded ``TreeCast(mesh=)``, whose ``host`` leaves are the whole
    state (every rank of the group drives its engine in step)."""

    def __init__(self, hdr: Dict[str, Any], device="cuda", mesh=None):
        from ..config import SimParams, TreeOpts
        from .treecast import TreeCast

        self.model = TreeCast(SimParams(**hdr["config"]),
                              TreeOpts(**hdr["opts"]), device=device,
                              mesh=mesh)
        self.mesh = mesh
        self.hdr = hdr

    def _dev(self, a: np.ndarray):
        import torch

        return torch.from_numpy(np.array(a)).to(self.model.device)

    def _rows(self, a: np.ndarray):
        t = self._dev(a)
        return t if self.mesh is None else self.mesh.local(t)

    def init(self):
        return self.model.init(root=self.hdr["root"], seed=self.hdr["seed"])

    def begin_many(self, st, mask):
        from ..ops import tree as tree_ops

        return tree_ops.begin_subscribe_many(st, self._dev(mask),
                                             pm=self.mesh)

    def publish_many(self, st, ids):
        from ..ops import tree as tree_ops

        return tree_ops.publish_many(st, self._dev(ids), pm=self.mesh)

    def churn(self, st, kill, leave):
        return st._replace(alive=st.alive & ~self._rows(kill),
                           leaving=st.leaving | self._rows(leave))

    def rollout(self, st, n):
        return self.model.rollout(st, n, record=True)

    def host(self, st, names=None):
        """Leaves as numpy in the reference's dtypes (the key as uint32);
        sharded, the peer-dim leaves all-gathered whole."""
        from ..ops.tree import TREE_PEER_DIMS

        out = {}
        for name in st._fields if names is None else names:
            v = getattr(st, name)
            if self.mesh is not None and name in TREE_PEER_DIMS:
                v = self.mesh.all_gather_rows(v)
            a = v.cpu().numpy()
            out[name] = a.view(np.uint32) if name == "key" else a
        return out


def port_replay(doc: Dict[str, Any], device="cuda", clock=time.perf_counter,
                mesh=None, until: Optional[str] = None,
                cut_steps: Optional[int] = None):
    """The port's run of ``doc``'s configuration on ``device`` (sharded
    over ``mesh`` when given), replaying its step counts (up to the phase
    ``until``, of which ``cut_steps``: see :func:`run`) -> (document,
    extras)."""
    hdr = {k: doc[k] for k in header(doc["config"]["max_peers"])}
    eng = PortEngine(hdr, device, mesh)
    body, extras = run(eng, hdr, plan=doc, clock=clock, until=until,
                       cut_steps=cut_steps)
    extras["engine"] = eng
    return dict(hdr, **body), extras
